"""Fused BigVGAN resblock stage, K10
(`voice_tts_tpu/ops/attic/fused_vocoder.py`).

`fused_resblock_stage(x, pack, dilations)`: x (1, C, T) f32, the upsampled
signal of one stage -> (1, C, T), the mean over the stage's nk AMP
resblocks.  Each resblock runs, per dilation d of its schedule,
AA-snake -> dilated conv -> AA-snake -> conv -> residual add.  The semantics
are the JAX kernel's, not the module path's: the signal is zero outside
[0, T) and every AA-snake output and conv output is taken on [0, T) only;
the polyphase up-phases and their snake values are computed on the
zero-extended signal and are not masked; convs are SAME with zero padding;
the blocks' results sum in order and the mean is `acc * (1.0 / nk)`.  The
module path replicate-pads instead, so the two agree only beyond the
stage's 78-sample halo from either end.

- `fused_resblock_stage_plain`: PyTorch ops (CPU tensors, and the reference
  the kernel is checked against on the card);
- `csrc/fused_vocoder.cu` (`vtt_fused_resblock_stage`): the hand-written
  kernel, one C call per stage that launches the 18 (AA-snake, conv) pairs
  on the stream (the AA-snake in each conv's prologue), for CUDA tensors.
  Each pair is an implicit GEMM on the tensor cores (TF32 `mma.sync`) with
  f32-class numerics by a three-pass split of both operands, hi = tf32(v),
  lo = tf32(v - hi), summing lo.hi + hi.lo + hi.hi in f32:
  `fused_resblock_stage_split_plain` is that arithmetic in PyTorch ops.
  The weights' split planes (`KernelPack`, `kernel_pack`) are made once a
  pack and kept beside it; `plan_fused_stage` is the launch of one pair
  (the C launch applies the same rule, `vtt_fused_stage_plan`).

`bigvgan_fused_apply` runs a whole vocode with the fused stages
(`EngineConfig.use_fused_vocoder`); the JAX kernel's Mosaic chunk width
(`_tt_for_channels`, `FUSED_VOC_TT`) has no counterpart: the result does not
depend on it.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from voice_tts_tpu_torch.config import BigVGANConfig
from voice_tts_tpu_torch.models.vocoder.packed import (can_pack, pad_kernel,
                                                       snake_values, sub_state)
from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.aa_activation import TAPS_HOST, aa_snake_zero_plain
from voice_tts_tpu_torch.ops.counters import LAUNCHES

# the JAX gate (18 * k_max * C^2 f32 weights resident in VMEM), kept; the
# kernel itself streams its weights through shared memory at any C
_MAX_FUSED_CHANNELS = 192
MAX_HALO = 64          # the kernel's largest d * (k - 1) / 2 (25 at the flagship config)
MAX_TAPS = 15
_CI = 16               # input channels a prologue chunk
_STAGES = 3            # ring stages, each one tap's two 8-channel weight slabs
_THREADS = 256
SPANS = {"all": 0, "prologue": 1, "mma": 2, "mma_no_weights": 3, "skeleton": 4}


class StagePack(NamedTuple):
    """Parameters of one fused stage.

    Conv order: block-major, then (convs1_m, convs2_m) per iteration:
    index = block * 2 * n_iter + 2 * m (+1 for convs2); activation order
    matches (+1 for the activation after convs1)."""

    w: torch.Tensor       # (n, k_max, C, C) f32 [tap][out][in], taps centre-embedded
    b: torch.Tensor       # (n, C, 1) f32
    alpha: torch.Tensor   # (n, C, 1) f32 (exp applied if log-scale)
    brec: torch.Tensor    # (n, C, 1) f32, 1 / (beta + 1e-9)
    kernel_sizes: Tuple[int, ...]   # each block's own taps, centred in k_max


@torch.no_grad()
def pack_stage(state: Dict[str, torch.Tensor], stage: int,
               cfg: BigVGANConfig) -> StagePack:
    """One stage's resblock parameters from a BigVGAN state dict."""
    nk = len(cfg.resblock_kernel_sizes)
    k_max = max(cfg.resblock_kernel_sizes)
    n_iter = len(cfg.resblock_dilation_sizes[0])
    has_beta = cfg.activation == "snakebeta"
    ws, bs, aa, br = [], [], [], []
    for j in range(nk):
        blk = sub_state(state, f"resblocks_{stage * nk + j}")
        for m in range(n_iter):
            for conv, act in ((f"convs1_{m}", 2 * m), (f"convs2_{m}", 2 * m + 1)):
                w = pad_kernel(blk[f"{conv}.weight"].float(), k_max)   # (C, C, k)
                ws.append(w.permute(2, 0, 1))                           # (k, C, C)
                bs.append(blk[f"{conv}.bias"].float()[:, None])
                alpha, brec = snake_values(sub_state(blk, f"act_{act}"),
                                           cfg.snake_logscale, has_beta)
                aa.append(alpha.float()[:, None])
                br.append(brec.float()[:, None])
    return StagePack(torch.stack(ws).contiguous(), torch.stack(bs), torch.stack(aa),
                     torch.stack(br), tuple(cfg.resblock_kernel_sizes))


class KernelPack(NamedTuple):
    """The kernel's form of a `StagePack`'s conv weights: each f32 weight
    split into hi = tf32(w) and lo = tf32(w - hi), laid out per (pair, tap,
    8 input channels) as a slab of CP / 16 output tiles x (hi, lo) x 32
    lanes x 4, the m16n8k8 A fragment of each lane (g, t) = (lane // 4,
    lane % 4): rows o = g, g + 8 and columns i = t, t + 4 of the tile
    (output channels padded with zeros to CP, `padded_channels`)."""

    w: torch.Tensor       # (n, k_max, C / 8, CP / 16, 2, 32, 4) f32


_KERNEL_PACKS: Dict[int, Tuple[weakref.ref, KernelPack]] = {}
# the warps' (rows, 16-channel tiles a warp) over the output channels: the
# first that holds C (`channel_tiles` in csrc/fused_vocoder.cu)
_CHANNEL_TILES = ((1, 1), (1, 2), (1, 3), (2, 2), (2, 3), (4, 2), (4, 3))


def _channel_tiles(c: int) -> Tuple[int, int]:
    return next(o for o in _CHANNEL_TILES if 16 * o[0] * o[1] >= c)


def padded_channels(c: int) -> int:
    """The output channels the kernel computes for C: whole 16-row MMA
    tiles over its warps (32 for C 24; C itself at 48, 96, 192)."""
    wm, mt = _channel_tiles(c)
    return 16 * wm * mt


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from zero,
    as `cvt.rna.tf32.f32`), kept in f32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def kernel_pack(pack: StagePack) -> KernelPack:
    """The split weight slabs of `pack`, made once and kept while pack.w
    lives (a pack is not written after packing)."""
    key = id(pack.w)
    hit = _KERNEL_PACKS.get(key)
    if hit is not None and hit[0]() is pack.w:
        return hit[1]
    n, k_max, c, _ = pack.w.shape
    if c % 8 or c > _MAX_FUSED_CHANNELS:
        raise ValueError(f"fused_resblock_stage: {c} channels, not a multiple of 8 up to "
                         f"{_MAX_FUSED_CHANNELS}")
    cp = padded_channels(c)
    hi = tf32_round(pack.w)
    planes = torch.stack([hi, tf32_round(pack.w - hi)], dim=-1)   # (n, k, o, i, plane)
    planes = F.pad(planes, (0, 0, 0, 0, 0, cp - c))
    # o = 16 tile + 8 ob + g, i = 8 slab + 4 ib + t; a lane's quad is
    # (o, i) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    planes = planes.reshape(n, k_max, cp // 16, 2, 8, c // 8, 2, 4, 2)
    kp = KernelPack(planes.permute(0, 1, 5, 2, 8, 4, 7, 6, 3)
                    .reshape(n, k_max, c // 8, cp // 16, 2, 32, 4).contiguous())
    _KERNEL_PACKS[key] = (weakref.ref(pack.w, lambda _, k=key: _KERNEL_PACKS.pop(k, None)),
                          kp)
    return kp


class FusedStagePlan(NamedTuple):
    """The launch of one (AA-snake, conv) pair: blocks of every output
    channel x `bn` samples; 8 warps as `wm` rows x 8 / wm columns, each `mt`
    16-channel by `nt` 8-sample MMA tiles; the prologue in chunks of `ci`
    input channels; a ring of `stages` weight slabs; `smem` bytes of
    dynamic shared memory."""

    bn: int
    wm: int
    mt: int
    nt: int
    ci: int
    stages: int
    threads: int
    smem: int


def plan_fused_stage(c: int, t: int, k: int, d: int) -> FusedStagePlan:
    """The C launch's rule (`plan_stage` in csrc/fused_vocoder.cu): M is
    every output channel, padded to whole 16-row tiles over wm warp rows of
    mt tiles (the first of (1, 1), (1, 2), (1, 3), (2, 2), (2, 3), (4, 2),
    (4, 3) that holds C); N is a time tile of bn = (8 / wm) x 4 x 8 samples.
    Shared memory: the weight ring (stages x 2 slabs x CP x 16 floats), Z's
    hi and lo planes (2 x rows x 16, rows = bn + 2 halo rounded up to 4; x,
    ci x (rows + 16), shares their space) and both phases (2 x ci x a stride
    of rows + 8 rounded to 4 mod 8)."""
    halo = d * (k - 1) // 2
    if (c < 8 or c > _MAX_FUSED_CHANNELS or c % 8 or t < 1 or k < 1 or k % 2 == 0
            or k > MAX_TAPS or d < 1 or halo > MAX_HALO):
        raise ValueError(f"fused_resblock_stage: no plan for C {c}, T {t}, k {k}, d {d}")
    wm, mt = _channel_tiles(c)
    nt = 4
    bn = 8 // wm * nt * 8
    rows = bn + -(-2 * halo // 4) * 4
    stride = rows + 8 + (4 if (rows + 8) % 8 == 0 else 0)
    floats = _STAGES * 2 * 16 * wm * mt * 16 + 2 * rows * 16 + 2 * _CI * stride
    return FusedStagePlan(bn, wm, mt, nt, _CI, _STAGES, _THREADS, 4 * floats)


def fused_stage_plan(cfg: BigVGANConfig) -> List[bool]:
    """Which upsample stages run the fused kernel: a packable schedule and
    at most _MAX_FUSED_CHANNELS channels (stages 2-5 at the flagship)."""
    if not can_pack(cfg):
        return [False] * len(cfg.upsample_rates)
    return [cfg.upsample_initial_channel // (2 ** (i + 1)) <= _MAX_FUSED_CHANNELS
            for i in range(len(cfg.upsample_rates))]


def pack_fused_stages(state: Dict[str, torch.Tensor],
                      cfg: BigVGANConfig) -> Dict[int, StagePack]:
    """The pack of every fused stage, keyed by stage index."""
    return {i: pack_stage(state, i, cfg)
            for i, fused in enumerate(fused_stage_plan(cfg)) if fused}


def _conv_same(z: torch.Tensor, w_taps: torch.Tensor, bias: torch.Tensor,
               dilation: int) -> torch.Tensor:
    """SAME zero-padded dilated conv; w_taps (k, out, in), bias (C, 1)."""
    k = w_taps.shape[0]
    y = F.conv1d(z, w_taps.permute(1, 2, 0), None, padding=dilation * (k - 1) // 2,
                 dilation=dilation)
    return y + bias[None]


def _conv_same_split(z: torch.Tensor, w_taps: torch.Tensor, bias: torch.Tensor,
                     dilation: int) -> torch.Tensor:
    """`_conv_same` in the kernel's arithmetic: both operands split into TF32
    hi and lo parts, the three products lo.hi + hi.lo + hi.hi in f32."""
    zh, wh = tf32_round(z), tf32_round(w_taps)
    zl, wl = tf32_round(z - zh), tf32_round(w_taps - wh)
    y = None
    for a, b in ((zl, wh), (zh, wl), (zh, wh)):
        term = _conv_same(a, b, torch.zeros_like(bias), dilation)
        y = term if y is None else y + term
    return y + bias[None]


def fused_resblock_stage_plain(x: torch.Tensor, pack: StagePack,
                               dilations: Sequence[int]) -> torch.Tensor:
    """The JAX kernel's function in PyTorch ops (see the module docstring);
    each block's convs over its own taps (the centre-embedded zeros add
    nothing)."""
    return _stage_plain(x, pack, dilations, _conv_same)


def fused_resblock_stage_split_plain(x: torch.Tensor, pack: StagePack,
                                     dilations: Sequence[int]) -> torch.Tensor:
    """`fused_resblock_stage_plain` with every conv in the kernel's
    three-pass TF32 split (`_conv_same_split`): a plain model of the
    kernel's numerics."""
    return _stage_plain(x, pack, dilations, _conv_same_split)


def _stage_plain(x, pack, dilations, conv) -> torch.Tensor:
    n_iter, k_max = len(dilations), pack.w.shape[1]
    acc = None
    for j, k in enumerate(pack.kernel_sizes):
        lo = (k_max - k) // 2
        xb = x
        for m, d in enumerate(dilations):
            ci = j * 2 * n_iter + 2 * m
            z = aa_snake_zero_plain(xb, pack.alpha[ci], pack.brec[ci])
            z = conv(z, pack.w[ci, lo:lo + k], pack.b[ci], d)
            z = aa_snake_zero_plain(z, pack.alpha[ci + 1], pack.brec[ci + 1])
            z = conv(z, pack.w[ci + 1, lo:lo + k], pack.b[ci + 1], 1)
            xb = xb + z
        acc = xb if acc is None else acc + xb
    return acc * (1.0 / len(pack.kernel_sizes))


def fused_resblock_stage_cuda(x: torch.Tensor, pack: StagePack, dilations: Sequence[int],
                              span: str = "all") -> torch.Tensor:
    """Launch the stage (one C call, 2 * nk * n_iter kernel launches).
    `span` "prologue" or "mma" runs only that part of each pair kernel: a
    measurement arm whose output is not the stage's."""
    if x.dim() != 3 or x.shape[0] != 1:
        raise ValueError(f"fused_resblock_stage: x must be (1, C, T), got {tuple(x.shape)}")
    _, c, t = x.shape
    n, k_max = pack.w.shape[:2]
    nk, n_iter = len(pack.kernel_sizes), len(dilations)
    if n != 2 * nk * n_iter:
        raise ValueError(f"fused_resblock_stage: {n} convs in the pack, want "
                         f"2 * {nk} blocks * {n_iter} dilations")
    for k in pack.kernel_sizes:
        if k % 2 != 1 or not 1 <= k <= k_max:
            raise ValueError(f"fused_resblock_stage: kernel size {k} not odd in 1..{k_max}")
        for d in set(dilations) | {1}:
            plan_fused_stage(c, t, k, d)
    args = (("x", x, (1, c, t)), ("w", pack.w, (n, k_max, c, c)), ("b", pack.b, (n, c, 1)),
            ("alpha", pack.alpha, (n, c, 1)), ("brec", pack.brec, (n, c, 1)))
    for name, a, shape in args:
        if a.dtype != torch.float32:
            raise TypeError(f"fused_resblock_stage: {name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"fused_resblock_stage: {name} must be contiguous {shape}")
    for name, a, _ in args:
        if not a.is_cuda or a.device != x.device:
            raise ValueError(f"fused_resblock_stage: {name} must be on a CUDA device, "
                             f"with x ({x.device})")
    if span not in SPANS:
        raise ValueError(f"fused_resblock_stage: span {span!r}")
    kp = kernel_pack(pack)
    xb, y, out = (torch.empty_like(x) for _ in range(3))
    ks = (ctypes.c_int * nk)(*pack.kernel_sizes)
    ds = (ctypes.c_int * n_iter)(*dilations)
    lib = build.kernels()
    LAUNCHES["fused_resblock_stage"] += 1
    lib.call("vtt_fused_resblock_stage", x.data_ptr(), kp.w.data_ptr(),
             pack.b.data_ptr(), pack.alpha.data_ptr(), pack.brec.data_ptr(),
             xb.data_ptr(), y.data_ptr(), out.data_ptr(), c, t, k_max, nk, n_iter,
             ctypes.addressof(ks), ctypes.addressof(ds),
             TAPS_HOST.ctypes.data_as(ctypes.c_void_p),
             float(np.float32(1.0) / np.float32(nk)), SPANS[span],
             build.stream_handle(x.device))
    return out


def fused_resblock_stage(x: torch.Tensor, pack: StagePack,
                         dilations: Sequence[int]) -> torch.Tensor:
    """x (1, C, T) f32 (post-upsample) -> (1, C, T), the mean over the
    stage's resblocks.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (errors raise, no fallback)."""
    if x.is_cuda:
        return fused_resblock_stage_cuda(x, pack, dilations)
    if x.device.type != "cpu":
        raise ValueError(f"fused_resblock_stage: unsupported device {x.device}")
    return fused_resblock_stage_plain(x, pack, dilations)


def bigvgan_fused_apply(model, stage_packs: Dict[int, StagePack],
                        mel: torch.Tensor) -> torch.Tensor:
    """The port's `BigVGAN` forward with the packed stages through K10 when
    the batch is 1 (the single-request path); other stages, and every stage
    of a larger batch, take the module path."""
    cfg = model.cfg
    dilations = tuple(cfg.resblock_dilation_sizes[0])
    x = model.conv_pre(mel)
    for i in range(len(cfg.upsample_rates)):
        x = getattr(model, f"ups_{i}")(x)
        if i in stage_packs and x.shape[0] == 1:
            x = fused_resblock_stage(x, stage_packs[i], dilations)
        else:
            x = model.stage(i, x)
    return model.head(x)

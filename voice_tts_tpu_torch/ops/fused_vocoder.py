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

`bigvgan_fused_apply` runs a whole vocode with the fused stages
(`EngineConfig.use_fused_vocoder`); the JAX kernel's Mosaic chunk width
(`_tt_for_channels`, `FUSED_VOC_TT`) has no counterpart: the result does not
depend on it.
"""

from __future__ import annotations

import ctypes
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


def fused_resblock_stage_plain(x: torch.Tensor, pack: StagePack,
                               dilations: Sequence[int]) -> torch.Tensor:
    """The JAX kernel's function in PyTorch ops (see the module docstring);
    each block's convs over its own taps (the centre-embedded zeros add
    nothing)."""
    n_iter, k_max = len(dilations), pack.w.shape[1]
    acc = None
    for j, k in enumerate(pack.kernel_sizes):
        lo = (k_max - k) // 2
        xb = x
        for m, d in enumerate(dilations):
            ci = j * 2 * n_iter + 2 * m
            z = aa_snake_zero_plain(xb, pack.alpha[ci], pack.brec[ci])
            z = _conv_same(z, pack.w[ci, lo:lo + k], pack.b[ci], d)
            z = aa_snake_zero_plain(z, pack.alpha[ci + 1], pack.brec[ci + 1])
            z = _conv_same(z, pack.w[ci + 1, lo:lo + k], pack.b[ci + 1], 1)
            xb = xb + z
        acc = xb if acc is None else acc + xb
    return acc * (1.0 / len(pack.kernel_sizes))


def fused_resblock_stage_cuda(x: torch.Tensor, pack: StagePack,
                              dilations: Sequence[int]) -> torch.Tensor:
    """Launch the stage (one C call, 2 * nk * n_iter kernel launches)."""
    if x.dim() != 3 or x.shape[0] != 1:
        raise ValueError(f"fused_resblock_stage: x must be (1, C, T), got {tuple(x.shape)}")
    _, c, t = x.shape
    n, k_max = pack.w.shape[:2]
    nk, n_iter = len(pack.kernel_sizes), len(dilations)
    if n != 2 * nk * n_iter:
        raise ValueError(f"fused_resblock_stage: {n} convs in the pack, want "
                         f"2 * {nk} blocks * {n_iter} dilations")
    for k in pack.kernel_sizes:
        if k % 2 != 1 or not 1 <= k <= min(k_max, MAX_TAPS):
            raise ValueError(f"fused_resblock_stage: kernel size {k} not odd in 1..{k_max}")
        if max(dilations) * (k - 1) // 2 > MAX_HALO:
            raise ValueError(f"fused_resblock_stage: halo over {MAX_HALO} samples")
    for name, a, shape in (("x", x, (1, c, t)), ("w", pack.w, (n, k_max, c, c)),
                           ("b", pack.b, (n, c, 1)), ("alpha", pack.alpha, (n, c, 1)),
                           ("brec", pack.brec, (n, c, 1))):
        if not a.is_cuda or a.device != x.device:
            raise ValueError(f"fused_resblock_stage: {name} must be on {x.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"fused_resblock_stage: {name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"fused_resblock_stage: {name} must be contiguous {shape}")
    xb, y, out = (torch.empty_like(x) for _ in range(3))
    ks = (ctypes.c_int * nk)(*pack.kernel_sizes)
    ds = (ctypes.c_int * n_iter)(*dilations)
    lib = build.kernels()
    LAUNCHES["fused_resblock_stage"] += 1
    lib.call("vtt_fused_resblock_stage", x.data_ptr(), pack.w.data_ptr(),
             pack.b.data_ptr(), pack.alpha.data_ptr(), pack.brec.data_ptr(),
             xb.data_ptr(), y.data_ptr(), out.data_ptr(), c, t, k_max, nk, n_iter,
             ctypes.addressof(ks), ctypes.addressof(ds),
             TAPS_HOST.ctypes.data_as(ctypes.c_void_p),
             float(np.float32(1.0) / np.float32(nk)), build.stream_handle(x.device))
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

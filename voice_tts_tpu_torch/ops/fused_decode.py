"""Batch-1 decode step of the int8 GPT-2 trunk with the folded readout, K1.

Port of `voice_tts_tpu/ops/fused_decode.py` (`pack_gpt`, `pack_readout`,
`cache_to_time_major`, `fused_decode_step` with `readout_pack`,
`apply_kv_update`), float-KV branch.

One step, per layer: LN1 -> QKV -> attention over the live [0, pos) cache
prefix plus the current token -> projection + residual -> LN2 -> fc ->
GELU-tanh -> fc2 + residual; then final LN + int8 mel_head -> logits.

- `fused_decode_step_plain`: PyTorch ops mirroring the Pallas kernel's
  numerics (CPU; the reference on the card);
- `csrc/fused_decode.cu`: hand-written kernels, launched as a host-sequenced
  chain (5 launches per layer + 1 readout) by `fused_decode_step_cuda`.

Pack layout.  The JAX pack holds (L, 12, D, D) int8 tiles in (in, out)
order.  The port stores every tile transposed, (out, in): tiles 0-2 then
read as the (3D, D) QKV matrix, tile 3 as the projection, tiles 4-7 as the
(4D, D) fc matrix and tiles 8-11 as the fc2 matrix in four contraction
tiles, each output column's weights contiguous for 16-byte loads.
`consts` (L, 28, D) f32 is the JAX layout unchanged: rows 0-11 dequant
scales, 12-23 biases (fc2 bias once, in row 23), 24-27 LN1/LN2 weight and
bias.  The readout stores the int8 mel_head as (12 * VT, D) rows (the
transposed JAX (12, D, VT) tiles, concatenated) with scale and bias as the
two rows of a (2, 12 * VT) f32 table.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES

BLOCK_T = 256          # cache length granularity (Tmax % BLOCK_T == 0)
TILES_PER_LAYER = 12   # 3 (qkv) + 1 (proj) + 4 (fc) + 4 (fc2)
RO_TILES = 12          # readout column tiles
_EPI_NONE, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2


class FusedDecodePack(NamedTuple):
    w: torch.Tensor        # (L, 12, D, D) int8, each tile (out, in)
    consts: torch.Tensor   # (L, 28, D) f32


class ReadoutPack(NamedTuple):
    w: torch.Tensor        # (12 * VT, D) int8 — padded mel_head rows
    consts: torch.Tensor   # (2, 12 * VT) f32: [dequant scale; bias]
    lnf: torch.Tensor      # (2, D) f32: final_norm [weight; bias]


def pack_gpt(state: Dict[str, torch.Tensor], layers: int) -> FusedDecodePack:
    """Pack an int8-quantized UnifiedVoice state (`utils.quantize`)."""
    ws, cs = [], []
    for i in range(layers):
        p = f"gpt.h_{i}."
        qkv_w = state[p + "attn_c_attn.weight"]
        d = qkv_w.shape[0]

        def col_tiles(m, n):  # (D, n*D) -> (n, D_out, D_in)
            return m.reshape(d, n, d).permute(1, 2, 0)

        ws.append(torch.cat([
            col_tiles(qkv_w, 3),
            state[p + "attn_c_proj.weight"].t()[None],
            col_tiles(state[p + "mlp_c_fc.weight"], 4),
            state[p + "mlp_c_proj.weight"].reshape(4, d, d).transpose(1, 2),
        ]).contiguous())

        def rows(v, n):
            return v.reshape(n, d).float()

        scales = torch.cat([
            rows(state[p + "attn_c_attn.scale"], 3),
            rows(state[p + "attn_c_proj.scale"], 1),
            rows(state[p + "mlp_c_fc.scale"], 4),
            state[p + "mlp_c_proj.scale"].reshape(1, d).float().expand(4, d),
        ])
        zeros = torch.zeros((3, d), dtype=torch.float32, device=qkv_w.device)
        biases = torch.cat([
            rows(state[p + "attn_c_attn.bias"], 3),
            rows(state[p + "attn_c_proj.bias"], 1),
            rows(state[p + "mlp_c_fc.bias"], 4),
            zeros, rows(state[p + "mlp_c_proj.bias"], 1),
        ])
        lns = torch.stack([state[p + "ln_1.weight"], state[p + "ln_1.bias"],
                           state[p + "ln_2.weight"], state[p + "ln_2.bias"]]).float()
        cs.append(torch.cat([scales, biases, lns]))
    return FusedDecodePack(torch.stack(ws), torch.stack(cs).contiguous())


def pack_readout(state: Dict[str, torch.Tensor]) -> ReadoutPack:
    """final_norm + int8 mel_head (per-output-channel symmetric scales); the
    vocab is zero-padded to 12 tiles of a multiple of 128 columns, padded
    columns carry scale 0 / bias 0 and callers slice back to the vocab."""
    w = state["mel_head.weight"].float()        # (V, D)
    b = state["mel_head.bias"].float()
    v, d = w.shape
    vt = -(-v // (RO_TILES * 128)) * 128
    wp = torch.zeros((RO_TILES * vt, d), dtype=torch.float32, device=w.device)
    wp[:v] = w
    bias = torch.zeros((RO_TILES * vt,), dtype=torch.float32, device=w.device)
    bias[:v] = b
    amax = wp.abs().amax(dim=1)
    # `* (1 / 127)`: XLA compiles the JAX package's `/ 127.0` into a multiply
    # by the f32 reciprocal; the same product keeps the packs bit-identical
    scale = torch.where(amax > 0, torch.clamp(amax, min=1e-8) * (1.0 / 127.0),
                        torch.zeros_like(amax))
    q = torch.where(scale[:, None] > 0,
                    wp / torch.clamp(scale, min=1e-30)[:, None],
                    torch.zeros_like(wp))
    q = torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    lnf = torch.stack([state["final_norm.weight"],
                       state["final_norm.bias"]]).float()
    return ReadoutPack(q.contiguous(), torch.stack([scale, bias]), lnf)


def cache_to_time_major(kv_cache: torch.Tensor) -> torch.Tensor:
    """(L, 2, B, H, hd, T) -> (L, 2, B, T, H*hd)."""
    l, two, b, h, hd, t = kv_cache.shape
    return kv_cache.permute(0, 1, 2, 5, 3, 4).reshape(l, two, b, t, h * hd).contiguous()


def apply_kv_update(kv_cache: torch.Tensor, kv_new: torch.Tensor,
                    pos: int) -> torch.Tensor:
    """Write kv_new (L, 2, D) into the time-major cache at `pos`, IN PLACE
    (the JAX version returns an updated copy).  Returns the cache."""
    kv_cache[:, :, 0, pos, :] = kv_new.to(kv_cache.dtype)
    return kv_cache


def _ln(x, w, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _dot(src, w_t, scale, bias):
    """bf16(src) (1, K) @ int8 (F, K)^T, f32 accumulation, * scale + bias."""
    y = src.to(torch.bfloat16).float() @ w_t.float().t()
    return y * scale + bias


def fused_decode_step_plain(x, pack: FusedDecodePack, kv_cache, bias, pos: int,
                            heads: int, readout_pack: Optional[ReadoutPack] = None):
    """Plain PyTorch version; see `fused_decode_step`."""
    n_layers, _, _, _, d = kv_cache.shape
    hd = d // heads
    w_all, c_all = pack.w, pack.consts
    xs = x.float().reshape(1, d)
    kv_new = torch.empty((n_layers, 2, d), dtype=kv_cache.dtype, device=x.device)
    for layer in range(n_layers):
        w, c = w_all[layer], c_all[layer]
        h = _ln(xs, c[24], c[25])
        q = _dot(h, w[0], c[0], c[12])
        k = _dot(h, w[1], c[1], c[13])
        v = _dot(h, w[2], c[2], c[14])
        kv_new[layer, 0] = k[0].to(kv_cache.dtype)
        kv_new[layer, 1] = v[0].to(kv_cache.dtype)
        qh = (q * (hd ** -0.5)).reshape(heads, hd)
        kc = kv_cache[layer, 0, 0, :pos].float().reshape(pos, heads, hd)
        vc = kv_cache[layer, 1, 0, :pos].float().reshape(pos, heads, hd)
        scores = torch.einsum("hd,thd->ht", qh, kc) + bias[:pos, 0][None, :]
        s_cur = (qh * k.reshape(heads, hd)).sum(-1, keepdim=True)
        probs = torch.softmax(torch.cat([scores, s_cur], dim=1), dim=1)
        ctx = (torch.einsum("ht,thd->hd", probs[:, :pos], vc)
               + probs[:, pos:] * v.reshape(heads, hd))
        xs = xs + _dot(ctx.reshape(1, d), w[3], c[3], c[15])
        h = _ln(xs, c[26], c[27])
        hs = [torch.nn.functional.gelu(_dot(h, w[t], c[t], c[t + 12]),
                                       approximate="tanh") for t in range(4, 8)]
        acc = None
        for t in range(8, 12):
            part = _dot(hs[t - 8], w[t], c[t], c[t + 12])
            acc = part if acc is None else acc + part
        xs = xs + acc
    if readout_pack is None:
        return xs, kv_new, None
    hf = _ln(xs, readout_pack.lnf[0], readout_pack.lnf[1])
    logits = _dot(hf, readout_pack.w, readout_pack.consts[0],
                  readout_pack.consts[1])
    return xs, kv_new, logits


def _check_cuda_inputs(x, pack, kv_cache, bias, heads, readout_pack):
    """Raise unless the CUDA chain can take these tensors."""
    n_layers, two, b, t_max, d = kv_cache.shape
    dev = x.device
    if b != 1 or two != 2 or d % heads or x.numel() != d:
        raise ValueError(f"fused_decode_step: x {tuple(x.shape)} / cache "
                         f"{tuple(kv_cache.shape)} / heads {heads}")
    hd = d // heads
    if t_max % BLOCK_T or d % 16 or hd % 8 or 32 % (hd // 8):
        raise ValueError("fused_decode_step: needs Tmax % 256 == 0, D % 16 == 0 "
                         "and a head width hd with hd % 8 == 0 dividing 256")
    if kv_cache.dtype != torch.bfloat16:
        raise TypeError("fused_decode_step: the CUDA kernel reads a bf16 cache")
    checks = [("pack.w", pack.w, torch.int8, (n_layers, 12, d, d)),
              ("pack.consts", pack.consts, torch.float32, (n_layers, 28, d)),
              ("bias", bias, torch.float32, (t_max, 1)),
              ("kv_cache", kv_cache, torch.bfloat16, None)]
    if readout_pack is not None:
        v_pad = readout_pack.w.shape[0]
        checks += [("readout.w", readout_pack.w, torch.int8, (v_pad, d)),
                   ("readout.consts", readout_pack.consts, torch.float32, (2, v_pad)),
                   ("readout.lnf", readout_pack.lnf, torch.float32, (2, d))]
    for name, t, dtype, shape in checks:
        if t.device != dev:
            raise ValueError(f"fused_decode_step: {name} on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"fused_decode_step: {name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_decode_step: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_decode_step: {name} must be contiguous")
    if any(t.data_ptr() % 16 for t in
           [pack.w, kv_cache] + ([readout_pack.w] if readout_pack is not None else [])):
        raise ValueError("fused_decode_step: weight packs and cache must be "
                         "16-byte aligned")


def fused_decode_step_cuda(x, pack: FusedDecodePack, kv_cache, bias, pos: int,
                           heads: int, readout_pack: Optional[ReadoutPack] = None):
    """The CUDA kernel chain; see `fused_decode_step`."""
    _check_cuda_inputs(x, pack, kv_cache, bias, heads, readout_pack)
    n_layers, _, _, t_max, d = kv_cache.shape
    if not 0 <= pos < t_max:
        raise ValueError(f"fused_decode_step: pos {pos} outside [0, {t_max})")
    lib = build.kernels()
    call = lib.call
    stream = build.stream_handle(x.device)
    dev = x.device
    xs = x.float().reshape(d).clone()
    qkv = torch.empty(3 * d, dtype=torch.float32, device=dev)
    ctx = torch.empty(d, dtype=torch.float32, device=dev)
    hid = torch.empty(4 * d, dtype=torch.float32, device=dev)
    kv_new = torch.empty((n_layers, 2, d), dtype=kv_cache.dtype, device=dev)
    # byte addresses from the base pointers (no per-layer tensor views: the
    # chain is 5 launches a layer and its host cost sets the step time)
    row = d * 4                     # bytes per f32 row of consts
    tile = d * d                    # bytes per int8 tile
    cache_rows = t_max * d * 2      # bytes per (layer, k|v) bf16 cache plane
    q_scale = float((d // heads) ** -0.5)
    xp, qkvp, ctxp, hidp = xs.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), hid.data_ptr()
    w_base, c_base = pack.w.data_ptr(), pack.consts.data_ptr()
    cache_base, kv_base = kv_cache.data_ptr(), kv_new.data_ptr()
    bias_p = bias.data_ptr()
    LAUNCHES["fused_decode_step"] += 1
    for layer in range(n_layers):
        w0 = w_base + layer * TILES_PER_LAYER * tile
        c0 = c_base + layer * 28 * row
        cache_k = cache_base + 2 * layer * cache_rows
        # LN1 -> qkv (tiles 0-2, scales rows 0-2, biases rows 12-14)
        call("vtt_dq_gemv", xp, c0 + 24 * row, c0 + 25 * row, w0, 1, d,
             c0, c0 + 12 * row, None, qkvp, 3 * d, _EPI_NONE, stream)
        call("vtt_decode_attend", qkvp, cache_k, cache_k + cache_rows, bias_p,
             pos, d, heads, q_scale, ctxp, kv_base + layer * 2 * d * 2, stream)
        # x += proj(ctx)   (tile 3, scale row 3, bias row 15)
        call("vtt_dq_gemv", ctxp, None, None, w0 + 3 * tile, 1, d,
             c0 + 3 * row, c0 + 15 * row, xp, xp, d, _EPI_RESIDUAL, stream)
        # LN2 -> fc -> GELU   (tiles 4-7, scales rows 4-7, biases rows 16-19)
        call("vtt_dq_gemv", xp, c0 + 26 * row, c0 + 27 * row, w0 + 4 * tile,
             1, d, c0 + 4 * row, c0 + 16 * row, None, hidp, 4 * d, _EPI_GELU,
             stream)
        # x += fc2(h)   (tiles 8-11 = 4 contraction tiles, scale row 8,
        # the bias once from row 23)
        call("vtt_dq_gemv", hidp, None, None, w0 + 8 * tile, 4, d,
             c0 + 8 * row, c0 + 23 * row, xp, xp, d, _EPI_RESIDUAL, stream)
    if readout_pack is None:
        return xs.reshape(1, d), kv_new, None
    v_pad = readout_pack.w.shape[0]
    logits = torch.empty(v_pad, dtype=torch.float32, device=dev)
    lnf = readout_pack.lnf
    call("vtt_dq_gemv", xp, lnf[0].data_ptr(), lnf[1].data_ptr(),
         readout_pack.w.data_ptr(), 1, d, readout_pack.consts[0].data_ptr(),
         readout_pack.consts[1].data_ptr(), None, logits.data_ptr(), v_pad,
         _EPI_NONE, stream)
    return xs.reshape(1, d), kv_new, logits.reshape(1, v_pad)


def fused_decode_step(x: torch.Tensor, pack: FusedDecodePack,
                      kv_cache: torch.Tensor, bias: torch.Tensor, pos: int,
                      heads: int, readout_pack: Optional[ReadoutPack] = None):
    """One decode step of the whole trunk plus the folded readout.

    x (1, D) token embedding; kv_cache TIME-MAJOR (L, 2, 1, Tmax, D)
    (`cache_to_time_major`), Tmax % 256 == 0; bias (Tmax, 1) f32 additive
    mask (-1e30 on invalid prompt pads); pos — index of the current token
    (positions [0, pos) are live history).  Returns (hidden (1, D) f32
    pre-ln_f, kv_new (L, 2, D) in the cache dtype, logits (1, 12 * VT) f32,
    or None without a readout pack); the caller writes kv_new at `pos`
    (`apply_kv_update`) and slices the logits to the vocab.  CPU tensors take the plain version; CUDA tensors
    launch the kernels (errors raise, there is no fallback).
    """
    if x.is_cuda:
        return fused_decode_step_cuda(x, pack, kv_cache, bias, int(pos), heads,
                                      readout_pack)
    if x.device.type != "cpu":
        raise ValueError(f"fused_decode_step: unsupported device {x.device}")
    return fused_decode_step_plain(x, pack, kv_cache, bias, int(pos), heads,
                                   readout_pack)

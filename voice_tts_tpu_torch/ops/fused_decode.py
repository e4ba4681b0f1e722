"""Decode steps of the int8 or int4 GPT-2 trunk with the folded readout: K1
(one row), K3 (B rows, with the beam ancestor table), K6 (the speculative
verify of K tokens of one sequence) and K7 (the int4 weight branch of all
three).

Port of `voice_tts_tpu/ops/fused_decode.py` (`pack_gpt`, `pack_gpt_int4`,
`pack_readout`, `cache_to_time_major`, the int8-KV helpers,
`fused_decode_step` and `fused_decode_step_batch` with `readout_pack`,
`kv_scales` and `beam_src`, `fused_decode_verify`, the `apply_kv_update*`
writers).  The int4 branch has the numerics of the JAX default dequant
scheme (`int4_expand=False`, and "i8sh", which gives the same values);
`int4_expand=True`, which rounds each dequantized weight to bf16, is a
TPU-only scheme the port does not carry (`check_int4_expand`).

One step, per layer and row: LN1 -> QKV -> attention over the row's live
[0, pos_b) cache prefix plus the current token -> projection + residual ->
LN2 -> fc -> GELU-tanh -> fc2 + residual; then final LN + int8 mel_head ->
logits.  With an ancestor table, row b reads position t of its history from
cache row `src[b, t]`; with an int8 cache, each cached row is dequantized
with the scale of the row it is read from.

- `fused_decode_step_batch_plain`: PyTorch ops mirroring the Pallas
  kernels' numerics (CPU; the reference on the card); K1's plain version is
  this at B = 1;
- `fused_decode_step_batch_split_plain`: the same step with the CUDA
  attention's arithmetic (the prefix in splits of BLOCK_T positions, their
  softmax partials combined in split order), for the tests; `attend_splits`
  and `attend_workspace` size the CUDA attention's grid and scratch;
- `fused_decode_verify_plain`: the same trunk over the K rows with K6's
  attention (shared committed prefix, then a causal tail over the K rows'
  unrounded k/v); `fused_decode_verify_split_plain` sums it as the CUDA
  verify attention does (the prefix in the splits of `verify_splits`);
- `int4_gemv_plain`: one int4 GEMV (K7) summed as its kernel sums it, and
  `int4_gemv` its wrapper; `plan_int4_gemv` sizes the kernel's grid;
- `csrc/fused_decode.cu`: hand-written kernels, launched as a host-sequenced
  chain (5 launches per layer + 1 readout) by `_decode_chain_cuda`; K1 is
  the chain at B = 1, K6 the chain at K rows with the verify attention, and
  an int4 pack (K7) selects the int4 GEMV for the trunk's products.

Pack layout.  The JAX pack holds (L, 12, D, D) int8 tiles in (in, out)
order.  The port stores every tile transposed, (out, in): tiles 0-2 then
read as the (3D, D) QKV matrix, tile 3 as the projection, tiles 4-7 as the
(4D, D) fc matrix and tiles 8-11 as the fc2 matrix in four contraction
tiles, each output column's weights contiguous for 16-byte loads.
`consts` (L, 28, D) f32 is the JAX layout unchanged: rows 0-11 dequant
scales, 12-23 biases (fc2 bias once, in row 23), 24-27 LN1/LN2 weight and
bias.  The readout stores the int8 mel_head as (12 * VT, D) rows (the
transposed JAX (12, D, VT) tiles, concatenated) with scale and bias as the
two rows of a (2, 12 * VT) f32 table.  The int4 pack keeps the same (out,
in) order with two contraction rows to a byte: (L, 12, D, D/2) int8, where
byte k of an output column holds contraction row k in its low nibble and
row k + D/2 in its high nibble (the JAX nibble pairing), and its group
scales are the JAX (L, 12, G, D) table transposed to (L, 12, D, G), so that
one output column's G scales are contiguous.

The cache writers update the cache IN PLACE (the JAX versions return
updated copies) and return it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES

BLOCK_T = 256          # cache length granularity (Tmax % BLOCK_T == 0)
TILES_PER_LAYER = 12   # 3 (qkv) + 1 (proj) + 4 (fc) + 4 (fc2)
RO_TILES = 12          # readout column tiles
MAX_ROWS, MAX_ROWS_TABLE = 8, 12   # K3 rows without / with an ancestor table
_EPI_NONE, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2

Pos = Union[int, torch.Tensor]


class FusedDecodePack(NamedTuple):
    w: torch.Tensor        # (L, 12, D, D) int8, each tile (out, in)
    consts: torch.Tensor   # (L, 28, D) f32


class FusedDecodePackInt4(NamedTuple):
    w: torch.Tensor        # (L, 12, D, D/2) int8 nibble pairs, each tile (out, in/2)
    consts: torch.Tensor   # (L, 28, D) f32: rows 0-11 zero, the rest as pack_gpt's
    gscales: torch.Tensor  # (L, 12, D, G) f32 group scales, G = D // group


Pack = Union[FusedDecodePack, FusedDecodePackInt4]

GROUP = 128


def group_size(d: int) -> int:
    """Scale-group width along the contraction dim: 128, shrunk so each
    packed half (d/2 rows) holds a whole number of groups on tiny configs."""
    return min(GROUP, d // 2)


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


def pack_gpt_int4(state: Dict[str, torch.Tensor], layers: int,
                  group: int = 0) -> FusedDecodePackInt4:
    """Pack the f32 GPT trunk of a UnifiedVoice state (the master, not the
    int8 copy) into int4 tiles with one scale per `group` contraction rows
    and output column (0 = `group_size(D)`, g128 at the flagship width):
    scale max|w| / 7 floored at 1e-12, round half to even, clip to [-8, 7].
    `* (1 / 7)`: XLA compiles the jitted JAX `/ 7.0` into a product with the
    f32 reciprocal, so the same product keeps nibbles and scales bit-equal;
    the division by the scale is a true one on both sides."""
    ws, cs, ss = [], [], []
    for i in range(layers):
        p = f"gpt.h_{i}."
        d = state[p + "attn_c_attn.weight"].shape[0]
        gsz = group or group_size(d)
        if (d // 2) % gsz:
            raise ValueError(f"int4 group {gsz} must divide the packed half {d // 2}")

        def col_tiles(m, n):  # (D, n*D) -> (n, D_in, D_out), the JAX tiles
            return m.float().reshape(d, n, d).permute(1, 0, 2)

        tiles = torch.cat([
            col_tiles(state[p + "attn_c_attn.weight"], 3),
            state[p + "attn_c_proj.weight"].float()[None],
            col_tiles(state[p + "mlp_c_fc.weight"], 4),
            state[p + "mlp_c_proj.weight"].float().reshape(4, d, d),
        ])                                               # (12, D_in, D_out)
        grouped = tiles.reshape(12, d // gsz, gsz, d)
        scale = torch.clamp(grouped.abs().amax(dim=2) * (1.0 / 7.0), min=1e-12)
        q = torch.clamp(torch.round(grouped / scale[:, :, None, :]), -8, 7)
        q = q.reshape(12, d, d).to(torch.int32)
        packed = ((q[:, :d // 2] & 15) | ((q[:, d // 2:] & 15) << 4)).to(torch.int8)
        ws.append(packed.transpose(1, 2).contiguous())   # (12, D_out, D/2)
        ss.append(scale.transpose(1, 2).contiguous())    # (12, D_out, G)

        def rows(v, n):
            return v.reshape(n, d).float()

        biases = torch.cat([
            rows(state[p + "attn_c_attn.bias"], 3),
            rows(state[p + "attn_c_proj.bias"], 1),
            rows(state[p + "mlp_c_fc.bias"], 4),
            torch.zeros((3, d), dtype=torch.float32, device=tiles.device),
            rows(state[p + "mlp_c_proj.bias"], 1),
        ])
        lns = torch.stack([state[p + "ln_1.weight"], state[p + "ln_1.bias"],
                           state[p + "ln_2.weight"], state[p + "ln_2.bias"]]).float()
        cs.append(torch.cat([torch.zeros((12, d), dtype=torch.float32,
                                         device=tiles.device), biases, lns]))
    return FusedDecodePackInt4(torch.stack(ws), torch.stack(cs).contiguous(),
                               torch.stack(ss))


def check_int4_expand(int4_expand) -> None:
    """Accept the JAX int4 dequant schemes the port computes: False and
    "i8sh" (the same nibble values and sums).  True rounds each dequantized
    weight to bf16 before the product, a TPU-only scheme (an MXU expansion
    of the scales) with other results: refused."""
    if int4_expand is True:
        raise ValueError("int4_expand=True is a TPU-only int4 dequant scheme "
                         "(whole-tile bf16 dequant on the MXU); the port "
                         "computes int4_expand=False / 'i8sh'")
    if int4_expand not in (False, "i8sh"):
        raise ValueError(f"int4_expand must be False, True or 'i8sh', got "
                         f"{int4_expand!r}")


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


# ---------------------------------------------------------------------------
# int8 KV: one symmetric scale per (layer, k|v, row, position)
# ---------------------------------------------------------------------------

def _quantize_rows(x: torch.Tensor):
    """x (..., D) float -> (int8 rows, scales (...) f32): scale max|row| / 127
    floored at 1e-12, round half to even, clip to +-127.  `* (1 / 127)` as
    XLA compiles the JAX `/ 127.0`; the division by the scale is a true one."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / 127.0), min=1e-12)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def quantize_kv_cache(tm_cache: torch.Tensor):
    """(L, 2, 1, T, D) float -> (int8 cache, scales (L, T, 2) f32)."""
    q, s = _quantize_rows(tm_cache)                  # s (L, 2, 1, T)
    return q, s[:, :, 0, :].permute(0, 2, 1).contiguous()


def quantize_kv_rows(kv_new: torch.Tensor):
    """(L, 2, D) f32 new-token rows -> (int8 rows, scales (L, 2) f32)."""
    return _quantize_rows(kv_new)


def quantize_kv_cache_batch(tm_cache: torch.Tensor):
    """(L, 2, B, T, D) float -> (int8 cache, scales (L, B, T, 2) f32)."""
    q, s = _quantize_rows(tm_cache)                  # s (L, 2, B, T)
    return q, s.permute(0, 2, 3, 1).contiguous()


def _write_rows(buf: torch.Tensor, dim: int, pos: Pos, rows: torch.Tensor,
               active: Optional[torch.Tensor]) -> None:
    """Write `rows` into `buf` at position `pos` of its time axis `dim`: a
    host int by assignment, a device position (a 0-d integer tensor) by
    `index_copy_`, with no host read.  With a device position, `active` (a
    0-d bool tensor) keeps the row `buf` holds there where it is false (a
    step of a device loop taken after the loop's stop)."""
    rows = rows.to(buf.dtype)
    if not isinstance(pos, torch.Tensor):
        buf.select(dim, pos).copy_(rows)
        return
    idx = pos.reshape(1).long()
    rows = rows.unsqueeze(dim)
    if active is not None:
        rows = torch.where(active, rows, buf.index_select(dim, idx))
    buf.index_copy_(dim, idx, rows)


def apply_kv_update(kv_cache: torch.Tensor, kv_new: torch.Tensor, pos: Pos,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write kv_new (L, 2, D) into the time-major cache at `pos` (a host int,
    or a 0-d device tensor with `active`, see `_write_rows`)."""
    _write_rows(kv_cache[:, :, 0], 2, pos, kv_new, active)
    return kv_cache


def apply_kv_update_q(kv_cache: torch.Tensor, kv_scales: torch.Tensor,
                      kv_new: torch.Tensor, pos: Pos,
                      active: Optional[torch.Tensor] = None):
    """Quantize kv_new (L, 2, D) f32 and write row + scale at `pos` into the
    int8 cache / (L, Tmax, 2) scale table.  Returns (cache, scales)."""
    q, s = quantize_kv_rows(kv_new)
    _write_rows(kv_cache[:, :, 0], 2, pos, q, active)
    _write_rows(kv_scales, 1, pos, s, active)
    return kv_cache, kv_scales


def apply_kv_update_span(kv_cache: torch.Tensor, kv_new: torch.Tensor,
                         pos: int) -> torch.Tensor:
    """Write kv_new (L, 2, K, D) at the span [pos, pos + K) of the batch-1
    time-major cache (the speculative verify's commit)."""
    kv_cache[:, :, 0, pos:pos + kv_new.shape[2], :] = kv_new.to(kv_cache.dtype)
    return kv_cache


def apply_kv_update_batch(kv_cache: torch.Tensor, kv_new: torch.Tensor,
                          pos: Pos, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write kv_new (L, 2, B, D) into the batched cache at the shared `pos`."""
    _write_rows(kv_cache, 3, pos, kv_new, active)
    return kv_cache


def apply_kv_update_q_batch(kv_cache: torch.Tensor, kv_scales: torch.Tensor,
                            kv_new: torch.Tensor, pos: Pos,
                            active: Optional[torch.Tensor] = None):
    """Quantize kv_new (L, 2, B, D) f32 and write rows + scales at the shared
    `pos` into the int8 cache / (L, B, Tmax, 2) scale table."""
    q, s = _quantize_rows(kv_new)                    # s (L, 2, B)
    _write_rows(kv_cache, 3, pos, q, active)
    _write_rows(kv_scales, 2, pos, s.permute(0, 2, 1), active)
    return kv_cache, kv_scales


def _scatter_rows(buf: torch.Tensor, dim: int, pos: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """Write `rows` (buf's shape without its time axis `dim`) into `buf`, each
    row b of axis dim - 1 at its own position pos[b] of axis `dim`, by
    `scatter_`: no host read, so a captured graph holds the write."""
    rows = rows.to(buf.dtype).unsqueeze(dim)
    shape = [1] * buf.dim()
    shape[dim - 1] = pos.shape[0]
    buf.scatter_(dim, pos.long().reshape(shape).expand(rows.shape), rows)


def apply_kv_update_rows(kv_cache: torch.Tensor, kv_new: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Per-row write (continuous batching): kv_new (L, 2, B, D) lands at each
    row's own position pos (B,), a device tensor, in the batched time-major
    cache (L, 2, B, Tmax, D).  An idle row writes at its stale position, as
    in the JAX package; the next admission overwrites its row."""
    _scatter_rows(kv_cache, 3, pos, kv_new)
    return kv_cache


def apply_kv_update_q_rows(kv_cache: torch.Tensor, kv_scales: torch.Tensor,
                           kv_new: torch.Tensor, pos: torch.Tensor):
    """Per-row int8 write: quantize kv_new (L, 2, B, D) f32 and place each
    row and its scales at its own position pos (B,) (cache int8 (L, 2, B,
    Tmax, D), scales (L, B, Tmax, 2)).  Returns (cache, scales)."""
    q, s = _quantize_rows(kv_new)                    # s (L, 2, B)
    _scatter_rows(kv_cache, 3, pos, q)
    _scatter_rows(kv_scales, 2, pos, s.permute(0, 2, 1))
    return kv_cache, kv_scales


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _ln(x, w, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _dot(src, w_t, scale, bias):
    """bf16(src) (B, K) @ int8 (F, K)^T, f32 accumulation, * scale + bias."""
    y = src.to(torch.bfloat16).float() @ w_t.float().t()
    return y * scale + bias


def _unpack_int4(w: torch.Tensor):
    """(F, K/2) nibble pairs -> (low, high) signed nibble values, f32."""
    wi = w.to(torch.int32)
    return (((wi & 15) ^ 8) - 8).float(), (wi >> 4).float()


def _dot4(src, w_t, gscale, bias):
    """bf16(src) (B, K) @ an int4 tile (F, K/2) with its (F, G) group scales,
    as the JAX default scheme: each group's sum of the bf16 activation times
    the signed nibbles in f32, times the group's scale, added in group order
    (low half, high half) to an f32 sum; then the bias."""
    xb = src.to(torch.bfloat16).float()
    lo, hi = _unpack_int4(w_t)
    half = lo.shape[1]
    per_half = gscale.shape[1] // 2
    gsz = half // per_half
    y = torch.zeros((xb.shape[0], lo.shape[0]), dtype=torch.float32, device=xb.device)
    for g in range(per_half):
        sl = slice(g * gsz, (g + 1) * gsz)
        y = y + (xb[:, sl] @ lo[:, sl].t()) * gscale[:, g]
        y = y + (xb[:, half + g * gsz:half + (g + 1) * gsz] @ hi[:, sl].t()
                 ) * gscale[:, per_half + g]
    return y + bias


def int4_gemv_plain(x, w, gscales, bias, ln=None, res=None, epilogue: int = _EPI_NONE):
    """One int4 GEMV of the chain (K7) summed as the kernel sums it: x (R,
    n_kt * ktile) f32, through the LN `ln` = (weight, bias) when given, then
    rounded to bf16; w (n_kt, F, ktile / 2) int8 nibble pairs; gscales
    (n_kt, F, G) f32.  Each contraction tile's sum starts at 0 and takes, in
    group order (low half, then high half), each group's f32 sum times its
    scale; the tiles' sums are added in tile order, then the bias (F,), then
    the epilogue (GELU-tanh, or `res` + y).  At one tile this is `_dot4`;
    over the fc2's four it associates the tile sums as the kernel does."""
    n_kt, f, half = w.shape
    ktile = 2 * half
    xb = (_ln(x, *ln) if ln is not None else x).to(torch.bfloat16).float()
    acc = torch.zeros((x.shape[0], f), dtype=torch.float32, device=x.device)
    for kt in range(n_kt):
        lo, hi = _unpack_int4(w[kt])
        gs = gscales[kt]
        per_half = gs.shape[1] // 2
        gsz = half // per_half
        xk = xb[:, kt * ktile:(kt + 1) * ktile]
        tile = torch.zeros_like(acc)
        for g in range(per_half):
            sl = slice(g * gsz, (g + 1) * gsz)
            tile = tile + (xk[:, sl] @ lo[:, sl].t()) * gs[:, g]
            tile = tile + (xk[:, half + g * gsz:half + (g + 1) * gsz] @ hi[:, sl].t()
                           ) * gs[:, per_half + g]
        acc = acc + tile
    y = acc + bias
    if epilogue == _EPI_GELU:
        return torch.nn.functional.gelu(y, approximate="tanh")
    if epilogue == _EPI_RESIDUAL:
        return res + y
    return y


def _layer_dot(pack: Pack, layer: int):
    """dot(src, t): the product of `src` with weight tile t of `layer`, the
    dequant scale and bias row t + 12, for an int8 or an int4 pack."""
    w, c = pack.w[layer], pack.consts[layer]
    if isinstance(pack, FusedDecodePackInt4):
        gs = pack.gscales[layer]
        return lambda src, t: _dot4(src, w[t], gs[t], c[t + 12])
    return lambda src, t: _dot(src, w[t], c[t], c[t + 12])


def _trunk_plain(xs, pack: Pack, kv_new, attend, kernel_order: bool = False):
    """Every layer of one step over the rows of xs (B, D) f32: LN1 -> QKV ->
    `attend(layer, q, k, v)` -> projection + residual -> LN2 -> fc -> GELU-tanh
    -> fc2 + residual.  Writes each layer's k/v rows into kv_new (L, 2, B, D)
    and returns the hidden rows.  fc2 adds its four tiles' products, each
    with its bias row, as the JAX kernels do; with `kernel_order` an int4
    pack's fc2 is summed as the K7 kernel sums it (`int4_gemv_plain`: the
    tiles' sums, then the bias once)."""
    twin_fc2 = kernel_order and isinstance(pack, FusedDecodePackInt4)
    for layer in range(pack.w.shape[0]):
        dot, c = _layer_dot(pack, layer), pack.consts[layer]
        h = _ln(xs, c[24], c[25])
        q, k, v = dot(h, 0), dot(h, 1), dot(h, 2)
        kv_new[layer, 0] = k.to(kv_new.dtype)
        kv_new[layer, 1] = v.to(kv_new.dtype)
        xs = xs + dot(attend(layer, q, k, v), 3)
        h = _ln(xs, c[26], c[27])
        hs = [torch.nn.functional.gelu(dot(h, t), approximate="tanh")
              for t in range(4, 8)]
        if twin_fc2:
            xs = xs + int4_gemv_plain(torch.cat(hs, dim=1), pack.w[layer, 8:12],
                                      pack.gscales[layer, 8:12], c[23])
            continue
        acc = None
        for t in range(8, 12):
            part = dot(hs[t - 8], t)
            acc = part if acc is None else acc + part
        xs = xs + acc
    return xs


def _readout_plain(xs, readout_pack: Optional[ReadoutPack]):
    if readout_pack is None:
        return None
    hf = _ln(xs, readout_pack.lnf[0], readout_pack.lnf[1])
    return _dot(hf, readout_pack.w, readout_pack.consts[0], readout_pack.consts[1])


def _pos_rows(pos: Pos, b: int, device) -> torch.Tensor:
    """The per-row live prefix lengths as a (B,) int64 tensor, from a host
    int, a 0-d or one-element tensor shared by the rows, or a (B,) one."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(-1).to(device=device, dtype=torch.int64).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int64, device=device)


def _split_attention(qh, keys, values, mask, s_tail, v_tail, split_t: int):
    """The CUDA attentions' arithmetic (K1 / K3, K6): qh (B, H, hd) scaled
    queries, keys / values (B, P, H, hd) f32, mask (B, P) additive (-inf
    past a row's prefix), s_tail (B, H, N) the scores of the N tokens
    attended after the prefix (-inf where a row may not see one; at least
    one seen a row) and v_tail (B, H, N, hd) their values.  Each split of
    `split_t` positions keeps its max m, sum l and unnormalised weighted sum
    of V, o (a split with no live position: m = -inf, l = 0, o = 0); the
    splits are combined in order by the online-softmax recurrence (each
    rescaled to the running max), then the tail.  Returns (B, H, hd)."""
    scores = torch.einsum("bhd,bthd->bht", qh, keys) + mask[:, None, :]
    m = torch.full_like(s_tail[..., 0], float("-inf"))
    l, o = torch.zeros_like(m), torch.zeros_like(v_tail[:, :, 0])
    for c0 in range(0, keys.shape[1], split_t):
        sc = scores[..., c0:c0 + split_t]
        ms = sc.amax(-1)                                         # (B, H)
        live = torch.isfinite(ms)
        e = torch.where(live[..., None], torch.exp(sc - ms[..., None]),
                        torch.zeros_like(sc))
        o_s = torch.einsum("bht,bthd->bhd", e, values[:, c0:c0 + split_t])
        # a row with no live position yet keeps (m, l, o) = (-inf, 0, 0)
        m_new = torch.maximum(m, ms)
        keep = torch.where(torch.isfinite(m), torch.exp(m - m_new), torch.zeros_like(m))
        add = torch.where(live, torch.exp(ms - m_new), torch.zeros_like(ms))
        l = l * keep + e.sum(-1) * add
        o = o * keep[..., None] + o_s * add[..., None]
        m = m_new
    m_f = torch.maximum(m, s_tail.amax(-1))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_f), torch.zeros_like(m))
    p = torch.exp(s_tail - m_f[..., None])                       # (B, H, N)
    return ((o * alpha[..., None] + (p[..., None] * v_tail).sum(-2))
            / (l * alpha + p.sum(-1))[..., None])


def _split_prefix_attention(qh, keys, values, mask, s_cur, v_cur, split_t: int):
    """K1 / K3's split attention (`_split_attention`) with the current
    token as the tail: s_cur (B, H, 1) its score, v_cur (B, H, hd) its
    value."""
    return _split_attention(qh, keys, values, mask, s_cur, v_cur[:, :, None], split_t)


def _step_batch_plain(x, pack: Pack, kv_cache, bias, pos: Pos, heads: int,
                      kv_scales, beam_src, readout_pack, split_t: Optional[int]):
    n_layers, _, b, _, d = kv_cache.shape
    hd = d // heads
    dev = x.device
    int8_kv = kv_scales is not None
    pos_b = _pos_rows(pos, b, dev)
    p_max = int(pos_b.max())
    t_idx = torch.arange(p_max, device=dev)[None, :]           # (1, P)
    rows = (beam_src[:, :p_max].long() if beam_src is not None
            else torch.arange(b, device=dev)[:, None].expand(b, p_max))
    # positions past a row's own prefix take no weight (an idle pos-0 row
    # attends to its current token only)
    mask = torch.where(t_idx < pos_b[:, None], bias[:, :p_max].float(),
                       torch.tensor(float("-inf"), device=dev))
    kv_new = torch.empty((n_layers, 2, b, d), device=dev,
                         dtype=torch.float32 if int8_kv else kv_cache.dtype)

    def cached(layer, kv):      # (B, P, H, hd) f32, each row via its ancestor
        c = kv_cache[layer, kv][rows, t_idx].float()
        if int8_kv:
            c = c * kv_scales[layer][rows, t_idx, kv][..., None]
        return c.reshape(b, p_max, heads, hd)

    def attend(layer, q, k, v):
        qh = (q * (hd ** -0.5)).reshape(b, heads, hd)
        s_cur = (qh * k.reshape(b, heads, hd)).sum(-1, keepdim=True)
        if split_t is not None:
            return _split_prefix_attention(qh, cached(layer, 0), cached(layer, 1), mask,
                                           s_cur, v.reshape(b, heads, hd),
                                           split_t).reshape(b, d)
        scores = torch.einsum("bhd,bthd->bht", qh, cached(layer, 0)) + mask[:, None, :]
        probs = torch.softmax(torch.cat([scores, s_cur], dim=-1), dim=-1)
        ctx = (torch.einsum("bht,bthd->bhd", probs[..., :p_max], cached(layer, 1))
               + probs[..., p_max:] * v.reshape(b, heads, hd))
        return ctx.reshape(b, d)

    xs = _trunk_plain(x.float().reshape(b, d), pack, kv_new, attend,
                      kernel_order=split_t is not None)
    return xs, kv_new, _readout_plain(xs, readout_pack)


def fused_decode_step_batch_plain(x, pack: Pack, kv_cache, bias,
                                  pos: Pos, heads: int,
                                  kv_scales: Optional[torch.Tensor] = None,
                                  beam_src: Optional[torch.Tensor] = None,
                                  readout_pack: Optional[ReadoutPack] = None):
    """Plain PyTorch version; see `fused_decode_step_batch`."""
    return _step_batch_plain(x, pack, kv_cache, bias, pos, heads, kv_scales,
                             beam_src, readout_pack, None)


def fused_decode_step_batch_split_plain(x, pack: Pack, kv_cache, bias,
                                        pos: Pos, heads: int,
                                        kv_scales: Optional[torch.Tensor] = None,
                                        beam_src: Optional[torch.Tensor] = None,
                                        readout_pack: Optional[ReadoutPack] = None):
    """The plain step summed as the CUDA chain sums it: the prefix cut into
    splits of BLOCK_T positions, each split's softmax partials combined in
    split order with the current token (`_split_prefix_attention`), and an
    int4 pack's fc2 in the K7 kernel's order (`int4_gemv_plain`); the same
    function as `fused_decode_step_batch_plain`, summed another way."""
    return _step_batch_plain(x, pack, kv_cache, bias, pos, heads, kv_scales,
                             beam_src, readout_pack, BLOCK_T)


def _verify_plain(x, pack: FusedDecodePack, kv_cache, bias, pos: int, heads: int,
                  split_t: Optional[int]):
    n_layers, _, _, _, d = kv_cache.shape
    kk = x.shape[0]
    hd = d // heads
    dev = x.device
    pos = int(pos)
    pre_bias = bias[:pos, 0].float()
    causal = torch.ones((kk, kk), dtype=torch.bool, device=dev).tril()
    neg = torch.tensor(float("-inf"), device=dev)
    kv_new = torch.empty((n_layers, 2, kk, d), device=dev, dtype=kv_cache.dtype)

    def attend(layer, q, k, v):
        qh = (q * (hd ** -0.5)).reshape(kk, heads, hd)
        ck = kv_cache[layer, 0, 0, :pos].float().reshape(pos, heads, hd)
        cv = kv_cache[layer, 1, 0, :pos].float().reshape(pos, heads, hd)
        s_tail = torch.einsum("jhd,ihd->jhi", qh, k.reshape(kk, heads, hd))
        s_tail = torch.where(causal[:, None, :], s_tail, neg)
        if split_t is not None:
            v_tail = v.reshape(kk, heads, hd).transpose(0, 1)[None].expand(kk, -1, -1, -1)
            return _split_attention(qh, ck[None].expand(kk, -1, -1, -1),
                                    cv[None].expand(kk, -1, -1, -1),
                                    pre_bias[None].expand(kk, -1), s_tail, v_tail,
                                    split_t).reshape(kk, d)
        s_pre = torch.einsum("jhd,thd->jht", qh, ck) + pre_bias
        probs = torch.softmax(torch.cat([s_pre, s_tail], dim=-1), dim=-1)
        ctx = (torch.einsum("jht,thd->jhd", probs[..., :pos], cv)
               + torch.einsum("jhi,ihd->jhd", probs[..., pos:],
                              v.reshape(kk, heads, hd)))
        return ctx.reshape(kk, d)

    xs = _trunk_plain(x.float().reshape(kk, d), pack, kv_new, attend)
    return xs, kv_new


def fused_decode_verify_plain(x, pack: FusedDecodePack, kv_cache, bias,
                              pos: int, heads: int):
    """Plain PyTorch version; see `fused_decode_verify`.  Row j attends the
    committed prefix [0, pos) under the bias, then rows i <= j of the K
    current tokens with their unrounded f32 k/v (JAX `_attend_verify`)."""
    return _verify_plain(x, pack, kv_cache, bias, pos, heads, None)


def fused_decode_verify_split_plain(x, pack: FusedDecodePack, kv_cache, bias,
                                    pos: int, heads: int):
    """The plain verify with the CUDA verify attention's arithmetic: the
    committed prefix in the splits of `verify_splits`, each split's softmax
    partials of every row combined in split order, then the row's causal
    tail (`_split_attention`); the same function as
    `fused_decode_verify_plain`, summed another way."""
    split_t, _ = verify_splits(pos, heads, kv_cache.shape[3])
    return _verify_plain(x, pack, kv_cache, bias, pos, heads, split_t)


def fused_decode_step_plain(x, pack: Pack, kv_cache, bias, pos: Pos,
                            heads: int, readout_pack: Optional[ReadoutPack] = None,
                            kv_scales: Optional[torch.Tensor] = None):
    """Plain PyTorch version; see `fused_decode_step` (K3's at B = 1)."""
    n_layers, _, _, t_max, d = kv_cache.shape
    scales = None if kv_scales is None else kv_scales.reshape(n_layers, 1, t_max, 2)
    y, kv_new, logits = fused_decode_step_batch_plain(
        x, pack, kv_cache, bias.reshape(1, t_max), pos, heads,
        kv_scales=scales, readout_pack=readout_pack)
    return y, kv_new[:, :, 0], logits


# ---------------------------------------------------------------------------
# the CUDA chain
# ---------------------------------------------------------------------------

def attend_splits(pos: Pos, t_max: int) -> int:
    """Splits of the CUDA attention's grid (one block per head, row and
    split of BLOCK_T positions): enough for the longest live prefix, that
    is ceil(pos / BLOCK_T) for a host int pos (at least 1), and Tmax /
    BLOCK_T for a position on the device (shared or per row), which the
    host does not read; a split past a row's prefix contributes nothing."""
    if isinstance(pos, torch.Tensor):
        return t_max // BLOCK_T
    return max(1, -(-min(int(pos), t_max) // BLOCK_T))


def attend_workspace(b: int, heads: int, hd: int, splits: int) -> int:
    """f32 scratch of one attention launch, (B, H, splits, hd + 2): each
    split's weighted sum of V, max and sum.  Reused by every layer."""
    return b * heads * splits * (hd + 2)


SMS = 132              # streaming multiprocessors of the H100


K7_MIN_WARPS, K7_MAX_WARPS = 4, 16   # warps a block of the int4 GEMV
K7_MAX_COL_BLOCKS = 4                # runs of 8 output columns a block


class Int4GemvPlan(NamedTuple):
    warps: int             # warps a block (K7_MIN_WARPS .. K7_MAX_WARPS)
    col_blocks: int        # runs of 8 output columns a block (1 .. K7_MAX_COL_BLOCKS)
    blocks: int
    units: int             # (column run, contraction tile, group) triples a block


def plan_int4_gemv(k: int, f: int, gsize: int, ln: bool) -> Int4GemvPlan:
    """The K7 grid for a (K, F) GEMV with scale groups of `gsize` rows. A
    block owns runs of 8 output columns (one tensor-core tile wide): one,
    or on a GEMV with an LN prologue as many (up to 4) as keep a block an
    SM, since every block restages x and the LN constants from L2.  Its
    units of work, one a (run, contraction tile, group), its warps take in
    rounds: as few rounds as K7_MAX_WARPS allow, the units spread evenly,
    at least K7_MIN_WARPS warps.  At the flagship widths, g128: qkv 160
    blocks of 3 runs (15 units, 15 warps), proj 160 of 1 (5, 5), fc 160 of
    4 (20 units in two rounds of 10 warps), fc2 160 of 1 (20, 10)."""
    runs = f // 8
    col_blocks = 1
    if ln:
        col_blocks = next((c for c in range(K7_MAX_COL_BLOCKS, 0, -1)
                           if runs % c == 0 and runs // c >= SMS), 1)
    units = col_blocks * (k // (2 * gsize))
    rounds = -(-units // K7_MAX_WARPS)
    warps = max(K7_MIN_WARPS, -(-units // rounds))
    return Int4GemvPlan(warps, col_blocks, -(-runs // col_blocks), units)


VERIFY_MIN_SPLIT, VERIFY_MAX_SPLIT = 32, 256   # prefix positions a K6 block
VERIFY_MIN_BLOCKS = 2 * SMS


def verify_splits(pos: int, heads: int, t_max: int):
    """(split width, splits) of the K6 attention's grid, one block per
    (head, split) attending its split for all K rows: the committed prefix
    [0, pos) cut into splits of a multiple of 32 positions (one pass of a
    block's warps at hd 64), 32-256, at least VERIFY_MIN_BLOCKS blocks
    unless the width is at a bound; at least one split (an empty prefix
    still needs the block that combines the causal tail).  At 20 heads:
    pos 300, 10 splits of 32; pos 1500, 16 of 96."""
    live = min(int(pos), t_max)
    want = -(-VERIFY_MIN_BLOCKS // heads)
    width = -(-max(live, 1) // want) // 32 * 32
    width = min(VERIFY_MAX_SPLIT, max(VERIFY_MIN_SPLIT, width))
    return width, max(1, -(-live // width))


def verify_workspace(heads: int, splits: int, k: int, hd: int) -> int:
    """f32 scratch of one K6 attention launch, (H, splits, K, hd + 2): each
    split's weighted sum of V, max and sum for every row."""
    return heads * splits * k * (hd + 2)


def _check(name, t, dev, dtype, shape, align16=False):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, x on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _decode_chain_cuda(kernel: str, x, pack: Pack, kv_cache, bias, pos: Pos,
                       heads: int, kv_scales, beam_src, readout_pack,
                       verify: bool = False):
    """Run the CUDA kernel chain over the B rows of x (B, D); `kernel` names
    the counter.  kv_cache (L, 2, B, Tmax, D) bf16 | int8; bias (B, Tmax)
    f32; kv_scales (L, B, Tmax, 2) f32 or None; beam_src (B, Tmax) int32 or
    None; pos a host int, or a tensor on the device shared by the rows (0-d
    or one element) or one a row (B,), which no host code reads: the
    kernels clamp it to Tmax.  With `verify`
    the B rows are K tokens of one sequence at pos, pos + 1, ...: the cache
    and the bias hold that one sequence, (L, 2, 1, Tmax, D) and (1, Tmax),
    and each layer's attention is the verify kernel.  An int4 pack selects
    the int4 weight loader for the trunk (the readout stays int8)."""
    n_layers, two, cb, t_max, d = kv_cache.shape
    b = x.shape[0]
    dev = x.device
    int8_kv = kv_scales is not None
    int4 = isinstance(pack, FusedDecodePackInt4)
    if two != 2 or d % heads or x.shape != (b, d) or cb != (1 if verify else b):
        raise ValueError(f"{kernel}: x {tuple(x.shape)} / cache "
                         f"{tuple(kv_cache.shape)} / heads {heads}")
    hd = d // heads
    if t_max % BLOCK_T or d % 16 or hd % 8 or 32 % (hd // 8):
        raise ValueError(f"{kernel}: needs Tmax % 256 == 0, D % 16 == 0 and a "
                         "head width hd with hd % 8 == 0 dividing 256")
    cache_dtype = torch.int8 if int8_kv else torch.bfloat16
    _check(f"{kernel}: x", x, dev, torch.float32, None)
    _check(f"{kernel}: kv_cache", kv_cache, dev, cache_dtype, None, align16=True)
    _check(f"{kernel}: pack.w", pack.w, dev, torch.int8,
           (n_layers, 12, d, d // 2 if int4 else d), True)
    _check(f"{kernel}: pack.consts", pack.consts, dev, torch.float32, (n_layers, 28, d))
    if int4:
        n_groups = pack.gscales.shape[-1]
        gsz = d // max(n_groups, 1)
        if n_groups < 2 or n_groups % 2 or gsz * n_groups != d or gsz % 16 or d % 32:
            raise ValueError(f"{kernel}: int4 groups {n_groups} at D {d}: needs an "
                             "even count of groups of a multiple of 16 rows and "
                             "D % 32 == 0")
        _check(f"{kernel}: pack.gscales", pack.gscales, dev, torch.float32,
               (n_layers, 12, d, n_groups))
    _check(f"{kernel}: bias", bias, dev, torch.float32, (cb, t_max))
    if int8_kv:
        _check(f"{kernel}: kv_scales", kv_scales, dev, torch.float32,
               (n_layers, b, t_max, 2))
    if beam_src is not None:
        _check(f"{kernel}: beam_src", beam_src, dev, torch.int32, (b, t_max))
    if readout_pack is not None:
        v_pad = readout_pack.w.shape[0]
        _check(f"{kernel}: readout.w", readout_pack.w, dev, torch.int8, (v_pad, d), True)
        _check(f"{kernel}: readout.consts", readout_pack.consts, dev,
               torch.float32, (2, v_pad))
        _check(f"{kernel}: readout.lnf", readout_pack.lnf, dev, torch.float32, (2, d))
    pos_rows = None
    if isinstance(pos, torch.Tensor):
        if verify or pos.numel() not in (1, b):
            raise ValueError(f"{kernel}: pos {tuple(pos.shape)}: a host int, or "
                             f"one or {b} positions")
        pos_rows = pos.reshape(-1).to(device=dev, dtype=torch.int32).expand(b).contiguous()
        pos = 0
    elif not 0 <= int(pos) <= t_max - (b if verify else 1):
        raise ValueError(f"{kernel}: pos {int(pos)} with {b if verify else 1} "
                         f"row(s) outside [0, {t_max})")
    lib = build.kernels()
    call = lib.call
    stream = build.stream_handle(dev)
    xs = x.clone()
    qkv = torch.empty((b, 3 * d), dtype=torch.float32, device=dev)
    ctx = torch.empty((b, d), dtype=torch.float32, device=dev)
    hid = torch.empty((b, 4 * d), dtype=torch.float32, device=dev)
    kv_new = torch.empty((n_layers, 2, b, d), device=dev,
                         dtype=torch.float32 if int8_kv else kv_cache.dtype)
    if verify:
        split_t, splits = verify_splits(pos, heads, t_max)
        work = torch.empty(verify_workspace(heads, splits, b, hd),
                           dtype=torch.float32, device=dev)
        arrivals = torch.zeros(heads, dtype=torch.int32, device=dev)
    else:
        splits = attend_splits(pos_rows if pos_rows is not None else pos, t_max)
        work = torch.empty(attend_workspace(b, heads, hd, splits),
                           dtype=torch.float32, device=dev)
        # each launch leaves its arrival counts at zero for the next one
        arrivals = torch.zeros(b * heads, dtype=torch.int32, device=dev)
    # byte addresses from the base pointers (no per-layer tensor views: the
    # chain is 5 launches a layer and its host cost sets the step time)
    row = d * 4                              # bytes per f32 row of consts
    tile = d * d // 2 if int4 else d * d     # bytes per weight tile
    # dequant scales of tile t at s0 + t * s_tile: a consts row (int8), or
    # the tile's (D, G) group-scale block (int4)
    s_tile = d * pack.gscales.shape[-1] * 4 if int4 else row
    plane = cb * t_max * d * kv_cache.element_size()  # one (layer, k|v) plane
    kv_layer = 2 * b * d * kv_new.element_size()
    q_scale = float(hd ** -0.5)
    xp, qkvp, ctxp, hidp = xs.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), hid.data_ptr()
    w_base, c_base = pack.w.data_ptr(), pack.consts.data_ptr()
    g_base = pack.gscales.data_ptr() if int4 else None
    cache_base, kv_base = kv_cache.data_ptr(), kv_new.data_ptr()
    scale_base = kv_scales.data_ptr() if int8_kv else None
    src_p = beam_src.data_ptr() if beam_src is not None else None
    pos_p = pos_rows.data_ptr() if pos_rows is not None else None
    bias_p = bias.data_ptr()
    work_p, arrivals_p = work.data_ptr(), arrivals.data_ptr()
    if int4:
        # the K7 grid of each GEMV: qkv, proj, fc, fc2
        plans = [plan_int4_gemv(k, f, gsz, ln) for k, f, ln in
                 ((d, 3 * d, True), (d, d, False), (d, 4 * d, True), (4 * d, d, False))]

        def gemv(i, x_p, ln_w, ln_b, w_p, n_kt, s_p, bias_p_, res_p, out_p, f, epi):
            call("vtt_dq_gemv4", x_p, ln_w, ln_b, w_p, n_kt, d, s_p, gsz, bias_p_,
                 res_p, out_p, f, b, epi, plans[i].warps, plans[i].col_blocks, stream)
    else:
        def gemv(i, x_p, ln_w, ln_b, w_p, n_kt, s_p, bias_p_, res_p, out_p, f, epi):
            call("vtt_dq_gemv", x_p, ln_w, ln_b, w_p, n_kt, d, s_p, bias_p_, res_p,
                 out_p, f, b, epi, stream)
    LAUNCHES[kernel] += 1
    if int4:
        LAUNCHES["fused_decode_int4"] += 1
    for layer in range(n_layers):
        w0 = w_base + layer * TILES_PER_LAYER * tile
        c0 = c_base + layer * 28 * row
        s0 = g_base + layer * TILES_PER_LAYER * s_tile if int4 else c0
        cache_k = cache_base + 2 * layer * plane
        # LN1 -> qkv (tiles 0-2, biases rows 12-14)
        gemv(0, xp, c0 + 24 * row, c0 + 25 * row, w0, 1, s0, c0 + 12 * row, None,
             qkvp, 3 * d, _EPI_NONE)
        if verify:
            call("vtt_verify_attend", qkvp, cache_k, cache_k + plane, bias_p,
                 pos, b, t_max, d, heads, q_scale, ctxp,
                 kv_base + layer * kv_layer, work_p, split_t, splits, arrivals_p,
                 stream)
        else:
            scales = (scale_base + layer * b * t_max * 2 * 4) if int8_kv else None
            call("vtt_decode_attend", qkvp, cache_k, cache_k + plane, scales,
                 bias_p, src_p, pos_p, pos, b, t_max, d, heads, q_scale, ctxp,
                 kv_base + layer * kv_layer, int(int8_kv), work_p, splits,
                 arrivals_p, stream)
        # x += proj(ctx)   (tile 3, bias row 15)
        gemv(1, ctxp, None, None, w0 + 3 * tile, 1, s0 + 3 * s_tile, c0 + 15 * row,
             xp, xp, d, _EPI_RESIDUAL)
        # LN2 -> fc -> GELU   (tiles 4-7, biases rows 16-19)
        gemv(2, xp, c0 + 26 * row, c0 + 27 * row, w0 + 4 * tile, 1, s0 + 4 * s_tile,
             c0 + 16 * row, None, hidp, 4 * d, _EPI_GELU)
        # x += fc2(h)   (tiles 8-11 = 4 contraction tiles; int8: one scale
        # row 8; int4: each tile's own group scales; the bias once, row 23)
        gemv(3, hidp, None, None, w0 + 8 * tile, 4, s0 + 8 * s_tile, c0 + 23 * row,
             xp, xp, d, _EPI_RESIDUAL)
    if readout_pack is None:
        return xs, kv_new, None
    v_pad = readout_pack.w.shape[0]
    logits = torch.empty((b, v_pad), dtype=torch.float32, device=dev)
    lnf = readout_pack.lnf
    call("vtt_dq_gemv", xp, lnf[0].data_ptr(), lnf[1].data_ptr(),
         readout_pack.w.data_ptr(), 1, d, readout_pack.consts[0].data_ptr(),
         readout_pack.consts[1].data_ptr(), None, logits.data_ptr(), v_pad, b,
         _EPI_NONE, stream)
    return xs, kv_new, logits


def fused_decode_step_cuda(x, pack: Pack, kv_cache, bias, pos: Pos,
                           heads: int, readout_pack: Optional[ReadoutPack] = None,
                           kv_scales: Optional[torch.Tensor] = None):
    """The CUDA kernel chain at B = 1; see `fused_decode_step`."""
    n_layers, _, b, t_max, d = kv_cache.shape
    if b != 1 or x.numel() != d:
        raise ValueError(f"fused_decode_step: x {tuple(x.shape)} / cache "
                         f"{tuple(kv_cache.shape)}: one row")
    if bias.shape != (t_max, 1):
        raise ValueError(f"fused_decode_step: bias must be {(t_max, 1)}, "
                         f"got {tuple(bias.shape)}")
    scales = None if kv_scales is None else kv_scales.reshape(n_layers, 1, t_max, 2)
    y, kv_new, logits = _decode_chain_cuda(
        "fused_decode_step", x.float().reshape(1, d), pack, kv_cache,
        bias.reshape(1, t_max), pos, heads, scales, None, readout_pack)
    return y, kv_new[:, :, 0], logits


def fused_decode_step(x: torch.Tensor, pack: Pack,
                      kv_cache: torch.Tensor, bias: torch.Tensor, pos: Pos,
                      heads: int, readout_pack: Optional[ReadoutPack] = None,
                      kv_scales: Optional[torch.Tensor] = None):
    """One decode step of the whole trunk plus the folded readout, K1.

    x (1, D) token embedding; pack the int8 trunk (`pack_gpt`) or the int4
    one (`pack_gpt_int4`, K7); kv_cache TIME-MAJOR (L, 2, 1, Tmax, D)
    (`cache_to_time_major`), Tmax % 256 == 0, bf16 or, with `kv_scales`
    (L, Tmax, 2) f32, int8 (`quantize_kv_cache`); bias (Tmax, 1) f32
    additive mask (-1e30 on invalid prompt pads); pos — index of the current
    token (positions [0, pos) are live history), a host int or a 0-d
    integer tensor on x's device (a device loop's position).  Returns (hidden (1, D) f32
    pre-ln_f, kv_new (L, 2, D) in the cache dtype — f32 with an int8 cache —,
    logits (1, 12 * VT) f32, or None without a readout pack); the caller
    writes kv_new at `pos` (`apply_kv_update`, `apply_kv_update_q`) and
    slices the logits to the vocab.  CPU tensors take the plain version;
    CUDA tensors launch the kernels (errors raise, there is no fallback).
    """
    if x.is_cuda:
        return fused_decode_step_cuda(x, pack, kv_cache, bias, pos, heads,
                                      readout_pack, kv_scales)
    if x.device.type != "cpu":
        raise ValueError(f"fused_decode_step: unsupported device {x.device}")
    return fused_decode_step_plain(x, pack, kv_cache, bias, pos, heads,
                                   readout_pack, kv_scales)


def fused_decode_step_batch(x: torch.Tensor, pack: Pack,
                            kv_cache: torch.Tensor, bias: torch.Tensor,
                            pos: Pos, heads: int,
                            kv_scales: Optional[torch.Tensor] = None,
                            beam_src: Optional[torch.Tensor] = None,
                            readout_pack: Optional[ReadoutPack] = None):
    """One decode step of the trunk for B rows plus the folded readout, K3.

    x (B, D) token embeddings, B <= 8 (<= 12 with an ancestor table); pack
    int8 (`pack_gpt`) or int4 (`pack_gpt_int4`, K7);
    kv_cache TIME-MAJOR (L, 2, B, Tmax, D), bf16 or, with `kv_scales`
    (L, B, Tmax, 2) f32, int8 (`quantize_kv_cache_batch`); bias (B, Tmax)
    f32 additive per-row prompt-pad mask; pos an int shared by all rows, a
    0-d integer tensor on the device shared by all rows, or a (B,) int
    tensor of per-row live prefix lengths (0 marks an idle slot: its
    outputs are finite and meaningless); beam_src (B, Tmax) int32
    ancestor table or None: row b reads position t from cache row
    `beam_src[b, t]` (dequantized with that row's scale).  Returns (hidden
    (B, D) f32, kv_new (L, 2, B, D) in the cache dtype — f32 with an int8
    cache —, logits (B, 12 * VT) f32 or None); write kv_new with
    `apply_kv_update_batch` / `apply_kv_update_q_batch`.  CPU tensors take
    the plain version; CUDA tensors launch the kernels (errors raise).
    """
    b = kv_cache.shape[2]
    cap = MAX_ROWS_TABLE if beam_src is not None else MAX_ROWS
    if not 1 <= b <= cap:
        raise ValueError(f"fused_decode_step_batch: 1 <= B <= {cap}, got {b}")
    if x.is_cuda:
        src = None if beam_src is None else beam_src.to(torch.int32).contiguous()
        return _decode_chain_cuda("fused_decode_step_batch", x.float().contiguous(),
                                  pack, kv_cache, bias, pos, heads, kv_scales,
                                  src, readout_pack)
    if x.device.type != "cpu":
        raise ValueError(f"fused_decode_step_batch: unsupported device {x.device}")
    return fused_decode_step_batch_plain(x, pack, kv_cache, bias, pos, heads,
                                         kv_scales, beam_src, readout_pack)


def fused_decode_verify(x: torch.Tensor, pack: FusedDecodePack,
                        kv_cache: torch.Tensor, bias: torch.Tensor, pos: int,
                        heads: int):
    """The speculative verify step, K6: K = 2..8 tokens of ONE sequence in
    one pass over the int8 trunk.

    x (K, D) embeddings of the tokens at positions pos .. pos + K - 1;
    kv_cache TIME-MAJOR (L, 2, 1, Tmax, D) bf16, Tmax % 256 == 0 (positions
    [0, pos) are the committed history); bias (Tmax, 1) f32 additive mask.
    Row j attends the prefix, then rows i <= j of the K tokens with their
    unrounded k/v.  Returns (hidden (K, D) f32, kv_new (L, 2, K, D) bf16);
    commit with `apply_kv_update_span`.  No readout and no int8 KV (the
    JAX engine refuses spec decode with int8 KV).  CPU tensors take the
    plain version; CUDA tensors launch the kernels (errors raise)."""
    kk = x.shape[0]
    if not 2 <= kk <= 8:
        raise ValueError(f"fused_decode_verify: 2 <= K <= 8 tokens, got {kk}")
    if not isinstance(pack, FusedDecodePack):
        raise TypeError("fused_decode_verify: the verify pass takes the int8 "
                        f"pack (FusedDecodePack), got {type(pack).__name__}")
    t_max = kv_cache.shape[3]
    if bias.shape != (t_max, 1):
        raise ValueError(f"fused_decode_verify: bias must be {(t_max, 1)}, "
                         f"got {tuple(bias.shape)}")
    if x.is_cuda:
        y, kv_new, _ = _decode_chain_cuda(
            "fused_decode_verify", x.float().contiguous(), pack, kv_cache,
            bias.reshape(1, t_max), int(pos), heads, None, None, None,
            verify=True)
        return y, kv_new
    if x.device.type != "cpu":
        raise ValueError(f"fused_decode_verify: unsupported device {x.device}")
    return fused_decode_verify_plain(x, pack, kv_cache, bias, int(pos), heads)


def int4_gemv(x: torch.Tensor, w: torch.Tensor, gscales: torch.Tensor,
              bias: torch.Tensor, ln=None, res: Optional[torch.Tensor] = None,
              epilogue: int = _EPI_NONE) -> torch.Tensor:
    """One int4 GEMV of the chain (K7) on its own: x (R <= 12, n_kt *
    ktile) f32; w (n_kt, F, ktile / 2) int8 nibble pairs and gscales (n_kt,
    F, G) f32, the layout of a `pack_gpt_int4` tile run; bias (F,) f32; ln
    (weight, bias) (K,) f32 each or None; res (R, F) f32 for the residual
    epilogue.  Returns (R, F) f32.  CPU tensors take `int4_gemv_plain`;
    CUDA tensors launch the kernel with the grid of `plan_int4_gemv`."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"int4_gemv: unsupported device {x.device}")
        return int4_gemv_plain(x, w, gscales, bias, ln, res, epilogue)
    rows, k = x.shape
    n_kt, f, half = w.shape
    n_groups = gscales.shape[-1]
    gsz = 2 * half // max(n_groups, 1)
    if (k != 2 * half * n_kt or not 1 <= rows <= 12 or n_groups % 2 or gsz % 16
            or gsz * n_groups != 2 * half or half % 16 or f % 8):
        raise ValueError(f"int4_gemv: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"gscales {tuple(gscales.shape)}")
    dev = x.device
    _check("int4_gemv: x", x, dev, torch.float32, None)
    _check("int4_gemv: w", w, dev, torch.int8, None, True)
    _check("int4_gemv: gscales", gscales, dev, torch.float32, (n_kt, f, n_groups), True)
    _check("int4_gemv: bias", bias, dev, torch.float32, (f,), True)
    if ln is not None:
        for t in ln:
            _check("int4_gemv: ln", t, dev, torch.float32, (k,), True)
    if epilogue == _EPI_RESIDUAL:
        _check("int4_gemv: res", res, dev, torch.float32, (rows, f))
    out = torch.empty((rows, f), dtype=torch.float32, device=dev)
    plan = plan_int4_gemv(k, f, gsz, ln is not None)
    LAUNCHES["fused_decode_int4"] += 1
    build.kernels().call(
        "vtt_dq_gemv4", x.data_ptr(), ln[0].data_ptr() if ln is not None else None,
        ln[1].data_ptr() if ln is not None else None, w.data_ptr(), n_kt, 2 * half,
        gscales.data_ptr(), gsz, bias.data_ptr(),
        res.data_ptr() if epilogue == _EPI_RESIDUAL else None, out.data_ptr(), f, rows,
        epilogue, plan.warps, plan.col_blocks, build.stream_handle(dev))
    return out

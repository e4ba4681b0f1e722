"""int4 tile-stream micro-benchmark kernel, K13 (`scripts/micro_int4.py`).

One call streams T int4-packed tiles w (T, D/2, D) int8 (byte k of a column
holds contraction row k in its low nibble and row k + D/2 in its high one;
236 MB at 288 tiles of D 1280) with group scales gs (2 per_half, D) f32,
per_half = (D/2) / min(128, D/2): rows 0..per_half-1 scale the low
nibbles' groups, the rest the high ones'.  The accumulator starts at
x (8, D) f32; for each tile in order, x0 = acc[0] and
acc[0] <- 0.5 acc[0] + 1e-6 y(x0, w[t]); rows 1-7 stay x.  The carried
row makes tile t's product read what tile t - 1 wrote.  y is the mode:

- `dma`: the tile's first byte row as f32 (raw packed bytes, not unpacked);
- `cur`: nibbles by int32 mask / xor (lo = ((b & 15) ^ 8) - 8, hi = b >> 4)
  as bf16, then per group of 128 rows a sub-dot of bf16(x0) with f32
  accumulation, scaled on the output by its scale row (i0 = g, the high
  half's per_half + i0);
- `i8sh`: the same values unpacked by int8 shifts (lo = (b << 4) >> 4);
- `g2`: as `cur` with two groups a half (K 320 at D 1280), scale rows
  i0 = g * (per_half // 2): rows 0 and 2 (5 and 7) at per_half 5, a quirk
  of the script kept as it is;
- `dense`: two dots of K D/2, times scale row 0;
- `expand` / `xp8`: the tile dequantized in f32 as lo * gs[r // gsize]
  (hi likewise), cast to bf16, then two dense dots; `xp8` unpacks by int8
  shifts.  The script's 0/1 expansion matmul is a Mosaic workaround: here
  it is the gather of scale row r // gsize it computes.

`run(x, w, gs, mode, iters, per_half)` repeats the call as
x <- 0.5 x + 1e-6 out (`voice_tts_tpu_torch/scripts/micro_int4.py`).

- `micro_int4_plain`: PyTorch ops, tile by tile (CPU tensors, and the
  reference the kernel is checked against on the card);
- `csrc/micro_int4.cu` (`vtt_micro_int4`): the hand-written kernel, one
  cooperative launch a call: each block owns a column slice and a 64-row
  slice of the contraction, one grid barrier a tile (none in `dma`).
"""

from __future__ import annotations

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES

MODES = ("dma", "cur", "i8sh", "g2", "dense", "expand", "xp8")
GROUP = 128
ROWS = 8
KSPLIT = 64     # packed rows of a kernel block (its columns: 128)


def per_half_for(d: int) -> int:
    """Scale groups a half: (D/2) / min(128, D/2)."""
    half = d // 2
    return half // min(GROUP, half)


def unpack_mask(w: torch.Tensor):
    """int8 bytes -> (low, high) signed nibbles by int32 mask / xor and an
    arithmetic shift (the script's `cur` unpack)."""
    wb = w.to(torch.int32)
    return ((wb & 15) ^ 8) - 8, wb >> 4


def unpack_shift(w: torch.Tensor):
    """int8 bytes -> (low, high) signed nibbles by int8 shifts: (b << 4) >> 4
    and b >> 4 (the script's `i8sh` / `xp8` unpack)."""
    return (w << 4) >> 4, w >> 4


def _dot(xb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """bf16 (1, K) @ bf16 (K, F) with f32 accumulation (exact products)."""
    return xb.float() @ wb.float()


def stage_plain(x0: torch.Tensor, wt: torch.Tensor, gs: torch.Tensor,
                mode: str, per_half: int) -> torch.Tensor:
    """One tile's (1, D) f32 term y for the carried row x0 (1, D)."""
    half, d = wt.shape
    if mode == "dma":
        return wt[:1].float()
    xb = x0.to(torch.bfloat16)
    lo, hi = unpack_shift(wt) if mode in ("i8sh", "xp8") else unpack_mask(wt)
    if mode in ("cur", "i8sh", "g2"):
        nph = 2 if mode == "g2" else per_half
        gsz = half // nph
        lo, hi = lo.to(torch.bfloat16), hi.to(torch.bfloat16)
        y = torch.zeros((1, d), dtype=torch.float32, device=wt.device)
        for g in range(nph):
            sl = slice(g * gsz, (g + 1) * gsz)
            i0 = g * (per_half // nph)
            y = y + _dot(xb[:, sl], lo[sl]) * gs[i0:i0 + 1]
            y = y + (_dot(xb[:, half + g * gsz:half + (g + 1) * gsz], hi[sl])
                     * gs[per_half + i0:per_half + i0 + 1])
        return y
    if mode == "dense":
        y = (_dot(xb[:, :half], lo.to(torch.bfloat16))
             + _dot(xb[:, half:], hi.to(torch.bfloat16)))
        return y * gs[0:1]
    if mode in ("expand", "xp8"):
        rows = torch.arange(half, device=wt.device) // (half // per_half)
        slo, shi = gs[:per_half][rows], gs[per_half:][rows]
        return (_dot(xb[:, :half], (lo.float() * slo).to(torch.bfloat16))
                + _dot(xb[:, half:], (hi.float() * shi).to(torch.bfloat16)))
    raise ValueError(f"micro_int4: unknown mode {mode!r}")


def micro_int4_plain(x: torch.Tensor, w: torch.Tensor, gs: torch.Tensor,
                     mode: str, per_half: int) -> torch.Tensor:
    """x (8, D) f32, w (T, D/2, D) int8, gs (2 per_half, D) f32 -> (8, D) f32:
    row 0 carried through the tiles in order, rows 1-7 x."""
    acc = x.float().clone()
    for t in range(w.shape[0]):
        y = stage_plain(acc[0:1], w[t], gs, mode, per_half)
        acc[0:1] = acc[0:1] * 0.5 + y * 1e-6
    return acc


def _check(x, w, gs, mode, per_half) -> None:
    if mode not in MODES:
        raise ValueError(f"micro_int4: unknown mode {mode!r}, one of {MODES}")
    if x.dim() != 2 or w.dim() != 3 or x.shape[0] != ROWS:
        raise ValueError(f"micro_int4: x (8, D) and w (T, D/2, D), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    d = x.shape[1]
    if tuple(w.shape[1:]) != (d // 2, d) or d % 2:
        raise ValueError(f"micro_int4: w must be (T, {d // 2}, {d}), got {tuple(w.shape)}")
    if per_half != per_half_for(d) or tuple(gs.shape) != (2 * per_half, d):
        raise ValueError(f"micro_int4: per_half {per_half} and gs {tuple(gs.shape)} "
                         f"for D {d} (per_half {per_half_for(d)})")
    if x.dtype != torch.float32 or w.dtype != torch.int8 or gs.dtype != torch.float32:
        raise TypeError("micro_int4: x and gs must be f32 and w int8")


def micro_int4_cuda(x: torch.Tensor, w: torch.Tensor, gs: torch.Tensor,
                    mode: str, per_half: int) -> torch.Tensor:
    """One cooperative launch; raises if the card cannot hold the grid."""
    _check(x, w, gs, mode, per_half)
    n_tiles, half, d = w.shape
    if d % (4 * KSPLIT):
        # 128-column blocks, and 64-row blocks inside every mode's groups
        raise ValueError(f"micro_int4: D must be a multiple of {4 * KSPLIT}, got {d}")
    for name, a in (("x", x), ("w", w), ("gs", gs)):
        if not a.is_cuda or a.device != x.device or not a.is_contiguous():
            raise ValueError(f"micro_int4: {name} must be contiguous on {x.device}")
    # the blocks' partials of a tile, double-buffered: (2, D/2 / 64, D)
    scratch = torch.empty((2 * (half // KSPLIT) * d,), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    lib = build.kernels()
    LAUNCHES["micro_int4"] += 1
    lib.call("vtt_micro_int4", x.data_ptr(), w.data_ptr(), gs.data_ptr(),
             scratch.data_ptr(), out.data_ptr(), MODES.index(mode), n_tiles, d,
             per_half, build.stream_handle(x.device))
    return out


def micro_int4(x: torch.Tensor, w: torch.Tensor, gs: torch.Tensor, mode: str,
               per_half: int) -> torch.Tensor:
    """x (8, D) f32, w (T, D/2, D) int8, gs (2 per_half, D) f32 -> (8, D)
    f32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (errors raise)."""
    if x.is_cuda:
        return micro_int4_cuda(x, w, gs, mode, per_half)
    if x.device.type != "cpu":
        raise ValueError(f"micro_int4: unsupported device {x.device}")
    _check(x, w, gs, mode, per_half)
    return micro_int4_plain(x, w, gs, mode, per_half)


def run(x: torch.Tensor, w: torch.Tensor, gs: torch.Tensor, mode: str,
        iters: int, per_half: int) -> torch.Tensor:
    """`iters` calls, each feeding the next: x <- 0.5 x + 1e-6 out (the JAX
    script's `run`)."""
    for _ in range(iters):
        x = x * 0.5 + micro_int4(x, w, gs, mode, per_half) * 1e-6
    return x

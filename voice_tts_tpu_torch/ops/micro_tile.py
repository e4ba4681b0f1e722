"""int8 tile-stream micro-benchmark kernel, K12 (`scripts/micro_tile.py`).

One call streams T int8 (D, D) weight tiles, a decode step's int8 weights
at the defaults (288 tiles of 1280 x 1280, 472 MB), and returns
`out = x + sum_t stage(x, w[t])` with x (8, D) f32 (the input, not carried
from tile to tile).  The stage is the mode:

- `dma`: the tile's first 8 rows as f32;
- `convert`: the whole tile converted to bf16, then its rows :8 as f32;
- `dot1`: `bf16(x[:1]) @ bf16(w[t])` with f32 accumulation, into row 0
  only (rows 1-7 stay x);
- `dot8`: the same for all 8 rows;
- `dot8i`: `int8(x) @ w[t]` in int32, cast to f32 per tile.  The f32 ->
  int8 cast saturates as JAX's does (truncate toward zero, clamp to
  [-128, 127], NaN -> 0); torch's `.to(torch.int8)` wraps, so it is
  written out.

`run(x, w, mode, iters)` repeats the call as x <- 0.5 x + 1e-6 out, so no
pass can be hoisted; the benchmark times the difference of two iteration
counts (`voice_tts_tpu_torch/scripts/micro_tile.py`).

- `micro_tile_plain`: PyTorch ops, tile by tile in order (CPU tensors, and
  the reference the kernel is checked against on the card);
- `csrc/micro_tile.cu` (`vtt_micro_tile`): the hand-written kernel,
  launched for CUDA tensors: tiles spread over the card, partials reduced
  in a fixed order by a second pass (one C call, two launches); `dot8`
  and `dot8i` run on the tensor cores (mma.sync bf16 and s8), the other
  modes on the CUDA cores.
"""

from __future__ import annotations

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES

MODES = ("dma", "convert", "dot1", "dot8", "dot8i")
ROWS = 8                 # rows of x
COLS = 128               # columns of a kernel block (one 128-byte row segment)
TILES_PER_BLOCK = 4      # tiles one kernel block streams into its partial


def saturate_int8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int8 as JAX's `astype(int8)`: truncate toward zero, clamp to
    [-128, 127], NaN -> 0."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.clamp(torch.trunc(x), -128, 127).to(torch.int8)


def int8_dot(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (N, D) @ int8 (D, F) -> int32, exact: the products and their
    sums (|sum| <= D * 128 * 127 < 2^53) are exact in f64, which every
    device multiplies (CUDA has no int32 matmul)."""
    return (xq.double() @ w.double()).to(torch.int32)


def stage_plain(x: torch.Tensor, wt: torch.Tensor, mode: str) -> torch.Tensor:
    """One tile's (8, D) f32 term for tile wt (D, D) int8."""
    if mode == "dma":
        return wt[:ROWS].float()
    if mode == "convert":
        return wt.to(torch.bfloat16)[:ROWS].float()
    if mode in ("dot1", "dot8"):
        n = 1 if mode == "dot1" else ROWS
        y = x[:n].to(torch.bfloat16).float() @ wt.to(torch.bfloat16).float()
        return torch.cat([y, torch.zeros_like(x[n:])]) if n < ROWS else y
    if mode == "dot8i":
        return int8_dot(saturate_int8(x), wt).float()
    raise ValueError(f"micro_tile: unknown mode {mode!r}")


def micro_tile_plain(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x (8, D) f32, w (T, D, D) int8 -> x + the tiles' terms, added in tile
    order as the TPU kernel's accumulator does."""
    acc = x.float().clone()
    for t in range(w.shape[0]):
        acc = acc + stage_plain(x, w[t], mode)
    return acc


def _check(x: torch.Tensor, w: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"micro_tile: unknown mode {mode!r}, one of {MODES}")
    if x.dim() != 2 or w.dim() != 3 or x.shape[0] != ROWS:
        raise ValueError(f"micro_tile: x (8, D) and w (T, D, D), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    d = x.shape[1]
    if tuple(w.shape[1:]) != (d, d):
        raise ValueError(f"micro_tile: w must be (T, {d}, {d}), got {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.int8:
        raise TypeError(f"micro_tile: x must be f32 and w int8, got {x.dtype}, {w.dtype}")


def micro_tile_cuda(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch the CUDA kernel: the tile pass and its fixed-order reduction."""
    _check(x, w, mode)
    n_tiles, d, _ = w.shape
    if d % COLS:
        raise ValueError(f"micro_tile: D must be a multiple of {COLS}, got {d}")
    for name, a in (("x", x), ("w", w)):
        if not a.is_cuda or a.device != x.device or not a.is_contiguous():
            raise ValueError(f"micro_tile: {name} must be contiguous on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("micro_tile: x must be 16-byte aligned (the kernel reads float4)")
    groups = -(-n_tiles // TILES_PER_BLOCK)
    partial = torch.empty((groups, ROWS, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = build.kernels()
    LAUNCHES["micro_tile"] += 1
    lib.call("vtt_micro_tile", x.data_ptr(), w.data_ptr(), partial.data_ptr(),
             out.data_ptr(), MODES.index(mode), n_tiles, d, TILES_PER_BLOCK,
             build.stream_handle(x.device))
    return out


def micro_tile(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x (8, D) f32, w (T, D, D) int8 -> (8, D) f32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (errors raise)."""
    if x.is_cuda:
        return micro_tile_cuda(x, w, mode)
    if x.device.type != "cpu":
        raise ValueError(f"micro_tile: unsupported device {x.device}")
    _check(x, w, mode)
    return micro_tile_plain(x, w, mode)


def run(x: torch.Tensor, w: torch.Tensor, mode: str, iters: int) -> torch.Tensor:
    """`iters` calls, each feeding the next: x <- 0.5 x + 1e-6 out (the JAX
    script's `run`)."""
    for _ in range(iters):
        x = x * 0.5 + micro_tile(x, w, mode) * 1e-6
    return x

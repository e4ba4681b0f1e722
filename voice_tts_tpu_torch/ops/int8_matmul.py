"""int8 weight-only GEMV for a few rows, K4.

`y = (x @ W) * scale`, W (D, F) int8 in the JAX (in, out) layout with a
per-output-column scale (1, F) f32, f32 accumulation, output in x's dtype
(`voice_tts_tpu/ops/int8_matmul.py`).  `Conv1DGPT` routes int8 products of
at most 32 rows here.

- `int8_gemv_plain`: PyTorch ops (CPU; the reference on the card);
- `int8_gemv_split_plain`: the same function summed as the kernel cuts it
  (split partials added in split order), for the tests;
- `plan_int8_gemv`: the kernel's grid: 128-column stripes, slabs of at
  most 8 rows of x, and the contraction split so that every shape launches
  at least two blocks an SM of the H100 (132 SMs);
- `csrc/int8_gemv.cu`: the hand-written kernel (a cp.async weight stream
  over the split contraction, then a fixed-order sum of the split partials
  that writes x's dtype), launched for CUDA tensors: two launches a call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES

MAX_ROWS = 32
COLS = 128            # output columns a block owns
CHUNK = 32            # weight rows a pipeline stage holds
MAX_SPLIT_ROWS = 1024
MIN_BLOCKS = 2 * 132  # two blocks an SM of the H100


class Int8GemvPlan(NamedTuple):
    slab: int          # rows of x a block takes (1, 2, 4 or 8)
    slabs: int
    stripes: int       # 128-column stripes
    splits: int        # contraction slices
    split_rows: int    # contraction rows a slice (the last one shorter)
    partial_numel: int  # f32 workspace: (splits, N, F)

    @property
    def blocks(self) -> int:
        return self.slabs * self.stripes * self.splits


def plan_int8_gemv(n: int, d: int, f: int) -> Int8GemvPlan:
    """The K4 grid for x (n, d) @ W (d, f): as many contraction slices of
    whole 32-row chunks as it takes for MIN_BLOCKS blocks (fewer only when
    D has too few chunks), at most MAX_SPLIT_ROWS rows a slice."""
    slab = next(s for s in (1, 2, 4, 8) if n <= s or s == 8)
    slabs = -(-n // slab)
    stripes = -(-f // COLS)
    chunks = -(-d // CHUNK)
    want = -(-MIN_BLOCKS // (stripes * slabs))
    per = min(max(1, chunks // want), MAX_SPLIT_ROWS // CHUNK)
    splits = -(-chunks // per)
    return Int8GemvPlan(slab, slabs, stripes, splits, per * CHUNK, splits * n * f)


def int8_gemv_plain(x: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x (N, D); w_q (D, F) int8; scale (1, F) or (F,) f32 -> (N, F) x.dtype.

    int8 -> x.dtype is exact (|q| <= 127), products accumulate in f32."""
    y = x.float() @ w_q.to(x.dtype).float()
    return (y * scale.reshape(1, -1).float()).to(x.dtype)


def int8_gemv_split_plain(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """`int8_gemv_plain` summed as the kernel cuts it: one f32 partial a
    contraction slice of `plan_int8_gemv`, added in slice order, then the
    scale and the cast to x's dtype."""
    n, d = x.shape
    plan = plan_int8_gemv(n, d, w_q.shape[1])
    xf, wf = x.float(), w_q.to(x.dtype).float()
    acc = None
    for s in range(plan.splits):
        sl = slice(s * plan.split_rows, min(d, (s + 1) * plan.split_rows))
        part = xf[:, sl] @ wf[sl]
        acc = part if acc is None else acc + part
    return (acc * scale.reshape(1, -1).float()).to(x.dtype)


def int8_gemv_cuda(x: torch.Tensor, w_q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError("int8_gemv: x must be (N, D) and w_q (D, F)")
    n, d = x.shape
    f = w_q.shape[1]
    if w_q.shape[0] != d or scale.numel() != f:
        raise ValueError(f"int8_gemv: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"int8_gemv: 1 <= N <= {MAX_ROWS} rows, got {n}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_gemv: x must be bf16 or f32, got {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("int8_gemv: w_q must be int8 and scale float32")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"int8_gemv: {name} must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_gemv: {name} must be contiguous")
    if f % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_gemv: F must be a multiple of 16 and w_q 16-byte aligned")
    plan = plan_int8_gemv(n, d, f)
    partial = torch.empty(plan.partial_numel, dtype=torch.float32, device=x.device)
    out = torch.empty((n, f), dtype=x.dtype, device=x.device)
    lib = build.kernels()
    LAUNCHES["int8_gemv"] += 1
    lib.call("vtt_int8_gemv", x.data_ptr(), int(x.dtype == torch.bfloat16),
             w_q.data_ptr(), scale.data_ptr(), partial.data_ptr(), out.data_ptr(),
             n, d, f, plan.slab, plan.split_rows, plan.splits,
             build.stream_handle(x.device))
    return out


def int8_gemv(x: torch.Tensor, w_q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x (N <= 32, D); w_q (D, F) int8; scale (1, F) f32 -> (N, F) x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.is_cuda:
        return int8_gemv_cuda(x.contiguous(), w_q, scale.reshape(-1).float())
    if x.device.type != "cpu":
        raise ValueError(f"int8_gemv: unsupported device {x.device}")
    return int8_gemv_plain(x, w_q, scale)

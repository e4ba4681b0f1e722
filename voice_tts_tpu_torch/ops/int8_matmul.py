"""int8 weight-only GEMV for a few rows, K4.

`y = (x @ W) * scale`, W (D, F) int8 in the JAX (in, out) layout with a
per-output-column scale (1, F) f32, f32 accumulation, output in x's dtype
(`voice_tts_tpu/ops/int8_matmul.py`).  `Conv1DGPT` routes int8 products of
at most 32 rows here.

- `int8_gemv_plain`: PyTorch ops (CPU; the reference on the card);
- `csrc/int8_gemv.cu`: the hand-written kernel, launched for CUDA tensors.
"""

from __future__ import annotations

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES

MAX_ROWS = 32


def int8_gemv_plain(x: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x (N, D); w_q (D, F) int8; scale (1, F) or (F,) f32 -> (N, F) x.dtype.

    int8 -> x.dtype is exact (|q| <= 127), products accumulate in f32."""
    y = x.float() @ w_q.to(x.dtype).float()
    return (y * scale.reshape(1, -1).float()).to(x.dtype)


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
    if f % 4 or w_q.data_ptr() % 4:
        raise ValueError("int8_gemv: F must be a multiple of 4 and w_q 4-byte aligned")
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    lib = build.kernels()
    LAUNCHES["int8_gemv"] += 1
    lib.call("vtt_int8_gemv", x.data_ptr(), int(x.dtype == torch.bfloat16),
             w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, f,
             build.stream_handle(x.device))
    return out.to(x.dtype)


def int8_gemv(x: torch.Tensor, w_q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x (N <= 32, D); w_q (D, F) int8; scale (1, F) f32 -> (N, F) x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.is_cuda:
        return int8_gemv_cuda(x.contiguous(), w_q, scale.reshape(-1).float())
    if x.device.type != "cpu":
        raise ValueError(f"int8_gemv: unsupported device {x.device}")
    return int8_gemv_plain(x, w_q, scale)

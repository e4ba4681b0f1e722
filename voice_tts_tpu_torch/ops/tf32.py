"""The split-TF32 arithmetic of the tensor-core kernels, in plain PyTorch.

K10 (`csrc/fused_vocoder.cu`) and the f32 DiT attention tile
(`csrc/dit_attention_tf32.cuh`) get f32-class products from the TF32 tensor
cores by splitting each f32 operand v into hi = tf32(v) and lo = tf32(v -
hi) and summing lo.hi + hi.lo + hi.hi in f32 (`mma_tf32` in
`csrc/common.cuh`).  K10 rounds both parts to nearest (`split_tf32`), the
attention tile truncates them (`split_tf32_trunc`).  Their plain split versions model that
arithmetic with these functions.
"""

from __future__ import annotations

import torch


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from zero,
    as `cvt.rna.tf32.f32`), kept in f32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor):
    """(hi, lo): hi = tf32(v), lo = tf32(v - hi)."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by dropping the 13 low mantissa bits, kept in f32."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32_trunc(v: torch.Tensor):
    """The f32 DiT attention tile's split (`split_tf32` in
    `csrc/dit_attention_tf32.cuh`): hi = tf32_trunc(v), lo = tf32_trunc(v -
    hi)."""
    hi = tf32_trunc(v)
    return hi, tf32_trunc(v - hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 as the attention tile's three TF32 passes, lo.hi + hi.lo
    + hi.hi, each operand split by `split_tf32_trunc`."""
    ah, al = split_tf32_trunc(a.float())
    bh, bl = split_tf32_trunc(b.float())
    return al @ bh + ah @ bl + ah @ bh

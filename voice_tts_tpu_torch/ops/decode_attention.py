"""Bounded-read decode attention, K5 (`voice_tts_tpu/ops/decode_attention.py`).

Single-token queries over a preallocated, time-minor KV cache that read only
the live prefix: `decode_attention(q, k_cache, v_cache, bias, length)` with
q (B, H, hd); k / v caches (B, H, hd, Tmax), bf16 or f32; bias (B, Tmax) f32
additive (-1e30 at padded prompt positions); `length` (host int) the
attendable positions.  Scores are f32 from the widened q and k, times
hd ** -0.5, plus the bias; positions at or past `length` take no part; the
softmax's f32 accumulator is divided by its sum at the end.  Returns
(B, H, hd) in q's dtype.  It runs on the unfused decode step when
`GPTConfig.pallas_decode_attention` is set (`models/gpt/gpt2.py`), whose
cache length is a multiple of BLOCK_T, as the JAX kernel requires.

- `decode_attention_plain`: PyTorch ops on the live prefix (CPU tensors, and
  the reference the kernel is checked against on the card);
- `csrc/decode_attention.cu` (`vtt_decode_attention`): the hand-written
  kernel, launched for CUDA tensors, one launch for all B rows.
"""

from __future__ import annotations

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES

BLOCK_T = 512          # the flagged decode path's cache length granularity
MAX_HEAD_DIM = 128     # the kernel's widest head


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, bias: torch.Tensor,
                           length: int) -> torch.Tensor:
    """The JAX kernel's function in PyTorch ops (see the module docstring)."""
    hd = q.shape[-1]
    s = torch.einsum("bhd,bhdt->bht", q.float(), k_cache[..., :length].float())
    s = s * (hd ** -0.5) + bias[:, None, :length].float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bht,bhdt->bhd", e, v_cache[..., :length].float())
    return (acc / e.sum(dim=-1)[..., None]).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, bias: torch.Tensor,
                          length: int) -> torch.Tensor:
    """Launch the CUDA kernel (one launch for all B rows)."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q (B, H, hd) and caches (B, H, hd, T), "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, hd = q.shape
    t_max = k_cache.shape[3]
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: q must be f32 or bf16, got {q.dtype}")
    if not 1 <= length <= t_max:
        raise ValueError(f"decode_attention: length {length} outside 1..{t_max}")
    for name, a, shape, dtype in (("k_cache", k_cache, (b, h, hd, t_max), q.dtype),
                                  ("v_cache", v_cache, (b, h, hd, t_max), q.dtype),
                                  ("bias", bias, (b, t_max), torch.float32)):
        if not a.is_cuda or a.device != q.device:
            raise ValueError(f"decode_attention: {name} must be on {q.device}")
        if a.dtype != dtype:
            raise TypeError(f"decode_attention: {name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous {shape}, "
                             f"got {tuple(a.shape)}")
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = build.kernels()
    LAUNCHES["decode_attention"] += 1
    lib.call("vtt_decode_attention", q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), bias.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), b, h, hd, t_max, int(length),
             float(hd ** -0.5), build.stream_handle(q.device))
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     bias: torch.Tensor, length: int) -> torch.Tensor:
    """q (B, H, hd); caches (B, H, hd, Tmax); bias (B, Tmax) f32; `length`
    attendable positions -> (B, H, hd) in q's dtype.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (errors raise)."""
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, bias, length)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode_attention_plain(q, k_cache, v_cache, bias, length)

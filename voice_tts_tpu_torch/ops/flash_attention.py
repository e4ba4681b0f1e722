"""Segment-id-masked DiT self-attention, K11: what
`jax.experimental.pallas.ops.tpu.flash_attention` computes as the DiT calls it
(`voice_tts_tpu/models/s2mel/dit.py:122-148`): non-causal, no bias, with
segment ids, query i of row b sees key j only where q_seg[b, i] ==
kv_seg[b, j], scores times `sm_scale`.

`flash_attention(q, k, v, q_seg, kv_seg, sm_scale)`: q, k, v (B, H, T, hd)
f32 or bf16; q_seg, kv_seg (B, T) int.  Returns v's dtype.

The DiT call site pads T to a multiple of 128 for the TPU's block sizes; the
kernel masks its own ragged edge, so the port's DiT does not pad (only query
rows >= x_lens change, which nothing reads).

- `flash_attention_ref`: PyTorch ops after jax's own `mha_reference` in
  that module (mask added as `-0.7 * float32 max`), with f32 scores from the
  f32-widened q and k and p cast to v's dtype before an f32 PV product;
- `csrc/dit_attention.cu` (`vtt_flash_attention`): the hand-written
  kernel, launched for CUDA tensors (the K9 device code with the segment
  mask: bf16 `csrc/dit_attention_mma.cuh`, f32 `csrc/dit_attention.cuh`).
"""

from __future__ import annotations

import ctypes

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.cfm_attention import check_qkv, softmax_pv, strides_arg
from voice_tts_tpu_torch.ops.counters import LAUNCHES

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_seg: torch.Tensor, kv_seg: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """The function of jax's flash_attention with segment ids, in PyTorch ops."""
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    mask = q_seg.to(q.device)[:, :, None] == kv_seg.to(q.device)[:, None, :]
    s = s + torch.where(mask, 0.0, MASK_VALUE)[:, None, :, :]
    return softmax_pv(s, v)


def flash_attention_cuda(q, k, v, q_seg, kv_seg, sm_scale: float) -> torch.Tensor:
    check_qkv("flash_attention", q, k, v)
    b, h, t, _ = q.shape
    segs = [s.to(device=q.device, dtype=torch.int32).contiguous() for s in (q_seg, kv_seg)]
    if any(s.shape != (b, t) for s in segs):
        raise ValueError(f"flash_attention: segment ids must be ({b}, {t})")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = strides_arg(q, k, v, out)
    lib = build.kernels()
    LAUNCHES["flash_attention"] += 1
    lib.call("vtt_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), ctypes.addressof(strides), segs[0].data_ptr(),
             segs[1].data_ptr(), int(q.dtype == torch.bfloat16), b, h, t,
             float(sm_scale), build.stream_handle(q.device))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_seg: torch.Tensor, kv_seg: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """q, k, v (B, H, T, hd); q_seg, kv_seg (B, T) -> (B, H, T, hd).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, q_seg, kv_seg, sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, q_seg, kv_seg, sm_scale)

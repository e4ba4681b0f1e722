"""Key-length-masked DiT self-attention, K9
(`voice_tts_tpu/ops/attic/cfm_attention.py`).

`cfm_attention(q, k, v, lens, scale)`: q, k, v (B, H, T, hd) f32 or bf16;
lens (B,) the valid KEY count of each row.  Scores are f32 from the
f32-widened q and k, times `scale`; keys at col >= lens[b] get -1e30;
softmax in f32; p is cast to v's dtype before the PV product, which
accumulates in f32.  Returns v's dtype.  Rows at query positions >= lens are
well-defined junk (the caller masks them), as in the JAX kernel.

The JAX kernel sits in `ops/attic/` because it lost its A/B against XLA on a
TPU; that verdict is a TPU measurement, so the port keeps it under `ops/`.

- `cfm_attention_ref`: PyTorch ops (CPU; the reference on the card);
- `csrc/dit_attention.cu` (`vtt_cfm_attention`): the hand-written kernel,
  launched for CUDA tensors, one flash tile on the tensor cores for each
  type (both copy 16-byte chunks of each row: see `check_qkv`):
  - bf16: `csrc/dit_attention_mma.cuh`, mma.sync m16n8k16 bf16, the
    probabilities rounded to bf16 before PV;
  - f32: `csrc/dit_attention_tf32.cuh`, mma.sync m16n8k8 tf32 in three
    passes: each f32 operand split into hi = tf32(v) and lo = tf32(v - hi)
    (TF32 by truncation), a product summing lo.hi + hi.lo + hi.hi in f32
    (f32-class numerics),
    for Q K^T and for P V with the unnormalized probabilities in f32.  Its
    bound is three TF32 passes of 4 * T_attended * hd operations a (query,
    head) at 495 TFLOP/s;
- `cfm_attention_split_plain`: the f32 tile's arithmetic in PyTorch ops
  (`attention_split_plain`: the split products of `ops/tf32.py` and the
  online softmax over 64-key tiles, K9's key loop stopping at
  ceil(lens[b] / 64) tiles), the CPU model the tests hold against the JAX
  kernel.
"""

from __future__ import annotations

import ctypes

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES
from voice_tts_tpu_torch.ops.tf32 import split_matmul

HEAD_DIM = 64      # the kernel's head width (the DiT's 512 / 8)
KEY_TILE = 64      # keys a tile of the kernels' online softmax
_NEG = -1e30


def softmax_pv(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f32 softmax of masked scores (B, H, T, T), p cast to v's dtype, PV
    accumulated in f32; returns v's dtype."""
    p = torch.softmax(scores, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(v.dtype)


def cfm_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lens: torch.Tensor, scale: float) -> torch.Tensor:
    """The JAX kernel's function in PyTorch ops (see the module docstring)."""
    t = q.shape[2]
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    col = torch.arange(t, device=q.device)
    keep = col[None, :] < lens.to(q.device)[:, None]               # (B, T) keys
    s = torch.where(keep[:, None, None, :], s, _NEG)
    return softmax_pv(s, v)


def attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_tile, n_tiles, scale: float) -> torch.Tensor:
    """The f32 tensor-core tile's arithmetic in PyTorch ops: for each batch
    row b, its first n_tiles[b] 64-key tiles in order, scores from the
    three-pass split product (`split_matmul`) times `scale`, masked by
    `mask_tile(b, k0, s)`, an online softmax (f32 running max and sum, the
    max of an all -inf start guarded), and PV from the split product of the
    unnormalized f32 probabilities; the output divided by the sum at the
    end.  q, k, v (B, H, T, hd) f32 -> (B, H, T, hd) f32."""
    t = q.shape[2]
    rows = []
    for b in range(q.shape[0]):
        qb = q[b].float()
        m = torch.full(qb.shape[:2] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        o = torch.zeros_like(qb)
        for k0 in range(0, min(t, n_tiles[b] * KEY_TILE), KEY_TILE):
            kt, vt = k[b, :, k0:k0 + KEY_TILE].float(), v[b, :, k0:k0 + KEY_TILE].float()
            s = mask_tile(b, k0, split_matmul(qb, kt.transpose(-1, -2)) * scale)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            mu = torch.where(mn == float("-inf"), 0.0, mn)
            alpha = torch.exp(m - mu)
            p = torch.exp(s - mu)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + split_matmul(p, vt)
            m = mn
        rows.append(o / l)
    return torch.stack(rows)


def key_tiles(t: int, lens) -> list:
    """The 64-key tiles K9's kernel walks for each row: ceil(lens[b] / 64)
    when lens[b] >= 1, else every tile of T (the uniform row)."""
    every = -(-t // KEY_TILE)
    return [min(every, -(-n // KEY_TILE)) if n >= 1 else every for n in lens]


def cfm_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              lens: torch.Tensor, scale: float) -> torch.Tensor:
    """K9's f32 tensor-core tile in PyTorch ops (`attention_split_plain`):
    keys at col >= lens[b] get -1e30; the key loop stops at ceil(lens[b] /
    64) tiles.  f32 q, k, v on the CPU."""
    lens = [int(n) for n in lens]

    def mask_tile(b, k0, s):
        col = torch.arange(k0, k0 + s.shape[-1])
        return torch.where(col < lens[b], s, _NEG)
    return attention_split_plain(q, k, v, mask_tile, key_tiles(q.shape[2], lens), scale)


def check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise unless q, k, v are (B, H, T, 64) CUDA tensors of one dtype (f32
    or bf16) on one device with a contiguous head dim and int32 strides,
    with 16-byte-aligned bases and (batch, head, time) strides in multiples
    of 16 bytes (8 bf16 or 4 f32 elements), since both tensor-core tiles
    copy each row in 16-byte chunks (the wrappers' contiguous outputs and
    the DiT's q, k, v meet that)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must be equal (B, H, T, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head width {HEAD_DIM}, got {q.shape[-1]}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be f32 or bf16, got {q.dtype}")
    for n, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != q.dtype:
            raise TypeError(f"{name}: {n} is {a.dtype}, q is {q.dtype}")
        if not a.is_cuda or a.device != q.device:
            raise ValueError(f"{name}: {n} must be on {q.device}")
        if a.stride(-1) != 1:
            raise ValueError(f"{name}: {n} needs a contiguous head dim")
        if sum((n - 1) * s for n, s in zip(a.shape, a.stride())) >= 2 ** 31:
            raise ValueError(f"{name}: {n} is too large for int32 offsets")
        per16 = 16 // a.element_size()
        if a.data_ptr() % 16 or any(s % per16 for d, s in zip(a.shape[:3], a.stride()[:3])
                                    if d > 1):
            raise ValueError(f"{name}: {n} needs a 16-byte-aligned base and strides in "
                             f"multiples of {per16} ({str(a.dtype).split('.')[-1]}), got "
                             f"offset {a.data_ptr() % 16} B, strides {a.stride()}")


def strides_arg(*tensors: torch.Tensor):
    """The (batch, head, time) element strides of each tensor, as the host
    int array the C entries take (kept alive by the caller)."""
    vals = [s for a in tensors for s in a.stride()[:3]]
    return (ctypes.c_int * len(vals))(*vals)


def cfm_attention_cuda(q, k, v, lens, scale: float) -> torch.Tensor:
    check_qkv("cfm_attention", q, k, v)
    b, h, t, _ = q.shape
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"cfm_attention: lens must be ({b},), got {tuple(lens.shape)}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = strides_arg(q, k, v, out)
    lib = build.kernels()
    LAUNCHES["cfm_attention"] += 1
    lib.call("vtt_cfm_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), ctypes.addressof(strides), lens.data_ptr(),
             int(q.dtype == torch.bfloat16), b, h, t, float(scale),
             build.stream_handle(q.device))
    return out


def cfm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lens: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v (B, H, T, hd); lens (B,) valid key counts -> (B, H, T, hd).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.is_cuda:
        return cfm_attention_cuda(q, k, v, lens, scale)
    if q.device.type != "cpu":
        raise ValueError(f"cfm_attention: unsupported device {q.device}")
    return cfm_attention_ref(q, k, v, lens, scale)

"""Bounded-read decode attention, K5 (`voice_tts_tpu/ops/decode_attention.py`).

Single-token queries over a preallocated, time-minor KV cache that read only
the live prefix: `decode_attention(q, k_cache, v_cache, bias, length)` with
q (B, H, hd); k / v caches (B, H, hd, Tmax), bf16 or f32; bias (B, Tmax) f32
additive (-1e30 at padded prompt positions); `length` the attendable
positions, a host int or a 0-d integer tensor on q's device (a device
loop's, which no host code reads: JAX prefetches it as a traced scalar).
Scores are f32 from the widened q and k, times hd ** -0.5, plus the bias;
positions at or past `length` take no part; the softmax's f32 accumulator
is divided by its sum at the end.  Returns (B, H, hd) in q's dtype.  It
runs on the unfused decode step when `GPTConfig.pallas_decode_attention` is
set (`models/gpt/gpt2.py`), whose cache length is a multiple of BLOCK_T, as
the JAX kernel requires.

- `decode_attention_plain`: PyTorch ops on the live prefix, which a tensor
  length masks (CPU tensors, and the reference the kernel is checked
  against on the card);
- `plan_decode_splits`: the kernel's split of the live prefix (of the
  whole cache for a tensor length);
- `decode_attention_split_plain`: the kernel's decomposition in PyTorch ops,
  each split's (o, m, l) and their combine in split order (the CPU model of
  the kernel's order);
- `csrc/decode_attention.cu` (`vtt_decode_attention`): the hand-written
  kernel, launched for CUDA tensors, one launch for all B rows: one block a
  (head, row, split), the splits combined by the last block of a (row,
  head) to arrive.  With a tensor length the kernel reads it from device
  memory and its grid is the fixed plan of the whole cache: the blocks past
  the length only arrive, and the combine takes the live splits alone.  Its
  workspace and arrival counters (`split_workspace`) are kept per device
  and shape and reused by every call, so calls on one device are
  stream-ordered (the decode step runs on one stream).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES

BLOCK_T = 512          # the flagged decode path's cache length granularity
MAX_HEAD_DIM = 128     # the kernel's widest head
SPLIT_MIN, SPLIT_MAX = 32, 512   # positions a block: powers of two in between
# four blocks a streaming multiprocessor of the H100: on the card, B 3 at
# length 1571 ran fastest at 420 blocks (256 positions a split), a fifth
# under 240 blocks of 512 (`chip_smoke.py`'s width sweep)
MAX_BLOCKS = 4 * 132


Length = Union[int, torch.Tensor]


@functools.lru_cache(maxsize=4096)
def plan_decode_splits(b: int, h: int, length: int):
    """(split width, splits) of the kernel's grid, one block a (head, row,
    split) of the live prefix [0, length): the narrowest power of two in
    SPLIT_MIN..SPLIT_MAX positions that keeps b * h * splits at or under
    MAX_BLOCKS, or SPLIT_MAX.  At 20 heads: B 1, length 343, 11 splits of 32
    (220 blocks); B 3, length 1571, 7 of 256 (420).  A length on the device
    takes the plan of length Tmax, fixed for the cache."""
    width = SPLIT_MIN
    while width < SPLIT_MAX and b * h * -(-length // width) > MAX_BLOCKS:
        width *= 2
    return width, -(-length // width)


def _split_plan(b: int, h: int, t_max: int, length: Length):
    """The kernel's (split width, splits) for `length`: its own plan for a
    host int, the fixed plan of the whole cache for a tensor."""
    if isinstance(length, torch.Tensor):
        return plan_decode_splits(b, h, t_max)
    return plan_decode_splits(b, h, int(length))


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, bias: torch.Tensor,
                                 length: Length, split_t: Optional[int] = None
                                 ) -> torch.Tensor:
    """The kernel's decomposition in PyTorch ops: per split of `split_t`
    positions of [0, length), its max m, p = exp(s - m), l = sum p and o =
    p . v; then the largest m, M, and l = sum_s l_s e^(m_s - M), o = sum_s
    o_s e^(m_s - M) in split order; o / l in q's dtype.  Without `split_t`,
    the kernel's plan (`_split_plan`: a tensor length, read here, takes the
    fixed plan of the cache, whose splits past the length the kernel skips
    in the combine)."""
    hd = q.shape[-1]
    if split_t is None:
        split_t, _ = _split_plan(q.shape[0], q.shape[1], k_cache.shape[3], length)
    length = int(length)
    parts = []
    for t0 in range(0, length, split_t):
        t1 = min(t0 + split_t, length)
        s = torch.einsum("bhd,bhdt->bht", q.float(), k_cache[..., t0:t1].float())
        s = s * (hd ** -0.5) + bias[:, None, t0:t1].float()
        m = s.amax(dim=-1)
        e = torch.exp(s - m[..., None])
        parts.append((torch.einsum("bht,bhdt->bhd", e, v_cache[..., t0:t1].float()),
                      m, e.sum(dim=-1)))
    mx = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    o, l = 0.0, 0.0
    for o_s, m_s, l_s in parts:
        c = torch.exp(m_s - mx)
        l = l + l_s * c
        o = o + o_s * c[..., None]
    return (o / l[..., None]).to(q.dtype)


_WORKSPACE: dict = {}


def split_workspace(dev: torch.device, b: int, h: int, hd: int, splits: int):
    """The kernel's f32 scratch, (B, H, splits, hd + 2) each split's o, m
    and l, and its (B, H) int32 arrival counters, one pair per (device, B,
    H, hd, splits), allocated on first use and never freed: each launch
    leaves the counters at zero, and a graph that captured a launch keeps
    reading the same pair.  A first use inside a capture would take the
    pair from the graph's pool, so it raises: the capture's op-by-op warm-up
    allocates it."""
    key = (dev, b, h, hd, splits)
    pair = _WORKSPACE.get(key)
    if pair is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"decode_attention: workspace {key} first asked for "
                               "inside a CUDA graph capture")
        pair = (torch.empty(b * h * splits * (hd + 2), dtype=torch.float32, device=dev),
                torch.zeros(b * h, dtype=torch.int32, device=dev))
        _WORKSPACE[key] = pair
    return pair


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, bias: torch.Tensor,
                           length: Length) -> torch.Tensor:
    """The JAX kernel's function in PyTorch ops (see the module docstring):
    the prefix sliced at a host int, or the whole cache with the positions
    at or past a tensor length masked (no host read)."""
    hd = q.shape[-1]
    if isinstance(length, torch.Tensor):
        t_max = k_cache.shape[-1]
        live = torch.arange(t_max, device=q.device) < length
        s = torch.einsum("bhd,bhdt->bht", q.float(), k_cache.float())
        s = s * (hd ** -0.5) + bias[:, None, :].float()
        s = torch.where(live, s, float("-inf"))
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        acc = torch.einsum("bht,bhdt->bhd", e, v_cache.float())
        return (acc / e.sum(dim=-1)[..., None]).to(q.dtype)
    s = torch.einsum("bhd,bhdt->bht", q.float(), k_cache[..., :length].float())
    s = s * (hd ** -0.5) + bias[:, None, :length].float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bht,bhdt->bhd", e, v_cache[..., :length].float())
    return (acc / e.sum(dim=-1)[..., None]).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, bias: torch.Tensor,
                          length: Length, split_t: int = None) -> torch.Tensor:
    """Launch the CUDA kernel (one launch for all B rows, its grid from
    `_split_plan` unless `split_t`, a power of two in 32..512, is given).
    A tensor `length` (0-d or one element, integer, on q's device) stays on
    the device: the kernel reads it and clamps it to [1, Tmax]."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q (B, H, hd) and caches (B, H, hd, T), "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, hd = q.shape
    t_max = k_cache.shape[3]
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: q must be f32 or bf16, got {q.dtype}")
    on_device = isinstance(length, torch.Tensor)
    if on_device:
        if (length.numel() != 1 or length.device != q.device
                or length.dtype.is_floating_point or length.dtype == torch.bool):
            raise ValueError(f"decode_attention: a tensor length must be one integer "
                             f"on {q.device}")
    elif not 1 <= length <= t_max:
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
    per_vec = 16 // q.element_size()
    if t_max % per_vec or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"decode_attention: the caches are read in 16-byte vectors: "
                         f"Tmax a multiple of {per_vec} and 16-byte-aligned bases")
    q = q.contiguous()
    out = torch.empty_like(q)
    if split_t is None:
        split_t, splits = _split_plan(b, h, t_max, length)
    elif split_t not in (32, 64, 128, 256, 512):
        raise ValueError(f"decode_attention: split width {split_t} not a power of "
                         f"two in {SPLIT_MIN}..{SPLIT_MAX}")
    else:
        splits = -(-(t_max if on_device else int(length)) // split_t)
    work, arrivals = split_workspace(q.device, b, h, hd, splits)
    len_dev = length.reshape(1).to(torch.int32) if on_device else None
    lib = build.kernels()
    LAUNCHES["decode_attention"] += 1
    lib.call("vtt_decode_attention", q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), bias.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), b, h, hd, t_max,
             0 if on_device else int(length),
             len_dev.data_ptr() if on_device else None, splits,
             float(hd ** -0.5), split_t, work.data_ptr(), arrivals.data_ptr(),
             build.stream_handle(q.device))
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     bias: torch.Tensor, length: Length) -> torch.Tensor:
    """q (B, H, hd); caches (B, H, hd, Tmax); bias (B, Tmax) f32; `length`
    attendable positions, a host int or a 0-d integer tensor on the device
    -> (B, H, hd) in q's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (errors raise)."""
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, bias, length)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode_attention_plain(q, k_cache, v_cache, bias, length)

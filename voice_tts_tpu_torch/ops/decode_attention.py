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
- `plan_decode_splits`: the kernel's split of the live prefix;
- `decode_attention_split_plain`: the kernel's decomposition in PyTorch ops,
  each split's (o, m, l) and their combine in split order (the CPU model of
  the kernel's order);
- `csrc/decode_attention.cu` (`vtt_decode_attention`): the hand-written
  kernel, launched for CUDA tensors, one launch for all B rows: one block a
  (head, row, split), the splits combined by the last block of a (row,
  head) to arrive.  Its workspace and arrival counters are kept per device
  and reused by every call, so calls on one device are stream-ordered (the
  decode step runs on one stream).
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=4096)
def plan_decode_splits(b: int, h: int, length: int):
    """(split width, splits) of the kernel's grid, one block a (head, row,
    split) of the live prefix [0, length): the narrowest power of two in
    SPLIT_MIN..SPLIT_MAX positions that keeps b * h * splits at or under
    MAX_BLOCKS, or SPLIT_MAX.  At 20 heads: B 1, length 343, 11 splits of 32
    (220 blocks); B 3, length 1571, 7 of 256 (420)."""
    width = SPLIT_MIN
    while width < SPLIT_MAX and b * h * -(-length // width) > MAX_BLOCKS:
        width *= 2
    return width, -(-length // width)


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, bias: torch.Tensor,
                                 length: int, split_t: int) -> torch.Tensor:
    """The kernel's decomposition in PyTorch ops: per split of `split_t`
    positions of [0, length), its max m, p = exp(s - m), l = sum p and o =
    p . v; then the largest m, M, and l = sum_s l_s e^(m_s - M), o = sum_s
    o_s e^(m_s - M) in split order; o / l in q's dtype."""
    hd = q.shape[-1]
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
    and l, and its (B, H) int32 arrival counters, kept per device: each
    launch leaves the counters at zero, so they are zeroed only when they
    grow."""
    work, arrivals = _WORKSPACE.get(dev, (None, None))
    if work is None or work.numel() < b * h * splits * (hd + 2):
        work = torch.empty(b * h * splits * (hd + 2), dtype=torch.float32, device=dev)
    if arrivals is None or arrivals.numel() < b * h:
        arrivals = torch.zeros(b * h, dtype=torch.int32, device=dev)
    _WORKSPACE[dev] = (work, arrivals)
    return work, arrivals


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
                          length: int, split_t: int = None) -> torch.Tensor:
    """Launch the CUDA kernel (one launch for all B rows, its grid from
    `plan_decode_splits` unless `split_t`, a power of two in 32..512, is
    given)."""
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
    per_vec = 16 // q.element_size()
    if t_max % per_vec or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"decode_attention: the caches are read in 16-byte vectors: "
                         f"Tmax a multiple of {per_vec} and 16-byte-aligned bases")
    q = q.contiguous()
    out = torch.empty_like(q)
    if split_t is None:
        split_t, splits = plan_decode_splits(b, h, int(length))
    elif split_t not in (32, 64, 128, 256, 512):
        raise ValueError(f"decode_attention: split width {split_t} not a power of "
                         f"two in {SPLIT_MIN}..{SPLIT_MAX}")
    else:
        splits = -(-int(length) // split_t)
    work, arrivals = split_workspace(q.device, b, h, hd, splits)
    lib = build.kernels()
    LAUNCHES["decode_attention"] += 1
    lib.call("vtt_decode_attention", q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), bias.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), b, h, hd, t_max, int(length),
             float(hd ** -0.5), split_t, work.data_ptr(), arrivals.data_ptr(),
             build.stream_handle(q.device))
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

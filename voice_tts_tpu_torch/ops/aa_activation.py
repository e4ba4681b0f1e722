"""Anti-aliased snake activation (BigVGAN AMP activation), K2.

`2x upsample (12-tap kaiser-sinc) -> snake-beta -> 2x low-pass downsample`
in polyphase form, as in `voice_tts_tpu/ops/aa_activation.py`:

    u_even[t] = 2 * sum_a h[2a+1] * x_ext[t + 5 - a]        (a = 0..5)
    u_odd[t]  = 2 * sum_a h[2a]   * x_ext[t + 6 - a]
    z_even    = snake(u_even),  z_odd = snake(u_odd)
    out[t]    = sum_b h[2b+1] * ze_ext[t + b + 1]
              + sum_b h[2b]   * zo_ext[t + b]               (b = 0..5)

with x_ext = x replicate-padded (3 left, 4 right) and the phases extended by
3 on each side (left pads take z_even[0], right pads take z_odd[-1]).

Two implementations of the same function:

- `aa_snake_plain`: PyTorch ops (CPU tensors, and the reference the kernel
  is checked against on the card);
- the hand-written CUDA kernel `csrc/aa_snake.cu`, launched by
  `aa_snake_activation` for every CUDA tensor, with the launch parameters
  of `plan_aa_snake`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from voice_tts_tpu_torch.ops import build
from voice_tts_tpu_torch.ops.counters import LAUNCHES


def kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass (sum-normalized), identical to the JAX
    package's filter (reference `alias_free_activation/torch/filter.py`)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


_FILTER12 = kaiser_sinc_filter(0.25, 0.3, 12)  # the ratio=2 filter
_H_ODD = [float(v) for v in _FILTER12[1::2]]    # h[1], h[3], ..., h[11]
_H_EVEN = [float(v) for v in _FILTER12[0::2]]   # h[0], h[2], ..., h[10]
# the taps as the kernels take them (K2, and K10's AA prologue): odd, then even
TAPS_HOST = np.ascontiguousarray(np.concatenate(
    [_FILTER12[1::2], _FILTER12[0::2]]).astype(np.float32))


def _snake(u, alpha, beta_recip):
    s = torch.sin(u * alpha)
    return u + beta_recip * s * s


def aa_snake_plain(x: torch.Tensor, alpha: torch.Tensor,
                   beta_recip: torch.Tensor) -> torch.Tensor:
    """x (B, C, T) f32 -> (B, C, T); alpha / beta_recip (C,)."""
    t_len = x.shape[-1]
    x_ext = torch.cat([x[..., :1].expand(*x.shape[:-1], 3), x,
                       x[..., -1:].expand(*x.shape[:-1], 4)], dim=-1)
    a = alpha[None, :, None]
    br = beta_recip[None, :, None]

    def phase(taps, offset):
        acc = None
        for k, tap in enumerate(taps):
            sl = x_ext[..., offset - k:offset - k + t_len]
            acc = sl * tap if acc is None else acc + sl * tap
        return acc

    z_e = _snake(2.0 * phase(_H_ODD, 5), a, br)
    z_o = _snake(2.0 * phase(_H_EVEN, 6), a, br)
    left = z_e[..., :1].expand(*z_e.shape[:-1], 3)
    right = z_o[..., -1:].expand(*z_o.shape[:-1], 3)
    ze_ext = torch.cat([left, z_e, right], dim=-1)
    zo_ext = torch.cat([left, z_o, right], dim=-1)
    acc = None
    for b in range(6):
        term = (ze_ext[..., b + 1:b + 1 + t_len] * _H_ODD[b]
                + zo_ext[..., b:b + t_len] * _H_EVEN[b])
        acc = term if acc is None else acc + term
    return acc


def aa_snake_zero_plain(x: torch.Tensor, alpha: torch.Tensor,
                        beta_recip: torch.Tensor) -> torch.Tensor:
    """The AA-snake of x (1, C, T) taken as zero outside [0, T), as K10
    (`ops/fused_vocoder.py`) computes it: the phases at -3 .. T+2 from the
    zero-extended signal (not masked), the output on [0, T).
    u_e[u] = 2 sum_a h_odd[a] x[u+2-a], u_o[u] = 2 sum_a h_even[a] x[u+3-a];
    out[t] = sum_b h_odd[b] z_e[t-2+b] + sum_b h_even[b] z_o[t-3+b]."""
    t = x.shape[-1]
    xp = torch.nn.functional.pad(x, (6, 6))    # xp[p] = x[p - 6]
    n = t + 6                                  # phases u = -3 + q

    def mac(taps, off):
        acc = None
        for a, tap in enumerate(taps):
            s = 3 + off - a
            term = xp[..., s:s + n] * tap
            acc = term if acc is None else acc + term
        return acc

    a, br = alpha.reshape(1, -1, 1), beta_recip.reshape(1, -1, 1)
    ze = _snake(2.0 * mac(_H_ODD, 2), a, br)
    zo = _snake(2.0 * mac(_H_EVEN, 3), a, br)

    def mac2(z, taps, off):
        acc = None
        for b, tap in enumerate(taps):
            term = z[..., off + b:off + b + t] * tap
            acc = term if acc is None else acc + term
        return acc
    return mac2(ze, _H_ODD, 1) + mac2(zo, _H_EVEN, 0)


class AASnakePlan(NamedTuple):
    """K2's launch: one block of `threads` a (row, tile of `tile` outputs)."""

    tile: int      # outputs a block: 512, 1024 or 2048
    threads: int   # tile / 8: two runs of 4 outputs a thread
    tiles: int     # blocks along T
    vec: bool      # 16-byte loads and stores (T % 4 == 0); else scalar
    smem: int      # dynamic shared memory, bytes: x (tile + 16), two phases (tile + 8)


def plan_aa_snake(rows: int, t: int) -> AASnakePlan:
    """The launch for `rows` rows of `t` samples: the smallest tile of 512,
    1024 or 2048 outputs that holds the row, else 2048 (8 outputs a
    thread); 16-byte vectors where every row starts on a 16-byte boundary.
    The C entry refuses any other tile."""
    if rows < 1 or rows > 65535 or t < 1:
        raise ValueError(f"aa_snake: unsupported shape (rows {rows}, T {t})")
    tile = next((n for n in (512, 1024) if t <= n), 2048)
    return AASnakePlan(tile, tile // 8, -(-t // tile), t % 4 == 0, 4 * (3 * tile + 32))


def aa_snake_cuda(x: torch.Tensor, alpha: torch.Tensor,
                  beta_recip: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (f32, contiguous, all on one CUDA device)."""
    if x.dim() != 3:
        raise ValueError(f"aa_snake: x must be (B, C, T), got {tuple(x.shape)}")
    b, c, t = x.shape
    args = (("x", x, (b, c, t)), ("alpha", alpha, (c,)), ("beta_recip", beta_recip, (c,)))
    for name, tensor, shape in args:
        if tensor.dtype != torch.float32:
            raise TypeError(f"aa_snake: {name} must be float32, got {tensor.dtype}")
        if tuple(tensor.shape) != shape or not tensor.is_contiguous():
            raise ValueError(f"aa_snake: {name} must be contiguous {shape}")
    for name, tensor, _ in args:
        if tensor.device != x.device or not tensor.is_cuda:
            raise ValueError(f"aa_snake: {name} must be on a CUDA device, with x ({x.device})")
    plan = plan_aa_snake(b * c, t)
    out = torch.empty_like(x)
    vec = plan.vec and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = build.kernels()
    LAUNCHES["aa_snake_activation"] += 1
    lib.call("vtt_aa_snake", x.data_ptr(), alpha.data_ptr(),
             beta_recip.data_ptr(), out.data_ptr(), b * c, c, t, plan.tile, int(vec),
             TAPS_HOST.ctypes.data_as(ctypes.c_void_p),
             build.stream_handle(x.device))
    return out


def sin2_cuda(x: torch.Tensor) -> torch.Tensor:
    """sin^2 of a CUDA f32 tensor as both kernels compute it (`sin_mod_pi`
    in csrc/aa_math.cuh, squared): a check of its accuracy, off the
    kernels' path."""
    if x.dtype != torch.float32 or not x.is_contiguous() or not x.is_cuda or x.numel() < 1:
        raise ValueError("sin2_cuda: x must be a non-empty contiguous float32 CUDA tensor")
    out = torch.empty_like(x)
    build.kernels().call("vtt_sin2", x.data_ptr(), out.data_ptr(), x.numel(),
                         build.stream_handle(x.device))
    return out


def aa_snake_activation(x: torch.Tensor, alpha: torch.Tensor,
                        beta_recip: torch.Tensor) -> torch.Tensor:
    """Fused 2x-up -> snake -> 2x-down activation.

    x (B, C, T); alpha (C,) snake frequency (already exponentiated);
    beta_recip (C,) = 1 / (beta + 1e-9).  Computes in f32 and returns
    x's dtype.  CPU tensors take the plain PyTorch version; CUDA tensors
    always launch the kernel (errors raise, there is no fallback).
    """
    dtype = x.dtype
    xf = x.float().contiguous()
    af = alpha.float().contiguous()
    bf = beta_recip.float().contiguous()
    if x.is_cuda:
        out = aa_snake_cuda(xf, af, bf)
    elif x.device.type == "cpu":
        out = aa_snake_plain(xf, af, bf)
    else:
        raise ValueError(f"aa_snake_activation: unsupported device {x.device}")
    return out.to(dtype)

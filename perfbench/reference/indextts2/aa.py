"""The anti-aliased snake activation of BigVGAN (2x upsample with a
12-tap kaiser-sinc filter, snake-beta, 2x low-pass downsample) in polyphase
form, in plain PyTorch: a frozen copy of `aa_snake_plain` of the program's
`ops/aa_activation.py`, without its kernel."""

from __future__ import annotations

import math

import numpy as np
import torch


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


def aa_snake_activation(x: torch.Tensor, alpha: torch.Tensor,
                        beta_recip: torch.Tensor) -> torch.Tensor:
    """x (B, C, T) in f32 -> x's dtype; alpha, beta_recip (C,)."""
    out = aa_snake_plain(x.float(), alpha.float(), beta_recip.float())
    return out.to(x.dtype)

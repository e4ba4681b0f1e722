"""Polyphase windowed-sinc resampler (`voice_tts_tpu/audio/resample.py`):
torchaudio's `functional.resample` algorithm (hann-windowed sinc,
lowpass_filter_width 6, rolloff 0.99) as one strided conv."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _sinc_resample_kernel(orig_freq: int, new_freq: int,
                          lowpass_filter_width: int = 6,
                          rolloff: float = 0.99):
    """Returns (kernels (new_freq, 1, K), width, orig_freq, new_freq) after gcd."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig_freq = int(orig_freq) // gcd
    new_freq = int(new_freq) // gcd
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    tpi = t * np.pi
    scale = base_freq / orig_freq
    kernels = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernels = kernels * window * scale
    return kernels.astype(np.float32)[:, None, :], width, orig_freq, new_freq


class Resampler:
    """Fixed-rate-pair resampler for (B, T) signals on `device`."""

    def __init__(self, orig_sr: int, new_sr: int, device="cpu"):
        kernels, width, o, n = _sinc_resample_kernel(orig_sr, new_sr)
        self.orig_sr, self.new_sr = orig_sr, new_sr
        self._kernels = torch.from_numpy(kernels).to(device)
        self._width = width
        self._o, self._n = o, n

    def output_length(self, length: int) -> int:
        return int(math.ceil(self._n * length / self._o))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self._o == self._n:
            return x
        b, t = x.shape
        xp = F.pad(x, (self._width, self._width + self._o))
        y = F.conv1d(xp[:, None, :], self._kernels, stride=self._o)
        return y.transpose(1, 2).reshape(b, -1)[:, :self.output_length(t)]

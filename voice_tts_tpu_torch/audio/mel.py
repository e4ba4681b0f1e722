"""Synthesis-side log-mel spectrogram (`voice_tts_tpu/audio/mel.py`):
reflect-pad by (n_fft - hop) / 2, periodic hann, center=False frames,
magnitude sqrt(power + 1e-9), slaney mel basis, log(clamp(x, 1e-5)).
Output (B, n_mels, frames)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from voice_tts_tpu_torch.config import MelConfig
from voice_tts_tpu_torch.audio import filters
from voice_tts_tpu_torch.audio.stft import frame_power_spectrum, frame_signal


class MelSpectrogram:
    """Precomputed-constant log-mel transform on `device`."""

    def __init__(self, cfg: MelConfig, device="cpu"):
        self.cfg = cfg
        window = filters.hann_window(cfg.win_size, periodic=True)
        if cfg.win_size < cfg.n_fft:
            pad = (cfg.n_fft - cfg.win_size) // 2
            window = np.pad(window, (pad, cfg.n_fft - cfg.win_size - pad))
        cos_m, sin_m = filters.dft_matrices(cfg.n_fft, window)
        mel = filters.slaney_mel_matrix(cfg.sample_rate, cfg.n_fft, cfg.num_mels,
                                        cfg.fmin, cfg.fmax)
        self._cos = torch.from_numpy(cos_m).to(device)
        self._sin = torch.from_numpy(sin_m).to(device)
        self._mel_t = torch.from_numpy(np.ascontiguousarray(mel.T)).to(device)
        self._pad = (cfg.n_fft - cfg.hop_size) // 2

    def num_frames(self, num_samples: int) -> int:
        t = num_samples + 2 * self._pad
        return 1 + (t - self.cfg.n_fft) // self.cfg.hop_size

    def pad_reflect(self, audio: np.ndarray) -> np.ndarray:
        """Host-side reflect padding at the true signal boundary."""
        audio = np.asarray(audio)
        return np.pad(audio, [(0, 0)] * (audio.ndim - 1)
                      + [(self._pad, self._pad)], mode="reflect")

    def on_prepadded(self, padded: torch.Tensor) -> torch.Tensor:
        """log-mel of an already reflect-padded signal (B, T + 2*pad)."""
        frames = frame_signal(padded, self.cfg.n_fft, self.cfg.hop_size)
        mag = torch.sqrt(frame_power_spectrum(frames, self._cos, self._sin) + 1e-9)
        logmel = torch.log(torch.clamp(mag @ self._mel_t, min=1e-5))
        return logmel.transpose(1, 2)

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T) in [-1, 1] -> log-mel (B, n_mels, F)."""
        x = F.pad(audio[:, None, :], (self._pad, self._pad), mode="reflect")[:, 0]
        return self.on_prepadded(x)

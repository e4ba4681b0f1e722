"""Kaldi-style fbank + SeamlessM4T w2v-bert feature extractor
(`voice_tts_tpu/audio/kaldi.py`): dc-offset removal, preemphasis, povey
window, zero-pad to n_fft, matmul-DFT power spectrum, kaldi mel triangles,
log with floor; the Seamless path adds per-bin normalization over valid
frames and stride-2 frame stacking (80 -> 160 dims)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import filters
from .stft import frame_power_spectrum, frame_signal


class KaldiFbank:
    """waveform (B, T) in [-1, 1] -> log-mel (B, F, n_mels)."""

    def __init__(self, sample_rate: int = 16000, num_mel_bins: int = 80,
                 frame_length: int = 400, frame_shift: int = 160,
                 n_fft: int = 512, preemphasis: float = 0.97,
                 remove_dc_offset: bool = True, low_freq: float = 20.0,
                 high_freq: Optional[float] = None,
                 mel_floor: float = 1.192092955078125e-07,
                 waveform_scale: float = 32768.0, device="cpu"):
        self.frame_length = frame_length
        self.frame_shift = frame_shift
        self.preemphasis = preemphasis
        self.remove_dc_offset = remove_dc_offset
        self.waveform_scale = waveform_scale
        self.mel_floor = mel_floor
        window = filters.povey_window(frame_length)
        cos_m, sin_m = filters.dft_matrices(n_fft, window, frame_length=frame_length)
        mel = filters.kaldi_mel_matrix(sample_rate, n_fft, num_mel_bins,
                                       low_freq, high_freq)
        self._cos = torch.from_numpy(cos_m).to(device)
        self._sin = torch.from_numpy(sin_m).to(device)
        self._mel_t = torch.from_numpy(np.ascontiguousarray(mel.T)).to(device)

    def num_frames(self, num_samples: int) -> int:
        if num_samples < self.frame_length:
            return 0
        return 1 + (num_samples - self.frame_length) // self.frame_shift

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        x = audio.float() * self.waveform_scale
        frames = frame_signal(x, self.frame_length, self.frame_shift)
        if self.remove_dc_offset:
            frames = frames - frames.mean(dim=-1, keepdim=True)
        if self.preemphasis > 0:
            prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
            frames = frames - self.preemphasis * prev
        power = frame_power_spectrum(frames, self._cos, self._sin)
        return torch.log(torch.clamp(power @ self._mel_t, min=self.mel_floor))


class SeamlessFeatures:
    """SeamlessM4TFeatureExtractor clone producing (B, F//2, 160) features."""

    def __init__(self, sample_rate: int = 16000, num_mel_bins: int = 80,
                 stride: int = 2, device="cpu"):
        self.fbank = KaldiFbank(sample_rate=sample_rate, num_mel_bins=num_mel_bins,
                                device=device)
        self.stride = stride

    def num_output_frames(self, num_samples: int) -> int:
        f = self.fbank.num_frames(num_samples)
        f = f + (-f) % self.stride
        return f // self.stride

    def __call__(self, audio: torch.Tensor,
                 valid_samples: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio (B, T) -> (input_features (B, F', 160), attention_mask (B, F'))."""
        feats = self.fbank(audio)
        b, f, c = feats.shape
        if valid_samples is not None:
            valid_frames = torch.clamp(
                torch.div(valid_samples - self.fbank.frame_length,
                          self.fbank.frame_shift, rounding_mode="floor") + 1, min=0)
            fmask = torch.arange(f, device=feats.device)[None, :] < valid_frames[:, None]
            m = fmask[..., None].to(feats.dtype)
            n = torch.clamp(valid_frames, min=2)[:, None, None].to(feats.dtype)
            mean = (feats * m).sum(dim=1, keepdim=True) / n
            var = (((feats - mean) * m) ** 2).sum(dim=1, keepdim=True) / (n - 1)
            feats = (feats - mean) / torch.sqrt(var + 1e-7) * m
        else:
            valid_frames = torch.full((b,), f, dtype=torch.int64, device=feats.device)
            mean = feats.mean(dim=1, keepdim=True)
            var = ((feats - mean) ** 2).sum(dim=1, keepdim=True) / max(f - 1, 1)
            feats = (feats - mean) / torch.sqrt(var + 1e-7)
        pad = (-f) % self.stride
        if pad:
            feats = F.pad(feats, (0, 0, 0, pad))
        fp = feats.shape[1]
        stacked = feats.reshape(b, fp // self.stride, c * self.stride)
        mask = (torch.arange(fp // self.stride, device=feats.device)[None, :]
                < torch.div(valid_frames, self.stride, rounding_mode="floor")[:, None])
        return stacked, mask.to(torch.int32)

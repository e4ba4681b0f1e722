"""Framing + matmul-DFT power spectrum (`voice_tts_tpu/audio/stft.py`)."""

from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice x (B, T) into frames (B, F, frame_length); F = 1+(T-len)//hop."""
    return x.unfold(-1, frame_length, hop)


def frame_power_spectrum(frames: torch.Tensor, cos_m: torch.Tensor,
                         sin_m: torch.Tensor) -> torch.Tensor:
    """|DFT|^2 of pre-windowed frames: (B, F, L) x (L, bins) -> (B, F, bins),
    full f32 products."""
    re = frames @ cos_m
    im = frames @ sin_m
    return re * re + im * im

"""Filterbank / window construction (host-side numpy, consumed as constants).

Copied from `voice_tts_tpu/audio/filters.py` (jax-free, but it sits
behind the JAX package's jax-importing `audio/__init__`).

Two mel conventions are needed by the pipeline:

- **slaney** (librosa default): used by the 22.05 kHz synthesis mel frontend
  (reference `s2mel/modules/audio.py:52` calls `librosa.filters.mel`).
- **kaldi**: used by the 16 kHz conditioning features — both the
  SeamlessM4T w2v-bert extractor (HF `feature_extraction_seamless_m4t.py`) and
  the CAMPPlus kaldi fbank (reference `infer_v2.py:529-533`).

Windows: periodic hann (torch.hann_window default) and kaldi povey.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# mel scales
# ---------------------------------------------------------------------------

def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def _hz_to_mel_kaldi(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def slaney_mel_matrix(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                      fmax: float | None = None) -> np.ndarray:
    """librosa.filters.mel equivalent (htk=False, norm='slaney').

    Returns (n_mels, n_fft // 2 + 1) float32.
    """
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)

    mel_min = _hz_to_mel_slaney(fmin)
    mel_max = _hz_to_mel_slaney(fmax)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # slaney normalization: area of each filter = 2 / bandwidth
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def kaldi_mel_matrix(sr: int, n_fft: int, n_mels: int, fmin: float = 20.0,
                     fmax: float | None = None) -> np.ndarray:
    """Kaldi-style mel filterbank: triangles built in mel space, no norm.

    Matches HF `mel_filter_bank(..., mel_scale="kaldi",
    triangularize_in_mel_space=True, norm=None)`, which itself matches kaldi's
    `GetMelBanks` — the convention used by both torchaudio kaldi fbank and the
    SeamlessM4T extractor.  Returns (n_mels, n_fft // 2 + 1) float32.
    """
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1

    mel_min = _hz_to_mel_kaldi(fmin)
    mel_max = _hz_to_mel_kaldi(fmax)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)

    # in mel-space triangularization, the fft "frequencies" are bin mels
    fft_bin_width = sr / n_fft
    fft_freqs = _hz_to_mel_kaldi(fft_bin_width * np.arange(n_bins))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def hann_window(win_size: int, periodic: bool = True) -> np.ndarray:
    """torch.hann_window equivalent (periodic=True by default)."""
    n = win_size if periodic else win_size - 1
    t = np.arange(win_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * t / n)).astype(np.float32)


def povey_window(win_size: int) -> np.ndarray:
    """Kaldi povey window: hann(sym)**0.85."""
    t = np.arange(win_size, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / (win_size - 1))
    return (hann ** 0.85).astype(np.float32)


# ---------------------------------------------------------------------------
# DFT matrices (matmul-based STFT rides the MXU; no FFT op needed)
# ---------------------------------------------------------------------------

def dft_matrices(n_fft: int, window: np.ndarray | None = None,
                 frame_length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT analysis matrices of shape (frame_length, n_fft//2+1).

    The window is folded into the matrices.  If ``frame_length < n_fft`` the
    frame is implicitly zero-padded at the end (kaldi convention).
    """
    frame_length = frame_length or n_fft
    n_bins = n_fft // 2 + 1
    t = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * t * k / n_fft
    cos_m = np.cos(angle)
    sin_m = -np.sin(angle)
    if window is not None:
        cos_m = cos_m * window.astype(np.float64)[:, None]
        sin_m = sin_m * window.astype(np.float64)[:, None]
    return cos_m.astype(np.float32), sin_m.astype(np.float32)

"""Host-side audio IO: WAV encode/decode, prompt loading and truncation.

Copied from `voice_tts_tpu/audio/wav.py` (jax-free, but it sits behind
the JAX package's jax-importing `audio/__init__`).

Replaces the reference's torchaudio load/save + `_load_and_cut_audio`
(reference `infer_v2.py:307-419`, `infer_v2.py:764-776`) without torchaudio:
stdlib `wave`-format parsing via numpy (PCM16/24/32, float32), mono mixdown,
15 s truncation, int16 WAV writing.
"""

from __future__ import annotations

import io
import struct
import wave
from typing import Optional, Tuple, Union

import numpy as np

AudioInput = Union[str, bytes, np.ndarray, Tuple[np.ndarray, int]]


def decode_audio_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a WAV byte string -> (float32 mono (T,), sample_rate).

    Supports PCM 16/24/32-bit and IEEE float32 WAV.  Raises ValueError for
    other containers (mp3 etc. are out of scope without ffmpeg).
    """
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("unsupported audio container (expected WAV/RIFF)")
    # walk chunks manually: python's wave module rejects float wavs
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError("malformed WAV: truncated fmt chunk")
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError("malformed WAV: missing fmt/data chunk")
    audio_fmt, channels, sr, _, _, bits = fmt
    if audio_fmt == 0xFFFE and len(data) >= 2:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = 1 if bits in (16, 24, 32) else audio_fmt
    if audio_fmt == 3 and bits == 32:
        x = np.frombuffer(payload, dtype="<f4").astype(np.float32)
    elif audio_fmt in (1, 0xFFFE) and bits == 16:
        x = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_fmt in (1, 0xFFFE) and bits == 32:
        x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_fmt in (1, 0xFFFE) and bits == 24:
        raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
        vals = (raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV format: fmt={audio_fmt} bits={bits}")
    if channels > 1:
        x = x.reshape(-1, channels)[:, 0]  # take first channel (mono-ize)
    return np.clip(x, -1.0, 1.0), sr


def load_prompt_audio(audio_input: AudioInput, max_seconds: Optional[float] = None,
                      assumed_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Accept path / bytes / ndarray / (ndarray, sr); mono-ize and truncate.

    Mirrors the accepted input types of `_load_and_cut_audio`
    (reference `infer_v2.py:307-419`).
    """
    if isinstance(audio_input, (bytes, bytearray)):
        audio, sr = decode_audio_bytes(bytes(audio_input))
    elif isinstance(audio_input, str):
        with open(audio_input, "rb") as f:
            audio, sr = decode_audio_bytes(f.read())
    elif isinstance(audio_input, tuple):
        arr, sr = audio_input
        audio = np.asarray(arr, dtype=np.float32)
    elif isinstance(audio_input, np.ndarray):
        if assumed_sr is None:
            raise ValueError("raw ndarray input requires assumed_sr")
        audio, sr = np.asarray(audio_input, dtype=np.float32), assumed_sr
    else:
        raise TypeError(f"unsupported audio input type {type(audio_input)}")
    if audio.ndim == 2:  # (C, T) or (T, C): pick the longer axis as time
        audio = audio[0] if audio.shape[0] < audio.shape[1] else audio[:, 0]
    if max_seconds is not None:
        audio = audio[: int(max_seconds * sr)]
    return np.clip(audio.astype(np.float32), -1.0, 1.0), int(sr)


def encode_wav_int16(audio: np.ndarray, sample_rate: int) -> bytes:
    """float or int16 mono (T,) -> int16 WAV bytes (reference output format)."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = np.clip(audio, -32767.0, 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(audio.tobytes())
    return buf.getvalue()

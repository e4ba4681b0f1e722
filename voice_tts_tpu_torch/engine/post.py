"""Post-processing of generated code / waveform sequences (copied from
`voice_tts_tpu/engine/post.py`, which sits behind the JAX package's
jax-importing `engine/__init__`; the device-side silence trim is the
PyTorch version of `remove_long_silence_jax`)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def remove_long_silence(codes: np.ndarray, lengths: np.ndarray,
                        stop_token: int, silent_token: int = 52,
                        max_consecutive: int = 30) -> Tuple[np.ndarray, np.ndarray]:
    """Shrink runs of the silent code (reference `infer_v2.py:212-267`).

    codes (B, T) already stop-trimmed to `lengths` (stop excluded); if a row
    contains more than `max_consecutive` silent tokens, runs are capped at 10.
    """
    out_rows: List[np.ndarray] = []
    out_lens = []
    for row, ln in zip(codes, lengths):
        row = row[:ln]
        if int(np.sum(row == silent_token)) > max_consecutive:
            keep = []
            run = 0
            for tok in row.tolist():
                if tok != silent_token:
                    keep.append(tok)
                    run = 0
                elif run < 10:
                    keep.append(tok)
                    run += 1
            row = np.asarray(keep, dtype=codes.dtype)
        out_rows.append(row)
        out_lens.append(len(row))
    max_len = max(out_lens) if out_lens else 0
    out = np.full((len(out_rows), max_len), stop_token, dtype=codes.dtype)
    for i, row in enumerate(out_rows):
        out[i, :len(row)] = row
    return out, np.asarray(out_lens, dtype=np.int64)


def remove_long_silence_torch(codes, lengths, stop_token: int,
                              silent_token: int = 52, max_consecutive: int = 30,
                              pad_value: int = 0):
    """`remove_long_silence` on device tensors with fixed shapes (the JAX
    package's `remove_long_silence_jax`): codes (B, T), lengths (B,) valid
    counts (stop excluded) -> (out (B, T), new_lengths (B,)), kept tokens
    left-compacted, the rest `pad_value`."""
    import torch

    b, t = codes.shape
    idx = torch.arange(t, device=codes.device)[None, :]
    valid = idx < lengths[:, None]
    is_sil = (codes == silent_token) & valid
    last_non_sil = torch.cummax(torch.where(is_sil, -1, idx), dim=1).values
    run = idx - last_non_sil
    needs_trim = (is_sil.sum(dim=1) > max_consecutive)[:, None]
    keep = valid & (~is_sil | (run <= 10) | ~needs_trim)
    new_pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out = torch.full((b, t + 1), pad_value, dtype=codes.dtype, device=codes.device)
    pos = torch.where(keep, new_pos, t)          # dropped -> spill column t
    out.scatter_(1, pos, torch.where(keep, codes, pad_value))
    new_lengths = torch.clamp(keep.sum(dim=1), min=1)
    return out[:, :t], new_lengths


def insert_interval_silence(wavs: List[np.ndarray], sampling_rate: int = 22050,
                            interval_silence_ms: int = 200) -> np.ndarray:
    """Concatenate segment waveforms with silence gaps
    (reference `infer_v2.py:306-330`)."""
    if not wavs:
        return np.zeros(0, dtype=np.float32)
    if interval_silence_ms <= 0 or len(wavs) == 1:
        return np.concatenate(wavs)
    sil = np.zeros(int(sampling_rate * interval_silence_ms / 1000.0),
                   dtype=wavs[0].dtype)
    pieces = []
    for i, w in enumerate(wavs):
        pieces.append(w)
        if i < len(wavs) - 1:
            pieces.append(sil)
    return np.concatenate(pieces)


def pick_bucket(n: int, buckets) -> int:
    """Smallest bucket >= n (clamped to the largest)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]

"""Attention-block conditioning encoder: the reference's `condition_type=
"perceiver"` branch and its mean-pooled default arm
(`voice_tts_tpu/models/gpt/cond_encoder.py`).

`ConditioningEncoder` = Conv1d (spec_dim -> D, k=1) followed by 6
`AttentionBlock`s, each GroupNorm -> qkv Conv1d(k=1) ->
`QKVAttentionLegacy` -> proj Conv1d(k=1) -> residual.  The published
IndexTTS-2 config selects `conformer_perceiver`, but a custom `config.yaml`
can reach these branches, so conversion and loading do not fail on them.
Torch layout (B, C, T) inside, f32 softmax.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv1d, GroupNorm, einsum


def _norm_groups(channels: int) -> int:
    """The reference's `normalization` group count: 32 for wide layers,
    fewer for narrow ones, halved until it divides the channels."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = int(groups / 2)
    if groups <= 2:
        raise ValueError(f"no GroupNorm grouping for {channels} channels")
    return groups


class AttentionBlock(nn.Module):
    """Residual self-attention block, x (B, C, T) -> (B, C, T).

    The qkv conv's 3C output channels are grouped head-major
    (`QKVAttentionLegacy`): head h owns channels [3 ch h, 3 ch (h + 1)),
    split [q | k | v]; q and k are each scaled by ch ** -0.25 before the
    dot (the split 1 / sqrt(ch) softmax scale)."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(_norm_groups(channels), channels)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        h = self.num_heads
        ch = c // h
        qkv = self.qkv(self.norm(x)).reshape(b, h, 3 * ch, t)
        q, k, v = qkv[:, :, :ch], qkv[:, :, ch:2 * ch], qkv[:, :, 2 * ch:]
        scale = ch ** -0.25
        w = einsum("bhct,bhcs->bhts", q * scale, k * scale)
        w = torch.softmax(w.float(), dim=-1).to(x.dtype)
        a = einsum("bhts,bhcs->bhct", w, v).reshape(b, c, t)
        return x + self.proj_out(a)


class AttentionConditioningEncoder(nn.Module):
    """Conv1d(k=1) stem + `attn_blocks` AttentionBlocks: x (B, T, spec_dim)
    -> (B, T, dim); with `mean=True` the time mean (B, dim), the
    reference's default-encoder arm."""

    def __init__(self, spec_dim: int, dim: int, num_heads: int,
                 attn_blocks: int = 6, mean: bool = False):
        super().__init__()
        self.attn_blocks, self.mean = attn_blocks, mean
        self.init = Conv1d(spec_dim, dim, 1)
        for i in range(attn_blocks):
            setattr(self, f"attn_{i}", AttentionBlock(dim, num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.init(x.transpose(1, 2))
        for i in range(self.attn_blocks):
            h = getattr(self, f"attn_{i}")(h)
        if self.mean:
            return h.mean(dim=2)
        return h.transpose(1, 2)

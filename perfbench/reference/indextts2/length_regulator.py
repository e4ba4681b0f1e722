"""Length regulator: semantic embeddings -> mel-rate condition
(`voice_tts_tpu/models/s2mel/length_regulator.py`).

Linear in-projection, nearest-neighbour interpolation to the target length
inside a fixed output bucket, conv / masked GroupNorm / Mish stacks, final
1x1 conv, length masking.  GroupNorm statistics count valid frames only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import LengthRegulatorConfig
from .layers import Conv1d, Linear


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class MaskedGroupNorm(nn.Module):
    """torch.nn.GroupNorm over (B, C, T) with padding excluded from stats."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def _init(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        g = self.num_groups
        m = mask[:, None, None, :]
        xg = x.reshape(b, g, c // g, t) * m
        count = m.sum(dim=(2, 3), keepdim=True) * (c // g)
        mean = xg.sum(dim=(2, 3), keepdim=True) / count
        var = (((xg - mean) * m) ** 2).sum(dim=(2, 3), keepdim=True) / count
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, t)
        return y * self.weight[None, :, None] + self.bias[None, :, None]


class InterpolateRegulator(nn.Module):
    def __init__(self, cfg: LengthRegulatorConfig, in_dim: int):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.content_in_proj = Linear(in_dim, c)
        for i in range(cfg.num_sampling_ratios):
            setattr(self, f"conv_{i}", Conv1d(c, c, 3, padding=1))
            setattr(self, f"norm_{i}", MaskedGroupNorm(cfg.groups, c))
        self.conv_out = Conv1d(c, c, 1)

    def forward(self, x: torch.Tensor, src_len: torch.Tensor,
                target_len: torch.Tensor, out_max: int) -> torch.Tensor:
        """x (B, T_src_bucket, in_dim), src/target lengths (B,) ->
        (B, out_max, channels), zero beyond target_len."""
        h = self.content_in_proj(x)
        j = torch.arange(out_max, device=x.device)
        idx = torch.floor(j[None, :] * src_len[:, None] / target_len[:, None])
        idx = torch.clamp(idx.to(torch.int64), 0, x.shape[1] - 1)
        g = torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))
        mask = (j[None, :] < target_len[:, None]).to(h.dtype)
        g = g * mask[..., None]
        y = g.transpose(1, 2)
        for i in range(self.cfg.num_sampling_ratios):
            y = getattr(self, f"conv_{i}")(y)
            y = getattr(self, f"norm_{i}")(y, mask)
            y = mish(y)
            y = y * mask[:, None, :]
        y = self.conv_out(y)
        return y.transpose(1, 2) * mask[..., None]

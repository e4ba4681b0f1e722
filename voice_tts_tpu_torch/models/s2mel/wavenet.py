"""WaveNet refinement head of the DiT final layer
(`voice_tts_tpu/models/s2mel/wavenet.py`): stride-1 odd-kernel convs with
symmetric reflect padding, gated dilated conv stack."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from voice_tts_tpu_torch.config import WaveNetConfig
from voice_tts_tpu_torch.models.layers import Conv1d


class ReflectConv1d(nn.Module):
    """SConv1d equivalent for stride-1 use: reflect pad then valid conv."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.conv = Conv1d(in_ch, features, kernel_size, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (self.kernel_size - 1) * self.dilation
        if pad:
            x = F.pad(x, (pad - pad // 2, pad // 2), mode="reflect")
        return self.conv(x)


def reflect_fill(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Positions past lens-1 take the mirror image around the last valid
    frame (x[lens-2], x[lens-3], ...): exact-length reflect padding emulated
    inside a static buffer."""
    t = x.shape[-1]
    p = torch.arange(t, device=x.device)[None, :]
    idx = torch.where(p < lens[:, None], p, 2 * lens[:, None] - 2 - p)
    idx = torch.clamp(idx, 0, t - 1)
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


class WN(nn.Module):
    """Gated dilated conv stack: x (B, C, T), mask (B, 1, T), g (B, gin, 1)."""

    def __init__(self, cfg: WaveNetConfig, gin_channels: int):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.cond_layer = ReflectConv1d(gin_channels, 2 * h * cfg.num_layers, 1)
        for i in range(cfg.num_layers):
            setattr(self, f"in_layer_{i}", ReflectConv1d(
                h, 2 * h, cfg.kernel_size, cfg.dilation_rate ** i))
            res_skip_ch = 2 * h if i < cfg.num_layers - 1 else h
            setattr(self, f"res_skip_{i}", ReflectConv1d(h, res_skip_ch, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor, x_lens: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        c = self.cfg
        h = c.hidden_dim
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g)
        for i in range(c.num_layers):
            x_conv_in = reflect_fill(x, x_lens) if x_lens is not None else x
            x_in = getattr(self, f"in_layer_{i}")(x_conv_in)
            g_l = g_all[:, i * 2 * h:(i + 1) * 2 * h]
            acts = x_in + g_l
            acts = torch.tanh(acts[:, :h]) * torch.sigmoid(acts[:, h:])
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < c.num_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask

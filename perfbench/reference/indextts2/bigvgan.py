"""BigVGAN v2 vocoder (mel -> waveform), plain PyTorch (a frozen copy of
the program's `models/vocoder/bigvgan.py`, its activations through `aa.py`
in place of the K2 kernel).

conv_pre (k7) -> 6x [ConvTranspose1d upsample -> mean of 3 AMP residual
blocks] -> anti-aliased snake post-activation -> conv_post (k7) -> clamp.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .config import BigVGANConfig
from .layers import Conv1d, ConvTranspose1d
from .aa import aa_snake_activation


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class SnakeParams(nn.Module):
    """Per-channel snake(-beta) parameters, stored as in the checkpoint."""

    def __init__(self, channels: int, logscale: bool = True, beta: bool = True):
        super().__init__()
        self.logscale = logscale
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels)) if beta else None

    def _init(self, gen):
        init = nn.init.zeros_ if self.logscale else nn.init.ones_
        init(self.alpha)
        if self.beta is not None:
            init(self.beta)

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        alpha = self.alpha
        beta = self.beta if self.beta is not None else alpha
        if self.logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        return alpha, 1.0 / (beta + 1e-9)


class AMPBlock1(nn.Module):
    """Anti-aliased multi-periodicity residual block."""

    def __init__(self, channels: int, kernel_size: int, dilations,
                 snake_logscale: bool, snake_beta: bool):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            setattr(self, f"convs1_{i}", Conv1d(
                channels, channels, kernel_size, dilation=d,
                padding=_get_padding(kernel_size, d)))
            setattr(self, f"convs2_{i}", Conv1d(
                channels, channels, kernel_size, dilation=1,
                padding=_get_padding(kernel_size, 1)))
        for i in range(2 * self.n):
            setattr(self, f"act_{i}", SnakeParams(channels, snake_logscale,
                                                  snake_beta))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            a1, b1 = getattr(self, f"act_{2 * i}")()
            xt = aa_snake_activation(x, a1, b1)
            xt = getattr(self, f"convs1_{i}")(xt)
            a2, b2 = getattr(self, f"act_{2 * i + 1}")()
            xt = aa_snake_activation(xt, a2, b2)
            xt = getattr(self, f"convs2_{i}")(xt)
            x = xt + x
        return x


class BigVGAN(nn.Module):
    """mel (B, num_mels, F) -> waveform (B, 1, F * prod(upsample_rates))."""

    def __init__(self, cfg: BigVGANConfig):
        super().__init__()
        self.cfg = cfg
        snake_beta = cfg.activation == "snakebeta"
        self.conv_pre = Conv1d(cfg.num_mels, cfg.upsample_initial_channel, 7,
                               padding=3)
        nk = len(cfg.resblock_kernel_sizes)
        ch_in = cfg.upsample_initial_channel
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            ch = cfg.upsample_initial_channel // (2 ** (i + 1))
            setattr(self, f"ups_{i}", ConvTranspose1d(
                ch_in, ch, k, stride=u, padding=(k - u) // 2))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                setattr(self, f"resblocks_{i * nk + j}", AMPBlock1(
                    ch, rk, tuple(rd), cfg.snake_logscale, snake_beta))
            ch_in = ch
        self.activation_post = SnakeParams(ch_in, cfg.snake_logscale, snake_beta)
        self.conv_post = Conv1d(ch_in, 1, 7, padding=3,
                                use_bias=cfg.use_bias_at_final)

    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The mean of stage i's AMP resblocks on the upsampled x."""
        nk = len(self.cfg.resblock_kernel_sizes)
        xs = None
        for j in range(nk):
            out = getattr(self, f"resblocks_{i * nk + j}")(x)
            xs = out if xs is None else xs + out
        return xs / nk

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Post activation -> conv_post -> tanh or clamp to [-1, 1]."""
        a, b = self.activation_post()
        x = self.conv_post(aa_snake_activation(x, a, b))
        if self.cfg.use_tanh_at_final:
            return torch.tanh(x)
        return torch.clamp(x, -1.0, 1.0)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel)
        for i in range(len(self.cfg.upsample_rates)):
            x = self.stage(i, getattr(self, f"ups_{i}")(x))
        return self.head(x)

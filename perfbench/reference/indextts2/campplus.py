"""CAMPPlus speaker-style encoder (kaldi fbank -> x-vector)
(`voice_tts_tpu/models/conditioning/campplus.py`): FCM 2-D conv front-end,
D-TDNN blocks with context-aware masking, transit layers, stats pooling,
dense head; batch norms in eval mode.  `valid_len` makes padded inputs give
exactly the unpadded result (padding re-zeroed after every nonlinearity,
pooling statistics over valid frames only)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import CAMPPlusConfig
from .layers import Conv1d, lecun_normal_


class BatchNormInference(nn.Module):
    """BatchNorm(1d/2d) with running statistics; channel axis 1."""

    def __init__(self, channels: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))
        self.weight = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def _init(self, gen):
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x):
        shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        y = ((x - self.running_mean.reshape(shape))
             * torch.rsqrt(self.running_var.reshape(shape) + self.eps))
        if self.weight is not None:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y


class Conv2dTorch(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel, stride=(1, 1),
                 padding=(0, 0)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty(features, in_ch, *kernel))

    def _init(self, gen):
        lecun_normal_(self.weight, gen)

    def forward(self, x):
        return F.conv2d(x.to(self.weight.dtype), self.weight, None, self.stride,
                        self.padding)


class BasicResBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2dTorch(in_planes, planes, (3, 3), (stride, 1), (1, 1))
        self.bn1 = BatchNormInference(planes)
        self.conv2 = Conv2dTorch(planes, planes, (3, 3), (1, 1), (1, 1))
        self.bn2 = BatchNormInference(planes)
        self.has_shortcut = stride != 1 or in_planes != planes
        if self.has_shortcut:
            self.shortcut_conv = Conv2dTorch(in_planes, planes, (1, 1), (stride, 1))
            self.shortcut_bn = BatchNormInference(planes)

    def forward(self, x, tmask):
        out = F.relu(self.bn1(self.conv1(x))) * tmask
        out = self.bn2(self.conv2(out))
        sc = self.shortcut_bn(self.shortcut_conv(x)) if self.has_shortcut else x
        return F.relu(out + sc) * tmask


class FCM(nn.Module):
    def __init__(self, m_channels: int = 32, feat_dim: int = 80):
        super().__init__()
        self.conv1 = Conv2dTorch(1, m_channels, (3, 3), (1, 1), (1, 1))
        self.bn1 = BatchNormInference(m_channels)
        for li in range(2):
            for bi, s in enumerate((2, 1)):
                setattr(self, f"layer{li + 1}_{bi}",
                        BasicResBlock(m_channels, m_channels, s))
        self.conv2 = Conv2dTorch(m_channels, m_channels, (3, 3), (2, 1), (1, 1))
        self.bn2 = BatchNormInference(m_channels)
        self.out_channels = m_channels * (feat_dim // 8)

    def forward(self, x, tmask1d):
        tmask = 1.0 if tmask1d is None else tmask1d[:, :, None, :]
        x = F.relu(self.bn1(self.conv1(x[:, None, :, :]))) * tmask
        for li in range(2):
            for bi in range(2):
                x = getattr(self, f"layer{li + 1}_{bi}")(x, tmask)
        x = F.relu(self.bn2(self.conv2(x))) * tmask
        b, c, f, t = x.shape
        return x.reshape(b, c * f, t)


class CAMLayer(nn.Module):
    def __init__(self, in_ch: int, bn_channels: int, out_channels: int,
                 kernel_size: int, dilation: int, reduction: int = 2,
                 seg_len: int = 100):
        super().__init__()
        self.seg_len = seg_len
        pad = (kernel_size - 1) // 2 * dilation
        self.linear_local = Conv1d(in_ch, out_channels, kernel_size, padding=pad,
                                   dilation=dilation, use_bias=False)
        self.linear1 = Conv1d(in_ch, bn_channels // reduction, 1)
        self.linear2 = Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x, mask, count):
        y = self.linear_local(x)
        if mask is None:
            context = x.mean(dim=-1, keepdim=True)
        else:
            context = x.sum(dim=-1, keepdim=True) / count[:, None, None]
        context = context + self._seg_pooling(x, count)
        context = F.relu(self.linear1(context))
        out = y * torch.sigmoid(self.linear2(context))
        return out if mask is None else out * mask

    def _seg_pooling(self, x, count):
        b, c, t = x.shape
        seg = self.seg_len
        n = -(-t // seg)
        xp = F.pad(x, (0, n * seg - t))
        sums = xp.reshape(b, c, n, seg).sum(dim=-1)
        starts = torch.arange(n, device=x.device) * seg
        if count is None:
            counts = torch.clamp(t - starts, max=seg).to(x.dtype)[None, :]
        else:
            counts = torch.clamp(torch.clamp(count[:, None] - starts[None, :], max=seg),
                                 1, seg).to(x.dtype)
        avg = sums / counts[:, None, :]
        return torch.repeat_interleave(avg, seg, dim=-1)[..., :t]


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_ch: int, out_channels: int, bn_channels: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        self.nonlinear1_bn = BatchNormInference(in_ch)
        self.linear1 = Conv1d(in_ch, bn_channels, 1, use_bias=False)
        self.nonlinear2_bn = BatchNormInference(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, bn_channels, out_channels,
                                  kernel_size, dilation)

    def forward(self, x, mask, count):
        y = F.relu(self.nonlinear1_bn(x))
        if mask is not None:
            y = y * mask
        y = F.relu(self.nonlinear2_bn(self.linear1(y)))
        if mask is not None:
            y = y * mask
        return self.cam_layer(y, mask, count)


_BLOCKS = ((12, 3, 1), (24, 3, 2), (16, 3, 2))  # (layers, kernel, dilation)


class CAMPPlus(nn.Module):
    """fbank (B, T, feat_dim) -> x-vector (B, embedding_size)."""

    def __init__(self, cfg: CAMPPlusConfig):
        super().__init__()
        self.cfg = cfg
        self.head = FCM(m_channels=32, feat_dim=cfg.feat_dim)
        self.tdnn_linear = Conv1d(self.head.out_channels, cfg.init_channels, 5,
                                  stride=2, padding=2, use_bias=False)
        self.tdnn_bn = BatchNormInference(cfg.init_channels)
        channels = cfg.init_channels
        for i, (num_layers, kernel, dilation) in enumerate(_BLOCKS):
            for j in range(num_layers):
                setattr(self, f"block{i + 1}_tdnnd{j + 1}", CAMDenseTDNNLayer(
                    channels + j * cfg.growth_rate, cfg.growth_rate,
                    cfg.bn_size * cfg.growth_rate, kernel, dilation))
            channels += num_layers * cfg.growth_rate
            setattr(self, f"transit{i + 1}_bn", BatchNormInference(channels))
            setattr(self, f"transit{i + 1}_linear",
                    Conv1d(channels, channels // 2, 1, use_bias=False))
            channels //= 2
        self.out_bn = BatchNormInference(channels)
        self.dense_linear = Conv1d(2 * channels, cfg.embedding_size, 1,
                                   use_bias=False)
        self.dense_bn = BatchNormInference(cfg.embedding_size, affine=False)

    def forward(self, x: torch.Tensor,
                valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        t_in = x.shape[1]
        x = x.transpose(1, 2)
        if valid_len is not None:
            tmask1d = (torch.arange(t_in, device=x.device)[None, :]
                       < valid_len[:, None])[:, None, :].to(x.dtype)
            x = x * tmask1d
        else:
            tmask1d = None
        x = self.head(x, tmask1d)
        x = F.relu(self.tdnn_bn(self.tdnn_linear(x)))
        if valid_len is not None:
            count = (valid_len - 1) // 2 + 1
            mask = (torch.arange(x.shape[-1], device=x.device)[None, :]
                    < count[:, None])[:, None, :].to(x.dtype)
            x = x * mask
        else:
            count = mask = None
        for i, (num_layers, _, _) in enumerate(_BLOCKS):
            for j in range(num_layers):
                y = getattr(self, f"block{i + 1}_tdnnd{j + 1}")(x, mask, count)
                x = torch.cat([x, y], dim=1)
            x = F.relu(getattr(self, f"transit{i + 1}_bn")(x))
            if mask is not None:
                x = x * mask
            x = getattr(self, f"transit{i + 1}_linear")(x)
        x = F.relu(self.out_bn(x))
        if mask is not None:
            x = x * mask
            n = count[:, None].to(x.dtype)
            mean = x.sum(dim=-1) / n
            var = (((x - mean[..., None]) * mask) ** 2).sum(dim=-1) / (n - 1)
        else:
            t = x.shape[-1]
            mean = x.mean(dim=-1)
            var = ((x - mean[..., None]) ** 2).sum(dim=-1) / max(t - 1, 1)
        stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
        return self.dense_bn(self.dense_linear(stats[..., None]))[..., 0]

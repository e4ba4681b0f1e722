"""Shared NN layers with the JAX package's (= torch's) parameter layouts
(`voice_tts_tpu/models/layers.py`).

Convolutions run in (B, C, T) with Conv1d weights (out, in/groups, k) and
ConvTranspose1d weights (in, out, k).  Compute dtype follows the JAX
modules: convolutions cast the input to the weight dtype, linear layers and
norms promote (f32 activations against bf16 weights compute in f32), norm
statistics are f32.

Random initialisation (`init_weights`) follows the JAX initialisers' scales:
lecun-normal (truncated, with flax's fan-in convention on the torch-layout
shape: fan_in = numel / shape[-1]) for Conv1d / Linear, normal(0.02) for
embeddings, ones / zeros for norms.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def lecun_normal_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal()` on a torch-layout weight: truncated normal with
    variance 1 / fan_in, fan_in = numel / shape[-1] (flax's in_axis=-2,
    out_axis=-1 convention applied to the stored shape)."""
    fan_in = t.numel() / t.shape[-1]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return t


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        t.normal_(0.0, std, generator=gen)
    return t


def xavier_uniform_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """flax `xavier_uniform()`: fan_in = shape[-2], fan_out = shape[-1]."""
    receptive = t.numel() / (t.shape[-2] * t.shape[-1])
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=gen)
    return t


def init_weights(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise every submodule that defines `_init(gen)`."""
    for m in module.modules():
        init = getattr(m, "_init", None)
        if init is not None:
            init(gen)
    return module


def promote(x: torch.Tensor, *ts: torch.Tensor) -> torch.dtype:
    dt = x.dtype
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """`jnp.einsum`: operands of mixed dtypes promote to the common one (a
    bf16 activation against an f32 one computes in f32)."""
    dt = promote(*ops)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


class Conv1d(nn.Module):
    """torch.nn.Conv1d-equivalent; computes in the weight dtype."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, use_bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(torch.empty(features, in_ch // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _init(self, gen):
        lecun_normal_(self.weight, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        y = F.conv1d(x.to(w.dtype), w, None, self.stride, self.padding,
                     self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias[None, :, None]
        return y


class ConvTranspose1d(nn.Module):
    """torch.nn.ConvTranspose1d-equivalent; weight (in, out, k).

    out_len = (in_len - 1) * stride - 2 * padding + kernel_size, the same
    length as the JAX module's lhs-dilated conv with the flipped kernel."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(in_ch, features, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _init(self, gen):
        lecun_normal_(self.weight, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        y = F.conv_transpose1d(x.to(w.dtype), w, None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias[None, :, None]
        return y


class Linear(nn.Module):
    """torch.nn.Linear-equivalent: weight (out, in); promotes dtypes."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _init(self, gen):
        lecun_normal_(self.weight, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = promote(x, self.weight)
        y = x.to(dt) @ self.weight.to(dt).t()
        if self.bias is not None:
            y = y + self.bias
        return y


class LayerNorm(nn.Module):
    """torch.nn.LayerNorm over the last dim, f32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def _init(self, gen):
        if self.weight is not None:
            nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        if self.weight is not None:
            y = y * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y


class GroupNorm(nn.Module):
    """torch.nn.GroupNorm over (B, C, T)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def _init(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        xg = x.reshape(b, self.num_groups, c // self.num_groups, t)
        mean = xg.mean(dim=(2, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, t)
        return y * self.weight[None, :, None] + self.bias[None, :, None]


class Embedding(nn.Module):
    """torch.nn.Embedding-equivalent (normal(0.02) init)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def _init(self, gen):
        normal_(self.weight, 0.02, gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]


class RMSNorm(nn.Module):
    """llama-style RMSNorm (reference `gpt_fast/model.py:322-333`)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def _init(self, gen):
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return normed.to(x.dtype) * self.weight


"""Perceiver resampler: variable-length conditioning -> fixed latent set
(`voice_tts_tpu/models/gpt/perceiver.py`): learned latents cross-attend to
[latents; projected context], GEGLU feed-forward, final RMSNorm scaled by
sqrt(dim)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, einsum, normal_


class PerceiverRMSNorm(nn.Module):
    """F.normalize(x) * sqrt(dim) * gamma."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def _init(self, gen):
        nn.init.ones_(self.gamma)

    def forward(self, x):
        normed = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                                 min=1e-12)
        return normed * math.sqrt(x.shape[-1]) * self.gamma


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, use_bias=False)
        self.to_kv = Linear(dim, 2 * inner, use_bias=False)
        self.to_out = Linear(inner, dim, use_bias=False)

    def forward(self, latents, context, mask: Optional[torch.Tensor]):
        b, n, _ = latents.shape
        q = self.to_q(latents)
        k, v = torch.chunk(self.to_kv(context), 2, dim=-1)

        def split(t):
            return t.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        scores = einsum("bhid,bhjd->bhij", q, k) * (self.dim_head ** -0.5)
        if mask is not None:
            neg = torch.finfo(scores.dtype).max
            scores = torch.where(mask[:, None, None, :], scores, -neg)
        probs = torch.softmax(scores, dim=-1)
        out = einsum("bhij,bhjd->bhid", probs, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.proj_in = Linear(dim, inner * 2)
        self.proj_out = Linear(inner, dim)

    def forward(self, x):
        a, gate = torch.chunk(self.proj_in(x), 2, dim=-1)
        return self.proj_out(F.gelu(gate) * a)


class PerceiverResampler(nn.Module):
    def __init__(self, dim: int, dim_context: int, num_latents: int,
                 heads: int = 8, depth: int = 2, ff_mult: int = 4,
                 dim_head: int = 64):
        super().__init__()
        self.depth = depth
        if dim_context != dim:
            self.proj_context = Linear(dim_context, dim)
        else:
            self.proj_context = None
        self.latents = nn.Parameter(torch.empty(num_latents, dim))
        for i in range(depth):
            setattr(self, f"attn_{i}", PerceiverAttention(dim, heads, dim_head))
            setattr(self, f"ff_{i}", GEGLUFeedForward(dim, ff_mult))
        self.norm = PerceiverRMSNorm(dim)

    def _init(self, gen):
        normal_(self.latents, 0.02, gen)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """x (B, T, dim_context), mask (B, num_latents + T) -> (B, latents, dim)."""
        b = x.shape[0]
        if self.proj_context is not None:
            x = self.proj_context(x)
        # the latents keep the parameter dtype and promote on contact, as
        # in the JAX module (torch.cat promotes like jnp.concatenate)
        latents = self.latents[None].expand(b, -1, -1)
        for i in range(self.depth):
            context = torch.cat([latents, x], dim=-2)
            latents = getattr(self, f"attn_{i}")(latents, context, mask) + latents
            latents = getattr(self, f"ff_{i}")(latents) + latents
        return self.norm(latents)

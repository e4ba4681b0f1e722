"""GPT-2 transformer stack of the acoustic-token GPT, plain PyTorch: the
causal forward over a whole sequence, without a KV cache, int8 weights or
kernels (a frozen copy of the float branch of the program's
`models/gpt/gpt2.py`).

Pre-LN blocks, fused-qkv Conv1D projections (W stored (in, out)), gelu_new
MLP, final ln_f; no positional embeddings inside the stack.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .layers import LayerNorm, normal_


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi)
                                  * (x + 0.044715 * (x ** 3))))
    return x * cdf


class Conv1DGPT(nn.Module):
    """HF GPT-2 'Conv1D': y = x @ W + b with W stored (in, out)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def _init(self, gen):
        normal_(self.weight, 0.02, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return x.to(dt) @ self.weight.to(dt) + self.bias


def attend(qkv: torch.Tensor, attn_mask: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head attention from the fused projection qkv (B, S, 3 * D);
    attn_mask (B, S, S) True where a key is attended.  Scores and softmax
    in f32."""
    b, s, _ = qkv.shape
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    d = q.shape[-1]
    hd = d // heads
    q = q.reshape(b, s, heads, hd).transpose(1, 2)          # (B, H, S, hd)
    k = k.reshape(b, s, heads, hd).transpose(1, 2)
    v = v.reshape(b, s, heads, hd).transpose(1, 2)
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    scores = torch.where(attn_mask[:, None], scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = (probs.float() @ v.float()).to(v.dtype)
    return ctx.transpose(1, 2).reshape(b, s, d)


class GPT2Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(dim)
        self.attn_c_attn = Conv1DGPT(dim, 3 * dim)
        self.attn_c_proj = Conv1DGPT(dim, dim)
        self.ln_2 = LayerNorm(dim)
        self.mlp_c_fc = Conv1DGPT(dim, 4 * dim)
        self.mlp_c_proj = Conv1DGPT(4 * dim, dim)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn_c_proj(attend(self.attn_c_attn(self.ln_1(x)), attn_mask,
                                        self.heads))
        return x + self.mlp_c_proj(gelu_new(self.mlp_c_fc(self.ln_2(x))))


class GPT2Stack(nn.Module):
    def __init__(self, layers: int, dim: int, heads: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            setattr(self, f"h_{i}", GPT2Block(dim, heads))
        self.ln_f = LayerNorm(dim)

    def forward(self, embeds: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """embeds (B, S, D) -> hidden (B, S, D): causal, and over the keys
        valid_mask (B, S) marks, when given."""
        b, s, _ = embeds.shape
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=embeds.device))
        mask = mask[None].expand(b, s, s)
        if valid_mask is not None:
            mask = mask & valid_mask[:, None, :]
        x = embeds
        for i in range(self.layers):
            x = getattr(self, f"h_{i}")(x, mask)
        return self.ln_f(x)

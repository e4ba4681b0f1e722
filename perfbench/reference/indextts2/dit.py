"""Flow-matching DiT estimator, plain PyTorch (a frozen copy of the
program's `models/s2mel/dit.py` without its K8 / K9 / K11 branches):
llama-style blocks with AdaLN(RMSNorm) on the timestep embedding,
interleaved-pair RoPE, SwiGLU FF, full key-masked attention through the
einsum, long skip connection, WaveNet final head.

`step_tables(t_span)` evaluates every timestep-dependent projection once
for the whole Euler schedule; `forward(tables=...)` takes one step's slice
and skips those projections (same parameters on the same t values).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import DiTConfig, WaveNetConfig
from .layers import Conv1d, Linear, RMSNorm
from .wavenet import WN


def find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


def rope_cache(seq_len: int, head_dim: int, base: float) -> np.ndarray:
    """(seq_len, head_dim//2, 2) cos/sin cache."""
    freqs = 1.0 / (base ** (np.arange(0, head_dim, 2)[: head_dim // 2] / head_dim))
    t = np.arange(seq_len)
    angles = np.outer(t, freqs)
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def rope_freqs(seq_len: int, head_dim: int, base: float, device: str) -> torch.Tensor:
    """`rope_cache` on `device`, made once a shape: every Euler step asks for
    it, and a captured step copies nothing from the host."""
    return torch.from_numpy(rope_cache(seq_len, head_dim, base)).to(device)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); freqs (T, D//2, 2); interleaved-pair rotation."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    cos = freqs[None, :, None, :, 0]
    sin = freqs[None, :, None, :, 1]
    out = torch.stack([xf[..., 0] * cos - xf[..., 1] * sin,
                       xf[..., 1] * cos + xf[..., 0] * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class AdaptiveRMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.project_layer = Linear(dim, 2 * dim)
        self.norm = RMSNorm(dim)

    def project(self, c: torch.Tensor) -> torch.Tensor:
        return self.project_layer(c)

    def forward(self, x, c=None, wb=None):
        if wb is None:
            wb = self.project(c)
        weight, bias = torch.chunk(wb.to(x.dtype), 2, dim=-1)
        return weight * self.norm(x) + bias


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.attention_norm = AdaptiveRMSNorm(d)
        self.wqkv = Linear(d, 3 * d, use_bias=False)
        self.wo = Linear(d, d, use_bias=False)
        self.ffn_norm = AdaptiveRMSNorm(d)
        inner = find_multiple(int(2 * 4 * d / 3), 256)
        self.w1 = Linear(d, inner, use_bias=False)
        self.w3 = Linear(d, inner, use_bias=False)
        self.w2 = Linear(inner, d, use_bias=False)

    def forward(self, x, c, freqs, mask, x_lens=None, tables=None):
        d = self.cfg.hidden_dim
        h = self.cfg.num_heads
        hd = d // h
        b, t, _ = x.shape
        wb_attn, wb_ffn = tables if tables is not None else (None, None)
        y = self.attention_norm(x, c, wb=wb_attn)
        q, k, v = torch.chunk(self.wqkv(y), 3, dim=-1)
        q = apply_rope(q.reshape(b, t, h, hd), freqs)
        k = apply_rope(k.reshape(b, t, h, hd), freqs)
        v = v.reshape(b, t, h, hd)
        scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(hd)
        scores = scores.float()
        scores = torch.where(mask[:, None, :, :], scores,
                             torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhij,bjhd->bihd", probs, v).reshape(b, t, d)
        x = x + self.wo(attn)
        y = self.ffn_norm(x, c, wb=wb_ffn)
        return x + self.w2(F.silu(self.w1(y)) * self.w3(y))


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding + MLP (scale 1000, max_period 10000)."""

    def __init__(self, hidden: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp_0 = Linear(freq_dim, hidden)
        self.mlp_2 = Linear(hidden, hidden)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.freq_dim // 2
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, device=t.device, dtype=torch.float32)
                          / half)
        args = 1000.0 * t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.mlp_2(F.silu(self.mlp_0(emb)))


class FinalLayer(nn.Module):
    """adaLN-modulated LayerNorm + linear; the modulation reads the DiT's
    timestep embedding, `cond_dim` wide."""

    def __init__(self, hidden: int, cond_dim: int):
        super().__init__()
        self.adaLN_1 = Linear(cond_dim, 2 * hidden)
        self.linear = Linear(hidden, hidden)

    def modulation(self, c: torch.Tensor) -> torch.Tensor:
        return self.adaLN_1(F.silu(c))

    def forward(self, x, c=None, mod=None):
        if mod is None:
            mod = self.modulation(c)
        shift, scale = torch.chunk(mod.to(x.dtype), 2, dim=-1)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + 1e-6)).to(x.dtype)
        y = y * (1 + scale[:, None, :]) + shift[:, None, :]
        return self.linear(y)


class DiT(nn.Module):
    """Velocity estimator: x (B, 80, T) noisy mel, prompt_x (B, 80, T),
    x_lens (B,), t (B,), style (B, style_dim), cond (B, T, content_dim)."""

    def __init__(self, cfg: DiTConfig, wavenet_cfg: WaveNetConfig):
        super().__init__()
        self.cfg = cfg
        c, w = cfg, wavenet_cfg
        d = c.hidden_dim
        self.t_embedder = TimestepEmbedder(d)
        self.cond_projection = Linear(c.content_dim, d)
        self.cond_x_merge_linear = Linear(2 * c.in_channels + d + c.style_dim, d)
        for i in range(c.depth):
            setattr(self, f"block_{i}", DiTBlock(c))
        self.transformer_norm = AdaptiveRMSNorm(d)
        if c.long_skip_connection:
            self.skip_linear = Linear(d + c.in_channels, d)
        self.t_embedder2 = TimestepEmbedder(w.hidden_dim)
        self.conv1 = Linear(d, w.hidden_dim)
        self.wavenet = WN(w, w.hidden_dim)
        self.res_projection = Linear(d, w.hidden_dim)
        self.final_layer = FinalLayer(w.hidden_dim, d)
        self.conv2 = Conv1d(w.hidden_dim, c.in_channels, 1)

    def step_tables(self, t_span: torch.Tensor) -> dict:
        """t_span (S,) -> dict of per-step tables with leading axis S."""
        t1 = self.t_embedder(t_span)
        t2 = self.t_embedder2(t_span)
        ce = t1[:, None, :]
        blocks = tuple(
            (getattr(self, f"block_{i}").attention_norm.project(ce),
             getattr(self, f"block_{i}").ffn_norm.project(ce))
            for i in range(self.cfg.depth))
        return {"t1": t1[:, None, :], "t2": t2[:, None, :], "blocks": blocks,
                "norm": self.transformer_norm.project(ce),
                "final": self.final_layer.modulation(t1)[:, None, :]}

    @staticmethod
    def table_step(tables: dict, i: int) -> dict:
        """The step-i slice of `step_tables` (and of its `fused_wb`)."""
        step = {"t1": tables["t1"][i], "t2": tables["t2"][i],
                "blocks": tuple((a[i], f[i]) for a, f in tables["blocks"]),
                "norm": tables["norm"][i], "final": tables["final"][i]}
        if "fused_wb" in tables:
            step["fused_wb"] = tables["fused_wb"][i]
        return step

    def forward(self, x, prompt_x, x_lens, t, style, cond,
                tables: Optional[dict] = None):
        c = self.cfg
        b, _, tlen = x.shape
        t1 = (self.t_embedder(t) if tables is None else tables["t1"]).to(x.dtype)
        cond = self.cond_projection(cond)
        xt = x.transpose(1, 2)
        pt = prompt_x.transpose(1, 2)
        x_in = torch.cat([xt, pt, cond,
                          style[:, None, :].expand(b, tlen, style.shape[-1])], dim=-1)
        h = self.cond_x_merge_linear(x_in)
        mask = torch.arange(tlen, device=x.device)[None, :] < x_lens[:, None]
        c_emb = t1[:, None, :]
        attn_mask = mask[:, None, :].expand(b, tlen, tlen)
        freqs = rope_freqs(tlen, c.hidden_dim // c.num_heads, float(c.rope_base),
                           str(x.device))
        for i in range(c.depth):
            h = getattr(self, f"block_{i}")(
                h, c_emb, freqs, attn_mask, x_lens,
                tables["blocks"][i] if tables is not None else None)
        h = self.transformer_norm(
            h, c_emb, wb=tables["norm"] if tables is not None else None)
        if c.long_skip_connection:
            h = self.skip_linear(torch.cat([h, xt], dim=-1))
        t2 = (self.t_embedder2(t) if tables is None else tables["t2"]).to(x.dtype)
        y = self.conv1(h).transpose(1, 2)
        x_mask = mask[:, None, :].to(y.dtype)
        g = t2[:, :, None].expand(b, t2.shape[-1], 1)
        y = self.wavenet(y, x_mask, g=g, x_lens=x_lens)
        y = y.transpose(1, 2) + self.res_projection(h)
        y = self.final_layer(
            y, t1, mod=tables["final"] if tables is not None else None)
        return self.conv2(y.transpose(1, 2))

"""wenet-style conformer conditioning encoder
(`voice_tts_tpu/models/gpt/conformer.py`): rel-pos multi-head attention
without rel-shift, GLU conv module, pre-norm, conv2d subsampling (linear,
conv2d2, conv2d, conv2d6, conv2d8)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voice_tts_tpu_torch.config import ConformerConfig
from voice_tts_tpu_torch.models.layers import (Conv1d, LayerNorm, Linear, einsum,
                                               lecun_normal_, xavier_uniform_)

_SUB_CONV_STAGES = {
    "conv2d2": ((3, 2),),
    "conv2d": ((3, 2), (3, 2)),
    "conv2d6": ((3, 2), (5, 3)),
    "conv2d8": ((3, 2), (3, 2), (3, 2)),
}
_SUB_MASK_SLICES = {
    "conv2d2": ((2, 2),),
    "conv2d": ((2, 2), (2, 2)),
    "conv2d6": ((2, 2), (4, 3)),
    "conv2d8": ((2, 2), (2, 2), (2, 2)),
}


def sinusoid_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """(1, max_len, d) transformer PE table."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]


class RelPositionAttention(nn.Module):
    def __init__(self, heads: int, dim: int):
        super().__init__()
        self.heads, self.dim = heads, dim
        dk = dim // heads
        self.linear_q = Linear(dim, dim)
        self.linear_k = Linear(dim, dim)
        self.linear_v = Linear(dim, dim)
        self.linear_pos = Linear(dim, dim, use_bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(heads, dk))
        self.pos_bias_v = nn.Parameter(torch.empty(heads, dk))
        self.linear_out = Linear(dim, dim)

    def _init(self, gen):
        xavier_uniform_(self.pos_bias_u, gen)
        xavier_uniform_(self.pos_bias_v, gen)

    def forward(self, x, pos_emb, mask: Optional[torch.Tensor]):
        b, t, _ = x.shape
        h, dk = self.heads, self.dim // self.heads
        q = self.linear_q(x).reshape(b, t, h, dk)
        k = self.linear_k(x).reshape(b, t, h, dk)
        v = self.linear_v(x).reshape(b, t, h, dk)
        p = self.linear_pos(pos_emb).reshape(1, -1, h, dk)
        ac = einsum("bihd,bjhd->bhij", q + self.pos_bias_u, k)
        bd = einsum("bihd,pjhd->bhij", q + self.pos_bias_v, p)
        scores = (ac + bd) / math.sqrt(dk)
        if mask is not None:
            scores = torch.where(mask[:, None, :, :], scores,
                                 torch.finfo(scores.dtype).min)
            probs = torch.softmax(scores, dim=-1)
            probs = torch.where(mask[:, None, :, :], probs, 0.0)
        else:
            probs = torch.softmax(scores, dim=-1)
        out = einsum("bhij,bjhd->bihd", probs, v)
        return self.linear_out(out.reshape(b, t, self.dim))


class ConvModule(nn.Module):
    """GLU conv module."""

    def __init__(self, dim: int, kernel_size: int = 15):
        super().__init__()
        self.pointwise_conv1 = Conv1d(dim, 2 * dim, 1)
        self.depthwise_conv = Conv1d(dim, dim, kernel_size, groups=dim,
                                     padding=(kernel_size - 1) // 2)
        self.norm = LayerNorm(dim)
        self.pointwise_conv2 = Conv1d(dim, dim, 1)

    def forward(self, x, pad_mask: Optional[torch.Tensor] = None):
        h = x.transpose(1, 2)
        if pad_mask is not None:
            h = h * pad_mask[:, None, :]
        h = self.pointwise_conv1(h)
        a, g = torch.chunk(h, 2, dim=1)
        h = self.depthwise_conv(a * torch.sigmoid(g))
        h = F.silu(self.norm(h.transpose(1, 2))).transpose(1, 2)
        h = self.pointwise_conv2(h)
        if pad_mask is not None:
            h = h * pad_mask[:, None, :]
        return h.transpose(1, 2)


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.output_size
        self.norm_mha = LayerNorm(d)
        self.self_attn = RelPositionAttention(cfg.attention_heads, d)
        self.norm_conv = LayerNorm(d)
        self.conv_module = ConvModule(d, cfg.cnn_module_kernel)
        self.norm_ff = LayerNorm(d)
        self.ff_w1 = Linear(d, cfg.linear_units)
        self.ff_w2 = Linear(cfg.linear_units, d)
        self.norm_final = LayerNorm(d)

    def forward(self, x, pos_emb, mask, pad_mask):
        x = x + self.self_attn(self.norm_mha(x), pos_emb, mask)
        x = x + self.conv_module(self.norm_conv(x), pad_mask)
        x = x + self.ff_w2(F.silu(self.ff_w1(self.norm_ff(x))))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """(B, T, input_size) + lengths -> ((B, T', output_size), mask (B, 1, T'))."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.output_size
        if cfg.input_layer in _SUB_CONV_STAGES:
            in_ch, feat = 1, cfg.input_size
            for i, (k, s) in enumerate(_SUB_CONV_STAGES[cfg.input_layer]):
                tag = "" if i == 0 else str(i)
                setattr(self, f"sub_conv{tag}_weight",
                        nn.Parameter(torch.empty(d, in_ch, k, k)))
                setattr(self, f"sub_conv{tag}_bias", nn.Parameter(torch.zeros(d)))
                in_ch, feat = d, (feat - k) // s + 1
            self.sub_out = Linear(d * feat, d)
        elif cfg.input_layer == "linear":
            self.sub_out = Linear(cfg.input_size, d)
            self.sub_norm = LayerNorm(d)
        else:
            raise NotImplementedError(cfg.input_layer)
        for i in range(cfg.num_blocks):
            setattr(self, f"layer_{i}", ConformerLayer(cfg))
        self.after_norm = LayerNorm(d)

    def _init(self, gen):
        for i in range(len(_SUB_CONV_STAGES.get(self.cfg.input_layer, ()))):
            tag = "" if i == 0 else str(i)
            lecun_normal_(getattr(self, f"sub_conv{tag}_weight"), gen)
            nn.init.zeros_(getattr(self, f"sub_conv{tag}_bias"))

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, t, _ = x.shape
        if lengths is None:
            lengths = torch.full((b,), t, dtype=torch.int64, device=x.device)
        mask = (torch.arange(t, device=x.device)[None, :] < lengths[:, None])[:, None, :]
        if cfg.input_layer in _SUB_CONV_STAGES:
            h = x[:, None, :, :]
            for i, (_, s) in enumerate(_SUB_CONV_STAGES[cfg.input_layer]):
                tag = "" if i == 0 else str(i)
                w = getattr(self, f"sub_conv{tag}_weight")
                bias = getattr(self, f"sub_conv{tag}_bias")
                h = F.relu(F.conv2d(h, w, None, s) + bias[None, :, None, None])
                start, step = _SUB_MASK_SLICES[cfg.input_layer][i]
                mask = mask[:, :, start::step]
            bb, cc, tt, ff = h.shape
            h = self.sub_out(h.transpose(1, 2).reshape(bb, tt, cc * ff))
        else:
            h = self.sub_norm(self.sub_out(x))
        tp = h.shape[1]
        pe = torch.from_numpy(sinusoid_position_encoding(max(tp, 1),
                                                         cfg.output_size)).to(h.device)
        h = h * math.sqrt(cfg.output_size)
        # the table stays f32, as in the JAX module: under bf16 weights the
        # position projection, and from it the attention, computes in f32
        pos_emb = pe[:, :tp]
        pad_mask = mask[:, 0, :].to(h.dtype)
        for i in range(cfg.num_blocks):
            h = getattr(self, f"layer_{i}")(h, pos_emb, mask, pad_mask)
        return self.after_norm(h), mask

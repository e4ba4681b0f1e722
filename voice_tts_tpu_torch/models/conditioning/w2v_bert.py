"""w2v-bert-2.0 semantic encoder, truncated at `output_layer`
(`voice_tts_tpu/models/conditioning/w2v_bert.py`): conformer layers with
relative_key attention, GLU causal depthwise conv module, half-step FFNs."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from voice_tts_tpu_torch.config import W2VBertConfig
from voice_tts_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, normal_


class FeedForward(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.intermediate_dense = Linear(hidden, intermediate)
        self.output_dense = Linear(intermediate, hidden)

    def forward(self, x):
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class ConvModule(nn.Module):
    def __init__(self, hidden: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.layer_norm = LayerNorm(hidden)
        self.pointwise_conv1 = Conv1d(hidden, 2 * hidden, 1, use_bias=False)
        self.depthwise_conv = Conv1d(hidden, hidden, kernel_size, groups=hidden,
                                     use_bias=False)
        self.depthwise_layer_norm = LayerNorm(hidden)
        self.pointwise_conv2 = Conv1d(hidden, hidden, 1, use_bias=False)

    def forward(self, x, pad_mask: Optional[torch.Tensor] = None):
        x = self.layer_norm(x)
        if pad_mask is not None:
            x = x * pad_mask[..., None]
        h = self.pointwise_conv1(x.transpose(1, 2))
        a, b = torch.chunk(h, 2, dim=1)
        h = F.pad(a * torch.sigmoid(b), (self.kernel_size - 1, 0))
        h = self.depthwise_conv(h)
        h = F.silu(self.depthwise_layer_norm(h.transpose(1, 2))).transpose(1, 2)
        return self.pointwise_conv2(h).transpose(1, 2)


class SelfAttention(nn.Module):
    """relative_key attention: content scores + clamped-distance embedding."""

    def __init__(self, hidden: int, heads: int, left_max: int, right_max: int):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.left_max, self.right_max = left_max, right_max
        d = hidden // heads
        self.linear_q = Linear(hidden, hidden)
        self.linear_k = Linear(hidden, hidden)
        self.linear_v = Linear(hidden, hidden)
        self.distance_embedding = nn.Parameter(torch.empty(left_max + right_max + 1, d))
        self.linear_out = Linear(hidden, hidden)

    def _init(self, gen):
        normal_(self.distance_embedding, 0.02, gen)

    def forward(self, x, attn_bias: Optional[torch.Tensor] = None):
        b, t, _ = x.shape
        d = self.hidden // self.heads
        q = self.linear_q(x).reshape(b, t, self.heads, d)
        k = self.linear_k(x).reshape(b, t, self.heads, d)
        v = self.linear_v(x).reshape(b, t, self.heads, d)
        scale = 1.0 / math.sqrt(d)
        scores = torch.einsum("bihd,bjhd->bhij", q, k) * scale
        pos = torch.arange(t, device=x.device)
        distance = (torch.clamp(pos[None, :] - pos[:, None], -self.left_max,
                                self.right_max) + self.left_max)
        pos_emb = self.distance_embedding[distance]              # (T, T, d)
        scores = scores + torch.einsum("bihd,ijd->bhij", q, pos_emb) * scale
        if attn_bias is not None:
            scores = scores + attn_bias
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", probs, v)
        return self.linear_out(out.reshape(b, t, self.hidden))


class ConformerLayer(nn.Module):
    def __init__(self, c: W2VBertConfig):
        super().__init__()
        h = c.hidden_size
        self.ffn1_layer_norm = LayerNorm(h)
        self.ffn1 = FeedForward(h, c.intermediate_size)
        self.self_attn_layer_norm = LayerNorm(h)
        self.self_attn = SelfAttention(h, c.num_heads,
                                       c.left_max_position_embeddings,
                                       c.right_max_position_embeddings)
        self.conv_module = ConvModule(h, c.conv_kernel_size)
        self.ffn2_layer_norm = LayerNorm(h)
        self.ffn2 = FeedForward(h, c.intermediate_size)
        self.final_layer_norm = LayerNorm(h)

    def forward(self, x, attn_bias=None, pad_mask=None):
        x = self.ffn1(self.ffn1_layer_norm(x)) * 0.5 + x
        x = self.self_attn(self.self_attn_layer_norm(x), attn_bias) + x
        x = x + self.conv_module(x, pad_mask)
        x = self.ffn2(self.ffn2_layer_norm(x)) * 0.5 + x
        return self.final_layer_norm(x)


class Wav2Vec2Bert(nn.Module):
    """input_features (B, T, 160) -> hidden state of layer `output_layer`."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        self.fp_layer_norm = LayerNorm(cfg.feature_projection_input_dim)
        self.fp_projection = Linear(cfg.feature_projection_input_dim, cfg.hidden_size)
        for i in range(cfg.output_layer):
            setattr(self, f"layer_{i}", ConformerLayer(cfg))

    def forward(self, features: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.fp_projection(self.fp_layer_norm(features))
        attn_bias = pad_mask = None
        if attention_mask is not None:
            pad_mask = attention_mask.to(x.dtype)
            x = x * pad_mask[..., None]
            attn_bias = (1.0 - pad_mask)[:, None, None, :] * torch.finfo(x.dtype).min
        for i in range(self.cfg.output_layer):
            x = getattr(self, f"layer_{i}")(x, attn_bias, pad_mask)
        return x

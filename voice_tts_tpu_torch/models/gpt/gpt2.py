"""GPT-2 transformer stack with a preallocated KV cache
(`voice_tts_tpu/models/gpt/gpt2.py`), float or int8 KV.

Pre-LN blocks, fused-qkv Conv1D projections, gelu_new MLP, final ln_f; no
positional embeddings inside the stack.  One module handles both the plain
causal forward and prefill / single steps against a fixed-shape cache.

Cache layout: (layers, 2, B, heads, head_dim, max_len), as in the JAX
package; the decode kernel takes it time-major (`ops.fused_decode`).  An
int8 cache is a `QuantKVCache`: int8 rows with one f32 scale per (layer,
k/v, batch, head, position), the dequant folded into the scores and the
probabilities (the unfused decode with `int8_kv`).  With
`pallas_attention` (`GPTConfig.pallas_decode_attention`) a single-token step
over a cache whose length is a multiple of 512 attends through K5
(`ops.decode_attention`), which reads only the live prefix.

`cache_index`, where the new rows land, is a host int or a 0-d integer
tensor on the device (a device loop's position, as the JAX package's
traced index, `dynamic_update_slice` at `voice_tts_tpu/models/gpt/gpt2.py:
120-133`): the cache is then written with `index_copy_` and K5 reads its
length from the device, so no host code reads the position.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from voice_tts_tpu_torch.models.layers import LayerNorm, normal_
from voice_tts_tpu_torch.ops.decode_attention import BLOCK_T, decode_attention
from voice_tts_tpu_torch.ops.int8_matmul import MAX_ROWS, int8_gemv

# a cache position: a host int, or a 0-d integer tensor on the device
Index = Union[int, torch.Tensor]


class QuantKVCache(NamedTuple):
    """int8 KV cache of the unfused decode (`voice_tts_tpu/models/gpt/gpt2.py:27-38`).

    Symmetric per-(layer, k/v, batch, head, position) scales: dequant is
    `int8 * scale`.  The scales fold into the attention scores and
    probabilities, so the dequantized cache is never materialized."""

    kv: torch.Tensor      # (L, 2, B, H, hd, Tmax) int8
    scales: torch.Tensor  # (L, 2, B, H, Tmax) f32


def _quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t (B, H, hd, S) float -> (int8 rows, scales (B, H, S) f32): scale
    max|t| over hd / 127 floored at 1e-12, round half to even (as
    `jnp.round`), clip to +-127.  `* (1 / 127)`: the JAX `decode` is jitted,
    and XLA compiles its `/ 127.0` into a multiply by the f32 reciprocal;
    the division by the scale is a true one there and here."""
    tf = t.float()
    s = torch.clamp(tf.abs().amax(dim=2) * (1.0 / 127.0), min=1e-12)
    q = torch.clamp(torch.round(tf / s[:, :, None, :]), -127, 127)
    return q.to(torch.int8), s


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation, written op by op as `jax.nn.gelu(x,
    approximate=True)` is, so a bf16 input rounds where the JAX graph does."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi)
                                  * (x + 0.044715 * (x ** 3))))
    return x * cdf


class Conv1DGPT(nn.Module):
    """HF GPT-2 'Conv1D': y = x @ W + b with W stored (in, out).

    Three branches, as in the JAX module: float weights; int8 weights (a
    `scale` buffer is present, see `utils.quantize`) with at most 32 rows
    -> the K4 int8 GEMV; int8 weights with more rows -> dequantize to bf16
    and multiply with `torch.matmul` (f32 accumulation), output in x's dtype.
    """

    def __init__(self, in_features: int, features: int, int8: bool = False):
        super().__init__()
        if int8:
            self.register_buffer("weight", torch.zeros(in_features, features,
                                                       dtype=torch.int8))
            self.register_buffer("scale", torch.ones(1, features))
        else:
            self.weight = nn.Parameter(torch.empty(in_features, features))
            self.scale = None
        self.bias = nn.Parameter(torch.zeros(features))

    def _init(self, gen):
        if self.scale is None:
            normal_(self.weight, 0.02, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if self.scale is None:
            dt = torch.promote_types(x.dtype, w.dtype)
            return x.to(dt) @ w.to(dt) + b
        if x.dim() == 3 and x.shape[0] * x.shape[1] <= MAX_ROWS:
            bsz, s, din = x.shape
            y = int8_gemv(x.reshape(bsz * s, din), w, self.scale.float())
            return y.reshape(bsz, s, -1) + b
        y = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
        return (y * self.scale.float() + b).to(x.dtype)


def _write_time(buf: torch.Tensor, cache_index: Index, rows: torch.Tensor) -> None:
    """rows (..., S) into buf (..., Tmax) at [cache_index, cache_index + S)
    along the last axis: a slice for a host int, `index_copy_` for a
    device position (no host read)."""
    s = rows.shape[-1]
    if not isinstance(cache_index, torch.Tensor):
        buf[..., cache_index:cache_index + s] = rows
        return
    idx = cache_index.to(buf.device).reshape(1).long() + torch.arange(s, device=buf.device)
    buf.index_copy_(buf.dim() - 1, idx, rows.to(buf.dtype))


def attend(qkv: torch.Tensor, kv, cache_index: Index, attn_mask: torch.Tensor,
           heads: int, pallas_attention: bool = False) -> torch.Tensor:
    """Multi-head attention of a block from its fused projection `qkv` (B,
    S, 3 * heads * hd) = [q | k | v]: writes K/V into `kv` (as
    `GPT2Block.forward` takes it) at `cache_index` (a host int or a 0-d
    device tensor) and returns the context (B, S, heads * hd).  The
    tensor-parallel block calls it on each shard's heads."""
    b, s, _ = qkv.shape
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    d = q.shape[-1]
    h, hd = heads, d // heads
    q = q.reshape(b, s, h, hd).transpose(1, 2)               # (B,H,S,hd)
    k = k.reshape(b, s, h, hd).permute(0, 2, 3, 1)           # (B,H,hd,S)
    v = v.reshape(b, s, h, hd).permute(0, 2, 3, 1)
    int8_kv = isinstance(kv, tuple)
    if int8_kv:
        kv_q, kv_s = kv
        for i, t in enumerate((k, v)):
            q_i, s_i = _quantize_kv(t)
            _write_time(kv_q[i], cache_index, q_i)
            _write_time(kv_s[i], cache_index, s_i)
        k_all, v_all = kv_q[0], kv_q[1]
    elif kv is not None:
        _write_time(kv[0], cache_index, k.to(kv.dtype))
        _write_time(kv[1], cache_index, v.to(kv.dtype))
        k_all, v_all = kv[0], kv[1]
    else:
        k_all, v_all = k, v
    if (pallas_attention and kv is not None and not int8_kv and s == 1
            and k_all.shape[3] % BLOCK_T == 0):
        # K5: reads only the live prefix [0, cache_index]; a device position
        # stays on the device as K5's length
        bias = torch.where(attn_mask[:, 0, :], 0.0, -1e30).float()
        length = (cache_index.to(q.device).reshape(()) + 1
                  if isinstance(cache_index, torch.Tensor) else cache_index + 1)
        return decode_attention(q[:, :, 0, :], k_all, v_all, bias,
                                length).reshape(b, s, d)
    # f32 scores / softmax regardless of the compute dtype; an int8 cache is
    # cast to the compute dtype before each product (exact: |q| <= 127), its
    # k dequant rides on the scores and its v dequant on the probabilities
    k_dot = k_all.to(q.dtype) if int8_kv else k_all
    scores = q.float() @ k_dot.float()
    if int8_kv:
        scores = scores * kv_s[0][:, :, None, :]
    scores = scores / math.sqrt(hd)
    scores = torch.where(attn_mask[:, None, :, :], scores,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if int8_kv:
        probs = probs * kv_s[1][:, :, None, :]
    v_dot = v_all.to(q.dtype) if int8_kv else v_all
    probs = probs.to(v_dot.dtype)
    ctx = (probs.float() @ v_dot.float().transpose(-1, -2)).to(v_dot.dtype)
    return ctx.transpose(1, 2).reshape(b, s, d)


class GPT2Block(nn.Module):
    def __init__(self, dim: int, heads: int, int8: bool = False,
                 pallas_attention: bool = False):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.pallas_attention = pallas_attention
        self.ln_1 = LayerNorm(dim)
        self.attn_c_attn = Conv1DGPT(dim, 3 * dim, int8)
        self.attn_c_proj = Conv1DGPT(dim, dim, int8)
        self.ln_2 = LayerNorm(dim)
        self.mlp_c_fc = Conv1DGPT(dim, 4 * dim, int8)
        self.mlp_c_proj = Conv1DGPT(4 * dim, dim, int8)

    def forward(self, x, kv, cache_index: Index, attn_mask: torch.Tensor):
        """x (B, S, D); kv (2, B, H, hd, Tmax), an int8 pair ((2, B, H, hd,
        Tmax) int8, (2, B, H, Tmax) f32 scales) or None; attn_mask (B, S, L).

        With a cache, K/V of the current block are written at
        [cache_index, cache_index + S) (in place, quantized for an int8
        pair) and attention spans the whole cache.  Returns (hidden, kv)."""
        res = x
        y = self.ln_1(x)
        ctx = attend(self.attn_c_attn(y), kv, cache_index, attn_mask, self.heads,
                     self.pallas_attention)
        x = res + self.attn_c_proj(ctx)
        res = x
        y = self.ln_2(x)
        y = self.mlp_c_fc(y)
        y = gelu_new(y)
        y = self.mlp_c_proj(y)
        return res + y, kv


def attention_mask(embeds: torch.Tensor, kv_cache, cache_index: Index,
                   valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, S, L) attendable keys of a stack's forward: causal over the S
    new rows at [cache_index, cache_index + S) of a cache of length L (or
    over the rows alone without a cache), and `valid_mask` (B, L).  A
    device `cache_index` gives the query positions on the device."""
    b, s, _ = embeds.shape
    dev = embeds.device
    if kv_cache is not None:
        cache = kv_cache.kv if isinstance(kv_cache, QuantKVCache) else kv_cache
        t_max = cache.shape[5]
        pos = torch.arange(t_max, device=dev)[None, None, :]
        q_pos = cache_index + torch.arange(s, device=dev)[None, :, None]
        mask = (pos <= q_pos).expand(b, s, t_max)
    else:
        t_max = s
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))[None].expand(b, s, s)
    if valid_mask is not None:
        mask = mask & valid_mask[:, None, :t_max]
    return mask


class GPT2Stack(nn.Module):
    def __init__(self, layers: int, dim: int, heads: int, int8: bool = False,
                 pallas_attention: bool = False):
        super().__init__()
        self.layers, self.dim, self.heads = layers, dim, heads
        for i in range(layers):
            setattr(self, f"h_{i}", GPT2Block(dim, heads, int8, pallas_attention))
        self.ln_f = LayerNorm(dim)

    def forward(self, embeds: torch.Tensor,
                kv_cache: Union[torch.Tensor, QuantKVCache, None] = None,
                cache_index: Index = 0,
                valid_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Union[torch.Tensor, QuantKVCache, None]]:
        """embeds (B, S, D) -> (hidden (B, S, D), cache).  `kv_cache` (a
        float tensor or a `QuantKVCache`) is updated in place.  valid_mask
        (B, L): attendable key positions."""
        int8_kv = isinstance(kv_cache, QuantKVCache)
        mask = attention_mask(embeds, kv_cache, cache_index, valid_mask)
        x = embeds
        for i in range(self.layers):
            if kv_cache is None:
                kv = None
            elif int8_kv:
                kv = (kv_cache.kv[i], kv_cache.scales[i])
            else:
                kv = kv_cache[i]
            x, _ = getattr(self, f"h_{i}")(x, kv, cache_index, mask)
        return self.ln_f(x), kv_cache

    def init_cache(self, batch: int, max_len: int, dtype, device) -> torch.Tensor:
        hd = self.dim // self.heads
        return torch.zeros((self.layers, 2, batch, self.heads, hd, max_len),
                           dtype=dtype, device=device)

    def init_quant_cache(self, batch: int, max_len: int, device) -> QuantKVCache:
        """An empty int8 cache, its scales 1e-12 (`init_quant_cache`)."""
        hd = self.dim // self.heads
        shape = (self.layers, 2, batch, self.heads, hd, max_len)
        return QuantKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.full(shape[:4] + (max_len,), 1e-12, dtype=torch.float32,
                       device=device))

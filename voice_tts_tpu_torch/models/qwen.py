"""Qwen-architecture causal LM for text -> emotion classification
(`voice_tts_tpu/models/qwen.py`).

The reference drives a Qwen chat model through HF generate to classify a
sentence into the 8 canonical emotions (`engine/qwen_emotion.py`).  This is
the llama-family decoder of the JAX package: RMSNorm, half-rotation RoPE,
GQA (each kv head repeated for its query heads), SwiGLU; Qwen2 with q/k/v
biases or Qwen3 with per-head q/k RMSNorm; the head tied to the embedding
or its own `lm_head`.  The modules carry the JAX names (`embed_tokens`,
`layer_{i}/{q,k,v,o}_proj`, `input_layernorm`, `post_attention_layernorm`,
`q_norm` / `k_norm`, `gate_proj` / `up_proj` / `down_proj`, `norm`,
`lm_head`), so a JAX Qwen tree flattens onto the `state_dict`
(`utils/convert.flatten_params`) and `utils/checkpoint.convert_qwen` maps a
Hugging Face checkpoint onto it.

Attention is dense, as the JAX side's einsums are (no Pallas kernel there,
no hand kernel here): masked scores take float-min, so a row with every
key masked softmaxes to uniform as in JAX.  The KV cache is f32, (L, 2, B,
kv_heads, Tmax, head_dim), written in place.

`qwen_greedy_decode` is JAX's `while_loop` on the device
(`engine/device_loop.py`): its state and stop test stay there, CHUNK steps
a chunk, one CUDA graph replay a chunk on the card and one host read after
it; a step after the stop leaves the state and the cache as they were.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from voice_tts_tpu_torch.engine import device_loop
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.models.layers import Embedding, Linear, RMSNorm
from voice_tts_tpu_torch.utils.convert import load_family

Index = Union[int, torch.Tensor]


class QwenArch(NamedTuple):
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 1000000.0
    rms_eps: float = 1e-6
    qkv_bias: bool = True      # Qwen2 style
    qk_norm: bool = False      # Qwen3 style
    tie_embeddings: bool = True


def _rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF llama-style rotation: rotate_half (first / second half split)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin (T, head_dim) f32 of the positions (T,) (a host range or
    one offset by a device position)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=positions.device,
                                        dtype=torch.float32) / head_dim))
    angles = positions.float()[..., None] * inv[None, :]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


class QwenBlock(nn.Module):
    def __init__(self, a: QwenArch):
        super().__init__()
        self.a = a
        h, kvh, hd = a.num_heads, a.num_kv_heads, a.head_dim
        self.input_layernorm = RMSNorm(a.hidden_size, a.rms_eps)
        self.q_proj = Linear(a.hidden_size, h * hd, use_bias=a.qkv_bias)
        self.k_proj = Linear(a.hidden_size, kvh * hd, use_bias=a.qkv_bias)
        self.v_proj = Linear(a.hidden_size, kvh * hd, use_bias=a.qkv_bias)
        if a.qk_norm:
            self.q_norm = RMSNorm(hd, a.rms_eps)
            self.k_norm = RMSNorm(hd, a.rms_eps)
        self.o_proj = Linear(h * hd, a.hidden_size, use_bias=False)
        self.post_attention_layernorm = RMSNorm(a.hidden_size, a.rms_eps)
        self.gate_proj = Linear(a.hidden_size, a.intermediate_size, use_bias=False)
        self.up_proj = Linear(a.hidden_size, a.intermediate_size, use_bias=False)
        self.down_proj = Linear(a.intermediate_size, a.hidden_size, use_bias=False)

    def forward(self, x, cos, sin, kv: Optional[torch.Tensor], positions: torch.Tensor,
                attn_mask: torch.Tensor, active: Optional[torch.Tensor]):
        """x (B, S, hidden); kv this layer's (2, B, kvh, Tmax, hd) cache or
        None; positions (S,) the cache rows the S tokens take; attn_mask
        (B, S, keys) bool.  The new k / v rows are written into kv in place
        (kept as they were where the 0-d `active` is False)."""
        a = self.a
        b, s, _ = x.shape
        h, kvh, hd = a.num_heads, a.num_kv_heads, a.head_dim
        y = self.input_layernorm(x)
        q = self.q_proj(y).reshape(b, s, h, hd)
        k = self.k_proj(y).reshape(b, s, kvh, hd)
        v = self.v_proj(y).reshape(b, s, kvh, hd)
        if a.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q = _rope_half(q, cos[None, :, None, :], sin[None, :, None, :]).transpose(1, 2)
        k = _rope_half(k, cos[None, :, None, :], sin[None, :, None, :]).transpose(1, 2)
        v = v.transpose(1, 2)
        if kv is not None:
            new = torch.stack([k, v]).to(kv.dtype)              # (2, B, kvh, S, hd)
            if active is not None:
                new = torch.where(active, new, kv.index_select(3, positions))
            kv.index_copy_(3, positions, new)
            k_all, v_all = kv[0], kv[1]
        else:
            k_all, v_all = k, v
        rep = h // kvh
        k_all = k_all.repeat_interleave(rep, dim=1)
        v_all = v_all.repeat_interleave(rep, dim=1)
        scores = torch.matmul(q, k_all.transpose(-1, -2)) / math.sqrt(hd)
        scores = torch.where(attn_mask[:, None], scores, torch.finfo(scores.dtype).min)
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v_all)
        x = x + self.o_proj(ctx.transpose(1, 2).reshape(b, s, h * hd))
        y = self.post_attention_layernorm(x)
        return x + self.down_proj(nn.functional.silu(self.gate_proj(y)) * self.up_proj(y))


class QwenLM(nn.Module):
    """The decoder; `forward` is JAX `QwenLM.__call__` with the cache
    written in place."""

    def __init__(self, arch: QwenArch):
        super().__init__()
        self.arch = arch
        self.embed_tokens = Embedding(arch.vocab_size, arch.hidden_size)
        for i in range(arch.num_layers):
            self.add_module(f"layer_{i}", QwenBlock(arch))
        self.norm = RMSNorm(arch.hidden_size, arch.rms_eps)
        if not arch.tie_embeddings:
            self.lm_head = Linear(arch.hidden_size, arch.vocab_size, use_bias=False)

    def init_cache(self, b: int, t_max: int, device) -> torch.Tensor:
        a = self.arch
        return torch.zeros((a.num_layers, 2, b, a.num_kv_heads, t_max, a.head_dim),
                           dtype=torch.float32, device=device)

    def forward(self, tokens: torch.Tensor, kv_cache: Optional[torch.Tensor] = None,
                cache_index: Index = 0, valid_mask: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (logits (B, S, vocab) f32, the cache).  With
        kv_cache the S tokens take cache rows cache_index .. + S - 1 (a host
        int or a 0-d device tensor) and attend every row up to their own;
        valid_mask (B, keys) masks left padding."""
        a = self.arch
        b, s = tokens.shape
        x = self.embed_tokens(tokens)
        positions = cache_index + torch.arange(s, device=tokens.device)
        cos, sin = rope_tables(positions, a.head_dim, a.rope_theta)
        if kv_cache is not None:
            t_max = kv_cache.shape[4]
            keys = torch.arange(t_max, device=tokens.device)
            mask = (keys[None, None, :] <= positions[None, :, None]).expand(b, s, t_max)
        else:
            mask = torch.ones((s, s), dtype=torch.bool, device=tokens.device).tril()
            mask = mask[None].expand(b, s, s)
        if valid_mask is not None:
            mask = mask & valid_mask[:, None, :mask.shape[-1]]
        for i in range(a.num_layers):
            kv = None if kv_cache is None else kv_cache[i]
            x = getattr(self, f"layer_{i}")(x, cos, sin, kv, positions, mask, active)
        x = self.norm(x)
        if a.tie_embeddings:
            logits = x @ self.embed_tokens.weight.t()
        else:
            logits = self.lm_head(x)
        return logits, kv_cache


def load_qwen_state(model: QwenLM, state) -> QwenLM:
    """Load a converted state (`convert_qwen`, or `flatten_params` of a JAX
    tree) strictly; a tied model drops the checkpoint's `lm_head.weight`
    (Hugging Face writes the tied copy)."""
    if model.arch.tie_embeddings:
        state = {k: v for k, v in state.items() if k != "lm_head.weight"}
    return load_family(model, state)


class QwenDecodeResult(NamedTuple):
    ids: torch.Tensor        # (B, max_new) generated ids, eos-padded
    steps: int               # decode steps after the prefill's token
    chunks: int              # chunks of the device loop


class _QwenState(NamedTuple):
    i: torch.Tensor          # () int64: ids so far, the next id's column
    token: torch.Tensor      # (B,) last id
    out: torch.Tensor        # (B, max_new)
    done: torch.Tensor       # (B,)


def qwen_greedy_decode(model: QwenLM, tokens: torch.Tensor, prompt_len, max_new: int,
                       eos_id: int, loops: Optional[DeviceLoops] = None,
                       chunk: Optional[int] = None) -> QwenDecodeResult:
    """tokens (B, P_bucket) *left-padded* (real tokens right-aligned),
    prompt_len (B,) or an int; greedy decode up to max_new (JAX
    `qwen_greedy_decode`: a uniform RoPE shift from the left padding is
    harmless).  The prefill runs op by op; the steps run as a device loop,
    `chunk` (default CHUNK) a chunk, on the card a replayed graph of `loops`
    (one of this call's own when None), or op by op with
    `DeviceLoops(..., capture=False)`.  `torch.argmax` takes the first
    index of a tie, as `jnp.argmax` does.  Returns the (B, max_new) ids,
    eos-padded, exactly JAX's, with the steps and chunks run."""
    b, pb = tokens.shape
    dev = tokens.device
    t_max = pb + max_new
    plen = torch.as_tensor(prompt_len, device=dev).reshape(-1)
    with torch.no_grad():
        cache = model.init_cache(b, t_max, dev)
        valid = torch.cat([torch.arange(pb, device=dev)[None, :] >= (pb - plen)[:, None],
                           torch.ones((b, max_new), dtype=torch.bool, device=dev)], dim=1)
        logits, _ = model(tokens, cache, 0, valid)
        token0 = torch.argmax(logits[:, -1], dim=-1)
        out0 = torch.full((b, max_new), eos_id, dtype=torch.long, device=dev)
        out0[:, 0] = token0
        s = _QwenState(torch.ones((), dtype=torch.long, device=dev), token0, out0,
                       token0 == eos_id)
        chunk = chunk or device_loop.CHUNK
        loops = device_loop.loops_for(dev, loops)
        key = ("qwen", id(model), b, pb, max_new, eos_id, chunk)
        st = device_loop.bind(loops, key, {"cache": cache, "valid": valid, **s._asdict()})
        cache, valid = st["cache"], st["valid"]

        def going(s: _QwenState) -> torch.Tensor:
            return (s.i < max_new) & ~s.done.all()

        def step(s: _QwenState) -> _QwenState:
            active = going(s)
            logits, _ = model(s.token[:, None], cache, pb + s.i - 1, valid, active=active)
            nxt = torch.where(s.done, eos_id, torch.argmax(logits[:, -1], dim=-1))
            col = s.i.clamp(max=max_new - 1).reshape(1)
            return device_loop.select(active, _QwenState(
                s.i + 1, nxt, s.out.index_copy(1, col, nxt[:, None]),
                s.done | (nxt == eos_id)), s)

        s, chunks = device_loop.run_chunks(
            _QwenState(*(st[f] for f in _QwenState._fields)), step, going, chunk, loops,
            key)
        return QwenDecodeResult(s.out.clone(), int(s.i) - 1, chunks)

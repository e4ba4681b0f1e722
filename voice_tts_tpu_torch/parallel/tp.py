"""The tensor-parallel UnifiedVoice: the GPT split over a mesh's "tp" axis
by `sharding_plan` (the JAX engine's `shard_params` of the GPT runtime
tree, `voice_tts_tpu/engine/engine.py:194-197`).

`shard_gpt` returns a copy of a float `UnifiedVoice` whose split leaves are
held one tensor a mesh device; every other leaf stays whole on the lead
device (the mesh's first).  Its methods are `UnifiedVoice`'s, so `decode`,
`beam_decode` and the engine take it in place of the unsharded module:

- trunk (`TPStack` of `TPBlock`s): megatron pairs.  `attn_c_attn` and
  `mlp_c_fc` are column-parallel, each shard holding its heads' q, k and v
  columns (the fused [q | k | v] matrix splits by heads within each third,
  not contiguously) and its slice of the MLP; `attn_c_proj` and
  `mlp_c_proj` are row-parallel; each pair ends in one reduction;
- KV cache (`ShardedKV`): each shard holds only its own heads, float or
  (under `init_quant_cache`) int8 with its scales;
- `mel_embedding` / `text_embedding` where the plan splits the vocabulary
  (`VocabParallelEmbedding`): a masked lookup a shard, the shards summed;
- `mel_head` / `text_head`, the conformer's `ff_w1` / `ff_w2` and the
  perceivers' `proj_in` / `proj_out` where the plan splits them
  (`ShardedLinear`): an output split computes each shard's slice and
  concatenates; an input split multiplies each shard's slice of the input
  and sums.

Collectives run on the lead device in shard order (a sum in f32, rounded
once to the compute dtype), so two runs are bit-equal; cross-device copies
are plain `.to(device)`.  A mesh may repeat a device: each shard is a
tensor of its own.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from voice_tts_tpu_torch.models.gpt.gpt2 import (GPT2Block, GPT2Stack, Index, QuantKVCache,
                                                 attend, attention_mask, gelu_new)
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.models.layers import Embedding, Linear, promote
from voice_tts_tpu_torch.parallel.mesh import Mesh, sharding_plan

Getter = Callable[[torch.Tensor], torch.Tensor]


def _param(t: torch.Tensor, device) -> nn.Parameter:
    """A parameter of its own on `device` (a copy even where `t` already
    lies there: shards on a repeated device must not alias)."""
    return nn.Parameter(t.detach().to(device, copy=True,
                                      memory_format=torch.contiguous_format),
                        requires_grad=t.requires_grad)


def _shards(t: torch.Tensor, dim: int, devices) -> nn.ParameterList:
    """`t` split evenly along `dim`, shard i on devices[i]."""
    return nn.ParameterList(_param(s, d) for s, d in
                            zip(t.tensor_split(len(devices), dim), devices))


def _reduce(parts: Sequence[torch.Tensor], lead, dtype) -> torch.Tensor:
    """Sum of the shards' partial products on the lead device in shard
    order, in f32, rounded once to `dtype`."""
    acc = parts[0].to(lead, torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(lead, torch.float32)
    return acc.to(dtype)


def _on(device):
    """A block in which `device` is the current CUDA device (a no-op off the
    card): a hand kernel launches onto the current device's stream, so a
    shard's K5 runs inside its device's block."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _conv1d(x, w, b=None):
    """`Conv1DGPT`'s float branch: x @ W (+ b), W (in, out)."""
    dt = promote(x, w)
    y = x.to(dt) @ w.to(dt)
    return y if b is None else y + b


def _linear(x, w, b=None):
    """`Linear`: x @ W.T (+ b), W (out, in)."""
    dt = promote(x, w)
    y = x.to(dt) @ w.to(dt).t()
    return y if b is None else y + b


class _Sharded(nn.Module):
    """A module holding split leaves: `gathered(get)` returns its leaves
    under `UnifiedVoice`'s names, whole on the lead device (`get` maps a
    parameter to the tensor wanted: its value or its gradient)."""

    def gathered(self, get: Getter) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class ShardedKV:
    """A KV cache, or its int8 scales, split over heads: `shards[i]` (L, 2,
    B, H / tp, ...) holds heads [i H / tp, (i + 1) H / tp) on mesh device i.
    `shape` is the whole cache's; `expand`, `contiguous`, `index_select`
    (the beam's cache reorder) and an assignment of another `ShardedKV` at
    an index over the leading dims (`prefill_rows`) act on every shard."""

    HEAD_DIM = 3

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.HEAD_DIM] = sum(t.shape[self.HEAD_DIM] for t in self.shards)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def expand(self, *sizes) -> "ShardedKV":
        sizes = list(sizes)
        sizes[self.HEAD_DIM] = -1
        return ShardedKV(t.expand(*sizes) for t in self.shards)

    def contiguous(self) -> "ShardedKV":
        return ShardedKV(t.contiguous() for t in self.shards)

    def index_select(self, dim: int, index: torch.Tensor) -> "ShardedKV":
        return ShardedKV(t.index_select(dim, index.to(t.device)) for t in self.shards)

    def __setitem__(self, index, value: "ShardedKV") -> None:
        for t, v in zip(self.shards, value.shards):
            t[index] = v


class VocabParallelEmbedding(_Sharded):
    """An `Embedding` whose rows (the vocabulary) split over the mesh: each
    shard looks up the ids in its range (zero elsewhere) and the shards sum
    on the lead device in shard order (exact: one term is not zero)."""

    def __init__(self, emb: Embedding, devices):
        super().__init__()
        self.devices = list(devices)
        self.weight_shards = _shards(emb.weight, 0, self.devices)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        lead = ids.device
        out, start = None, 0
        for w, dev in zip(self.weight_shards, self.devices):
            n = w.shape[0]
            local = ids.to(dev) - start
            hit = (local >= 0) & (local < n)
            e = torch.where(hit[..., None], w[local.clamp(0, n - 1)], 0).to(lead)
            out = e if out is None else out + e
            start += n
        return out

    def gathered(self, get: Getter) -> Dict[str, torch.Tensor]:
        lead = self.devices[0]
        return {"weight": torch.cat([get(w).to(lead) for w in self.weight_shards])}


class ShardedLinear(_Sharded):
    """A `Linear` (weight (out, in)) split over the mesh.  `split="out"`:
    each shard computes its slice of the output features (its slice of the
    bias added there when the plan splits the bias too), concatenated on
    the lead device in shard order; `split="in"`: each shard multiplies its
    slice of the input features, the partial products summed on the lead
    device (`_reduce`), then the whole bias."""

    def __init__(self, lin: Linear, split: str, devices, bias_sharded: bool):
        super().__init__()
        self.split, self.devices = split, list(devices)
        self.weight_shards = _shards(lin.weight, 0 if split == "out" else 1, self.devices)
        self.bias_shards = self.bias = None
        if lin.bias is not None:
            if bias_sharded:
                self.bias_shards = _shards(lin.bias, 0, self.devices)
            else:
                self.bias = _param(lin.bias, self.devices[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.device
        if self.split == "out":
            bs = self.bias_shards or [None] * len(self.devices)
            y = torch.cat([_linear(x.to(dev), w, b).to(lead) for w, b, dev in
                           zip(self.weight_shards, bs, self.devices)], dim=-1)
        else:
            xs = x.tensor_split(len(self.devices), dim=-1)
            parts = [_linear(xi.to(dev), w) for xi, w, dev in
                     zip(xs, self.weight_shards, self.devices)]
            y = _reduce(parts, lead, parts[0].dtype)
        return y if self.bias is None else y + self.bias

    def gathered(self, get: Getter) -> Dict[str, torch.Tensor]:
        lead = self.devices[0]
        dim = 0 if self.split == "out" else 1
        out = {"weight": torch.cat([get(w).to(lead) for w in self.weight_shards], dim)}
        if self.bias_shards is not None:
            out["bias"] = torch.cat([get(b).to(lead) for b in self.bias_shards])
        elif self.bias is not None:
            out["bias"] = get(self.bias)
        return out


class TPBlock(_Sharded):
    """A `GPT2Block` as two megatron pairs over the mesh: shard i holds
    heads [i h, (i + 1) h) (h = heads / tp) of `attn_c_attn` (its q, k and v
    columns) and the matching rows of `attn_c_proj`, and its slice of
    `mlp_c_fc` (columns and bias) and of `mlp_c_proj` (rows); each pair's
    partial products sum once on the lead device, where the norms, the
    residuals and the row-parallel biases stay."""

    def __init__(self, block: GPT2Block, devices):
        super().__init__()
        self.devices = list(devices)
        tp = len(self.devices)
        self.dim, self.heads = block.dim, block.heads // tp
        self.pallas_attention = block.pallas_attention
        self.ln_1, self.ln_2 = block.ln_1, block.ln_2
        ca = block.attn_c_attn
        self.qkv_w_shards = nn.ParameterList(
            _param(self._qkv_cols(ca.weight, i, tp), d) for i, d in enumerate(self.devices))
        self.qkv_b_shards = nn.ParameterList(
            _param(self._qkv_cols(ca.bias, i, tp), d) for i, d in enumerate(self.devices))
        self.proj_w_shards = _shards(block.attn_c_proj.weight, 0, self.devices)
        self.proj_b = _param(block.attn_c_proj.bias, self.devices[0])
        self.fc_w_shards = _shards(block.mlp_c_fc.weight, 1, self.devices)
        self.fc_b_shards = _shards(block.mlp_c_fc.bias, 0, self.devices)
        self.out_w_shards = _shards(block.mlp_c_proj.weight, 0, self.devices)
        self.out_b = _param(block.mlp_c_proj.bias, self.devices[0])

    def _qkv_cols(self, t: torch.Tensor, i: int, tp: int) -> torch.Tensor:
        """Shard i's [q | k | v] columns of the fused (.., 3 D) projection."""
        n = self.dim // tp
        return torch.cat([t[..., c * self.dim + i * n:c * self.dim + (i + 1) * n]
                          for c in range(3)], dim=-1)

    def forward(self, x, kvs: Optional[List], cache_index: Index,
                masks: List[torch.Tensor]):
        """x (B, S, D) on the lead device; kvs[i] shard i's layer cache (a
        tensor, an int8 pair, or None for all); `cache_index` a host int or
        a 0-d tensor on the lead device (each shard's `attend` takes it to
        its own); masks[i] the (B, S, L) mask on shard i's device.  Returns
        (hidden, kvs)."""
        lead = x.device
        y = self.ln_1(x)
        parts = []
        for i, dev in enumerate(self.devices):
            qkv = _conv1d(y.to(dev), self.qkv_w_shards[i], self.qkv_b_shards[i])
            with _on(dev):
                ctx = attend(qkv, None if kvs is None else kvs[i], cache_index, masks[i],
                             self.heads, self.pallas_attention)
            parts.append(_conv1d(ctx, self.proj_w_shards[i]))
        x = x + (_reduce(parts, lead, parts[0].dtype) + self.proj_b)
        y = self.ln_2(x)
        parts = []
        for i, dev in enumerate(self.devices):
            h = gelu_new(_conv1d(y.to(dev), self.fc_w_shards[i], self.fc_b_shards[i]))
            parts.append(_conv1d(h, self.out_w_shards[i]))
        return x + (_reduce(parts, lead, parts[0].dtype) + self.out_b), kvs

    def gathered(self, get: Getter) -> Dict[str, torch.Tensor]:
        lead, tp, n = self.devices[0], len(self.devices), self.dim // len(self.devices)

        def qkv(shards):
            ts = [get(t).to(lead) for t in shards]
            return torch.cat([ts[i][..., c * n:(c + 1) * n] for c in range(3)
                              for i in range(tp)], dim=-1)

        def cat(shards, dim):
            return torch.cat([get(t).to(lead) for t in shards], dim)
        return {"attn_c_attn.weight": qkv(self.qkv_w_shards),
                "attn_c_attn.bias": qkv(self.qkv_b_shards),
                "attn_c_proj.weight": cat(self.proj_w_shards, 0),
                "attn_c_proj.bias": get(self.proj_b),
                "mlp_c_fc.weight": cat(self.fc_w_shards, 1),
                "mlp_c_fc.bias": cat(self.fc_b_shards, 0),
                "mlp_c_proj.weight": cat(self.out_w_shards, 0),
                "mlp_c_proj.bias": get(self.out_b)}


class TPStack(nn.Module):
    """`GPT2Stack` over `TPBlock`s; its caches are `ShardedKV`s on the
    mesh."""

    def __init__(self, stack: GPT2Stack, devices):
        super().__init__()
        self.devices = list(devices)
        self.layers, self.dim, self.heads = stack.layers, stack.dim, stack.heads
        for i in range(self.layers):
            setattr(self, f"h_{i}", TPBlock(getattr(stack, f"h_{i}"), self.devices))
        self.ln_f = stack.ln_f

    def forward(self, embeds: torch.Tensor, kv_cache=None, cache_index: Index = 0,
                valid_mask: Optional[torch.Tensor] = None):
        """`GPT2Stack.forward` with the cache a `ShardedKV` or a
        `QuantKVCache` of two (updated in place)."""
        mask = attention_mask(embeds, kv_cache, cache_index, valid_mask)
        masks = [mask.to(d) for d in self.devices]
        int8_kv = isinstance(kv_cache, QuantKVCache)
        x = embeds
        for i in range(self.layers):
            if kv_cache is None:
                kvs = None
            elif int8_kv:
                kvs = [(q[i], s[i]) for q, s in zip(kv_cache.kv.shards,
                                                     kv_cache.scales.shards)]
            else:
                kvs = [t[i] for t in kv_cache.shards]
            x, _ = getattr(self, f"h_{i}")(x, kvs, cache_index, masks)
        return self.ln_f(x), kv_cache

    def _shape(self, batch: int, max_len: int):
        h = self.heads // len(self.devices)
        return (self.layers, 2, batch, h, self.dim // self.heads, max_len)

    def init_cache(self, batch: int, max_len: int, dtype, device=None) -> ShardedKV:
        """An empty float cache, each shard's heads on its device (`device`,
        the caller's lead device, is not needed: the mesh places it)."""
        return ShardedKV(torch.zeros(self._shape(batch, max_len), dtype=dtype, device=d)
                         for d in self.devices)

    def init_quant_cache(self, batch: int, max_len: int, device=None) -> QuantKVCache:
        """An empty int8 cache split over heads, its scales 1e-12."""
        shape = self._shape(batch, max_len)
        return QuantKVCache(
            ShardedKV(torch.zeros(shape, dtype=torch.int8, device=d) for d in self.devices),
            ShardedKV(torch.full(shape[:4] + (max_len,), 1e-12, dtype=torch.float32,
                                 device=d) for d in self.devices))


def _set_submodule(root: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, attr = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, attr, module)


def shard_gpt(gpt: UnifiedVoice, mesh: Mesh) -> UnifiedVoice:
    """A copy of the float `gpt` split over `mesh`'s "tp" axis by
    `sharding_plan` (see the module docstring); the replicated leaves on
    the mesh's first device.  `gpt` is left as it was.  Heads must divide
    by tp; the int8 runtime copy is a one-card path and is refused."""
    if mesh.shape.get("dp", 1) != 1:
        raise ValueError("shard_gpt takes one dp index's mesh (Mesh.row)")
    devices = list(mesh.devices.reshape(-1))
    tp = len(devices)
    if gpt.cfg.heads % tp:
        raise ValueError(f"{gpt.cfg.heads} heads do not split over tp={tp}")
    if gpt.gpt.h_0.attn_c_attn.scale is not None:
        raise ValueError("shard_gpt takes a float UnifiedVoice, not the int8 copy")
    model = copy.deepcopy(gpt).to(devices[0])
    if tp == 1:
        return model
    plan = sharding_plan(gpt.state_dict(), mesh)
    model.gpt = TPStack(model.gpt, devices)
    for name, mod in list(model.named_modules()):
        spec = plan.get(name + ".weight", ())
        if name.startswith("gpt.") or "tp" not in spec:
            continue
        if isinstance(mod, Embedding):
            new = VocabParallelEmbedding(mod, devices)
        elif isinstance(mod, Linear):
            new = ShardedLinear(mod, "out" if spec[0] == "tp" else "in", devices,
                                "tp" in plan.get(name + ".bias", ()))
        else:
            raise TypeError(f"{name}: no split for {type(mod).__name__}")
        _set_submodule(model, name, new)
    return model


def gathered_state(model: nn.Module, grad: bool = False) -> Dict[str, torch.Tensor]:
    """`model`'s leaves under the unsharded module's state-dict names,
    whole on the lead device (the shards concatenated): their values, or
    with `grad` their gradients (zeros where a leaf has none)."""
    if grad:
        def get(t):
            return t.grad if t.grad is not None else torch.zeros_like(t)
    else:
        def get(t):
            return t.detach()
    out: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(mod, _Sharded):
            out.update({prefix + k: v for k, v in mod.gathered(get).items()})
        elif not isinstance(mod, nn.ParameterList):
            out.update({prefix + k: get(p) for k, p in mod.named_parameters(recurse=False)})
            if not grad:
                out.update({prefix + k: b for k, b in mod.named_buffers(recurse=False)})
    return out


def shard_devices(model: nn.Module) -> Dict[str, List[str]]:
    """{leaf name: [device of each shard]} for every split leaf of a
    `shard_gpt` module (the check that each shard sits on its device)."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.ParameterList) and "_shards" in name:
            out[name] = [str(p.device) for p in mod]
    return out

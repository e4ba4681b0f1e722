"""Device mesh and the parameter sharding plan (`voice_tts_tpu/parallel/mesh.py`).

The JAX package drives its mesh from one process and lets XLA place the
collectives.  The port does the same from one process with one controller:
a `Mesh` is a numpy array of `torch.device`s with named axes, the plan says
which parameter leaves split over the "tp" axis, and `parallel.tp` holds
each split leaf as one tensor a device and does every collective on the
lead device in shard order.  A mesh may repeat a device (the CPU tests use
`[cpu] * n`, a one-card machine `[cuda:0] * tp`): each shard is a tensor of
its own all the same.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """`devices`: a numpy object array of `torch.device`, one axis a name
    of `axis_names`; `shape`: {axis name: size}, as `jax.sharding.Mesh`."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def row(self, index: int) -> "Mesh":
        """The "tp" mesh of dp index `index`."""
        return Mesh(self.devices.reshape(-1, self.shape.get("tp", 1))[index], ("tp",))


def make_mesh(axes: Sequence[str] = ("dp", "tp"),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (default: every visible CUDA device; with no
    card and no list it raises).  Without `shape`, one axis takes them all;
    two axes take tp from 4, then 2, then 1, whichever divides the count
    (JAX `make_mesh`)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass `devices`")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        else:
            tp = next(c for c in (4, 2, 1) if n % c == 0)
            shape = (n // tp, tp)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axes)


# (regex over 'path/like/this', spec) -- first match wins; a spec names the
# "tp" axis per dimension, None for a whole one; replicated otherwise
# (`voice_tts_tpu/parallel/mesh.py:49-72`, the same table)
Spec = Tuple[Optional[str], ...]
_GPT_RULES: Tuple[Tuple[str, Spec], ...] = (
    # GPT-2 trunk: megatron-style column/row parallel pairs
    (r".*attn_c_attn/weight$", (None, "tp")),
    (r".*attn_c_attn/bias$", ("tp",)),
    (r".*attn_c_proj/weight$", ("tp", None)),
    (r".*mlp_c_fc/weight$", (None, "tp")),
    (r".*mlp_c_fc/bias$", ("tp",)),
    (r".*mlp_c_proj/weight$", ("tp", None)),
    # vocab-sharded heads / embeddings (torch Linear layout (out, in))
    (r".*mel_head/weight$", ("tp", None)),
    (r".*text_head/weight$", ("tp", None)),
    (r".*mel_head/bias$", ("tp",)),
    (r".*text_head/bias$", ("tp",)),
    (r".*(mel|text)_embedding/weight$", ("tp", None)),
    # conformer / perceiver FF
    (r".*ff_w1/weight$", ("tp", None)),
    (r".*ff_w2/weight$", (None, "tp")),
    (r".*proj_in/weight$", ("tp", None)),
    (r".*proj_out/weight$", (None, "tp")),
    # DiT SwiGLU
    (r".*/w1/weight$", ("tp", None)),
    (r".*/w3/weight$", ("tp", None)),
    (r".*/w2/weight$", (None, "tp")),
)

REPLICATED: Spec = ()


def param_sharding_rules() -> Tuple[Tuple[str, Spec], ...]:
    return _GPT_RULES


def spec_for(path: str, mesh: Mesh) -> Spec:
    """The rule table's spec of `path`, replicated on a mesh without a
    "tp" axis of size above 1."""
    if mesh.shape.get("tp", 1) == 1:
        return REPLICATED
    for pattern, spec in _GPT_RULES:
        if re.match(pattern, path):
            return spec
    return REPLICATED


def sharding_plan(named_tensors: Mapping[str, object], mesh: Mesh) -> Dict[str, Spec]:
    """{name: spec} for each leaf (anything with `.shape`, keyed by its
    state-dict name: the port mirrors the JAX names, so "gpt.h_0.x" is
    matched as the JAX path "gpt/h_0/x"): the rule's spec, or `REPLICATED`
    where no rule matches or "tp" does not divide a dimension the spec
    splits (then the whole leaf replicates, `mesh.py:95-107`)."""
    tp = mesh.shape.get("tp", 1)
    plan = {}
    for name, t in named_tensors.items():
        spec = spec_for(name.replace(".", "/"), mesh)
        if any(axis == "tp" and t.shape[dim] % tp for dim, axis in enumerate(spec)):
            spec = REPLICATED
        plan[name] = spec
    return plan


def sharded_leaves(plan: Mapping[str, Spec]) -> Dict[str, Spec]:
    """The leaves of `plan` that split over "tp"."""
    return {k: v for k, v in plan.items() if "tp" in v}

"""JAX parameter trees -> the port's `state_dict`s, per model family.

The port's modules use the JAX modules' names for every submodule and
parameter, so a JAX tree `{"params": {"a": {"b": {"weight": w}}}}` maps to
the key `a.b.weight`; leaves are numpy arrays (or anything `np.asarray`
takes) and keep their values and shapes exactly.  `load_family` checks that
the converted keys and shapes are exactly the module's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested parameter dict (optionally under "params") -> flat state."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(val, path)
            else:
                out[path] = torch.from_numpy(np.array(np.asarray(val)))
    walk(tree, "")
    return out


def load_family(module: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy `state` into `module` (strict: same keys, same shapes)."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"{type(module).__name__}: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    for key, val in state.items():
        if tuple(own[key].shape) != tuple(val.shape):
            raise ValueError(f"{type(module).__name__}.{key}: shape "
                             f"{tuple(val.shape)} != {tuple(own[key].shape)}")
    module.load_state_dict({k: v.to(own[k].dtype) for k, v in state.items()})
    return module


# model families of an engine, keyed as in the JAX engine's `params`
FAMILIES = ("gpt", "s2mel", "vocoder", "campplus", "repcodec", "w2v")


def convert(family: str, tree) -> Dict[str, torch.Tensor]:
    """One JAX family tree -> the port module's state.  Every family
    converts the same way because the port mirrors the JAX names: gpt
    (UnifiedVoice), s2mel (S2Mel), vocoder (BigVGAN, weight norm already
    folded), campplus (batch-norm statistics included), repcodec (encoder +
    quantizer), w2v (w2v-bert truncated at `output_layer`)."""
    if family not in FAMILIES:
        raise KeyError(f"unknown model family {family!r}; expected {FAMILIES}")
    return flatten_params(tree)

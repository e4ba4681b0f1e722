"""Weight-only int8 quantization of the GPT trunk for the decode path
(`voice_tts_tpu/utils/quantize.py`).

The four GPT-2 trunk projections of every layer get an int8 weight plus a
per-output-channel f32 `scale`; every other float tensor of the GPT becomes
bf16.  `Conv1DGPT` detects the `scale` buffer at call time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

QUANT_MODULES = ("attn_c_attn", "attn_c_proj", "mlp_c_fc", "mlp_c_proj")


def quantize_int8_columns(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) f32 -> (int8 (in, out), scale (1, out) f32), on w's device."""
    amax = w.float().abs().amax(dim=0, keepdim=True)
    # XLA compiles the JAX package's `/ 127.0` into a multiply by the f32
    # reciprocal; the same product keeps the int8 weights bit-identical
    scale = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(w.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_gpt_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """int8-quantize the trunk projections of a UnifiedVoice state_dict.

    `...{attn_c_attn,attn_c_proj,mlp_c_fc,mlp_c_proj}.weight` (2-D) becomes
    int8 with a sibling `.scale`; every other f32 tensor becomes bf16."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state.items():
        parts = key.split(".")
        if (len(parts) >= 2 and parts[-1] == "weight"
                and parts[-2] in QUANT_MODULES and val.dim() == 2):
            q, scale = quantize_int8_columns(val)
            out[key] = q
            out[key[:-len("weight")] + "scale"] = scale
        elif val.dtype == torch.float32:
            out[key] = val.to(torch.bfloat16)
        else:
            out[key] = val
    return out

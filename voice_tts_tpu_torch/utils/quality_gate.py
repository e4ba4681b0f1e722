"""Quantization quality gates for the GPT decode path
(`voice_tts_tpu/utils/quality_gate.py`).

Measures, for a given UnifiedVoice state (converted weights through
`python -m voice_tts_tpu_torch.utils.onboard --quality-gates`, or random
weights):

1. greedy free-running code identity: each quantized decode through the K1
   chain against the bf16 unfused decode on identical prompts (prefix-match
   length, exact match);
2. teacher-forced per-step logit divergence along the bf16-greedy
   trajectory: KL(softmax_ref || softmax_q), top-1 agreement, max |dlogit|.

The schemes: `int8` (`pack_gpt`, the serving default), `int4` (`pack_gpt_int4`
at g128, through K7), `int4_gwide` (one scale group per packed half) and
`int8_rofold` (int8 plus the folded int8 readout).  The JAX module's
`int4_i8sh` is a TPU unpack of the same int4 values and is left out.  The
reference decodes an fp16-autocast GPT with no quantization at all, so every
scheme here is a speed / quality trade the reference does not make: this is
the record behind the int8 default and the int4 opt-in.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from voice_tts_tpu_torch.config import GenerationConfig, GPTConfig
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.models.gpt.decode import decode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice, n_cond_latents
from voice_tts_tpu_torch.ops.fused_decode import (BLOCK_T, apply_kv_update,
                                                  cache_to_time_major,
                                                  fused_decode_step, pack_gpt,
                                                  pack_gpt_int4, pack_readout)
from voice_tts_tpu_torch.utils.convert import load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

SCHEMES = ("int8", "int4", "int4_gwide", "int8_rofold")


def gate_inputs(cfg: GPTConfig, prompts: int, seed: int = 100) -> List[Dict[str, torch.Tensor]]:
    """Random conditioning latents (std 0.3), emotion vector (std 0.1) and
    text tokens of each prompt, drawn on the CPU from `seed + prompt`."""
    nc, d = n_cond_latents(cfg), cfg.model_dim
    bl = min(24, max(cfg.max_text_tokens - 2, 4))
    out = []
    for pi in range(prompts):
        g = torch.Generator().manual_seed(seed + pi)
        out.append({"cond": torch.randn((1, nc, d), generator=g) * 0.3,
                    "emo": torch.randn((1, d), generator=g) * 0.1,
                    "text": torch.randint(2, cfg.number_text_tokens, (1, bl), generator=g)})
    return out


def run_quality_gate(cfg: GPTConfig, state: Dict[str, torch.Tensor], steps: int = 96,
                     prompts: int = 1, device="cuda",
                     inputs: Optional[List[Dict[str, torch.Tensor]]] = None) -> dict:
    """Run both gates on `state` (the f32 UnifiedVoice state at `cfg`
    widths) on `device`.  `inputs`: each prompt's `cond` (1, nc, D), `emo`
    (1, D) and `text` (1, L) (default `gate_inputs`); the teacher-forced
    gate drives the first.  Returns {"config", "free_running": [...],
    "teacher_forced": {scheme: {kl_mean, kl_max, top1_agreement,
    max_abs_dlogit}}}."""
    dev = torch.device(device)
    inputs = inputs if inputs is not None else gate_inputs(cfg, prompts)
    master = load_family(UnifiedVoice(cfg), state).to(dev).eval().requires_grad_(False)
    model = load_family(UnifiedVoice(cfg), state).to(dev, torch.bfloat16)
    model.eval().requires_grad_(False)
    master_state = master.state_dict()
    qstate = quantize_gpt_state(master_state)
    pack8 = pack_gpt(qstate, cfg.layers)
    # (weight pack, readout pack): rofold also quantizes the logits head
    packs = {"int8": (pack8, None),
             "int4": (pack_gpt_int4(master_state, cfg.layers), None),
             "int4_gwide": (pack_gpt_int4(master_state, cfg.layers,
                                          group=cfg.model_dim // 2), None),
             "int8_rofold": (pack8, pack_readout(qstate))}
    del master, master_state
    gen = GenerationConfig(do_sample=False, num_beams=1, repetition_penalty=10.0,
                           max_mel_tokens=steps)
    # the quantized decodes run their device loops op by op on the card
    loops = DeviceLoops(dev, capture=False) if dev.type == "cuda" else None
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    results = {"config": {"layers": cfg.layers, "model_dim": cfg.model_dim,
                          "steps": steps, "prompts": len(inputs), "device": name},
               "free_running": [], "teacher_forced": {}}

    def args(inp):
        text = inp["text"].to(dev)
        return (inp["cond"].to(dev), inp["emo"].to(dev), text,
                torch.tensor([text.shape[1]], device=dev))

    with torch.no_grad():
        # ---------------- free-running greedy code identity ----------------
        for pi, inp in enumerate(inputs):
            ref = decode(model, gen, *args(inp), max_new=steps)
            ref_codes = ref.codes[0].cpu().tolist()
            ref_len = int(ref.lengths[0])
            row = {"prompt": pi, "ref_len": ref_len}
            for scheme, (pack, ro) in packs.items():
                res = decode(model, gen, *args(inp), max_new=steps, fused_pack=pack,
                             readout_pack=ro, loops=loops)
                codes = res.codes[0].cpu().tolist()
                n = min(ref_len, int(res.lengths[0]))
                agree = 0
                while agree < n and codes[agree] == ref_codes[agree]:
                    agree += 1
                row[scheme] = {"prefix_match": agree, "len": int(res.lengths[0]),
                               "exact": bool(agree == ref_len == int(res.lengths[0]))}
            results["free_running"].append(row)

        # ------------- teacher-forced per-step logit divergence -------------
        # every path steps along the same (bf16-greedy) token trajectory
        cond, emo, text, tlen = args(inputs[0])
        ref = decode(model, gen, cond, emo, text, tlen, max_new=steps)
        traj = ref.codes[0, :max(int(ref.lengths[0]) - 1, 1)].tolist()
        p = n_cond_latents(cfg) + 2 + text.shape[1] + 2
        t_max = p + 1 + steps
        t_max += (-t_max) % BLOCK_T
        vocab = cfg.number_mel_codes

        def forced_logits(pack=None, ro=None) -> torch.Tensor:
            """Step along `traj`: (T, V) f32 logits on the CPU."""
            prompt, valid_p = model.build_prompt(cond.to(torch.bfloat16),
                                                 emo.to(torch.bfloat16), text, tlen)
            cache = model.gpt.init_cache(1, t_max, prompt.dtype, dev)
            outs = [model.prefill(prompt, valid_p, cache)]
            valid = torch.cat([valid_p, torch.ones((1, t_max - p), dtype=torch.bool,
                                                   device=dev)], dim=1)
            if pack is None:
                for step, tok in enumerate(traj, start=1):
                    outs.append(model.decode_step(torch.tensor([tok], device=dev),
                                                  step - 1, p + step, valid, cache))
            else:
                bias = torch.where(valid[0, :, None], 0.0, -1e30).float()
                cache = cache_to_time_major(cache)
                for step, tok in enumerate(traj, start=1):
                    emb = model.embed_decode_token(torch.tensor([tok], device=dev),
                                                   step - 1)
                    hidden, kv_new, lp = fused_decode_step(
                        emb, pack, cache, bias, p + step, cfg.heads, readout_pack=ro)
                    apply_kv_update(cache, kv_new, p + step)
                    outs.append(lp[:, :vocab] if ro is not None else model.readout(hidden))
            return torch.stack([o[0].float().cpu() for o in outs])

        ref_logits = forced_logits()
        ref_logp = torch.log_softmax(ref_logits, dim=-1)
        for scheme, (pack, ro) in packs.items():
            ql = forced_logits(pack, ro)
            kl = torch.sum(ref_logp.exp() * (ref_logp - torch.log_softmax(ql, dim=-1)),
                           dim=-1)
            results["teacher_forced"][scheme] = {
                "kl_mean": float(kl.mean()), "kl_max": float(kl.max()),
                "top1_agreement": float((ref_logits.argmax(-1) == ql.argmax(-1))
                                        .float().mean()),
                "max_abs_dlogit": float((ql - ref_logits).abs().max()),
            }
    return results

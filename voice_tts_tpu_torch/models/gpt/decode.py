"""Autoregressive decode loop for UnifiedVoice, `num_beams == 1`
(`voice_tts_tpu/models/gpt/decode.py:151-319`).

A Python loop over a preallocated KV cache.  Logit processing follows the
HF order for the reference defaults: repetition penalty -> temperature ->
top-k -> top-p -> categorical sample (or argmax when `do_sample` is off),
with top-p computed inside the descending top-k candidates (no full-vocab
sort).  The repetition-penalty presence mask starts with {1, start_mel}
(HF sees the fake prompt ids and the start token).  With a fused pack
(batch 1) every step is one `ops.fused_decode.fused_decode_step` — the K1
kernel chain on a CUDA tensor — with the folded int8 readout and, with
`int8_kv`, an int8 cache with one scale per (layer, position, k|v) row.
Beam search is `models/gpt/beam.py`.

Left out here: speculative decode, batched decode, int8 KV on the unfused
path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from voice_tts_tpu.config import GenerationConfig
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice, n_cond_latents
from voice_tts_tpu_torch.ops.fused_decode import (BLOCK_T, FusedDecodePack,
                                                  ReadoutPack, apply_kv_update,
                                                  apply_kv_update_q,
                                                  cache_to_time_major,
                                                  fused_decode_step,
                                                  quantize_kv_cache)


class DecodeResult(NamedTuple):
    codes: torch.Tensor      # (B, max_new) generated codes (stop-padded)
    lengths: torch.Tensor    # (B,) codes per row including the stop token
    hit_limit: torch.Tensor  # (B,) True if stopped by max length
    steps: int               # decode steps after the prefill


def apply_repetition_penalty(logits, presence, penalty: float):
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def sample_token(logits: torch.Tensor, presence: torch.Tensor,
                 gen: GenerationConfig,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One sampling step: (B, V) logits -> (B,) token ids."""
    if gen.typical_sampling:
        raise NotImplementedError("typical sampling is not ported")
    logits = apply_repetition_penalty(logits, presence, gen.repetition_penalty)
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1)
    if gen.temperature != 1.0:
        logits = logits / gen.temperature
    k = min(gen.top_k if gen.top_k > 0 else logits.shape[-1], logits.shape[-1])
    top_vals, top_idx = torch.topk(logits, k, dim=-1)        # descending
    if gen.top_p < 1.0:
        probs = torch.softmax(top_vals, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        top_vals = torch.where(before >= gen.top_p,
                               torch.finfo(top_vals.dtype).min, top_vals)
    choice = torch.multinomial(torch.softmax(top_vals, dim=-1), 1,
                               generator=generator)
    return torch.gather(top_idx, 1, choice)[:, 0]


def decode(model: UnifiedVoice, gen: GenerationConfig,
           cond_latents: torch.Tensor, emo_vec: torch.Tensor,
           text_tokens: torch.Tensor, text_lengths: torch.Tensor,
           max_new: int, generator: Optional[torch.Generator] = None,
           fused_pack: Optional[FusedDecodePack] = None,
           readout_pack: Optional[ReadoutPack] = None,
           int8_kv: bool = False) -> DecodeResult:
    """Greedy / sampling AR decode; text_tokens (B, bucket_len) right-padded.

    Compute dtype follows the model's parameters (the int8 / bf16 runtime
    copy decodes with a bf16 cache); logits and sampling stay f32.  `int8_kv`
    quantizes the fused step's cache after the prefill (fused path only)."""
    cfg = model.cfg
    b, bl = text_tokens.shape
    dev = text_tokens.device
    use_fused = fused_pack is not None and b == 1
    int8_kv = int8_kv and use_fused
    p = n_cond_latents(cfg) + 2 + bl + 2
    t_max = p + 1 + max_new
    if use_fused:
        t_max += (-t_max) % BLOCK_T
    vocab = cfg.number_mel_codes
    param_dtype = model.conditioning_encoder.after_norm.bias.dtype

    with torch.no_grad():
        prompt, valid_p = model.build_prompt(cond_latents.to(param_dtype),
                                             emo_vec.to(param_dtype),
                                             text_tokens, text_lengths)
        valid = torch.cat([valid_p, torch.ones((b, t_max - p), dtype=torch.bool,
                                               device=dev)], dim=1)
        cache = model.gpt.init_cache(b, t_max, prompt.dtype, dev)
        logits = model.prefill(prompt, valid_p, cache)

        presence = torch.zeros((b, vocab), dtype=torch.bool, device=dev)
        presence[:, 1] = True
        presence[:, cfg.start_mel_token] = True
        rows = torch.arange(b, device=dev)
        token = sample_token(logits, presence, gen, generator)
        presence[rows, token] = True
        codes = torch.full((b, max_new), cfg.stop_mel_token, dtype=torch.long,
                           device=dev)
        codes[:, 0] = token
        finished = token == cfg.stop_mel_token
        lengths = torch.ones((b,), dtype=torch.long, device=dev)

        scales = None
        if use_fused:
            attn_bias = torch.where(valid[0, :, None], 0.0, -1e30).float()
            cache = cache_to_time_major(cache)
            if int8_kv:
                cache, scales = quantize_kv_cache(cache)
        step = 1
        while step < max_new and not bool(finished.all()):
            if use_fused:
                emb = model.embed_decode_token(token, step - 1)
                hidden, kv_new, logits_pad = fused_decode_step(
                    emb, fused_pack, cache, attn_bias, p + step, cfg.heads,
                    readout_pack=readout_pack, kv_scales=scales)
                if readout_pack is not None:
                    logits = logits_pad[:, :vocab]
                else:
                    logits = model.readout(hidden)
                if int8_kv:
                    apply_kv_update_q(cache, scales, kv_new, p + step)
                else:
                    apply_kv_update(cache, kv_new, p + step)
            else:
                logits = model.decode_step(token, step - 1, p + step, valid, cache)
            token = sample_token(logits, presence, gen, generator)
            token = torch.where(finished, cfg.stop_mel_token, token)
            presence[rows, token] = True
            codes[:, step] = token
            lengths = torch.where(finished, lengths, step + 1)
            finished = finished | (token == cfg.stop_mel_token)
            step += 1
    return DecodeResult(codes, lengths, ~finished, step - 1)

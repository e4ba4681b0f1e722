"""Autoregressive decode loops for UnifiedVoice, `num_beams == 1`
(`voice_tts_tpu/models/gpt/decode.py:151-553`): `decode` and the
self-speculative `spec_decode`.

Every arm, and `spec_decode`, runs as the JAX `while_loop` does, on the
device (`engine.device_loop`: chunks of steps over a preallocated KV
cache, one CUDA graph a chunk on the card, one host read a chunk; the
unfused step and the spec rounds take their positions on the device, as
K5's length and K6's position).  Logit processing follows the
HF order for the reference defaults: repetition penalty -> temperature ->
top-k -> top-p -> categorical sample (or argmax when `do_sample` is off),
with top-p computed inside the descending top-k candidates (no full-vocab
sort).  The repetition-penalty presence mask starts with {1, start_mel}
(HF sees the fake prompt ids and the start token).  With a fused pack
(batch 1) every step is one `ops.fused_decode.fused_decode_step` — the K1
kernel chain on a CUDA tensor — with the folded int8 readout and, with
`int8_kv`, an int8 cache with one scale per (layer, position, k|v) row.
With `fused_batch` and a pack, a batch of 2-8 rows (the engine's
`infer_batch` and batched segments under `use_fused_batch_decode`) runs
every step as one `fused_decode_step_batch` (K3) over the rows at one shared
position, with a (B, Tmax) per-row prompt-pad bias and, with `int8_kv`, an
int8 cache with one scale per (layer, row, position, k|v), as the same
device loop; each row's prefill runs alone (`prefill_rows`), so a row
decodes as it would alone through K1.
With `GPTConfig.pallas_decode_attention` the pack is not used, as in the JAX
package: every step is `UnifiedVoice.decode_step` over a float cache padded
to a multiple of 512, each layer's attention one K5 launch
(`ops.decode_attention`) and, on the int8 runtime copy, each trunk
projection one K4 launch.  Without a pack and without that flag, `int8_kv`
decodes `UnifiedVoice.decode_step` over an int8 `QuantKVCache` (one scale
per layer, k/v, row, head and position), as the JAX `decode` does.  Beam
search is `models/gpt/beam.py`.

`spec_decode` drafts K - 1 tokens with an int4 pack through K1 (K7's
loader), verifies all K in one int8 pass (`fused_decode_verify`, K6) and
keeps the target's distribution by rejection sampling over the warped
distributions (`speculative_accept`).

Typical sampling (`gen.typical_sampling`) runs the full-vocab warper
pipeline (`process_logits`, `apply_typical`) on every arm, its sorts on the
device, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import torch

from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine import device_loop
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.models.gpt.gpt2 import QuantKVCache
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice, n_cond_latents
from voice_tts_tpu_torch.ops.decode_attention import BLOCK_T as ATTN_BLOCK_T
from voice_tts_tpu_torch.ops.fused_decode import (BLOCK_T, FusedDecodePack,
                                                  Pack, ReadoutPack,
                                                  apply_kv_update,
                                                  apply_kv_update_q,
                                                  apply_kv_update_span,
                                                  MAX_ROWS, apply_kv_update_batch,
                                                  apply_kv_update_q_batch,
                                                  cache_to_time_major,
                                                  fused_decode_step,
                                                  fused_decode_step_batch,
                                                  fused_decode_verify,
                                                  quantize_kv_cache,
                                                  quantize_kv_cache_batch)


class DecodeResult(NamedTuple):
    codes: torch.Tensor      # (B, max_new) generated codes (stop-padded)
    lengths: torch.Tensor    # (B,) codes per row including the stop token
    hit_limit: torch.Tensor  # (B,) True if stopped by max length
    steps: int               # decode steps after the prefill
    chunks: int = 0          # chunks of the device loop


class _LoopState(NamedTuple):
    """The sampling loop's state on the device (JAX `_LoopState`; the cache
    is updated in place beside it and the generator stands for the key)."""
    step: torch.Tensor       # () int64: codes so far, the next code's index
    token: torch.Tensor      # (B,) last sampled token
    presence: torch.Tensor   # (B, V) repetition-penalty memory
    codes: torch.Tensor      # (B, max_new)
    finished: torch.Tensor   # (B,)
    lengths: torch.Tensor    # (B,)


def apply_repetition_penalty(logits, presence, penalty: float):
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.log_softmax`, written as it is: x - max - log(sum(exp))."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax`, written as it is: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _mask_sorted(logits: torch.Tensor, order: torch.Tensor,
                 remove_sorted: torch.Tensor) -> torch.Tensor:
    """Entries whose rank in `order` is flagged in `remove_sorted` go to
    float-min (the rank of an entry is the argsort of the order: the order
    scattered back)."""
    remove = torch.empty_like(remove_sorted).scatter_(-1, order, remove_sorted)
    return torch.where(remove, torch.finfo(logits.dtype).min, logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Full-vocab top-k (JAX `apply_top_k`): below the k-th largest value
    goes to float-min."""
    if k <= 0:
        return logits
    thresh = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.finfo(logits.dtype).min, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """HF TopPLogitsWarper (JAX `apply_top_p`): ascending stable sort, remove
    while the cumulative probability is <= 1 - p, keep >= 1 token."""
    if p >= 1.0:
        return logits
    order = torch.argsort(logits, dim=-1, stable=True)
    cum = torch.cumsum(_softmax(torch.gather(logits, -1, order)), dim=-1)
    remove_sorted = cum <= (1.0 - p)
    remove_sorted[..., -1] = False
    return _mask_sorted(logits, order, remove_sorted)


def apply_typical(logits: torch.Tensor, mass: float,
                  min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Entropy-typical filtering (JAX `apply_typical`, HF
    TypicalLogitsWarper): the tokens sorted by |-log p - H| (stable, as
    `jnp.argsort`), the most typical kept while their cumulative
    probability stays under `mass`, at least `min_tokens_to_keep`; the rest
    go to float-min.  Sorts on the device: no host read."""
    norm = log_softmax(logits)
    p = torch.exp(norm)
    ent = -(norm * p).sum(dim=-1, keepdim=True)
    shifted = (-norm - ent).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(p, -1, order), dim=-1)
    last_ind = (cum < mass).sum(dim=-1, keepdim=True).clamp(min=min_tokens_to_keep - 1)
    rank = torch.arange(logits.shape[-1], device=logits.device)
    return _mask_sorted(logits, order, rank > last_ind)


def process_logits(logits: torch.Tensor, presence: torch.Tensor,
                   gen: GenerationConfig) -> torch.Tensor:
    """The full-vocab warper pipeline (JAX `process_logits`): repetition
    penalty -> typical filtering (2 tokens kept under beams) -> when
    sampling, temperature -> top-k -> top-p."""
    logits = apply_repetition_penalty(logits, presence, gen.repetition_penalty)
    if gen.typical_sampling:
        logits = apply_typical(logits, gen.typical_mass, 2 if gen.num_beams > 1 else 1)
    if gen.do_sample:
        if gen.temperature != 1.0:
            logits = logits / gen.temperature
        logits = apply_top_p(apply_top_k(logits, gen.top_k), gen.top_p)
    return logits


def sample_token(logits: torch.Tensor, presence: torch.Tensor,
                 gen: GenerationConfig,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One sampling step: (B, V) logits -> (B,) token ids.  Top-p runs in
    the descending top-k candidate space (no full-vocab sort); typical
    sampling keeps the full-vocab pipeline (`process_logits`), as in JAX."""
    if gen.typical_sampling:
        warped = process_logits(logits, presence, gen)
        if gen.do_sample:
            return torch.multinomial(torch.softmax(warped, dim=-1), 1,
                                     generator=generator)[:, 0]
        return torch.argmax(warped, dim=-1)
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


def prefill_rows(model: UnifiedVoice, prompt: torch.Tensor, valid_p: torch.Tensor,
                 t_max: int):
    """`model.prefill` of each row alone into a (L, 2, B, H, hd, t_max) cache
    of the prompt's dtype: a row's logits and cache then do not depend on
    the rows beside it (a GEMM over more rows may sum in another order:
    cuBLAS picks its kernel by the row count), so a request decodes alike
    alone and in a batched K3 decode, whose step is row-independent.
    Returns ((B, V) logits, the cache)."""
    b = prompt.shape[0]
    cache = model.gpt.init_cache(b, t_max, prompt.dtype, prompt.device)
    logits = []
    for i in range(b):
        row = model.gpt.init_cache(1, t_max, prompt.dtype, prompt.device)
        logits.append(model.prefill(prompt[i:i + 1], valid_p[i:i + 1], row))
        cache[:, :, i:i + 1] = row
    return torch.cat(logits), cache


def generation_key(gen: GenerationConfig) -> tuple:
    """The sampling settings as part of a device loop's key (a captured
    step bakes them in)."""
    return tuple(sorted(dataclasses.asdict(gen).items()))


def _advance(s: _LoopState, logits: torch.Tensor, gen: GenerationConfig,
             generator: Optional[torch.Generator], stop: int, max_new: int) -> _LoopState:
    """One sampling step's update from the step's logits (JAX `body_fn`
    after the trunk): a finished row keeps emitting the stop token."""
    token = sample_token(logits, s.presence, gen, generator)
    token = torch.where(s.finished, stop, token)
    col = s.step.clamp(max=max_new - 1).reshape(1)    # step < max_new while active
    return _LoopState(s.step + 1, token,
                      s.presence.scatter(1, token[:, None], True),
                      s.codes.index_copy(1, col, token[:, None]),
                      s.finished | (token == stop),
                      torch.where(s.finished, s.lengths, s.step + 1))


def kv_tensors(cache) -> List[torch.Tensor]:
    """The tensors of an unfused decode's cache: a float cache, the rows and
    scales of a `QuantKVCache`, or every shard of a cache split over cards
    (`parallel.tp.ShardedKV`)."""
    parts = list(cache) if isinstance(cache, QuantKVCache) else [cache]
    return [t for part in parts for t in getattr(part, "shards", [part])]


def held_step(cache, pos: torch.Tensor, active: torch.Tensor, fn: Callable):
    """fn(), an unfused step that writes `cache` at the time position `pos`
    (0-d, the last axis of every cache tensor), with what it wrote there
    taken back where the 0-d `active` is false: a step after the loop's
    stop leaves the cache as it was."""
    ts = kv_tensors(cache)
    idx = [pos.reshape(1).to(t.device) for t in ts]
    held = [t.index_select(-1, i) for t, i in zip(ts, idx)]
    out = fn()
    for t, i, h in zip(ts, idx, held):
        t.index_copy_(t.dim() - 1, i,
                      torch.where(active.to(t.device), t.index_select(-1, i), h))
    return out


def is_sharded(cache) -> bool:
    """Whether a cache is split over cards (a tensor-parallel GPT's)."""
    return any(hasattr(part, "shards")
               for part in (cache if isinstance(cache, QuantKVCache) else [cache]))


def decode(model: UnifiedVoice, gen: GenerationConfig,
           cond_latents: torch.Tensor, emo_vec: torch.Tensor,
           text_tokens: torch.Tensor, text_lengths: torch.Tensor,
           max_new: int, generator: Optional[torch.Generator] = None,
           fused_pack: Optional[Pack] = None,
           readout_pack: Optional[ReadoutPack] = None,
           int8_kv: bool = False, loops: Optional[DeviceLoops] = None,
           chunk: Optional[int] = None, fused_batch: bool = False) -> DecodeResult:
    """Greedy / sampling AR decode; text_tokens (B, bucket_len) right-padded.

    Compute dtype follows the model's parameters (the int8 / bf16 runtime
    copy decodes with a bf16 cache); logits and sampling stay f32.  `int8_kv`
    quantizes the fused step's cache after the prefill, or without a fused
    pack decodes over an int8 `QuantKVCache` from the prefill on (the JAX
    `int8_kv_xla` case).  `cfg.pallas_decode_attention` turns the fused path
    off (K5 reads a float cache, so `int8_kv` drops there).  With
    `fused_batch`, a pack and 1 < B <= 8 the step is K3 over the B rows at
    one shared position (the JAX `use_fused_b` arm).

    Every arm is the JAX `while_loop` on the device (`engine.device_loop`):
    state, position and stop test stay there, and the steps run `chunk`
    (default CHUNK) at a time, one host read a chunk; on a CUDA device each
    chunk replays a graph of `loops` (the engine's; one of this call's own
    when None), or runs op by op with `DeviceLoops(..., capture=False)`.
    The unfused arm's step (`UnifiedVoice.decode_step`) takes its position
    on the device too; over a cache split over cards it runs op by op."""
    cfg = model.cfg
    b, bl = text_tokens.shape
    dev = text_tokens.device
    use_fused = (fused_pack is not None and b == 1
                 and not cfg.pallas_decode_attention)
    use_fused_b = (fused_pack is not None and fused_batch and 1 < b <= MAX_ROWS
                   and not cfg.pallas_decode_attention)
    # int8 KV without the fused steps needs the plain attention branch (K5
    # reads a float cache)
    int8_kv_eager = (int8_kv and not use_fused and not use_fused_b
                     and not cfg.pallas_decode_attention)
    int8_kv = int8_kv and (use_fused or use_fused_b)
    p = n_cond_latents(cfg) + 2 + bl + 2
    t_max = p + 1 + max_new
    if cfg.pallas_decode_attention:
        t_max += (-t_max) % ATTN_BLOCK_T
    elif use_fused or use_fused_b:
        t_max += (-t_max) % BLOCK_T
    vocab = cfg.number_mel_codes
    stop = cfg.stop_mel_token
    param_dtype = model.param_dtype

    with torch.no_grad():
        prompt, valid_p = model.build_prompt(cond_latents.to(param_dtype),
                                             emo_vec.to(param_dtype),
                                             text_tokens, text_lengths)
        valid = torch.cat([valid_p, torch.ones((b, t_max - p), dtype=torch.bool,
                                               device=dev)], dim=1)
        if use_fused_b:
            logits, cache = prefill_rows(model, prompt, valid_p, t_max)
        else:
            if int8_kv_eager:
                cache = model.gpt.init_quant_cache(b, t_max, dev)
            else:
                cache = model.gpt.init_cache(b, t_max, prompt.dtype, dev)
            logits = model.prefill(prompt, valid_p, cache)

        presence = torch.zeros((b, vocab), dtype=torch.bool, device=dev)
        presence[:, 1] = True
        presence[:, cfg.start_mel_token] = True
        token = sample_token(logits, presence, gen, generator)
        codes = torch.full((b, max_new), stop, dtype=torch.long, device=dev)
        codes[:, 0] = token
        s = _LoopState(torch.ones((), dtype=torch.long, device=dev), token,
                       presence.scatter(1, token[:, None], True), codes,
                       token == stop, torch.ones((b,), dtype=torch.long, device=dev))

        scales = bias = None
        if use_fused or use_fused_b:
            cache = cache_to_time_major(cache)
            if use_fused_b:
                # (B, Tmax) per-row additive mask over the cache positions
                bias = torch.where(valid, 0.0, -1e30).float()
                if int8_kv:
                    cache, scales = quantize_kv_cache_batch(cache)
            else:
                bias = torch.where(valid[0, :, None], 0.0, -1e30).float()
                if int8_kv:
                    cache, scales = quantize_kv_cache(cache)
            static = {"cache": cache, "bias": bias, "scales": scales}
        else:
            # the unfused step reads the request's valid mask
            static = {"cache": cache.kv if int8_kv_eager else cache,
                      "scales": cache.scales if int8_kv_eager else None, "valid": valid}
        chunk = chunk or device_loop.CHUNK
        loops = device_loop.loops_for(dev, loops, capture=not is_sharded(cache))
        key = ("decode", id(model), id(fused_pack), id(readout_pack), id(generator),
               generation_key(gen), b, p, t_max, max_new, use_fused, use_fused_b,
               int8_kv, int8_kv_eager, cfg.pallas_decode_attention, chunk)
        st = device_loop.bind(loops, key, {**static, **s._asdict()})
        cache, scales, bias, valid = st["cache"], st["scales"], st.get("bias"), st.get("valid")
        if int8_kv_eager:
            cache = QuantKVCache(cache, scales)

        def step(s: _LoopState) -> _LoopState:
            active = (s.step < max_new) & ~s.finished.all()
            pos = p + s.step                # at most t_max - 1
            if not (use_fused or use_fused_b):
                logits = held_step(cache, pos, active, lambda: model.decode_step(
                    s.token, s.step - 1, pos, valid, cache))
                return device_loop.select(active, _advance(s, logits, gen, generator,
                                                           stop, max_new), s)
            emb = model.embed_decode_token(s.token, s.step - 1)
            if use_fused_b:
                hidden, kv_new, logits_pad = fused_decode_step_batch(
                    emb, fused_pack, cache, bias, pos, cfg.heads, kv_scales=scales,
                    readout_pack=readout_pack)
                if int8_kv:
                    apply_kv_update_q_batch(cache, scales, kv_new, pos, active)
                else:
                    apply_kv_update_batch(cache, kv_new, pos, active)
            else:
                hidden, kv_new, logits_pad = fused_decode_step(
                    emb, fused_pack, cache, bias, pos, cfg.heads,
                    readout_pack=readout_pack, kv_scales=scales)
                if int8_kv:
                    apply_kv_update_q(cache, scales, kv_new, pos, active)
                else:
                    apply_kv_update(cache, kv_new, pos, active)
            logits = (logits_pad[:, :vocab] if readout_pack is not None
                      else model.readout(hidden))
            return device_loop.select(active, _advance(s, logits, gen, generator, stop,
                                                       max_new), s)

        s, chunks = device_loop.run_chunks(
            _LoopState(*(st[f] for f in _LoopState._fields)), step,
            lambda s: (s.step < max_new) & ~s.finished.all(), chunk, loops, key,
            generator)
        return DecodeResult(s.codes.clone(), s.lengths.clone(), ~s.finished,
                            int(s.step) - 1, chunks)


# ---------------------------------------------------------------------------
# self-speculative decode
# ---------------------------------------------------------------------------

class SpecDecodeResult(NamedTuple):
    codes: torch.Tensor      # (1, max_new) generated codes (stop-padded)
    lengths: torch.Tensor    # (1,) codes including the stop token
    hit_limit: torch.Tensor  # (1,) True if stopped by max length
    steps: int               # codes emitted after the prefill's first code
    rounds: int              # draft + verify rounds
    accepted: int            # drafted tokens accepted, over all rounds
    chunks: int = 0          # chunks of the device loop


class _SpecState(NamedTuple):
    """The speculative loop's state on the device (JAX `_SpecState`; the
    cache is updated in place beside it, the generator stands for the key,
    and the port counts rounds and accepted drafts there too)."""
    step: torch.Tensor       # () int64: codes emitted
    token: torch.Tensor      # (1,) last emitted token
    presence: torch.Tensor   # (1, V)
    codes: torch.Tensor      # (1, max_new + K): a round's window never clips
    finished: torch.Tensor   # (1,)
    lengths: torch.Tensor    # (1,)
    rounds: torch.Tensor     # () int64
    accepted: torch.Tensor   # () int64


def warped_logprobs(logits: torch.Tensor, presence: torch.Tensor,
                    gen: GenerationConfig) -> torch.Tensor:
    """(B, V) logits -> full-vocab log-probs of the warped distribution:
    repetition penalty -> temperature -> top-k -> top-p inside the top-k
    candidates, scattered back with -inf (not `finfo.min`: rejection
    sampling needs true zeros outside the support).  Greedy: the
    log-softmax of the penalized logits.  Typical sampling: the log-softmax
    of `process_logits` of the penalized logits (masked entries at
    float-min), which penalizes them a second time, as JAX's
    `warped_logprobs` does."""
    logits = apply_repetition_penalty(logits.float(), presence, gen.repetition_penalty)
    if gen.typical_sampling:
        return log_softmax(process_logits(logits, presence, gen))
    if gen.do_sample:
        if gen.temperature != 1.0:
            logits = logits / gen.temperature
        k = min(gen.top_k if gen.top_k > 0 else logits.shape[-1], logits.shape[-1])
        top_vals, top_idx = torch.topk(logits, k, dim=-1)        # descending
        if gen.top_p < 1.0:
            probs = torch.softmax(top_vals, dim=-1)
            before = torch.cumsum(probs, dim=-1) - probs
            top_vals = top_vals.masked_fill(before >= gen.top_p, float("-inf"))
        logits = torch.full_like(logits, float("-inf")).scatter(-1, top_idx, top_vals)
    return torch.log_softmax(logits, dim=-1)


def _draw(logp: torch.Tensor, gen: GenerationConfig,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) log-weights -> (B,) tokens: categorical, or argmax when greedy."""
    if gen.do_sample:
        return torch.multinomial(torch.softmax(logp, dim=-1), 1,
                                 generator=generator)[:, 0]
    return torch.argmax(logp, dim=-1)


def speculative_accept(lp_target: torch.Tensor, lp_draft: torch.Tensor,
                       drafts: torch.Tensor, uniforms: Optional[torch.Tensor]):
    """The acceptance step of speculative sampling over K - 1 drafts.

    lp_target (K, V): the target's warped log-probs at the K verified
    positions; lp_draft (K - 1, V): the draft's, at the drafted positions;
    drafts (K - 1,) the drafted tokens; uniforms (K - 1,) draws in (0, 1)
    for sampling, or None for greedy (a draft is accepted while it is the
    target's argmax).  Draft i is accepted when u_i < q(d_i) / p(d_i),
    compared as logs.  Returns (n_acc, log-weights of the next token's
    distribution): the residual max(q - p, 0) at the first rejection (the
    target row there when the residual is empty, or under greedy), or the
    target's last row (the bonus token) when every draft was accepted.
    Both are device tensors (n_acc 0-d): the step does not wait for the
    device."""
    kk = lp_target.shape[0]
    idx = torch.arange(kk - 1, device=lp_target.device)
    if uniforms is None:
        accept = lp_target[:-1].argmax(dim=-1) == drafts
    else:
        accept = torch.log(uniforms) < (lp_target[idx, drafts] - lp_draft[idx, drafts])
    n_acc = torch.cumprod(accept.to(torch.int64), dim=0).sum()
    # the first rejected position (`index_select`: a 0-d index would be read
    # on the host)
    row = torch.clamp(n_acc, max=kk - 2).reshape(1)
    corr = lp_target.index_select(0, row)[0]
    if uniforms is not None:
        resid = torch.clamp(torch.exp(corr) - torch.exp(lp_draft.index_select(0, row)[0]),
                            min=0.0)
        corr = torch.where(resid.sum() > 0, torch.log(torch.clamp(resid, min=1e-30)),
                           corr)
    return n_acc, torch.where(n_acc == kk - 1, lp_target[kk - 1], corr)


def spec_decode(model: UnifiedVoice, gen: GenerationConfig,
                cond_latents: torch.Tensor, emo_vec: torch.Tensor,
                text_tokens: torch.Tensor, text_lengths: torch.Tensor,
                max_new: int, generator: Optional[torch.Generator],
                pack_target: FusedDecodePack, pack_draft: Pack,
                k_spec: int = 4, loops: Optional[DeviceLoops] = None,
                chunk: Optional[int] = None) -> SpecDecodeResult:
    """Self-speculative AR decode, batch 1 (JAX `spec_decode`).

    Each round drafts k_spec - 1 tokens, one K1 step each with `pack_draft`
    (the int4 pack in the engine), then runs ONE verify pass of the int8
    `pack_target` over [last token, drafts] (K6), and emits the accepted
    drafts plus one token from the residual or the bonus distribution: every
    emitted token is distributed as sampling from the target.  Draft and
    target share the cache: the draft rows are scratch that the verify pass
    overwrites at the same positions.  Both read out through
    `model.readout`.  Stop-token and cap semantics as `decode` (drafts past
    a stop are dropped).  `cfg.pallas_decode_attention` is not read here,
    as the JAX `spec_decode` does not read it: the packs stay in use.

    The rounds are the JAX `while_loop` on the device (`engine.device_loop`,
    `chunk` rounds a chunk, default CHUNK // k_spec: about CHUNK codes at
    full acceptance): the position reaches K1 and K6 as a device tensor,
    the emission is JAX's masked window merge (no host read), a round draws
    a fixed number of times (k_spec - 1 drafts, the acceptance uniforms and
    the emitted token when sampling), and a round after the stop leaves the
    state and the cache as they were.  On a CUDA device each chunk replays a
    graph of `loops` (the engine's; one of this call's own when None), or
    runs op by op with `DeviceLoops(..., capture=False)`.  `rounds` and
    `accepted` are read once, at the end."""
    cfg = model.cfg
    b, bl = text_tokens.shape
    if b != 1:
        raise ValueError("speculative decode is the single-request path (batch 1)")
    kk = k_spec
    if not 2 <= kk <= 8:
        raise ValueError(f"k_spec must be in 2..8, got {kk}")
    dev = text_tokens.device
    p = n_cond_latents(cfg) + 2 + bl + 2
    t_max = p + 1 + max_new + kk          # drafts may overhang max_new
    t_max += (-t_max) % BLOCK_T
    vocab = cfg.number_mel_codes
    eos = cfg.stop_mel_token
    param_dtype = model.param_dtype

    with torch.no_grad():
        prompt, valid_p = model.build_prompt(cond_latents.to(param_dtype),
                                             emo_vec.to(param_dtype),
                                             text_tokens, text_lengths)
        valid = torch.cat([valid_p, torch.ones((1, t_max - p), dtype=torch.bool,
                                               device=dev)], dim=1)
        cache = model.gpt.init_cache(1, t_max, prompt.dtype, dev)
        logits0 = model.prefill(prompt, valid_p, cache)
        cache = cache_to_time_major(cache)
        bias = torch.where(valid[0, :, None], 0.0, -1e30).float()

        presence = torch.zeros((1, vocab), dtype=torch.bool, device=dev)
        presence[:, 1] = True
        presence[:, cfg.start_mel_token] = True
        token = _draw(warped_logprobs(logits0, presence, gen), gen, generator)
        codes = torch.full((1, max_new + kk), eos, dtype=torch.long, device=dev)
        codes[:, 0] = token
        zero = torch.zeros((), dtype=torch.long, device=dev)
        s = _SpecState(torch.ones((), dtype=torch.long, device=dev), token,
                       presence.scatter(1, token[:, None], True), codes, token == eos,
                       torch.ones((1,), dtype=torch.long, device=dev), zero, zero.clone())
        chunk = chunk or max(1, device_loop.CHUNK // kk)
        loops = device_loop.loops_for(dev, loops)
        key = ("spec", id(model), id(pack_target), id(pack_draft), id(generator),
               generation_key(gen), p, t_max, max_new, kk, chunk)
        st = device_loop.bind(loops, key, {"cache": cache, "bias": bias, **s._asdict()})
        cache, bias = st["cache"], st["bias"]

        def round_fn(s: _SpecState) -> _SpecState:
            active = (s.step < max_new) & ~s.finished.all()
            # made in the round: a replay reads only the key's static tensors
            lanes = torch.arange(kk, device=dev)
            pos0 = p + s.step               # the last emitted token's position
            # ---- draft kk - 1 tokens
            tok, pres_d = s.token, s.presence
            embs, ckpts, d_toks, d_lps = [], [], [], []
            for i in range(kk - 1):
                emb = model.embed_decode_token(tok, s.step - 1 + i)
                embs.append(emb)
                ckpts.append(pres_d)
                hidden, kv_new, _ = fused_decode_step(emb, pack_draft, cache, bias,
                                                      pos0 + i, cfg.heads)
                apply_kv_update(cache, kv_new, pos0 + i, active)
                lp_d = warped_logprobs(model.readout(hidden), pres_d, gen)
                tok = _draw(lp_d, gen, generator)
                d_toks.append(tok)
                d_lps.append(lp_d)
                pres_d = pres_d.scatter(1, tok[:, None], True)
            embs.append(model.embed_decode_token(tok, s.step - 1 + kk - 1))
            ckpts.append(pres_d)
            # ---- one verify pass over [token, d_0 .. d_{kk-2}]
            hid_v, kv_v = fused_decode_verify(torch.cat(embs), pack_target, cache,
                                              bias, pos0, cfg.heads)
            apply_kv_update_span(cache, kv_v, pos0, active)
            # the target's warped distributions, each under the presence
            # its position saw (row-wise: one call for the kk rows)
            pres_stack = torch.cat(ckpts)                       # (kk, V)
            lp_t = warped_logprobs(model.readout(hid_v), pres_stack, gen)
            # ---- accept, then the residual or bonus token
            drafts = torch.cat(d_toks)
            u = (torch.clamp(torch.rand(kk - 1, generator=generator, device=dev),
                             min=1e-20) if gen.do_sample else None)
            n_acc, next_lp = speculative_accept(lp_t, torch.cat(d_lps), drafts, u)
            t_star = _draw(next_lp[None], gen, generator)       # (1,)
            # ---- emit [d_0 .. d_{n_acc-1}, t_star], honouring stop and cap
            # (JAX's masked window merge)
            emitted = torch.where(lanes == n_acc, t_star, torch.cat([drafts, t_star]))
            is_stop = (emitted == eos) & (lanes <= n_acc)
            any_stop = is_stop.any()
            first_stop = torch.argmax(is_stop.long())
            # (>= 1 in a round that runs: JAX's count-0 branch is the stop,
            # which `select` covers; a round after it reads lane 0)
            count = torch.minimum(torch.where(any_stop, first_stop + 1, n_acc + 1),
                                  max_new - s.step)
            cols = s.step + lanes
            merged = torch.where(lanes < count, emitted, s.codes[0].index_select(0, cols))
            return device_loop.select(active, _SpecState(
                s.step + count, merged.index_select(0, (count - 1).clamp(min=0).reshape(1)),
                # the checkpoint at the emission boundary, and t_star's bit
                pres_stack.index_select(0, n_acc.reshape(1)).scatter(1, t_star[:, None], True),
                s.codes.index_copy(1, cols, merged[None]),
                s.finished | (any_stop & (count == first_stop + 1)),
                s.step + count, s.rounds + 1, s.accepted + n_acc), s)

        s, chunks = device_loop.run_chunks(
            _SpecState(*(st[f] for f in _SpecState._fields)), round_fn,
            lambda s: (s.step < max_new) & ~s.finished.all(), chunk, loops, key,
            generator)
        steps, rounds, accepted = torch.stack([s.step, s.rounds, s.accepted]).tolist()
    return SpecDecodeResult(s.codes[:, :max_new].clone(), s.lengths.clone(), ~s.finished,
                            steps - 1, rounds, accepted, chunks)

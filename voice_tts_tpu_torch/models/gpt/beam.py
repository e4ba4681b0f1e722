"""Beam search / beam sampling for one UnifiedVoice request
(`voice_tts_tpu/models/gpt/beam.py`: `_process_scores`,
`warp_candidate_space`, `_length_penalize`, `_candidates`, `_scorer_step`,
`_finalize_pool`, `beam_decode`).

The reference engine's default is `num_beams=3` (HF beam search / beam
sampling).  Semantics, as in the JAX package:

- scores are log-softmax of the logits with the repetition penalty applied
  to them (not to raw logits as in `decode.sample_token`), then, when
  sampling, temperature / top-k / top-p in each beam's top-nk candidate
  space;
- candidate scores = processed + beam score, flattened over (beam, vocab);
  2K candidates by top-k, or by Gumbel top-k (multinomial without
  replacement) when sampling, sorted descending;
- stop-token candidates ranked < K enter the hypothesis pool (one top-k
  over the union of pool and candidates), the first K others become the
  next beams; done when the pool is full and its worst score is at least
  the best running one (early_stopping=False); running beams fill the pool
  when the length limit ends the search.

Every top-k breaks ties by the lowest index, as `jax.lax.top_k` does (ties
are common: at step 0 two of three beams sit at -1e9, warped-out lanes at
float-min), and every argsort is stable, as `jnp.argsort` is.

Two arms, chosen as in the JAX package:

- the K3 arm (a fused pack and K <= 4): each step is one
  `ops.fused_decode.fused_decode_step_batch` over the K beams, which read
  their histories through a (K, Tmax) ancestor table instead of a reordered
  cache, with an optional int8 KV cache and the folded readout.  It runs as
  the JAX `while_loop` does, on the device (`engine.device_loop`): the
  `_BeamState`, the position and the `done` test stay there, the steps run
  a chunk at a time (one CUDA graph a chunk on the card), and a step after
  `done` or past `max_new` leaves the state and the cache as they were;
- the eager arm (no pack, K > 4, or `GPTConfig.pallas_decode_attention`):
  `UnifiedVoice.decode_step` over a cache that is physically reordered
  after every step.  It is the plain reference of the K3 arm
  (`ancestor_table=False` gives the K3 step the same physical reorder, for
  tests).  With `pallas_decode_attention` its cache is float, padded to a
  multiple of 512, and each layer attends through K5.  Both keep a host
  loop, one host read of `done` a step.

Request-batched beam (`beam_decode_fused_batch`, the engine's `infer_batch`
and multi-segment path): R requests x K beams = R * K <= 12 rows of one K3
step, each row reading its own request's history through a (R * K, Tmax)
ancestor table in global row ids; each request runs `beam_decode`'s search
(`_make_step` a request, its pool frozen once it is done while its rows
keep computing) and draws from a generator of its own; each request's
prefill runs alone (`prefill_rows`) and K3's per-row sums do not depend on
the row count, so a request gives the same search alone or in a batch.
It runs as the one-request arm does, a device loop keyed by (R, K, the
cap).  `beam_decode_batch` is its plain arm (no pack, or K > 4): one eager
`beam_decode` a request over the same streams.

Left out here: typical sampling (raises).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine import device_loop
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.models.gpt.decode import (DecodeResult,
                                                   apply_repetition_penalty,
                                                   generation_key, prefill_rows)
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice, n_cond_latents
from voice_tts_tpu_torch.ops.decode_attention import BLOCK_T as ATTN_BLOCK_T
from voice_tts_tpu_torch.ops.fused_decode import (BLOCK_T, MAX_ROWS_TABLE,
                                                  FusedDecodePack, ReadoutPack,
                                                  apply_kv_update_batch,
                                                  apply_kv_update_q_batch,
                                                  cache_to_time_major,
                                                  fused_decode_step_batch,
                                                  quantize_kv_cache_batch)

NEG = -1e9

# uniform(shape) -> f32 values in [1e-20, 1) for the Gumbel draw
Uniform = Callable[[tuple], torch.Tensor]


class _BeamState(NamedTuple):
    """The beam loop's state on the device (JAX `_BeamState`; the cache and
    its scales are updated in place beside it, and the generator stands for
    the key)."""
    step: torch.Tensor             # () int64: beam steps taken
    tokens: torch.Tensor           # (K, max_new) generated so far (reordered)
    beam_scores: torch.Tensor      # (K,)
    src: Optional[torch.Tensor]    # (K, Tmax) int32 ancestor table (K3 arm)
    presence: torch.Tensor         # (K, V)
    last_tokens: torch.Tensor      # (K,) fed into the next step
    pool_scores: torch.Tensor      # (K,)
    pool_seqs: torch.Tensor        # (K, max_new)
    pool_lens: torch.Tensor        # (K,)
    done: torch.Tensor             # () bool


class _BeamStateB(NamedTuple):
    """The request-batched beam loop's state (JAX `_BeamStateB`): R requests
    x K beams, request i's rows [i * K, (i + 1) * K)."""
    step: torch.Tensor             # () int64, shared by the requests
    tokens: torch.Tensor           # (R, K, max_new)
    beam_scores: torch.Tensor      # (R, K)
    src: torch.Tensor              # (R * K, Tmax) int32 table in global row ids
    presence: torch.Tensor         # (R, K, V)
    last_tokens: torch.Tensor      # (R * K,)
    pool_scores: torch.Tensor      # (R, K)
    pool_seqs: torch.Tensor        # (R, K, max_new)
    pool_lens: torch.Tensor        # (R, K)
    done: torch.Tensor             # (R,) bool


def topk_first(x: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest along the last axis, descending, the
    lowest index first among equal values."""
    idx = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.log_softmax`, written as it is: x - max - log(sum(exp))."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _process_scores(logprobs, presence, gen: GenerationConfig):
    """Repetition penalty on the log-probs.  The JAX version's other branches
    (typical sampling, and the warpers it applies only together with typical
    sampling) are not ported: typical sampling raises."""
    if gen.typical_sampling:
        raise NotImplementedError("typical sampling is not ported")
    return apply_repetition_penalty(logprobs, presence, gen.repetition_penalty)


def warp_candidate_space(s: torch.Tensor, top_k: int, top_p: float, n_keep: int):
    """Top-k / top-p warping in each row's top-nk candidate space,
    nk = max(top_k, n_keep): (top_vals (K, nk) descending with removed lanes
    at float-min, top_idx (K, nk) vocab ids)."""
    vocab = s.shape[-1]
    tk = min(top_k if top_k > 0 else vocab, vocab)
    nk = min(max(tk, n_keep), vocab)
    top_vals, top_idx = topk_first(s, nk)
    fmin = torch.finfo(top_vals.dtype).min
    rank = torch.arange(nk, device=s.device)[None, :]
    if nk > tk:
        # ranks past the warper's k stay selectable at float-min
        top_vals = torch.where(rank >= tk, fmin, top_vals)
    if top_p < 1.0:
        e = torch.exp(top_vals - top_vals.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        before = torch.cumsum(probs, dim=-1) - probs
        top_vals = torch.where((before >= top_p) & (rank != 0), fmin, top_vals)
    return top_vals, top_idx


def _length_penalize(sum_logprobs, length, length_penalty: float):
    if length_penalty == 0.0:
        return sum_logprobs
    n = torch.clamp(torch.as_tensor(length, device=sum_logprobs.device), min=1)
    return sum_logprobs / torch.pow(n.float(), length_penalty)


def _candidates(logits, presence, beam_scores, uniform: Optional[Uniform],
                gen: GenerationConfig, k: int, vocab: int):
    """2K candidates sorted by score: (scores (2K,), beams (2K,), tokens (2K,)).
    Greedy takes the top 2K of the flat (K * V) scores; sampling draws them
    by Gumbel top-k over the warped candidate space with `uniform`'s values."""
    logprobs = _log_softmax(logits.float())
    n_keep = 2 * k
    if not gen.do_sample or gen.typical_sampling:
        processed = _process_scores(logprobs, presence, gen)
        flat = (processed + beam_scores[:, None]).reshape(-1)
        cand_scores, idx = topk_first(flat, n_keep)
        return cand_scores, idx // vocab, idx % vocab
    s = apply_repetition_penalty(logprobs, presence, gen.repetition_penalty)
    if gen.temperature != 1.0:
        s = s / gen.temperature
    top_vals, top_idx = warp_candidate_space(s, gen.top_k, gen.top_p, n_keep)
    nk = top_vals.shape[-1]
    flat = (top_vals + beam_scores[:, None]).reshape(-1)
    g = _log_softmax(flat) - torch.log(-torch.log(uniform(tuple(flat.shape))))
    _, idx = topk_first(g, n_keep)
    cand_scores = flat[idx]
    order = torch.argsort(cand_scores, descending=True, stable=True)
    idx, cand_scores = idx[order], cand_scores[order]
    beams = idx // nk
    return cand_scores, beams, top_idx[beams, idx % nk]


def _scorer_step(step, done, pool_scores_in, pool_seqs_in, pool_lens_in,
                 tokens_in, cand_scores, cand_beams, cand_tokens,
                 gen: GenerationConfig, k: int, eos: int):
    """BeamSearchScorer.process over 2K sorted candidates; `step` a host int
    or a 0-d tensor on the device.  Returns (pool scores, seqs, lens, next
    scores, beams, tokens, done)."""
    dev = cand_scores.device
    is_eos = cand_tokens == eos
    ranks = torch.arange(2 * k, device=dev)
    gen_len = step                       # tokens generated before this one
    add = is_eos & (ranks < k) & ~done
    hyp_scores = _length_penalize(cand_scores, gen_len + 1, gen.length_penalty)
    cand_pool = torch.where(add, hyp_scores, 4 * NEG)
    top_scores, top_idx = topk_first(torch.cat([pool_scores_in, cand_pool]), k)
    # old pool entries keep their seq / len; new ones take the parent beam's
    # tokens and the current generated length
    from_pool = top_idx < k
    cand_sel = torch.clamp(top_idx - k, 0, 2 * k - 1)
    pool_idx = torch.clamp(top_idx, 0, k - 1)
    pool_seqs = torch.where(from_pool[:, None], pool_seqs_in[pool_idx],
                            tokens_in[cand_beams[cand_sel]])
    pool_lens = torch.where(from_pool, pool_lens_in[pool_idx], gen_len)
    # next beams: the first K non-stop candidates in order
    sel = torch.argsort(is_eos.long() * (4 * k) + ranks, stable=True)[:k]
    pool_full = torch.all(top_scores > NEG / 2)
    best_running = _length_penalize(cand_scores.max(), gen_len + 1,
                                    gen.length_penalty)
    done = done | (pool_full & (top_scores.min() >= best_running))
    return (top_scores, pool_seqs, pool_lens, cand_scores[sel],
            cand_beams[sel], cand_tokens[sel], done)


def _make_step(s: _BeamState, logits, uniform: Uniform, gen: GenerationConfig,
               k: int, vocab: int, eos: int, p: int, max_new: int):
    """JAX `make_step`: the candidates, the scorer, then the next beams'
    tokens and presence and, with an ancestor table, the table (this step's
    position is each row's own, then every row inherits its parent's
    history).  Returns (the next state, the parent of each next beam)."""
    cand = _candidates(logits, s.presence, s.beam_scores, uniform, gen, k, vocab)
    (pool_scores, pool_seqs, pool_lens, beam_scores, parents, last_tokens,
     done) = _scorer_step(s.step, s.done, s.pool_scores, s.pool_seqs, s.pool_lens,
                          s.tokens, *cand, gen, k, eos)
    col = s.step.clamp(max=max_new - 1).reshape(1)     # step < max_new while active
    tokens = s.tokens[parents].index_copy(1, col, last_tokens[:, None])
    presence = s.presence[parents].scatter(1, last_tokens[:, None], True)
    src = s.src
    if src is not None:
        own = torch.arange(k, dtype=src.dtype, device=src.device)[:, None]
        src = src.index_copy(1, (p + s.step).reshape(1), own)[parents]
    return _BeamState(s.step + 1, tokens, beam_scores, src, presence, last_tokens,
                      pool_scores, pool_seqs, pool_lens, done), parents


def _finalize_pool(pool_scores, pool_seqs, pool_lens, beam_scores, tokens,
                   step, done, gen: GenerationConfig, k: int):
    """Running beams enter the pool when the length limit ran out."""
    ran_out = ~done
    for c in range(k):
        score = _length_penalize(beam_scores[c], step, gen.length_penalty)
        worst = torch.argmin(pool_scores)
        do_add = ran_out & (score > pool_scores[worst])
        new_scores, new_seqs, new_lens = (pool_scores.clone(), pool_seqs.clone(),
                                          pool_lens.clone())
        new_scores[worst] = score
        new_seqs[worst] = tokens[c]
        new_lens[worst] = step
        pool_scores = torch.where(do_add, new_scores, pool_scores)
        pool_seqs = torch.where(do_add, new_seqs, pool_seqs)
        pool_lens = torch.where(do_add, new_lens, pool_lens)
    return pool_scores, pool_seqs, pool_lens


def _uniform_of(generator: Optional[torch.Generator], dev) -> Uniform:
    """The Gumbel draw's uniforms from `generator`, in [1e-20, 1)."""
    def uniform(shape):
        return torch.clamp(torch.rand(shape, generator=generator, device=dev), min=1e-20)
    return uniform


def _k3_logits(model: UnifiedVoice, fused_pack, readout_pack, cache, scales, bias,
               s, pos, active=None) -> torch.Tensor:
    """One K3 step at `pos` over the rows of `s.last_tokens`, each reading
    its history through the table `s.src` (or its own row when None);
    writes the rows' new KV at `pos` (kept where the 0-d `active` is false)
    and returns their (rows, V) logits."""
    emb = model.embed_decode_token(s.last_tokens, s.step - 1)
    hidden, kv_new, logits_pad = fused_decode_step_batch(
        emb, fused_pack, cache, bias, pos, model.cfg.heads,
        kv_scales=scales, beam_src=s.src, readout_pack=readout_pack)
    if scales is not None:
        apply_kv_update_q_batch(cache, scales, kv_new, pos, active)
    else:
        apply_kv_update_batch(cache, kv_new, pos, active)
    return (logits_pad[:, :model.cfg.number_mel_codes] if readout_pack is not None
            else model.readout(hidden))


def _best(s: _BeamState, gen: GenerationConfig, k: int, max_new: int, eos: int):
    """The search's result from its final state: running beams enter the
    pool when the length limit ran out, then the pool's best hypothesis as
    (seq (1, max_new) stop-padded, lengths (1,), hit_limit (1,))."""
    pool_scores, pool_seqs, pool_lens = _finalize_pool(
        s.pool_scores, s.pool_seqs, s.pool_lens, s.beam_scores, s.tokens, s.step,
        s.done, gen, k)
    best = torch.argmax(pool_scores)
    gen_len = pool_lens[best]
    hit_limit = (~s.done & (gen_len == s.step)).reshape(1)
    lengths = torch.where(hit_limit, gen_len, gen_len + 1)
    posn = torch.arange(max_new, device=gen_len.device)[None, :]
    return torch.where(posn < gen_len, pool_seqs[best][None, :], eos), lengths, hit_limit


def beam_decode(model: UnifiedVoice, gen: GenerationConfig,
                cond_latents: torch.Tensor, emo_vec: torch.Tensor,
                text_tokens: torch.Tensor, text_lengths: torch.Tensor,
                max_new: int, generator: Optional[torch.Generator] = None,
                fused_pack: Optional[FusedDecodePack] = None,
                int8_kv: bool = False,
                readout_pack: Optional[ReadoutPack] = None,
                uniform: Optional[Uniform] = None,
                ancestor_table: bool = True,
                loops: Optional[DeviceLoops] = None,
                chunk: Optional[int] = None) -> DecodeResult:
    """Beam search / sampling for one request (1 x K beams).

    Returns the best hypothesis as a (1, max_new) DecodeResult (`lengths`
    counts the codes plus the stop token when one ended the hypothesis;
    `steps` the decode steps after the prefill).  With `fused_pack` and
    K <= 4 every step runs K3 over the K beams, reading history through the
    ancestor table (`int8_kv`: an int8 cache with per-(beam, position)
    scales), as a device loop of `chunk` (default CHUNK) steps a chunk: on a
    CUDA device a replay of a graph of `loops` (the engine's; one of this
    call's own when None), or op by op with `DeviceLoops(..., capture=False)`.
    Otherwise, and always under `cfg.pallas_decode_attention`, the eager
    step with a physical cache reorder in a host loop (`ancestor_table=False`
    gives the K3 step that reorder and loop too).
    `uniform` replaces the Gumbel draw's uniforms (default: `generator`)."""
    cfg = model.cfg
    k = gen.num_beams
    b, bl = text_tokens.shape
    if b != 1:
        raise ValueError("beam decode drives one request")
    dev = text_tokens.device
    use_fused = (fused_pack is not None and k <= 4
                 and not cfg.pallas_decode_attention)
    int8_kv = int8_kv and use_fused
    p = n_cond_latents(cfg) + 2 + bl + 2
    t_max = p + 1 + max_new
    if cfg.pallas_decode_attention:
        t_max += (-t_max) % ATTN_BLOCK_T
    elif use_fused:
        t_max += (-t_max) % BLOCK_T
    vocab = cfg.number_mel_codes
    eos = cfg.stop_mel_token
    injected = uniform is not None
    if uniform is None:
        uniform = _uniform_of(generator, dev)
    param_dtype = model.param_dtype

    with torch.no_grad():
        prompt, valid_p = model.build_prompt(cond_latents.to(param_dtype),
                                             emo_vec.to(param_dtype),
                                             text_tokens, text_lengths)
        valid = torch.cat([valid_p, torch.ones((1, t_max - p), dtype=torch.bool,
                                               device=dev)], dim=1)
        valid_k = valid.expand(k, t_max)
        cache1 = model.gpt.init_cache(1, t_max, prompt.dtype, dev)
        logits = model.prefill(prompt, valid_p, cache1).expand(k, vocab)
        cache = cache1.expand(-1, -1, k, -1, -1, -1).contiguous()
        scales = src = attn_bias = None
        if use_fused:
            cache = cache_to_time_major(cache)             # (L, 2, K, Tmax, D)
            attn_bias = torch.where(valid_k, 0.0, -1e30).float()
            if int8_kv:
                cache, scales = quantize_kv_cache_batch(cache)
            if ancestor_table:
                # prefill wrote identical copies into every row: each row
                # starts pointing at its own copy
                src = torch.arange(k, dtype=torch.int32, device=dev)[:, None].repeat(1, t_max)

        presence = torch.zeros((k, vocab), dtype=torch.bool, device=dev)
        presence[:, 1] = True
        presence[:, cfg.start_mel_token] = True
        beam_scores = torch.full((k,), NEG, dtype=torch.float32, device=dev)
        beam_scores[0] = 0.0
        s = _BeamState(
            torch.zeros((), dtype=torch.long, device=dev),
            torch.zeros((k, max_new), dtype=torch.long, device=dev), beam_scores, src,
            presence, torch.zeros((k,), dtype=torch.long, device=dev),
            torch.full((k,), 2 * NEG, dtype=torch.float32, device=dev),
            torch.full((k, max_new), eos, dtype=torch.long, device=dev),
            torch.zeros((k,), dtype=torch.long, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))
        s, parents = _make_step(s, logits, uniform, gen, k, vocab, eos, p, max_new)

        chunks = 0
        if src is None:
            # the eager arm, or K3 with a physical reorder: a host loop
            step = 1
            while True:
                cache = cache.index_select(2, parents)
                if scales is not None:
                    scales = scales.index_select(1, parents)
                if step >= max_new or bool(s.done):
                    break
                if use_fused:
                    logits = _k3_logits(model, fused_pack, readout_pack, cache, scales,
                                        attn_bias, s, p + step)
                else:
                    logits = model.decode_step(s.last_tokens, step - 1, p + step,
                                               valid_k, cache)
                s, parents = _make_step(s, logits, uniform, gen, k, vocab, eos, p,
                                        max_new)
                step += 1
        else:
            chunk = chunk or device_loop.CHUNK
            loops = device_loop.loops_for(dev, loops)
            key = ("beam", id(model), id(fused_pack), id(readout_pack), id(generator),
                   id(uniform) if injected else None, generation_key(gen), p, t_max,
                   max_new, int8_kv, chunk)
            st = device_loop.bind(loops, key, {
                "cache": cache, "bias": attn_bias,
                **({"scales": scales} if int8_kv else {}),
                **s._asdict()})
            cache, attn_bias, scales = st["cache"], st["bias"], st.get("scales")

            def step_fn(s: _BeamState) -> _BeamState:
                active = (s.step < max_new) & ~s.done
                logits = _k3_logits(model, fused_pack, readout_pack, cache, scales,
                                    attn_bias, s, p + s.step, active)  # pos <= t_max - 1
                return device_loop.select(active, _make_step(
                    s, logits, uniform, gen, k, vocab, eos, p, max_new)[0], s)

            s, chunks = device_loop.run_chunks(
                _BeamState(*(st[f] for f in _BeamState._fields)), step_fn,
                lambda s: (s.step < max_new) & ~s.done, chunk, loops, key, generator)

        seq, lengths, hit_limit = _best(s, gen, k, max_new, eos)
    return DecodeResult(seq, lengths, hit_limit, int(s.step) - 1, chunks)


def _request(s: _BeamStateB, i: int, k: int) -> _BeamState:
    """Request i's part of the batched state, as a one-request state without
    a table."""
    return _BeamState(s.step, s.tokens[i], s.beam_scores[i], None, s.presence[i],
                      s.last_tokens[i * k:(i + 1) * k], s.pool_scores[i],
                      s.pool_seqs[i], s.pool_lens[i], s.done[i])


def _make_step_batch(s: _BeamStateB, logits, uniforms: Sequence[Uniform],
                     gen: GenerationConfig, k: int, vocab: int, eos: int, p: int,
                     max_new: int) -> _BeamStateB:
    """JAX `beam_decode_fused_batch`'s `make_step`: `_make_step` for each
    request on its (K, V) logits and its own draws, then the table in global
    row ids (this position is each row's own, then every row inherits its
    in-request parent's history)."""
    r = logits.shape[0]
    new, parents = zip(*(_make_step(_request(s, i, k), logits[i], uniforms[i], gen,
                                    k, vocab, eos, p, max_new) for i in range(r)))
    dev = s.src.device
    own = torch.arange(r * k, dtype=s.src.dtype, device=dev)[:, None]
    g_next = (torch.arange(r, device=dev)[:, None] * k + torch.stack(parents)).reshape(-1)
    src = s.src.index_copy(1, (p + s.step).reshape(1), own)[g_next]

    def stack(field):
        return torch.stack([getattr(n, field) for n in new])
    return _BeamStateB(s.step + 1, stack("tokens"), stack("beam_scores"), src,
                       stack("presence"), torch.cat([n.last_tokens for n in new]),
                       stack("pool_scores"), stack("pool_seqs"), stack("pool_lens"),
                       stack("done"))


def beam_decode_fused_batch(model: UnifiedVoice, gen: GenerationConfig,
                            cond_latents: torch.Tensor, emo_vec: torch.Tensor,
                            text_tokens: torch.Tensor, text_lengths: torch.Tensor,
                            max_new: int, generators: Sequence[torch.Generator],
                            fused_pack: FusedDecodePack, int8_kv: bool = False,
                            readout_pack: Optional[ReadoutPack] = None,
                            loops: Optional[DeviceLoops] = None,
                            chunk: Optional[int] = None) -> DecodeResult:
    """Request-batched beam search on K3: R requests x K beams = R * K rows
    of one step (JAX `beam_decode_fused_batch`).

    text_tokens (R, bucket) share the text bucket, so the prompt length and
    the position are shared; `generators` holds request i's stream at i.
    Each request runs `beam_decode`'s search; a finished request's pool
    freezes while its rows keep computing, until every request is done or
    `max_new` ran out.  The loop runs as `beam_decode`'s K3 arm (a device
    loop of `chunk` steps a chunk, one replayed graph a chunk on the card,
    every generator registered with it).  Returns an (R, max_new)
    DecodeResult; `steps` the shared steps after the prefill.  Needs a pack,
    K <= 4, R * K <= 12 and no `pallas_decode_attention` (raises otherwise:
    `beam_decode_batch` is the plain arm)."""
    cfg = model.cfg
    k = gen.num_beams
    r, bl = text_tokens.shape
    nrows = r * k
    if fused_pack is None or k > 4 or nrows > MAX_ROWS_TABLE or cfg.pallas_decode_attention:
        raise ValueError(f"beam_decode_fused_batch: needs a fused pack, K <= 4 and R * K "
                         f"<= {MAX_ROWS_TABLE} without pallas_decode_attention "
                         f"(R {r}, K {k})")
    if len(generators) != r:
        raise ValueError(f"beam_decode_fused_batch: {len(generators)} generators for "
                         f"{r} requests")
    dev = text_tokens.device
    p = n_cond_latents(cfg) + 2 + bl + 2
    t_max = p + 1 + max_new
    t_max += (-t_max) % BLOCK_T
    vocab = cfg.number_mel_codes
    eos = cfg.stop_mel_token
    uniforms = [_uniform_of(g, dev) for g in generators]
    param_dtype = model.param_dtype

    with torch.no_grad():
        prompt, valid_p = model.build_prompt(cond_latents.to(param_dtype),
                                             emo_vec.to(param_dtype),
                                             text_tokens, text_lengths)
        valid = torch.cat([valid_p, torch.ones((r, t_max - p), dtype=torch.bool,
                                               device=dev)], dim=1)
        logits, cache_r = prefill_rows(model, prompt, valid_p, t_max)   # (R, V)
        # rows [iK, (i + 1)K) are request i's; the int8 scales are per row
        # and position, so quantizing the R rows before the repeat is exact
        cache = cache_to_time_major(cache_r)
        scales = None
        if int8_kv:
            cache, scales = quantize_kv_cache_batch(cache)
            scales = scales.repeat_interleave(k, dim=1)
        cache = cache.repeat_interleave(k, dim=2)
        attn_bias = torch.where(valid.repeat_interleave(k, dim=0), 0.0, -1e30).float()
        src = torch.arange(nrows, dtype=torch.int32, device=dev)[:, None].repeat(1, t_max)
        presence = torch.zeros((r, k, vocab), dtype=torch.bool, device=dev)
        presence[:, :, 1] = True
        presence[:, :, cfg.start_mel_token] = True
        beam_scores = torch.full((r, k), NEG, dtype=torch.float32, device=dev)
        beam_scores[:, 0] = 0.0
        s = _BeamStateB(
            torch.zeros((), dtype=torch.long, device=dev),
            torch.zeros((r, k, max_new), dtype=torch.long, device=dev), beam_scores, src,
            presence, torch.zeros((nrows,), dtype=torch.long, device=dev),
            torch.full((r, k), 2 * NEG, dtype=torch.float32, device=dev),
            torch.full((r, k, max_new), eos, dtype=torch.long, device=dev),
            torch.zeros((r, k), dtype=torch.long, device=dev),
            torch.zeros((r,), dtype=torch.bool, device=dev))
        s = _make_step_batch(s, logits[:, None].expand(r, k, vocab), uniforms, gen, k,
                             vocab, eos, p, max_new)

        chunk = chunk or device_loop.CHUNK
        loops = device_loop.loops_for(dev, loops)
        key = ("beam_batch", id(model), id(fused_pack), id(readout_pack),
               tuple(id(g) for g in generators), generation_key(gen), r, k, p, t_max,
               max_new, int8_kv, chunk)
        st = device_loop.bind(loops, key, {
            "cache": cache, "bias": attn_bias,
            **({"scales": scales} if int8_kv else {}), **s._asdict()})
        cache, attn_bias, scales = st["cache"], st["bias"], st.get("scales")

        def step_fn(s: _BeamStateB) -> _BeamStateB:
            active = (s.step < max_new) & ~s.done.all()
            logits = _k3_logits(model, fused_pack, readout_pack, cache, scales,
                                attn_bias, s, p + s.step, active)
            return device_loop.select(active, _make_step_batch(
                s, logits.reshape(r, k, vocab), uniforms, gen, k, vocab, eos, p,
                max_new), s)

        s, chunks = device_loop.run_chunks(
            _BeamStateB(*(st[f] for f in _BeamStateB._fields)), step_fn,
            lambda s: (s.step < max_new) & ~s.done.all(), chunk, loops, key, generators)
        best = [_best(_request(s, i, k), gen, k, max_new, eos) for i in range(r)]
    return DecodeResult(*(torch.cat(parts) for parts in zip(*best)), int(s.step) - 1,
                        chunks)


def beam_decode_batch(model: UnifiedVoice, gen: GenerationConfig,
                      cond_latents: torch.Tensor, emo_vec: torch.Tensor,
                      text_tokens: torch.Tensor, text_lengths: torch.Tensor,
                      max_new: int, generators: Sequence[torch.Generator],
                      loops: Optional[DeviceLoops] = None) -> DecodeResult:
    """Beam search for a batch of independent requests without a pack (JAX
    `beam_decode_batch`, the plain arm of `beam_decode_fused_batch`): one
    eager `beam_decode` a request, request i drawing from `generators[i]`.
    Returns a (B, max_new) DecodeResult; `steps` and `chunks` summed over
    the requests."""
    res: List[DecodeResult] = [
        beam_decode(model, gen, cond_latents[i:i + 1], emo_vec[i:i + 1],
                    text_tokens[i:i + 1], text_lengths[i:i + 1], max_new,
                    generators[i], loops=loops)
        for i in range(text_tokens.shape[0])]
    return DecodeResult(torch.cat([x.codes for x in res]),
                        torch.cat([x.lengths for x in res]),
                        torch.cat([x.hit_limit for x in res]),
                        sum(x.steps for x in res), sum(x.chunks for x in res))

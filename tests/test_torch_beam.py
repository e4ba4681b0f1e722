"""Beam search of the port (`voice_tts_tpu_torch/models/gpt/beam.py`)
against the JAX package's (`voice_tts_tpu/models/gpt/beam.py`): the
candidate, scorer and finalize steps on numpy-seeded inputs (sampling with
the uniforms JAX draws for the same key), and whole greedy beam-3 decodes
of a tiny int8 GPT — the port's eager physical-reorder arm against JAX's
XLA arm, the port's K3 arm (ancestor table) against its physical-reorder
arm with float and int8 KV, and the port's int8-KV K3 arm against JAX's
fused int8-KV beam (Pallas in interpret mode)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
from voice_tts_tpu.models.gpt import beam as jbeam
from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
from voice_tts_tpu.ops.fused_decode import pack_gpt as jax_pack_gpt
from voice_tts_tpu.ops.fused_decode import pack_readout as jax_pack_readout
from voice_tts_tpu.utils.quantize import quantize_gpt_params
from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine.engine import TTSEngine, build_models, tiny_config
from voice_tts_tpu_torch.models.gpt import beam as pbeam
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.ops.fused_decode import pack_gpt, pack_readout
from voice_tts_tpu_torch.utils.convert import convert, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

pytest_plugins = ("port_fixtures",)

CFG = tiny_config()
JAX_CFG = JaxTTSConfig.from_dict(CFG.to_dict())
K = 3
SAMPLE = GenerationConfig(num_beams=K)                   # reference defaults
GREEDY = dataclasses.replace(SAMPLE, do_sample=False)


@functools.lru_cache(maxsize=None)
def jax_gen(gen: GenerationConfig) -> JaxGenerationConfig:
    """The JAX package's GenerationConfig with the same fields (one object
    per port config, so the jitted JAX functions compile once for it)."""
    return JaxGenerationConfig(**dataclasses.asdict(gen))


def t(x):
    return torch.from_numpy(np.asarray(x))


def _logits(rng, k=K, vocab=68):
    return (rng.standard_normal((k, vocab)) * 3).astype(np.float32)


def _presence(rng, k=K, vocab=68):
    p = rng.random((k, vocab)) < 0.1
    p[:, 1] = True
    return p


@pytest.mark.parametrize("gen", [GREEDY, SAMPLE], ids=["greedy", "sample"])
@pytest.mark.parametrize("step0", [True, False], ids=["step0_ties", "running"])
def test_candidates_match_jax(gen, step0):
    """Equal beams and tokens, scores to 1e-6 (log-softmax sums in another
    order); at step 0 the three beams share one row of logits and two sit at
    -1e9, so the Gumbel top-k ranks tied candidates (lowest index first)."""
    rng = np.random.default_rng(21 if step0 else 22)
    logits = _logits(rng)
    if step0:
        logits[:] = logits[0]
        beam_scores = np.asarray([0.0, -1e9, -1e9], np.float32)
    else:
        beam_scores = (-rng.random(K) * 20).astype(np.float32)
    presence = _presence(rng)
    key = jax.random.PRNGKey(5)
    ref = jbeam._candidates(jnp.asarray(logits), jnp.asarray(presence),
                            jnp.asarray(beam_scores), key, jax_gen(gen), K, 68)
    nk = max(gen.top_k, 2 * K)

    def uniform(shape):
        assert shape == (K * nk,)
        return t(jax.random.uniform(key, shape, minval=1e-20, maxval=1.0))
    out = pbeam._candidates(t(logits), t(presence), t(beam_scores), uniform,
                            gen, K, 68)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=0)


def test_warp_candidate_space_matches_jax():
    rng = np.random.default_rng(23)
    s = _logits(rng, vocab=200)
    for top_k, top_p in ((30, 0.8), (0, 0.5), (4, 1.0)):
        rv, ri = jbeam.warp_candidate_space(jnp.asarray(s), top_k, top_p, 6)
        pv, pi = pbeam.warp_candidate_space(t(s), top_k, top_p, 6)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pv.numpy() == np.finfo(np.float32).min,
                                      np.asarray(rv) == np.finfo(np.float32).min)
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6)


@pytest.mark.parametrize("case", ["empty_pool", "stop_tokens", "done"])
def test_scorer_step_matches_jax(case):
    """The hypothesis pool as one union top-k: an empty pool (all 2 * NEG,
    tied), stop-token candidates entering a partly full pool, and a search
    that is already done (nothing enters).  All outputs equal."""
    rng = np.random.default_rng(31)
    eos, max_new, step = 67, 10, 4
    cand_scores = np.sort(-rng.random(2 * K) * 10)[::-1].astype(np.float32)
    cand_beams = rng.integers(0, K, 2 * K).astype(np.int32)
    cand_tokens = rng.integers(0, 60, 2 * K).astype(np.int32)
    pool_scores = np.full(K, 2 * jbeam.NEG, np.float32)
    pool_seqs = np.full((K, max_new), eos, np.int32)
    pool_lens = np.zeros(K, np.int32)
    done = False
    if case != "empty_pool":
        cand_tokens[[0, 2, 4]] = eos
        pool_scores[0] = -3.5
        pool_seqs[0, :3] = [5, 6, 7]
        pool_lens[0] = 3
    done = case == "done"
    tokens = rng.integers(0, 60, (K, max_new)).astype(np.int32)
    lp_gen = dataclasses.replace(GREEDY, length_penalty=1.0)
    for gen in (GREEDY, lp_gen):
        ref = jbeam._scorer_step(step, jnp.asarray(done), *map(jnp.asarray, (
            pool_scores, pool_seqs, pool_lens, tokens, cand_scores, cand_beams,
            cand_tokens)), jax_gen(gen), K, eos)
        out = pbeam._scorer_step(step, torch.tensor(done), *map(t, (
            pool_scores, pool_seqs, pool_lens, tokens, cand_scores, cand_beams,
            cand_tokens)), gen, K, eos)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("done", [False, True])
def test_finalize_pool_matches_jax(done):
    rng = np.random.default_rng(41)
    pool_scores = np.asarray([-4.0, 2 * jbeam.NEG, -9.0], np.float32)
    pool_seqs = rng.integers(0, 60, (K, 8)).astype(np.int32)
    pool_lens = np.asarray([3, 0, 5], np.int32)
    beam_scores = np.asarray([-2.0, -6.0, -30.0], np.float32)
    tokens = rng.integers(0, 60, (K, 8)).astype(np.int32)
    ref = jbeam._finalize_pool(*map(jnp.asarray, (pool_scores, pool_seqs, pool_lens,
                                                  beam_scores, tokens)),
                               8, jnp.asarray(done), jax_gen(GREEDY), K)
    out = pbeam._finalize_pool(*map(t, (pool_scores, pool_seqs, pool_lens,
                                        beam_scores, tokens)),
                               8, torch.tensor(done), GREEDY, K)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# whole decodes on a tiny int8 GPT
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpts():
    """One tiny GPT: the JAX int8 runtime tree with its packs, and the port's
    int8 runtime module and packs converted from the same f32 weights."""
    c = CFG.gpt
    model = JUV(JAX_CFG.gpt)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]),
        method=JUV.init_all))(jax.random.PRNGKey(3))
    # nudge the stop token so that the greedy beams end inside 20 steps
    # (pool admissions, `done`, stop-padded codes) instead of at the limit
    params = jax.tree.map(lambda x: x, params)
    head = params["params"]["mel_head"]
    head["bias"] = head["bias"].at[c.stop_mel_token].add(0.85)
    jrt = quantize_gpt_params(params)
    master = load_family(build_models(CFG)["gpt"], convert("gpt", params))
    state = quantize_gpt_state(master.state_dict())
    prt = UnifiedVoice(c, int8=True)
    TTSEngine._cast_like(prt, state)
    prt.load_state_dict(state)
    prt.eval()
    rng = np.random.default_rng(51)
    inputs = ((rng.standard_normal((1, c.condition_num_latent, c.model_dim)) * 0.5
               ).astype(np.float32),
              (rng.standard_normal((1, c.model_dim)) * 0.5).astype(np.float32),
              rng.integers(3, c.number_text_tokens, (1, 16)).astype(np.int32),
              np.asarray([11], np.int32))
    return (model, jrt, jax_pack_gpt(jrt, c.layers), jax_pack_readout(jrt),
            prt, pack_gpt(state, c.layers), pack_readout(state), inputs)


def _port_decode(gpts, max_new, **kw):
    _, _, _, _, prt, _, _, (cond, emo, text, tlen) = gpts
    return pbeam.beam_decode(prt, GREEDY, t(cond), t(emo), t(text).long(),
                             t(tlen).long(), max_new, **kw)


def _same(out, ref):
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.hit_limit.numpy(), np.asarray(ref.hit_limit))


def test_beam_decode_greedy_matches_jax_xla_arm(gpts):
    """Greedy beam-3 with the physical cache reorder on both sides (JAX's XLA
    arm, `fused_pack=None`): identical codes, lengths and limit flag; the
    best hypothesis ends on a stop token before the limit."""
    model, jrt, _, _, _, _, _, inputs = gpts
    ref = jbeam.beam_decode(jrt, model, jax_gen(GREEDY), *map(jnp.asarray, inputs),
                            jax.random.PRNGKey(0), max_new=20)
    out = _port_decode(gpts, 20)
    _same(out, ref)
    assert not bool(out.hit_limit[0]) and 5 <= int(out.lengths[0]) < 20


@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16_kv", "int8_kv"])
def test_k3_arm_matches_physical_reorder(gpts, int8_kv):
    """The K3 arm reads each beam's history through the ancestor table; the
    same step with the cache physically reordered after every step gives the
    same codes."""
    _, _, _, _, _, pack, ro, _ = gpts
    kw = dict(fused_pack=pack, readout_pack=ro, int8_kv=int8_kv)
    table = _port_decode(gpts, 20, **kw)
    moved = _port_decode(gpts, 20, ancestor_table=False, **kw)
    for a, b in zip(table[:3], moved[:3]):
        assert torch.equal(a, b)
    assert table.steps == moved.steps >= 5


def test_k3_arm_int8_kv_matches_jax_fused_beam(gpts):
    """The port's K3 arm with int8 KV and the folded readout against JAX's
    fused beam (the Pallas K3 in interpret mode) with the same: equal codes."""
    model, jrt, jpack, jro, _, pack, ro, inputs = gpts
    ref = jbeam.beam_decode(jrt, model, jax_gen(GREEDY), *map(jnp.asarray, inputs),
                            jax.random.PRNGKey(0), max_new=12, fused_pack=jpack,
                            int8_kv=True, readout_pack=jro)
    out = _port_decode(gpts, 12, fused_pack=pack, readout_pack=ro, int8_kv=True)
    _same(out, ref)


def test_topk_first_breaks_ties_by_lowest_index():
    x = torch.tensor([1.0, 3.0, 3.0, -1e9, 3.0, -1e9])
    vals, idx = pbeam.topk_first(x, 5)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(ref_i).tolist() == [1, 2, 4, 0, 3]
    assert vals.tolist() == np.asarray(ref_v).tolist()

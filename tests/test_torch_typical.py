"""Typical sampling in the port (`apply_typical`, `process_logits`, the
typical branches of `sample_token`, `warped_logprobs` and the beam
candidates) against the JAX package: the filter on seeded logits with
planted ties at 1 and 2 tokens kept; a step's candidates with JAX's
uniforms injected; and whole greedy typical decodes of a tiny int8 GPT on
every decode arm (the K1 and the unfused device loops, beam-3 over K3
and eager, `spec_decode` with its double penalty, the request-batched beam
and the batched K3 decode) against JAX's loops (Pallas in interpret mode),
with a typical mass small enough that the codes differ from plain greedy.
Sampled, the chunked loops give the codes of one step a chunk (the K3 beam
against its reorder arm, with JAX's uniforms; K1, one seeded generator)."""

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
from voice_tts_tpu.models.gpt import decode as jdecode
from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
from voice_tts_tpu.ops import fused_decode as jfd
from voice_tts_tpu.utils.quantize import quantize_gpt_params
from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine.engine import TTSEngine, build_models, tiny_config
from voice_tts_tpu_torch.models.gpt import beam as pbeam
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.utils.convert import convert, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

pytest_plugins = ("port_fixtures",)

CFG = tiny_config()
MAX_NEW = 12
# Typical filtering is discontinuous in the logits, and the two frameworks'
# logits of one decode differ by up to ~1e-2 (the bf16 prefill, bf16
# roundings flipped by f32 sums in another order): a step whose typical set
# has a token that close to its boundary decodes differently on the two
# sides, though the decision on the same logits is JAX's bit for bit
# (`test_typical_decisions_on_jax_logits`, the candidates' tests).  The
# whole decodes are held against JAX's at the readout scale and mass below,
# where no step of any arm but the eager beam comes that close and the
# typical codes differ from plain greedy's; the eager beam at its own.
# Random weights give near-flat logits, whose typicality scores all sit
# near 0, hence the widened readout.
HEAD_SCALE, MASS = 3.0, 0.3
EAGER_HEAD_SCALE, EAGER_MASS = 4.0, 0.2
GREEDY = GenerationConfig(do_sample=False, num_beams=1, repetition_penalty=10.0,
                          typical_sampling=True, typical_mass=MASS)
BEAM_GREEDY = dataclasses.replace(GREEDY, num_beams=3)
SAMPLE = dataclasses.replace(GREEDY, do_sample=True)
BEAM_SAMPLE = dataclasses.replace(SAMPLE, num_beams=3)


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def jax_gen(gen: GenerationConfig) -> JaxGenerationConfig:
    return JaxGenerationConfig(**dataclasses.asdict(gen))


# f32 cumulative sums of 300 probabilities, in two orders, near 1
CUM_TOL = 1e-5


def _logits(rng, rows=3, vocab=300):
    """Seeded logits with planted ties: equal values inside a row, and a
    run of equal values at the entropy boundary's neighbourhood."""
    x = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    x[:, 10:20] = x[:, 5:6]
    x[:, 40:43] = x[:, 41:42].mean()
    x[0, 100:130] = x[0, 99]
    return x


@pytest.mark.parametrize("min_keep", [1, 2])
@pytest.mark.parametrize("mass", [0.05, 0.3, 0.9, 1.0])
def test_apply_typical_matches_jax(mass, min_keep):
    """The same entries masked, the rest untouched, masked at float-min;
    but an entry whose cumulative probability in the typical order lies
    within CUM_TOL of the mass, where the two cumulative sums' rounding
    decides (at mass 1 the tail of the order)."""
    x = _logits(np.random.default_rng(int(mass * 100) + min_keep))
    ref = np.asarray(jdecode.apply_typical(jnp.asarray(x), mass, min_keep))
    out = pdecode.apply_typical(t(x), mass, min_keep).numpy()
    norm = torch.log_softmax(t(x).double(), -1)
    order = torch.argsort((-norm - (-(norm * norm.exp()).sum(-1, keepdim=True))).abs(),
                          dim=-1, stable=True)
    cum = torch.empty_like(norm).scatter_(
        -1, order, torch.cumsum(torch.gather(norm.exp(), -1, order), -1)).numpy()
    differ = out != ref
    assert (np.abs(cum[differ] - mass) <= CUM_TOL).all()
    if mass < 1.0:
        assert not differ.any()
    kept = (out > np.finfo(np.float32).min).sum(-1)
    assert (kept >= min_keep).all() and (mass == 1.0 or (kept < x.shape[1]).all())


@pytest.mark.parametrize("gen", [GREEDY, SAMPLE, BEAM_SAMPLE], ids=["greedy", "sample", "beam"])
def test_process_logits_and_greedy_token_match_jax(gen):
    """`process_logits` (penalty, typical with 1 or 2 kept, temperature,
    top-k, top-p) equals JAX's; the greedy typical token is JAX's argmax;
    a sampled typical token lies inside JAX's warped support; the spec
    decode's warp is the log-softmax of the twice-penalized pipeline."""
    gen = dataclasses.replace(gen, temperature=0.8, top_k=40, top_p=0.8)
    rng = np.random.default_rng(3)
    x = _logits(rng)
    presence = rng.random(x.shape) < 0.1
    ref = np.asarray(jdecode.process_logits(jnp.asarray(x), jnp.asarray(presence),
                                            jax_gen(gen)))
    out = pdecode.process_logits(t(x), t(presence), gen).numpy()
    np.testing.assert_array_equal(out, ref)
    g = torch.Generator().manual_seed(0)
    tok = pdecode.sample_token(t(x), t(presence), gen, g).numpy()
    if gen.do_sample:
        assert (ref[np.arange(3), tok] > np.finfo(np.float32).min).all()
    else:
        np.testing.assert_array_equal(tok, ref.argmax(-1))
    twice = jdecode.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(presence),
                                             gen.repetition_penalty)
    lp = jax.nn.log_softmax(jdecode.process_logits(twice, jnp.asarray(presence),
                                                   jax_gen(gen)), axis=-1)
    np.testing.assert_allclose(pdecode.warped_logprobs(t(x), t(presence), gen).numpy(),
                               np.asarray(lp), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("gen", [BEAM_GREEDY, BEAM_SAMPLE], ids=["greedy", "sample"])
def test_beam_candidates_match_jax(gen):
    """A beam step's 2K candidates with typical filtering (2 kept) on the
    full-vocab log-probs, greedy and with the Gumbel draw over the K * V
    flat scores taking JAX's uniforms: equal beams and tokens, scores to
    1e-6 (log-softmax sums in another order)."""
    k, vocab = 3, 300
    rng = np.random.default_rng(21)
    logits = _logits(rng, k, vocab)
    beam_scores = (-rng.random(k) * 20).astype(np.float32)
    presence = rng.random((k, vocab)) < 0.1
    key = jax.random.PRNGKey(5)
    ref = jbeam._candidates(jnp.asarray(logits), jnp.asarray(presence),
                            jnp.asarray(beam_scores), key, jax_gen(gen), k, vocab)

    def uniform(shape):
        assert shape == (k * vocab,)
        return t(jax.random.uniform(key, shape, minval=1e-20, maxval=1.0))
    out = pbeam._candidates(t(logits), t(presence), t(beam_scores), uniform, gen, k, vocab)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# whole decodes on a tiny int8 GPT
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tiny_gpt(head_scale: float):
    """One tiny GPT with its readout scaled by `head_scale`: the JAX int8
    runtime tree with its int8 / int4 packs and readout, the port's int8
    runtime module with the same packs, and inputs for two requests."""
    c = CFG.gpt
    model = JUV(JaxTTSConfig.from_dict(CFG.to_dict()).gpt)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]),
        method=JUV.init_all))(jax.random.PRNGKey(3))
    head = params["params"]["mel_head"]
    head["weight"] = head["weight"] * head_scale
    jrt = quantize_gpt_params(params)
    master = load_family(build_models(CFG)["gpt"], convert("gpt", params))
    state = quantize_gpt_state(master.state_dict())
    prt = UnifiedVoice(c, int8=True)
    TTSEngine._cast_like(prt, state)
    prt.load_state_dict(state)
    rng = np.random.default_rng(51)
    inputs = ((rng.standard_normal((2, c.condition_num_latent, c.model_dim)) * 0.5
               ).astype(np.float32),
              (rng.standard_normal((2, c.model_dim)) * 0.5).astype(np.float32),
              rng.integers(3, c.number_text_tokens, (2, 16)).astype(np.int32),
              np.asarray([11, 14], np.int32))
    return dict(model=model, jrt=jrt, jpack=jfd.pack_gpt(jrt, c.layers),
                jro=jfd.pack_readout(jrt), jpack4=jfd.pack_gpt_int4(params, c.layers),
                prt=prt.eval(), pack=pfd.pack_gpt(state, c.layers),
                ro=pfd.pack_readout(state),
                pack4=pfd.pack_gpt_int4(master.state_dict(), c.layers), inputs=inputs)


@pytest.fixture(scope="module")
def gpts():
    return tiny_gpt(HEAD_SCALE)


def _args(g, rows=1):
    cond, emo, text, tlen = (x[:rows] for x in g["inputs"])
    return t(cond), t(emo), t(text).long(), t(tlen).long()


def _jargs(g, rows=1):
    return [jnp.asarray(x[:rows]) for x in g["inputs"]]


def _same(out, ref):
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.hit_limit.numpy(), np.asarray(ref.hit_limit))


@pytest.mark.parametrize("arm", ["k1", "unfused"])
def test_greedy_typical_decode_matches_jax(gpts, arm):
    """One-beam greedy typical decode: the K1 device loop (fused pack,
    folded readout) and the unfused device loop give JAX's codes, and they
    are not plain greedy's."""
    g = gpts
    kw = dict(fused_pack=g["pack"], readout_pack=g["ro"]) if arm == "k1" else {}
    jkw = dict(fused_pack=g["jpack"], readout_pack=g["jro"]) if arm == "k1" else {}
    ref = jdecode.decode(g["jrt"], g["model"], jax_gen(GREEDY), *_jargs(g),
                         jax.random.PRNGKey(0), max_new=MAX_NEW, **jkw)
    out = pdecode.decode(g["prt"], GREEDY, *_args(g), MAX_NEW, **kw)
    _same(out, ref)
    plain = pdecode.decode(g["prt"], _plain(GREEDY), *_args(g), MAX_NEW, **kw)
    assert not torch.equal(plain.codes, out.codes)
    assert out.chunks == 1


def _plain(gen):
    return dataclasses.replace(gen, typical_sampling=False)


@pytest.mark.parametrize("arm", ["k3", "eager"])
def test_greedy_typical_beam_matches_jax(arm):
    """Beam-3 greedy typical: the K3 device loop (int8 KV, ancestor table)
    gives JAX's fused beam's codes, the eager arm JAX's XLA beam's (at the
    eager settings), and neither is plain greedy's."""
    if arm == "k3":
        g, gen = tiny_gpt(HEAD_SCALE), BEAM_GREEDY
        kw = dict(fused_pack=g["pack"], int8_kv=True, readout_pack=g["ro"])
        jkw = dict(fused_pack=g["jpack"], int8_kv=True, readout_pack=g["jro"])
    else:
        g = tiny_gpt(EAGER_HEAD_SCALE)
        gen, kw, jkw = dataclasses.replace(BEAM_GREEDY, typical_mass=EAGER_MASS), {}, {}
    ref = jbeam.beam_decode(g["jrt"], g["model"], jax_gen(gen), *_jargs(g),
                            jax.random.PRNGKey(0), max_new=MAX_NEW, **jkw)
    out = pbeam.beam_decode(g["prt"], gen, *_args(g), MAX_NEW, **kw)
    _same(out, ref)
    assert not torch.equal(out.codes, pbeam.beam_decode(g["prt"], _plain(gen), *_args(g),
                                                        MAX_NEW, **kw).codes)


def test_greedy_typical_spec_decode_matches_jax(gpts):
    """Greedy typical spec decode (int4 drafts, the int8 verify, the warp
    penalizing twice as JAX's does): JAX's codes."""
    g = gpts
    ref = jdecode.spec_decode(g["jrt"], g["model"], jax_gen(GREEDY), *_jargs(g),
                              jax.random.PRNGKey(0), max_new=MAX_NEW,
                              pack_target=g["jpack"], pack_draft=g["jpack4"], k_spec=4)
    out = pdecode.spec_decode(g["prt"], GREEDY, *_args(g), MAX_NEW, None, g["pack"],
                              g["pack4"], 4)
    _same(out, ref)


def test_greedy_typical_batched_decodes_match_jax(gpts):
    """The request-batched beam (2 requests x 3 beams, one K3 step of 6
    rows) and the batched K3 sampling decode (2 rows at one position), both
    greedy typical: JAX's codes."""
    g = gpts
    ref = jbeam.beam_decode_fused_batch(
        g["jrt"], g["model"], jax_gen(BEAM_GREEDY), *_jargs(g, 2),
        jax.random.split(jax.random.PRNGKey(0), 2), max_new=MAX_NEW,
        fused_pack=g["jpack"], int8_kv=True, readout_pack=g["jro"])
    streams = [torch.Generator().manual_seed(40 + i) for i in range(2)]
    _same(pbeam.beam_decode_fused_batch(g["prt"], BEAM_GREEDY, *_args(g, 2), MAX_NEW,
                                        streams, g["pack"], int8_kv=True,
                                        readout_pack=g["ro"]), ref)
    ref = jdecode.decode(g["jrt"], g["model"], jax_gen(GREEDY), *_jargs(g, 2),
                         jax.random.PRNGKey(0), max_new=MAX_NEW, fused_pack=g["jpack"],
                         fused_batch=True, readout_pack=g["jro"])
    _same(pdecode.decode(g["prt"], GREEDY, *_args(g, 2), MAX_NEW, None, g["pack"],
                         g["ro"], fused_batch=True), ref)


def test_typical_decisions_on_jax_logits():
    """Where the two sides' K1 decodes part (the eager settings), every
    step's typical decision of the port on JAX's logits and presence,
    recorded inside JAX's loop, is JAX's token."""
    g = tiny_gpt(EAGER_HEAD_SCALE)
    gen = dataclasses.replace(GREEDY, typical_mass=EAGER_MASS)
    seen = []
    sample_token = jdecode.sample_token

    def spy(logits, presence, gen_, rng):
        jax.debug.callback(lambda lg, pr: seen.append((np.asarray(lg), np.asarray(pr))),
                           logits, presence)
        return sample_token(logits, presence, gen_, rng)
    jdecode.sample_token = spy
    try:   # a config object of its own: a fresh trace of the jitted loop
        ref = jdecode.decode(g["jrt"], g["model"],
                             JaxGenerationConfig(**dataclasses.asdict(gen)), *_jargs(g),
                             jax.random.PRNGKey(0), max_new=MAX_NEW, fused_pack=g["jpack"],
                             readout_pack=g["jro"])
    finally:
        jdecode.sample_token = sample_token
    assert len(seen) == MAX_NEW
    toks = [int(pdecode.sample_token(t(lg), t(pr), gen, None)[0]) for lg, pr in seen]
    assert toks == np.asarray(ref.codes)[0].tolist()
    out = pdecode.decode(g["prt"], gen, *_args(g), MAX_NEW, fused_pack=g["pack"],
                         readout_pack=g["ro"])
    assert out.codes[0].tolist() != toks


def test_generation_key_has_the_typical_fields():
    """A device loop's key tells the typical settings apart (a captured
    chunk bakes them in)."""
    keys = {pdecode.generation_key(g) for g in (
        GREEDY, _plain(GREEDY), dataclasses.replace(GREEDY, typical_mass=0.5))}
    assert len(keys) == 3


class JaxUniforms:
    """The uniforms JAX's beam draws from PRNGKey(0), one split a step."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, shape):
        self.key, sub = jax.random.split(self.key)
        return t(jax.random.uniform(sub, shape, minval=1e-20, maxval=1.0))


def test_sampled_typical_loops_match_host_loops(gpts):
    """Sampled typical: the chunked K3 beam gives the codes of the K3 step
    with a physical reorder one step a chunk (the reorder arm's device loop,
    which replaced its host loop; JAX's uniforms injected in both, drawn in
    the same order); the chunked K1 decode gives the codes of one step a
    chunk (one seeded generator), all in the vocabulary."""
    g = gpts
    kw = dict(fused_pack=g["pack"], readout_pack=g["ro"], int8_kv=True)
    ref = pbeam.beam_decode(g["prt"], BEAM_SAMPLE, *_args(g), MAX_NEW,
                            uniform=JaxUniforms(), ancestor_table=False, chunk=1, **kw)
    out = pbeam.beam_decode(g["prt"], BEAM_SAMPLE, *_args(g), MAX_NEW,
                            uniform=JaxUniforms(), chunk=4, **kw)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    runs = [pdecode.decode(g["prt"], SAMPLE, *_args(g), MAX_NEW,
                           torch.Generator().manual_seed(9), g["pack"], g["ro"], chunk=n)
            for n in (1, 16)]
    assert torch.equal(runs[0].codes, runs[1].codes)
    assert runs[0].chunks == MAX_NEW - 1 and runs[1].chunks == 1
    assert int(runs[0].codes.max()) < CFG.gpt.number_mel_codes

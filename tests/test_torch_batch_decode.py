"""The port's batched decodes against the JAX package's on one tiny GPT
(the JAX int8 runtime tree and its packs, the port's module and packs
converted from the same f32 parameters), greedy, the Pallas kernels in
interpret mode: the request-batched beam search `beam_decode_fused_batch`
at R 2 and 4 requests of beam-3 (6 and 12 K3 rows through the ancestor
table, int8 KV, folded readout), its plain arm `beam_decode_batch`, and the
batched sampling decode `decode(fused_batch=True)` at B 2 and 4 with texts
of other lengths in one bucket, free and then teacher-forced along JAX's
codes with every step's logits held to JAX's.  Then the port alone: a request's sampled
search in a batch equals the same request alone on the same stream, at
every chunk size, and the refusals.  The `cuda` cases (skipped without a
card) hold the batched keys' replayed graphs against the same chunks op by
op, and a retry after reseeding every request's stream."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.engine.engine import TTSEngine, build_models, tiny_config
from voice_tts_tpu_torch.models.gpt import beam as pbeam
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.utils.convert import convert, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

try:
    import jax
    import jax.numpy as jnp

    from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
    from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
    from voice_tts_tpu.models.gpt import beam as jbeam
    from voice_tts_tpu.models.gpt import decode as jdecode
    from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
    from voice_tts_tpu.ops.fused_decode import pack_gpt as jax_pack_gpt
    from voice_tts_tpu.ops.fused_decode import pack_readout as jax_pack_readout
    from voice_tts_tpu.utils.quantize import quantize_gpt_params
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

pytest_plugins = ("port_fixtures",)

CFG = tiny_config()
SAMPLE = GenerationConfig(num_beams=3)                   # reference defaults
BEAM_GREEDY = dataclasses.replace(SAMPLE, do_sample=False)
GREEDY = dataclasses.replace(SAMPLE, do_sample=False, num_beams=1)
MAX_NEW = 24
# a stop-token bias that ends some of the greedy beam-3 searches early
STOP_BUMP = 0.85
# four requests of one text bucket (16): their text lengths
TEXT_LENS = (11, 5, 16, 8)


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def jax_gen(gen: GenerationConfig):
    return JaxGenerationConfig(**dataclasses.asdict(gen))


def _port_gpt(params):
    """The port's int8 runtime UnifiedVoice and its K1 / K3 packs from JAX
    f32 parameters."""
    master = load_family(build_models(CFG)["gpt"], convert("gpt", params))
    state = quantize_gpt_state(master.state_dict())
    prt = UnifiedVoice(CFG.gpt, int8=True)
    TTSEngine._cast_like(prt, state)
    prt.load_state_dict(state)
    return prt.eval(), pfd.pack_gpt(state, CFG.gpt.layers), pfd.pack_readout(state)


def _inputs(seed=52):
    """Conditioning, emotion vectors and texts of four requests (numpy)."""
    c = CFG.gpt
    rng = np.random.default_rng(seed)
    r = len(TEXT_LENS)
    text = np.zeros((r, 16), np.int32)
    for i, n in enumerate(TEXT_LENS):
        text[i, :n] = rng.integers(3, c.number_text_tokens, n)
    return ((rng.standard_normal((r, c.condition_num_latent, c.model_dim)) * 0.5
             ).astype(np.float32),
            (rng.standard_normal((r, c.model_dim)) * 0.5).astype(np.float32),
            text, np.asarray(TEXT_LENS, np.int32))


@pytest.fixture(scope="module")
def gpts():
    """One tiny GPT two ways: as initialised (greedy decodes run to the
    limit) and with the stop token's bias raised (some beam searches end),
    each as the JAX int8 runtime tree with its packs and the port's module
    with its packs."""
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    c = CFG.gpt
    model = JUV(JaxTTSConfig.from_dict(CFG.to_dict()).gpt)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]),
        method=JUV.init_all))(jax.random.PRNGKey(5))
    bumped = jax.tree.map(lambda x: x, params)
    head = bumped["params"]["mel_head"]
    head["bias"] = head["bias"].at[c.stop_mel_token].add(STOP_BUMP)
    out = {}
    for name, p in (("plain", params), ("stop", bumped)):
        jrt = quantize_gpt_params(p)
        out[name] = (jrt, jax_pack_gpt(jrt, c.layers), jax_pack_readout(jrt), *_port_gpt(p))
    return model, out, _inputs()


def _same(out, ref):
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.hit_limit.numpy(), np.asarray(ref.hit_limit))


def _streams(r, seed=40, device="cpu"):
    return [torch.Generator(device=device).manual_seed(seed + i) for i in range(r)]


@pytest.mark.parametrize("r", [2, 4], ids=["6_rows", "12_rows"])
def test_beam_decode_fused_batch_matches_jax(gpts, r):
    """R requests x beam-3 in one K3 step of 3R rows (greedy, int8 KV, the
    folded readout): codes, lengths and limit flags equal JAX's
    `beam_decode_fused_batch` (Pallas K3 in interpret mode); with the stop
    bias some searches end before others and before the limit."""
    model, trees, inputs = gpts
    jrt, jpack, jro, prt, ppack, pro = trees["stop"]
    cond, emo, text, tlen = (x[:r] for x in inputs)
    ref = jbeam.beam_decode_fused_batch(
        jrt, model, jax_gen(BEAM_GREEDY), jnp.asarray(cond), jnp.asarray(emo),
        jnp.asarray(text), jnp.asarray(tlen), jax.random.split(jax.random.PRNGKey(0), r),
        max_new=MAX_NEW, fused_pack=jpack, int8_kv=True, readout_pack=jro)
    out = pbeam.beam_decode_fused_batch(
        prt, BEAM_GREEDY, t(cond), t(emo), t(text).long(), t(tlen).long(), MAX_NEW,
        _streams(r), ppack, int8_kv=True, readout_pack=pro)
    _same(out, ref)
    assert out.codes.shape == (r, MAX_NEW) and out.steps >= 8
    assert not bool(out.hit_limit.all())


def test_beam_decode_batch_matches_jax(gpts):
    """The plain arm (no pack: the eager step over a reordered cache, one
    request after another) against JAX's vmapped `beam_decode_batch`,
    greedy, two requests."""
    model, trees, inputs = gpts
    jrt, _, _, prt, _, _ = trees["stop"]
    cond, emo, text, tlen = (x[:2] for x in inputs)
    ref = jbeam.beam_decode_batch(jrt, model, jax_gen(BEAM_GREEDY), jnp.asarray(cond),
                                  jnp.asarray(emo), jnp.asarray(text), jnp.asarray(tlen),
                                  jax.random.PRNGKey(0), max_new=MAX_NEW)
    out = pbeam.beam_decode_batch(prt, BEAM_GREEDY, t(cond), t(emo), t(text).long(),
                                  t(tlen).long(), MAX_NEW, _streams(2))
    _same(out, ref)


# a greedy row may leave JAX's path where its top-2 logits lie closer than
# this: the int8 KV rounds at other points in the two frameworks (XLA's and
# PyTorch's f32 sums feed round(x / scale)), and at random weights the
# logits of a step often sit 1e-3 apart
TIE_TOL = 5e-3
# teacher-forced along JAX's codes, the port's logits of every step of every
# row lie this close to JAX's (absolute, f32 logits of magnitude ~1)
LOGIT_TOL = 2e-2
JAX_DECODE_STATIC = ("model", "gen", "max_new", "int8_kv", "int4_expand",
                     "merge_stages", "fused_batch")


def _jax_decode_logits(*args, **kwargs):
    """JAX's `decode` with every sampling step's (B, V) logits recorded (a
    fresh trace of the reference with a callback beside `sample_token`)."""
    logits, sample = [], jdecode.sample_token

    def recorded(lg, presence, gen, key):
        jax.debug.callback(lambda x: logits.append(np.asarray(x)), lg, ordered=True)
        return sample(lg, presence, gen, key)
    jdecode.sample_token = recorded
    try:
        out = jax.jit(jdecode.decode.__wrapped__,
                      static_argnames=JAX_DECODE_STATIC)(*args, **kwargs)
        jax.block_until_ready(out)
    finally:
        jdecode.sample_token = sample
    return out, logits


def _port_decode_logits(forced, *args, **kwargs):
    """The port's `decode(fused_batch=True)` with each sampling step's (B, V)
    logits recorded and the K3 steps' row counts; with `forced` ((B, max_new)
    codes) every step emits those codes (teacher forcing)."""
    calls, logits = [], []
    step, sample = pdecode.fused_decode_step_batch, pdecode.sample_token

    def counted(x, *a, **kw):
        calls.append(x.shape[0])
        return step(x, *a, **kw)

    def recorded(lg, presence, gen, generator):
        logits.append(lg.float().clone())
        token = sample(lg, presence, gen, generator)
        if forced is not None:
            token = t(forced[:, min(len(logits), forced.shape[1]) - 1])
        return token.long()
    pdecode.fused_decode_step_batch, pdecode.sample_token = counted, recorded
    try:
        out = pdecode.decode(*args, **kwargs)
    finally:
        pdecode.fused_decode_step_batch, pdecode.sample_token = step, sample
    return out, logits, calls


@pytest.mark.parametrize("b,int8_kv", [(2, False), (4, True)], ids=["b2_bf16", "b4_int8"])
def test_sampling_decode_fused_batch_matches_jax(gpts, b, int8_kv):
    """`decode(fused_batch=True)`: every step one K3 over the B rows at one
    shared position with a (B, Tmax) bias (texts of other lengths in one
    bucket), a float or an int8 cache.  Each row's greedy codes equal the
    same row decoded alone through K1 bit for bit, and JAX's
    `decode(fused_batch=True)`'s, but that a row may leave JAX's path at a
    near-tie: at its first differing code JAX's token lies within TIE_TOL of
    the port's largest (penalised) logit there.  Then the port is teacher-
    forced along JAX's codes: its logits of every step of every row, to the
    row's end, lie within LOGIT_TOL of JAX's, and it ends each row where
    JAX does."""
    model, trees, inputs = gpts
    jrt, jpack, jro, prt, ppack, pro = trees["plain"]
    cond, emo, text, tlen = (x[:b] for x in inputs)
    ref, ref_logits = _jax_decode_logits(
        jrt, model, jax_gen(GREEDY), jnp.asarray(cond), jnp.asarray(emo),
        jnp.asarray(text), jnp.asarray(tlen), jax.random.PRNGKey(0), max_new=MAX_NEW,
        fused_pack=jpack, int8_kv=int8_kv, fused_batch=True, readout_pack=jro)
    args = (prt, GREEDY, t(cond), t(emo), t(text).long(), t(tlen).long(), MAX_NEW, None,
            ppack, pro)
    out, logits, calls = _port_decode_logits(None, *args, int8_kv=int8_kv,
                                             fused_batch=True)
    assert calls and set(calls) == {b}
    codes, ref_codes = out.codes.numpy(), np.asarray(ref.codes)
    ref_lengths = np.asarray(ref.lengths)
    presence = np.zeros(logits[0].shape, bool)
    presence[:, [1, CFG.gpt.start_mel_token]] = True
    for i in range(b):
        alone = pdecode.decode(prt, GREEDY, t(cond[i:i + 1]), t(emo[i:i + 1]),
                               t(text[i:i + 1]).long(), t(tlen[i:i + 1]).long(), MAX_NEW,
                               None, ppack, pro, int8_kv=int8_kv)
        assert np.array_equal(alone.codes.numpy()[0], codes[i])
        differ = np.flatnonzero(codes[i] != ref_codes[i])
        if differ.size:
            j = differ[0]
            seen = presence[i].copy()
            seen[ref_codes[i, :j]] = True
            row = pdecode.apply_repetition_penalty(logits[j][i], t(seen),
                                                   GREEDY.repetition_penalty)
            assert float(row.max() - row[int(ref_codes[i, j])]) <= TIE_TOL, (i, j)
        else:
            assert int(out.lengths[i]) == int(ref_lengths[i])
    assert int((codes == ref_codes).all(axis=1).sum()) >= b - 1

    forced, forced_logits, _ = _port_decode_logits(ref_codes, *args, int8_kv=int8_kv,
                                                   fused_batch=True)
    np.testing.assert_array_equal(forced.codes.numpy(), ref_codes)
    np.testing.assert_array_equal(forced.lengths.numpy(), ref_lengths)
    np.testing.assert_array_equal(forced.hit_limit.numpy(), np.asarray(ref.hit_limit))
    assert len(ref_logits) >= int(ref_lengths.max())
    for i in range(b):
        for j in range(int(ref_lengths[i])):
            err = float(np.abs(forced_logits[j][i].numpy() - ref_logits[j][i]).max())
            assert err <= LOGIT_TOL, (i, j, err)


@pytest.mark.parametrize("chunk", [1, 16])
def test_sampled_request_equals_alone(chunk):
    """The port alone, sampling on: each request's search in a 12-row batch
    (every chunk size of the device loop) equals the same request decoded
    by `beam_decode` on the same stream, and a padded row (a repeat of
    request 0 on a stream seeded as its own) repeats its result."""
    eng = tiny_engine()
    prt, ppack, pro = eng.gpt_rt, eng.fused_pack, eng.readout_pack
    cond, emo, text, tlen = (t(x) for x in _inputs(53))
    rows = [0, 1, 2, 0]                        # request 0 twice: a padded row
    args = (cond[rows], emo[rows], text[rows].long(), tlen[rows].long())
    gens = [torch.Generator().manual_seed(70 + r) for r in rows]
    out = pbeam.beam_decode_fused_batch(prt, SAMPLE, *args, MAX_NEW, gens, ppack,
                                        int8_kv=True, readout_pack=pro, chunk=chunk)
    for i, r in enumerate(rows):
        alone = pbeam.beam_decode(prt, SAMPLE, cond[r:r + 1], emo[r:r + 1],
                                  text[r:r + 1].long(), tlen[r:r + 1].long(), MAX_NEW,
                                  torch.Generator().manual_seed(70 + r), fused_pack=ppack,
                                  int8_kv=True, readout_pack=pro)
        assert torch.equal(out.codes[i], alone.codes[0])
        assert int(out.lengths[i]) == int(alone.lengths[0])
        assert bool(out.hit_limit[i]) == bool(alone.hit_limit[0])


@functools.lru_cache(maxsize=None)
def tiny_engine(device="cpu"):
    """The port's tiny engine with the serving decode flags (no JAX)."""
    return TTSEngine.tiny(device=device, seed=3, use_fp16=True, use_int8_decode=True,
                          use_fused_decode=True, fold_readout=True,
                          use_fused_beam_decode=True, use_int8_kv=True)


@pytest.mark.parametrize("kwargs", [
    {"fused_pack": None}, {"gen": dataclasses.replace(SAMPLE, num_beams=5)},
    {"rows": 5}, {"generators": 3}], ids=["no_pack", "five_beams", "15_rows",
                                         "short_streams"])
def test_batched_beam_refuses_what_k3_cannot_run(kwargs):
    """No quiet fallback: without a pack, with K > 4, with more than 12 rows
    or without a stream a request, `beam_decode_fused_batch` raises."""
    eng = tiny_engine()
    r = kwargs.get("rows", 2)
    cond, emo, text, tlen = (t(x) for x in _inputs(55))
    idx = [i % 4 for i in range(r)]
    with pytest.raises(ValueError):
        pbeam.beam_decode_fused_batch(
            eng.gpt_rt, kwargs.get("gen", SAMPLE), cond[idx], emo[idx], text[idx].long(),
            tlen[idx].long(), MAX_NEW, _streams(kwargs.get("generators", r)),
            kwargs.get("fused_pack", eng.fused_pack), int8_kv=True,
            readout_pack=eng.readout_pack)


# ---------------------------------------------------------------------------
# on the card: the batched keys' graphs against the same chunks op by op
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _card_decode(eng, kind: str, streams, loops, max_new=MAX_NEW):
    """One batched decode of the tiny engine's runtime GPT on the card, its
    streams seeded anew: 4 requests of beam-3 through K3 at 12 rows, or 4
    rows of sampling through K3 at one shared position."""
    dev = eng.device
    cond, emo, text, tlen = (t(x).to(dev) for x in _inputs(56))
    text, tlen = text.long(), tlen.long()
    for i, g in enumerate(streams):
        g.manual_seed(90 + i)
    if kind == "beam":
        return pbeam.beam_decode_fused_batch(
            eng.gpt_rt, SAMPLE, cond, emo, text, tlen, max_new, streams, eng.fused_pack,
            int8_kv=True, readout_pack=eng.readout_pack, loops=loops)
    return pdecode.decode(eng.gpt_rt, dataclasses.replace(SAMPLE, num_beams=1), cond, emo,
                          text, tlen, max_new, streams[0], eng.fused_pack,
                          eng.readout_pack, int8_kv=True, loops=loops, fused_batch=True)


def _bit_equal(out, ref):
    return (all(torch.equal(a, b) for a, b in zip(out[:3], ref[:3]))
            and (out.steps, out.chunks) == (ref.steps, ref.chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["beam", "sampling"], ids=["beam3_12_rows", "sampling_4_rows"])
def test_batched_replay_matches_uncaptured_on_card(cuda_device, kind):
    """A batched key's graph (a first decode that captures, then two that
    replay) against the same chunks op by op: codes, lengths, limit flags,
    steps and chunks bit-equal, one graph for the key."""
    eng = tiny_engine(str(cuda_device))
    streams = _streams(4, device=cuda_device)
    ref = _card_decode(eng, kind, streams, DeviceLoops(cuda_device, capture=False))
    loops = DeviceLoops(cuda_device)
    for _ in range(3):
        assert _bit_equal(_card_decode(eng, kind, streams, loops), ref)
    assert loops.stats["graphs"] == 1 and loops.stats["replays"] == 3 * ref.chunks - 1


@pytest.mark.cuda
def test_batched_beam_retry_reseeds_every_stream_on_card(cuda_device):
    """A decode at a reduced cap, then the same requests at the full cap
    with every request's stream reseeded (the engine's retry): the full-cap
    decode replays the same streams, bit-equal to the full-cap decode op by
    op, and a request alone on its stream equals its row."""
    eng = tiny_engine(str(cuda_device))
    streams = _streams(4, device=cuda_device)
    loops = DeviceLoops(cuda_device)
    _card_decode(eng, "beam", streams, loops, max_new=8)
    out = _card_decode(eng, "beam", streams, loops)
    ref = _card_decode(eng, "beam", streams, DeviceLoops(cuda_device, capture=False))
    assert _bit_equal(out, ref) and loops.stats["graphs"] == 2
    cond, emo, text, tlen = (t(x).to(cuda_device) for x in _inputs(56))
    alone = pbeam.beam_decode(eng.gpt_rt, SAMPLE, cond[2:3], emo[2:3], text[2:3].long(),
                              tlen[2:3].long(), MAX_NEW,
                              torch.Generator(device=cuda_device).manual_seed(92),
                              fused_pack=eng.fused_pack, int8_kv=True,
                              readout_pack=eng.readout_pack, loops=loops)
    assert torch.equal(alone.codes[0], out.codes[2])


@pytest.mark.cuda
def test_to_device_moves_a_cpu_engine_to_the_card(cuda_device):
    """`to_device` of a CPU engine to the card: every parameter and pack on
    the card, the loops the card's, and a greedy beam-3 request decodes
    through K3 there; the card engine refuses the CPU."""
    eng = TTSEngine.tiny(device="cpu", seed=3, use_fp16=True, use_int8_decode=True,
                         use_fused_decode=True, fold_readout=True,
                         use_fused_beam_decode=True, use_int8_kv=True)
    sr = 16000
    wave = 0.3 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)
    from voice_tts_tpu_torch.audio import encode_wav_int16
    prompt = encode_wav_int16((wave * 32767).astype(np.float32), sr)
    ref = eng.infer(prompt, "hello world.", do_sample=False, num_beams=3)
    eng.to_device(cuda_device)
    assert all(p.is_cuda for m in eng.models.values() for p in m.parameters())
    assert eng.fused_pack.w.is_cuda and eng.readout_pack.w.is_cuda
    assert eng.loops is not None and eng.loops.device == cuda_device
    from voice_tts_tpu_torch.ops import counters
    counters.reset()
    out = eng.infer(prompt, "hello world.", do_sample=False, num_beams=3)
    assert ref.wav.size > 0 and out.wav.size > 0 and out.metrics["decode_steps"] > 0
    assert counters.snapshot()["fused_decode_step_batch"] > 0
    with pytest.raises(ValueError):
        eng.to_device("cpu")

"""The port's continuous batching (`engine/continuous.py`) against the JAX
package's (`voice_tts_tpu/engine/continuous.py`) on one tiny GPT (the JAX
int8 runtime tree and its pack, the port's module and pack converted from
the same f32 parameters), greedy, the Pallas K3 in interpret mode: the
per-row cache writes (float and int8 with scales) and the per-row
embedding, then `admit` + `run_chunk` under staggered admission and slot
reuse after a harvest, float and int8 KV, against JAX's and against the
port's `decode()` of each request alone (the fused pack, no readout pack).
Then the `ContinuousBatcher` on a tiny engine converted from the JAX one:
staggered submissions all complete, and a greedy request's WAV matches the
JAX batcher's with the JAX engine's CFM noise handed to the port; the
refusals.  The `cuda` cases (skipped without a card) hold a replayed chunk
against the same chunk op by op and count K3 once a step."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine import continuous as pcont
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.engine.engine import TTSEngine, build_models, tiny_config
from voice_tts_tpu_torch.models.gpt import decode as pdecode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.ops import counters
from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.utils.convert import convert, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

try:
    import jax
    import jax.numpy as jnp

    from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
    from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
    from voice_tts_tpu.engine import continuous as jcont
    from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
    from voice_tts_tpu.ops import fused_decode as jfd
    from voice_tts_tpu.utils.quantize import quantize_gpt_params
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

CFG = tiny_config()
GREEDY = GenerationConfig(do_sample=False, num_beams=1, repetition_penalty=10.0)
MAX_NEW, BUCKET, CHUNK = 12, 16, 4
# three requests of one text bucket: their text lengths
TEXT_LENS = (11, 5, 16)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the tiny models' ops are too small to
    share, and the test run's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def _t_max():
    p = CFG.gpt.condition_num_latent + 2 + BUCKET + 2
    t_max = p + 1 + MAX_NEW
    return t_max + (-t_max) % pfd.BLOCK_T


@pytest.fixture(scope="module")
def gpts():
    """The JAX int8 runtime tree with its pack and the port's int8 runtime
    module with its pack, from one set of f32 parameters; and three
    requests (numpy)."""
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
    jrt = quantize_gpt_params(params)
    master = load_family(build_models(CFG)["gpt"], convert("gpt", params))
    state = quantize_gpt_state(master.state_dict())
    prt = UnifiedVoice(c, int8=True)
    TTSEngine._cast_like(prt, state)
    prt.load_state_dict(state)
    rng = np.random.default_rng(52)
    reqs = []
    for n in TEXT_LENS:
        text = np.zeros((1, BUCKET), np.int32)
        text[0, :n] = rng.integers(3, c.number_text_tokens, n)
        reqs.append(((rng.standard_normal((1, c.condition_num_latent, c.model_dim)) * 0.5
                      ).astype(np.float32),
                     (rng.standard_normal((1, c.model_dim)) * 0.5).astype(np.float32),
                     text, np.asarray([n], np.int32)))
    return (model, jrt, jfd.pack_gpt(jrt, c.layers), prt.eval().requires_grad_(False),
            pfd.pack_gpt(state, c.layers), reqs)


# ---------------------------------------------------------------------------
# the per-row pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8_kv", [False, True], ids=["float", "int8"])
def test_kv_update_rows_match_jax(int8_kv):
    """Each row written at its own position (0 and Tmax - 1 among them):
    the cache, and with int8 the scales, equal JAX's exactly (jitted, as
    its `run_chunk` runs it: XLA multiplies by 1 / 127 where the eager JAX
    divides)."""
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    rng = np.random.default_rng(3)
    l, b, t_max, d = 2, 4, 256, 32
    kv_new = rng.standard_normal((l, 2, b, d)).astype(np.float32)
    pos = np.asarray([0, 255, 17, 0], np.int32)
    if int8_kv:
        cache = rng.integers(-127, 128, (l, 2, b, t_max, d)).astype(np.int8)
        scales = rng.random((l, b, t_max, 2)).astype(np.float32)
        ref_c, ref_s = jax.jit(jfd.apply_kv_update_q_rows)(
            jnp.asarray(cache), jnp.asarray(scales), jnp.asarray(kv_new), jnp.asarray(pos))
        out_c, out_s = pfd.apply_kv_update_q_rows(t(cache), t(scales), t(kv_new),
                                                  t(pos).long())
        np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
    else:
        cache = rng.standard_normal((l, 2, b, t_max, d)).astype(np.float32)
        ref_c = jax.jit(jfd.apply_kv_update_rows)(jnp.asarray(cache), jnp.asarray(kv_new),
                                                  jnp.asarray(pos))
        out_c = pfd.apply_kv_update_rows(t(cache), t(kv_new), t(pos).long())
    np.testing.assert_array_equal(out_c.numpy(), np.asarray(ref_c))
    assert not np.array_equal(out_c.numpy(), cache)


def test_embed_decode_token_rows_matches_jax(gpts):
    """Each row at its own mel position steps + 1, within 1e-6."""
    model, jrt, _, prt, _, _ = gpts
    token = np.asarray([3, 0, 17, 40], np.int32)
    steps = np.asarray([-1, 0, 5, 11], np.int32)
    ref = model.apply(jrt, jnp.asarray(token), jnp.asarray(steps),
                      method=JUV.embed_decode_token_rows)
    out = prt.embed_decode_token_rows(t(token).long(), t(steps).long())
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=1e-6)


# ---------------------------------------------------------------------------
# admit + run_chunk
# ---------------------------------------------------------------------------

class _Pair:
    """One slot pool in each package, driven alike."""

    def __init__(self, gpts, slots: int, int8_kv: bool):
        self.model, self.jrt, self.jpack, self.prt, self.ppack, self.reqs = gpts
        self.jgen = JaxGenerationConfig(**dataclasses.asdict(GREEDY))
        self.rng = jax.random.PRNGKey(0)
        dtype = self.prt.conditioning_encoder.after_norm.bias.dtype
        self.jstate = jcont.init_state(self.model.cfg, slots, _t_max(), MAX_NEW,
                                       jnp.bfloat16, int8_kv)
        self.pstate = pcont.init_state(CFG.gpt, slots, _t_max(), MAX_NEW, dtype, int8_kv)

    def admit(self, slot: int, req: int):
        cond, emo, text, tlen = self.reqs[req]
        self.jstate = jcont.admit(self.jrt, self.model, self.jgen, self.jstate,
                                  jnp.asarray(slot), jnp.asarray(cond), jnp.asarray(emo),
                                  jnp.asarray(text), jnp.asarray(tlen), self.rng)
        pcont.admit(self.prt, GREEDY, self.pstate, slot, t(cond), t(emo), t(text).long(),
                    t(tlen).long())

    def chunk(self):
        self.jstate, jstatus = jcont.run_chunk(self.jrt, self.jpack, self.model, self.jgen,
                                               self.jstate, self.rng, CHUNK)
        _, pstatus = pcont.run_chunk(self.prt, self.ppack, GREEDY, self.pstate, None, CHUNK)
        np.testing.assert_array_equal(pstatus.numpy(), np.asarray(jstatus))
        return pstatus.numpy()

    def run_until(self, slot: int, limit: int = 8):
        for _ in range(limit):
            status = self.chunk()
            if status[1, slot]:
                return status
        raise AssertionError(f"slot {slot} did not finish")


def _alone(gpts, req: int, int8_kv: bool):
    """The port's `decode()` of one request alone: the fused pack (K1), no
    readout pack, the slot pool's Tmax."""
    _, _, _, prt, ppack, reqs = gpts
    cond, emo, text, tlen = reqs[req]
    return pdecode.decode(prt, GREEDY, t(cond), t(emo), t(text).long(), t(tlen).long(),
                          MAX_NEW, fused_pack=ppack, int8_kv=int8_kv)


def _check_slot(pair, gpts, slot, req, status, int8_kv):
    codes = pair.pstate.codes[slot].numpy()
    np.testing.assert_array_equal(codes, np.asarray(pair.jstate.codes)[slot])
    ref = _alone(gpts, req, int8_kv)
    np.testing.assert_array_equal(codes, ref.codes[0].numpy())
    assert int(status[3, slot]) == int(ref.lengths[0])
    assert bool(status[2, slot]) == bool(ref.hit_limit[0])


@pytest.mark.parametrize("int8_kv", [False, True], ids=["float", "int8"])
def test_staggered_slots_match_jax_and_decode(gpts, int8_kv):
    """Three requests admitted at different times into a pool of three
    slots (the second after one chunk of the first, the third after two):
    every chunk's status equals JAX's, and each slot's codes, steps and
    limit flag equal JAX's and the port's `decode()` of the request alone
    (mid-flight admission does not perturb running slots)."""
    pair = _Pair(gpts, 3, int8_kv)
    pair.admit(0, 0)
    pair.chunk()
    pair.admit(1, 1)
    pair.chunk()
    pair.admit(2, 2)
    status = pair.run_until(2)
    assert status[1].all()
    for slot in range(3):
        _check_slot(pair, gpts, slot, slot, status, int8_kv)


@pytest.mark.parametrize("int8_kv", [False, True], ids=["float", "int8"])
def test_slot_reuse_after_harvest(gpts, int8_kv):
    """A slot freed by a finished request is admitted again beside a running
    one and reproduces the new request's lone decode: stale cache, scales
    and presence do not leak."""
    pair = _Pair(gpts, 2, int8_kv)
    pair.admit(0, 0)
    pair.chunk()
    pair.admit(1, 1)
    status = pair.run_until(0)
    _check_slot(pair, gpts, 0, 0, status, int8_kv)
    pair.admit(0, 2)
    status = pair.run_until(0)
    _check_slot(pair, gpts, 0, 2, status, int8_kv)
    _check_slot(pair, gpts, 1, 1, pair.run_until(1), int8_kv)


def test_idle_slot_and_chunk_counts(gpts):
    """An idle slot (pos 0) beside a running one stays idle and finite; on
    the CPU the chunk runs K3's plain version, which counts no launch."""
    _, _, _, prt, ppack, reqs = gpts
    state = pcont.init_state(CFG.gpt, 2, _t_max(), MAX_NEW, torch.bfloat16, False)
    cond, emo, text, tlen = reqs[0]
    pcont.admit(prt, GREEDY, state, 1, t(cond), t(emo), t(text).long(), t(tlen).long())
    counters.reset()
    _, status = pcont.run_chunk(prt, ppack, GREEDY, state, None, CHUNK)
    assert counters.LAUNCHES["fused_decode_step_batch"] == 0
    assert status.dtype == torch.int32 and status.shape == (4, 2)
    assert status[:, 0].tolist() == [0, 0, 0, 0] and int(state.pos[0]) == 0
    assert int(status[3, 1]) == 1 + CHUNK
    assert torch.isfinite(state.cache.float()).all()


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

TINY_FLAGS = dict(use_int8_decode=True, use_fused_decode=True)


def prompt_wav(f0: float = 220.0) -> bytes:
    """1 s at 16 kHz: a tone plus white noise (as `test_torch_engine.py`)."""
    from voice_tts_tpu_torch.audio import encode_wav_int16

    sr = 16000
    tt = np.arange(sr) / sr
    noise = np.random.default_rng(int(f0)).standard_normal(sr)
    x = 0.3 * np.sin(2 * np.pi * f0 * tt) + 0.05 * noise
    return encode_wav_int16((x * 32767).astype(np.float32), sr)


@pytest.fixture(scope="module")
def engines():
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    from voice_tts_tpu.engine.engine import TTSEngine as JaxEngine

    jeng = JaxEngine.tiny(**TINY_FLAGS)
    jeng.cfg.server.max_batch_size = 2
    params = jax.tree.map(np.asarray, jeng.params)
    extras = {"w2v_mean": np.asarray(jeng.w2v_mean),
              "w2v_std": np.asarray(jeng.w2v_std),
              "emo_matrix": [np.asarray(m) for m in jeng.emo_matrix],
              "spk_matrix": [np.asarray(m) for m in jeng.spk_matrix]}
    peng = TTSEngine.from_jax_params(copy.deepcopy(jeng.cfg), params, jeng.tokenizer,
                                     extras, device="cpu")
    return jeng, peng


GEN_KW = {"do_sample": False, "num_beams": 1, "max_mel_tokens": 16}


def test_batcher_matches_jax_batcher(engines, monkeypatch):
    """Two requests through a two-slot batcher in each package, the second
    submitted while the first decodes: both complete, with the same codes a
    job, and the WAVs within 8 LSB of int16 with the JAX engine's CFM noise
    handed to the port (the f32 s2mel / vocoder and the bf16 teacher-forced
    GPT round at other points in the two frameworks)."""
    jeng, peng = engines
    keys, seen = [], {"jax": [], "port": []}
    chain = jeng._s2mel_chain

    def rec_chain(*args, **kwargs):
        keys.append(args[9])
        return chain(*args, **kwargs)
    monkeypatch.setattr(jeng, "_s2mel_chain", rec_chain)
    monkeypatch.setattr(peng, "_draw_noise", lambda shape: torch.from_numpy(
        np.array(jax.random.normal(keys.pop(0), tuple(shape)))))
    for name, eng in (("jax", jeng), ("port", peng)):
        mel_jobs = eng._mel_jobs

        def rec(jobs, cbucket, name=name, mel_jobs=mel_jobs):
            seen[name].extend(np.asarray(j["codes"])[:j["code_len"]].tolist()
                              for j in jobs)
            return mel_jobs(jobs, cbucket)
        monkeypatch.setattr(eng, "_mel_jobs", rec)

    reqs = [{"spk_audio_prompt": prompt_wav(), "text": "hello world."},
            {"spk_audio_prompt": prompt_wav(330.0), "text": "one two three."}]
    out = {}
    for name, mod, eng in (("jax", jcont, jeng), ("port", pcont, peng)):
        batcher = mod.ContinuousBatcher(eng, chunk_steps=4, generation_kwargs=GEN_KW)
        first = batcher.submit(reqs[0])
        batcher.step_once()                   # the first request decodes alone
        second = batcher.submit(reqs[1])
        batcher.run()
        out[name] = []
        for holder, ev in (first, second):
            assert ev.is_set() and not isinstance(holder[0], Exception), holder
            out[name].append(holder[0])
        if name == "port":
            batcher.stop()
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 2
    for ref, res in zip(out["jax"], out["port"]):
        assert res.wav.dtype == np.int16 and res.wav.shape == ref.wav.shape
        assert res.wav.size > 0 and res.metrics["rtf"] > 0
        diff = np.abs(res.wav.astype(np.int32) - ref.wav.astype(np.int32)).max()
        assert diff <= 8, diff


def test_batcher_staggered_submissions_complete(engines):
    """Five requests over two slots from a submitting thread while the
    scheduler runs (`start` / `stop`): all complete with audio, slots are
    reused, the callback fires once a request, and after `stop` nothing
    waits: a request submitted after it fails at once."""
    _, peng = engines
    batcher = pcont.ContinuousBatcher(peng, chunk_steps=4, generation_kwargs=GEN_KW)
    assert batcher.slots == 2
    called = []
    batcher.start()
    try:
        pairs = []
        for i, text in enumerate(("hi.", "hello world.", "one two.", "a b c d.", "bye.")):
            pairs.append(batcher.submit({"spk_audio_prompt": prompt_wav(220.0 + 10 * i),
                                         "text": text}, callback=called.append))
        for holder, ev in pairs:
            assert ev.wait(120)
            assert not isinstance(holder[0], Exception), holder
            assert holder[0].wav.size > 0 and holder[0].metrics["audio_length"] > 0
    finally:
        batcher.stop()
    assert len(called) == 5 and batcher.stats["admitted"] == 5
    assert batcher.stats["status_reads"] == batcher.stats["chunks"] > 0
    holder, ev = batcher.submit({"spk_audio_prompt": prompt_wav(), "text": "late."})
    batcher._fail_all(RuntimeError("continuous batcher stopped"))
    assert ev.is_set() and isinstance(holder[0], RuntimeError)


def test_batcher_fails_a_bad_request_alone(engines):
    """An undecodable prompt fails its own request; the other completes."""
    _, peng = engines
    batcher = pcont.ContinuousBatcher(peng, chunk_steps=4, generation_kwargs=GEN_KW)
    bad = batcher.submit({"spk_audio_prompt": b"not a wav", "text": "hi."})
    good = batcher.submit({"spk_audio_prompt": prompt_wav(), "text": "hi."})
    batcher.run()
    batcher.stop()
    assert isinstance(bad[0][0], Exception)
    assert not isinstance(good[0][0], Exception) and good[0][0].wav.size > 0


def test_batcher_refusals():
    """Beam search and an engine without the fused pack raise ValueError."""
    eng = TTSEngine.tiny(**TINY_FLAGS)
    with pytest.raises(ValueError, match="num_beams"):
        pcont.ContinuousBatcher(eng, generation_kwargs={"num_beams": 3})
    with pytest.raises(ValueError, match="megakernel"):
        pcont.ContinuousBatcher(TTSEngine.tiny())


# ---------------------------------------------------------------------------
# the capture gate
# ---------------------------------------------------------------------------

def test_capture_gate_keeps_exclusive_sections_apart():
    """Two threads that ask for `exclusive()` inside their own shared
    sections both get it in turn (no deadlock), and no shared section of a
    third thread overlaps an exclusive one; the engine lock taken before
    the gate, as the batcher takes it, does not deadlock against a thread
    that captures holding it."""
    import sys
    import threading
    import time

    from voice_tts_tpu_torch.engine.device_loop import CaptureGate

    gate, log, lock = CaptureGate(), [], threading.Lock()
    barrier = threading.Barrier(2)
    stop = threading.Event()

    def record(kind, t0, t1):
        with lock:
            log.append((kind, t0, t1))

    def upgrader():
        with gate.shared():
            barrier.wait()
            with gate.exclusive():
                t0 = time.perf_counter()
                time.sleep(0.02)
                record("exclusive", t0, time.perf_counter())

    def reader():
        while not stop.is_set():
            with gate.shared():
                t0 = time.perf_counter()
                time.sleep(0.002)
                record("shared", t0, time.perf_counter())

    engine_lock = threading.Lock()

    def synthesis():                  # the lock, then the gate, then a capture
        with engine_lock, gate.shared():
            time.sleep(0.01)
            with gate.exclusive():
                t0 = time.perf_counter()
                time.sleep(0.02)
                record("exclusive", t0, time.perf_counter())

    def scheduler():                  # the lock before the gate, as `_prep_pending`
        for _ in range(5):
            with engine_lock, gate.shared():
                time.sleep(0.001)
            with gate.shared():
                time.sleep(0.003)

    threads = [threading.Thread(target=f) for f in (upgrader, upgrader, reader,
                                                     synthesis, scheduler)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads[:2] + threads[3:]:
            th.join(10)
        stop.set()
        threads[2].join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    ex = [x for x in log if x[0] == "exclusive"]
    assert len(ex) == 3
    for _, a0, a1 in ex:
        for kind, b0, b1 in log:
            if (kind, b0, b1) != ("exclusive", a0, a1):
                assert b1 <= a0 or b0 >= a1, (kind, b0, b1, a0, a1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("int8_kv", [False, True], ids=["float", "int8"])
def test_chunk_replay_matches_op_by_op_on_card(int8_kv):
    """A tiny engine's GPT on the card: three chunks with staggered
    admissions as replays of the key's graph against the same chunks op by
    op, every state tensor bit-equal, K3 k launches a chunk."""
    dev = _card()
    eng = TTSEngine.tiny(device=dev, use_int8_decode=True, use_fused_decode=True)
    model, pack = eng.gpt_rt, eng.fused_pack
    rng = np.random.default_rng(7)
    c = eng.cfg.gpt
    dtype = model.conditioning_encoder.after_norm.bias.dtype

    def req(n):
        text = torch.zeros((1, BUCKET), dtype=torch.long)
        text[0, :n] = torch.from_numpy(rng.integers(3, c.number_text_tokens, n))
        return (torch.from_numpy(rng.standard_normal((1, c.condition_num_latent,
                                                      c.model_dim)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal((1, c.model_dim)).astype(np.float32)),
                text, torch.tensor([n]))
    reqs = [[x.to(dev) for x in req(n)] for n in TEXT_LENS]
    runs = {}
    for name in ("op_by_op", "graphs"):
        loops = DeviceLoops(dev, capture=name == "graphs")
        state = pcont.init_state(c, 3, _t_max(), MAX_NEW, dtype, int8_kv, dev)
        key = pcont.chunk_key(model, pack, GREEDY, None, state, CHUNK)
        state = pcont.bind_state(loops, key, state)
        counters.reset()
        for i in range(3):
            pcont.admit(model, GREEDY, state, i, *reqs[i])
            pcont.run_chunk(model, pack, GREEDY, state, None, CHUNK, loops)
        torch.cuda.synchronize()
        assert counters.LAUNCHES["fused_decode_step_batch"] == 3 * CHUNK
        runs[name] = [x.clone() for x in state if x is not None]
    for a, b in zip(runs["op_by_op"], runs["graphs"]):
        assert torch.equal(a, b)

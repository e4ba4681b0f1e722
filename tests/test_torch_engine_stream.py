"""The port's batched and long-form engine paths on the tiny engine, CPU
(the kernels' plain versions): `infer_batch` request-batched against one
request a decode, sampling on (each request on its own stream), the cap
retry of `_decode_jobs`, the batched speaker conditioning, the routing of a
multi-segment request (`_should_batch_segments` with the card's step
times), streaming (`infer_generator`, `infer(stream_return=True)`) and
`to_device`."""

import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

from voice_tts_tpu.engine.engine import HashTokenizer as JaxHashTokenizer
from voice_tts_tpu_torch.audio import encode_wav_int16
from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine import engine as eng_mod
from voice_tts_tpu_torch.engine.engine import DECODE_STEP_MS, TTSEngine

SERVING = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
               use_fused_batch_decode=True, use_fused_beam_decode=True, use_int8_kv=True,
               fold_readout=True, use_bf16_conditioning=True)
TEXTS = ("one two.", "three.", "five six seven.", "eight nine.")
# five sentences of 7-11 tokens: three segments at 24 tokens a segment
SEGMENT_TEXT = "hello world. how are you. fine thanks. see you soon. bye now."



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the tiny models' ops are too small to
    share, and the test run's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def tone(f0: float, seconds: float = 0.6, sr: int = 16000) -> bytes:
    t = np.arange(int(seconds * sr)) / sr
    noise = np.random.default_rng(int(f0)).standard_normal(len(t))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * noise
    return encode_wav_int16((x * 32767).astype(np.float32), sr)


def requests():
    return [{"spk_audio_prompt": tone(220.0 if i % 2 == 0 else 330.0), "text": text}
            for i, text in enumerate(TEXTS)]


@pytest.fixture(scope="module")
def serving():
    return TTSEngine.tiny(device="cpu", **SERVING)


def _batch(engine, rows: int, beams: int):
    """`infer_batch` of the four requests from one generator state and an
    empty cap memory, at `beam_batch_rows = rows`."""
    engine.cfg.engine.beam_batch_rows = rows
    engine.cfg.generation.num_beams = beams
    engine.generator.manual_seed(11)
    engine._cap_hint.clear()
    out = engine.infer_batch(requests())
    return out, dict(engine.last_metrics)


@pytest.mark.parametrize("beams,rows,runs", [(3, 12, 1), (4, 12, 2)],
                         ids=["beam3_12_rows", "beam4_clamped_to_8_rows"])
def test_infer_batch_batched_equals_sequential(serving, beams, rows, runs):
    """Beam sampling (the reference defaults): the four requests packed
    into K3 steps of up to 12 rows (beam-4: 12 // 4 = 3 requests, clamped
    to chunks of 2) give the same WAVs bit for bit as one request a decode
    (`beam_batch_rows = K`), each request on its own stream in both."""
    batched, mb = _batch(serving, rows, beams)
    seq, ms = _batch(serving, beams, beams)
    assert (mb["decode_runs"], ms["decode_runs"]) == (runs, 4)
    for a, b in zip(batched, seq):
        assert a.wav.size > 0 and np.array_equal(a.wav, b.wav)
        assert set(a.metrics) == {"inference_time", "audio_length", "rtf"}
    serving.cfg.engine.beam_batch_rows = 12
    serving.cfg.generation.num_beams = 1


@pytest.mark.parametrize("beams,sample", [(3, True), (1, False)],
                         ids=["beam3_sampled", "sampling_greedy"])
def test_decode_jobs_retry_equals_full_cap(beams, sample):
    """`_decode_jobs` at a bucket cap of 32 codes under a 48-code limit: the
    rows that hit the cap decode once more at the full cap, and give the
    codes an engine without the estimate decodes at once (sampled beams on
    each job's own stream; greedy sampling, whose one stream the retry's
    smaller batch draws from otherwise); the retry teaches the bucket's
    cap."""
    def build(auto):
        cfg = eng_mod.tiny_config(**SERVING)
        cfg.generation.max_mel_tokens = 48
        cfg.generation.num_beams, cfg.generation.do_sample = beams, sample
        cfg.engine.codes_per_text_token = 0.5
        cfg.engine.auto_code_bucket = auto
        return TTSEngine.random(cfg, device="cpu", seed=0)

    def decode(engine):
        jobs = []
        for r in requests()[:3]:
            spk, emovec, segs = engine._prepare(r["spk_audio_prompt"], None, 1.0, None,
                                                False, r["text"], 120)
            jobs.append({"tokens": segs[0], "spk": spk, "emovec": emovec,
                         "ids": engine.tokenizer.convert_tokens_to_ids(segs[0])})
        timers = engine._new_timers()
        engine._decode_jobs(jobs, 16, engine.cfg.generation, timers=timers)
        return [j["codes"][:j["code_len"]].tolist() for j in jobs], timers

    e_auto, e_full = build(True), build(False)
    assert e_auto._decode_cap(16, e_auto.cfg.generation) == 32
    (auto, t_auto), (full, t_full) = decode(e_auto), decode(e_full)
    assert auto == full
    assert (t_auto["decode_runs"], t_full["decode_runs"]) == (2, 1)
    assert e_auto._decode_cap(16, e_auto.cfg.generation) == 48


def test_speaker_conditioning_batch_matches_single():
    """Three new speakers conditioned in one forward (padded to 4 rows by
    repeating the first) against each conditioned alone: every cached
    tensor within 2e-4 of max(1, max|ref|), the same mel frames; a second
    call finds them all cached."""
    prompts = [tone(220.0, 0.6), tone(330.0, 0.4), tone(440.0, 0.8)]
    batched = TTSEngine.tiny(device="cpu")
    single = TTSEngine.tiny(device="cpu")
    calls = []
    forward = batched._conditioning_forward

    def counted(rows):
        calls.append(len(rows))
        return forward(rows)
    batched._conditioning_forward = counted
    batched._speaker_conditioning_batch(prompts + prompts[:1])
    batched._speaker_conditioning_batch(prompts)
    assert calls == [4]
    for p in prompts:
        key = batched._content_key(p)
        got, ref = batched._spk_cache[key], single._speaker_conditioning(p)
        assert got["mel_frames"] == ref["mel_frames"]
        for name, r in ref.items():
            if name == "mel_frames":
                continue
            g = got[name]
            assert g.shape == r.shape and g.dtype == r.dtype, name
            err = float((g.float() - r.float()).abs().max())
            assert err <= 2e-4 * max(1.0, float(r.float().abs().max())), (name, err)


def _router(pack: bool, fused_batch: bool, batch_segments: bool = True):
    """What `_should_batch_segments` reads of an engine."""
    e = types.SimpleNamespace(batch_segments=batch_segments,
                              use_fused_batch_decode=fused_batch)
    return types.SimpleNamespace(cfg=types.SimpleNamespace(engine=e),
                                 fused_pack=object() if pack else None)


def _segments(*lens):
    return [["x"] * n for n in lens]


@pytest.mark.parametrize("router,lens,beams,expect", [
    (dict(pack=True, fused_batch=True, batch_segments=False), (20, 20), 1, False),
    (dict(pack=True, fused_batch=True), (20,), 1, False),
    (dict(pack=True, fused_batch=False), (20, 20), 3, True),
    (dict(pack=False, fused_batch=False), (20, 1), 1, True),
    (dict(pack=True, fused_batch=True), (20, 20), 1, True),
    (dict(pack=True, fused_batch=True), (100, 10), 1, False),
    (dict(pack=True, fused_batch=False), (20, 20, 20), 1, False),
    (dict(pack=True, fused_batch=False), (20,) * 40, 1, True),
], ids=["flag_off", "one_segment", "beams_batch", "eager_either_way",
        "k3_beats_k1_on_equal_segments", "k1_beats_k3_on_a_long_one",
        "eager_batch_loses_to_k1", "eager_batch_wins_at_40_segments"])
def test_should_batch_segments(router, lens, beams, expect):
    """The routing of a multi-segment request, the JAX rule with the card's
    step times: beams always batch; otherwise the batched decode's step
    time on the longest segment against the sequential one's on the sum
    (the eager step, 4.8x K1's, loses on 3 equal segments and wins on 40)."""
    gen = GenerationConfig(num_beams=beams)
    assert TTSEngine._should_batch_segments(_router(**router), _segments(*lens), gen) is expect


def test_step_times_are_the_cards():
    """The three step times are positive and ordered as measured: K1 under
    K3 at 4 rows under the eager step."""
    assert 0 < DECODE_STEP_MS["k1"] < DECODE_STEP_MS["k3_batch"] < DECODE_STEP_MS["eager"]


@pytest.fixture(scope="module")
def greedy():
    eng = TTSEngine.tiny(device="cpu", **SERVING)
    eng.cfg.generation = dataclasses.replace(eng.cfg.generation, do_sample=False)
    return eng


@pytest.mark.parametrize("quick", [0, 30])
def test_infer_generator_streams_infer_segments(greedy, quick):
    """`infer(stream_return=True)` returns a generator of each segment's
    int16 waveform followed by the silence gap (none after the last); the
    segments are the JAX segmenter's for `quick_streaming_tokens` (the
    `more_segment_before` of `infer`), and the chunks joined equal `infer`'s
    WAV (segments one after another) from the same generator state."""
    eng, prompt = greedy, tone(220.0)
    eng.cfg.engine.batch_segments = False
    state, hint = eng.generator.get_state(), dict(eng._cap_hint)
    whole = eng.infer(prompt, SEGMENT_TEXT, max_text_tokens_per_segment=24,
                      more_segment_before=quick)
    eng.generator.set_state(state)
    eng._cap_hint = hint
    stream = eng.infer(prompt, SEGMENT_TEXT, max_text_tokens_per_segment=24,
                       more_segment_before=quick, stream_return=True)
    assert inspect.isgenerator(stream)
    chunks = list(stream)
    eng.cfg.engine.batch_segments = True
    tok = JaxHashTokenizer(eng.cfg.gpt.number_text_tokens)
    segs = tok.split_segments(tok.tokenize(SEGMENT_TEXT), 24, quick)
    assert len(chunks) == 2 * len(segs) - 1 and len(segs) > 1
    gap = int(eng.cfg.engine.sample_rate * 200 / 1000)
    for i, c in enumerate(chunks):
        assert c.dtype == np.int16
        assert (len(c) == gap and not c.any()) if i % 2 else c.size > 0
    assert np.array_equal(np.concatenate(chunks), whole.wav)


def test_infer_generator_checks_keywords(greedy):
    """The generator's keywords are checked when it is made:
    `use_emo_text` with no Qwen emotion model (JAX's RuntimeError) and
    unknown keywords raise before any work."""
    assert greedy.qwen_emo is None
    with pytest.raises(RuntimeError, match="Qwen emotion model"):
        greedy.infer_generator(tone(220.0), "hi.", use_emo_text=True)
    with pytest.raises(TypeError):
        greedy.infer(tone(220.0), "hi.", stream_return=True, top_q=0.5)


def test_text_emotion_on_infer_stream_and_batch(greedy):
    """With a Qwen emotion model set, `infer`, `infer_generator` and
    `infer_batch` take `use_emo_text`: each gives the WAV of the same call
    with `emo_vector` = the model's scores for `emo_text` (the text when
    none), from the same generator state and cap memory."""
    from test_torch_qwen import port_emotion

    eng, prompt = greedy, tone(220.0)
    eng.qwen_emo = port_emotion()
    try:
        vec = list(eng.qwen_emo.inference("so happy").values())
        own = list(eng.qwen_emo.inference("hi.").values())

        def same(call, kw_text, kw_vec):
            state, hint = eng.generator.get_state(), dict(eng._cap_hint)
            a = call(**kw_text)
            eng.generator.set_state(state)
            eng._cap_hint = hint
            b = call(**kw_vec)
            return a, b

        a, b = same(lambda **kw: eng.infer(prompt, "hi.", **kw).wav,
                    {"use_emo_text": True, "emo_text": "so happy"}, {"emo_vector": vec})
        assert a.size > 0 and np.array_equal(a, b)
        a, b = same(lambda **kw: np.concatenate(list(eng.infer_generator(prompt, "hi.", **kw))),
                    {"use_emo_text": True}, {"emo_vector": own})
        assert np.array_equal(a, b)
        a, b = same(lambda **kw: eng.infer_batch([{"spk_audio_prompt": prompt,
                                                   "text": "hi.", **kw}])[0].wav,
                    {"use_emo_text": True, "emo_text": "so happy", "emo_alpha": 0.5},
                    {"emo_vector": vec, "emo_alpha": 0.5})
        assert np.array_equal(a, b)
    finally:
        eng.qwen_emo = None


@pytest.mark.parametrize("key", ["do_sample", "num_beams", "spk_audio", "stream_return"])
def test_infer_batch_refuses_unknown_keys(greedy, key):
    """A request key that `infer_batch` does not read (a per-request
    generation field, a misspelt keyword, an `infer`-only option) raises
    TypeError before any work, as `infer` does for an unknown keyword."""
    reqs = requests()[:2]
    reqs[1][key] = 1
    before = len(greedy._spk_cache)
    with pytest.raises(TypeError, match=key):
        greedy.infer_batch(reqs)
    assert len(greedy._spk_cache) == before


def test_to_device_moves_and_clears():
    """`to_device` moves every module and pack (here to the CPU it is on),
    keeps a greedy request's codes, clears the speaker and emotion caches
    and makes the generator anew; a CUDA engine refuses the CPU."""
    eng = TTSEngine.tiny(device="cpu", **SERVING)
    gen = dict(do_sample=False, num_beams=3)
    before = eng.infer(tone(220.0), "hello world.", **gen)
    old_gen = eng.generator
    assert eng._spk_cache and eng._emo_cache
    assert eng.to_device("cpu") is eng
    assert not eng._spk_cache and not eng._emo_cache and eng.loops is None
    assert eng.generator is not old_gen and eng.device == torch.device("cpu")
    after = eng.infer(tone(220.0), "hello world.", **gen)
    assert after.metrics["decode_steps"] == before.metrics["decode_steps"]
    assert after.wav.shape == before.wav.shape
    eng.device = torch.device("cuda")
    with pytest.raises(ValueError):
        eng.to_device("cpu")

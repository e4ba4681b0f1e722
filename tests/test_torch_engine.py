"""The port's single-request slice against the JAX engine: one tiny
engine with the int8 fused decode step, folded readout, fused pipeline and
bf16 GPT, greedy decoding; the port's engine holds the same weights
(converted) and runs on the CPU (the kernels' plain versions)."""

import asyncio
import inspect
import json

import jax
import numpy as np
import pytest
import torch

from voice_tts_tpu.engine.engine import TTSEngine as JaxEngine
from voice_tts_tpu.engine import post as jax_post
from voice_tts_tpu.models.gpt.decode import decode as jax_decode
from voice_tts_tpu_torch.audio import encode_wav_int16
from voice_tts_tpu_torch.engine.engine import TTSEngine
from voice_tts_tpu_torch.engine.qwen_emotion import parse_emotion_response
from voice_tts_tpu_torch.models.gpt.decode import decode as port_decode
from voice_tts_tpu_torch.serving.http import Request

FLAGS = dict(use_int8_decode=True, use_fused_decode=True, fold_readout=True,
             fuse_pipeline=True, use_fp16=True)
TEXT = "hello world."


def prompt_wav() -> bytes:
    """1 s at 16 kHz: a tone plus white noise.  The noise keeps every mel
    band well above the f32 rounding floor of the DFT sums; with a pure
    tone the far bands are cancellation residue, which the two frameworks'
    summation orders leave at different values."""
    sr = 16000
    t = np.arange(sr) / sr
    noise = np.random.default_rng(0).standard_normal(sr)
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * noise
    return encode_wav_int16((x * 32767).astype(np.float32), sr)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine.tiny(**FLAGS)
    params = jax.tree.map(np.asarray, jeng.params)
    extras = {"w2v_mean": np.asarray(jeng.w2v_mean),
              "w2v_std": np.asarray(jeng.w2v_std),
              "emo_matrix": [np.asarray(m) for m in jeng.emo_matrix],
              "spk_matrix": [np.asarray(m) for m in jeng.spk_matrix]}
    peng = TTSEngine.from_jax_params(jeng.cfg, params, jeng.tokenizer, extras,
                                     device="cpu")
    return jeng, peng


def _segment_inputs(eng, spk, emovec, segments):
    ids = eng.tokenizer.convert_tokens_to_ids(segments[0])
    bucket = jax_post.pick_bucket(len(ids), eng.cfg.engine.text_buckets)
    text = np.zeros((1, bucket), np.int32)
    text[0, :len(ids)] = ids
    return text, np.asarray([len(ids)], np.int32)


def test_conditioning_and_greedy_codes_match(engines):
    """Each engine conditions on the prompt itself; the greedy codes are
    identical (int8 trunk, bf16 cache, fused step + folded readout on both
    sides), and the decode runs several fused steps before the stop."""
    jeng, peng = engines
    wav = prompt_wav()
    jspk, jemo, jseg = jeng._prepare(wav, None, 1.0, None, False, None, False,
                                     TEXT, 120)
    pspk, pemo, pseg = peng._prepare(wav, None, 1.0, None, False, TEXT, 120)
    assert jseg == pseg
    for key, tol in (("cond_latents", 2e-4), ("spk_emovec", 2e-4),
                     ("style", 2e-4), ("prompt_condition", 2e-4),
                     ("ref_mel", 2e-4)):
        ref = np.asarray(jspk[key])
        err = np.abs(pspk[key].numpy() - ref).max()
        assert err <= tol * max(1.0, np.abs(ref).max()), (key, err)
    assert pspk["mel_frames"] == jspk["mel_frames"]

    gen = jeng._generation_config({"do_sample": False})
    text, tlen = _segment_inputs(jeng, jspk, jemo, jseg)
    max_new = jeng.cfg.generation.max_mel_tokens
    jres = jax_decode(jeng.params_gpt_rt, jeng.gpt, gen, jspk["cond_latents"],
                      jemo, jax.numpy.asarray(text), jax.numpy.asarray(tlen),
                      jax.random.PRNGKey(0), max_new=max_new,
                      fused_pack=jeng.fused_pack,
                      merge_stages=jeng.cfg.engine.merge_decode_stages,
                      readout_pack=jeng.readout_pack)
    pres = port_decode(peng.gpt_rt, peng._generation_config({"do_sample": False}),
                       pspk["cond_latents"], pemo, torch.from_numpy(text).long(),
                       torch.from_numpy(tlen).long(), max_new,
                       fused_pack=peng.fused_pack, readout_pack=peng.readout_pack)
    jcodes = np.asarray(jres.codes)
    n = int(np.asarray(jres.lengths)[0])
    stop = jeng.cfg.gpt.stop_mel_token
    emitted = n - (0 if bool(np.asarray(jres.hit_limit)[0]) else 1)
    assert emitted >= 8 and stop not in jcodes[0, :emitted].tolist()
    np.testing.assert_array_equal(pres.codes.numpy(), jcodes)
    assert int(pres.lengths[0]) == n


def test_infer_wav_matches_with_shared_noise(engines):
    """The whole segment (decode -> trim -> latent -> s2mel -> vocoder) with
    the JAX engine's CFM noise handed to the port.  Bound: 8 LSB of int16
    (the f32 s2mel / vocoder and the bf16 teacher-forced GPT round at other
    points in the two frameworks; the codes are identical)."""
    jeng, peng = engines
    wav = prompt_wav()
    rng0 = jeng._rng
    ref = jeng.infer(wav, TEXT, do_sample=False)
    r1, _ = jax.random.split(rng0)
    _, sub_s = jax.random.split(r1)
    peng._draw_noise = lambda shape: torch.from_numpy(
        np.asarray(jax.random.normal(sub_s, tuple(shape))))
    out = peng.infer(wav, TEXT, do_sample=False)
    assert out.sample_rate == ref.sample_rate
    assert out.wav.shape == ref.wav.shape and out.wav.size > 0
    diff = np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max()
    assert diff <= 8, diff
    for key in ("gpt_gen_time", "gpt_forward_time", "s2mel_time",
                "bigvgan_time", "rtf"):
        assert key in out.metrics


# five sentences of 7-11 tokens (the hash tokenizer takes each non-space
# character): at 24 tokens a segment they merge differently with and
# without `more_segment_before`
SEGMENT_TEXT = "hello world. how are you. fine thanks. see you soon. bye now."


@pytest.mark.parametrize("more", [0, 30])
def test_more_segment_before_matches_jax(engines, more):
    """The segments of `_prepare` with `more_segment_before = more` (the
    JAX `_prepare`'s `quick_streaming_tokens`) equal the JAX engine's on
    the same tokenizer; 30 splits the first tokens finer than 0."""
    jeng, peng = engines
    wav = prompt_wav()
    segs = {}
    for n in (0, more):
        _, _, jseg = jeng._prepare(wav, None, 1.0, None, False, None, False,
                                   SEGMENT_TEXT, 24, n)
        _, _, pseg = peng._prepare(wav, None, 1.0, None, False, SEGMENT_TEXT,
                                   24, n)
        assert pseg == jseg and len(jseg) > 1
        segs[n] = pseg
    assert (segs[more] != segs[0]) == (more > 0)


def test_infer_passes_more_segment_before(engines, monkeypatch):
    """`infer` hands `more_segment_before` to the segmenter: the segments it
    synthesizes are the JAX `_prepare`'s for the same N (each segment's
    synthesis is stubbed out).  `verbose` and an `emo_text` without
    `use_emo_text` are accepted and change nothing, as in JAX."""
    jeng, peng = engines
    wav = prompt_wav()
    seen = []

    def synth(seg, *_):
        seen.append(seg)
        return np.zeros(100, np.float32)
    monkeypatch.setattr(peng, "_synthesize_segment", synth)
    peng.infer(wav, SEGMENT_TEXT, max_text_tokens_per_segment=24,
               more_segment_before=30, verbose=True, emo_text="calm")
    _, _, jseg = jeng._prepare(wav, None, 1.0, None, False, None, False,
                               SEGMENT_TEXT, 24, 30)
    assert seen == jseg


def test_stream_return_returns_the_generator(engines, monkeypatch):
    """`stream_return=True` returns `infer_generator`'s generator (JAX
    `infer`'s contract): the segments' waveforms as they are made, here
    with each segment's synthesis stubbed out, and the silence between."""
    jeng, peng = engines
    wav = prompt_wav()
    monkeypatch.setattr(peng, "_synthesize_segment",
                        lambda seg, *_: np.ones(len(seg), np.int16))
    out = peng.infer(wav, SEGMENT_TEXT, max_text_tokens_per_segment=24,
                     stream_return=True)
    assert inspect.isgenerator(out)
    _, _, jseg = jeng._prepare(wav, None, 1.0, None, False, None, False,
                               SEGMENT_TEXT, 24, 0)
    chunks = list(out)
    assert [len(c) for c in chunks[::2]] == [len(s) for s in jseg]
    assert len(chunks) == 2 * len(jseg) - 1 and not any(c.any() for c in chunks[1::2])


@pytest.mark.parametrize("kwargs,error", [
    ({"use_emo_text": True}, RuntimeError),
    ({"use_emo_text": True, "emo_text": "happy"}, RuntimeError),
    ({"no_such_keyword": 1}, TypeError),
    ({"do_sample": False, "top_q": 0.5}, TypeError),
])
def test_infer_keyword_raises(engines, kwargs, error):
    """`use_emo_text` with no Qwen emotion model set raises JAX's
    RuntimeError, and any keyword that is not a GenerationConfig field
    raises TypeError, before any work, instead of being dropped."""
    jeng, peng = engines
    assert jeng.qwen_emo is None and peng.qwen_emo is None
    with pytest.raises(error):
        peng.infer(prompt_wav(), TEXT, **kwargs)
    if error is RuntimeError:
        with pytest.raises(RuntimeError, match="Qwen emotion model"):
            jeng.infer(prompt_wav(), TEXT, **kwargs)


def test_infer_with_text_emotion_matches_jax(engines):
    """`infer(use_emo_text=True)` with one tiny Qwen3 `QwenEmotion` set on
    each engine (the same weights and stub tokenizer): the emotion comes
    from `emo_text` (the emotion audio dropped, `emo_alpha` scaling the
    scores), the same emotion dict, and the WAV within 8 LSB of the JAX
    engine's with its CFM noise shared (the bound of
    `test_infer_wav_matches_with_shared_noise`)."""
    from test_torch_qwen import emotion_pair, tiny_models

    jeng, peng = engines
    jq, pq = emotion_pair(tiny_models("qwen3"))
    wav = prompt_wav()
    kw = dict(emo_audio_prompt=wav, emo_alpha=0.8, use_emo_text=True,
              emo_text="今天真开心", do_sample=False)
    jeng.qwen_emo, peng.qwen_emo = jq, pq
    noise = peng.__dict__.get("_draw_noise")
    try:
        rng0 = jeng._rng
        ref = jeng.infer(wav, TEXT, **kw)
        r1, _ = jax.random.split(rng0)
        _, sub_s = jax.random.split(r1)
        peng._draw_noise = lambda shape: torch.from_numpy(
            np.asarray(jax.random.normal(sub_s, tuple(shape))))
        out = peng.infer(wav, TEXT, **kw)
    finally:
        jeng.qwen_emo = peng.qwen_emo = None
        if noise is None:
            del peng._draw_noise
        else:
            peng._draw_noise = noise
    emo = pq.inference(kw["emo_text"])
    assert emo == jq.inference(kw["emo_text"])
    assert emo != parse_emotion_response("{}", "")          # not the calm fallback
    assert out.wav.shape == ref.wav.shape and out.wav.size > 0
    diff = np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max()
    assert diff <= 8, diff


@pytest.mark.parametrize("body", [
    {"text": "a", "spk_audio": "b"},
    {"text": "a", "spk_audio": "b", "emo_alpha": "0.5"},
    {"text": "a", "spk_audio": "b", "emo_alpha": True},
    {"text": "a", "spk_audio": "b", "emo_alpha": None},
    {"text": "a", "spk_audio": "b", "emo_alpha": "nan"},
    {"text": "a", "spk_audio": "b", "emotion": {"happy": "0.5"}},
    {"text": "a", "spk_audio": "b", "emotion": {"happy": 2}},
    {"text": "a", "spk_audio": "b", "emotion": 5},
    {"text": 1, "spk_audio": "b"},
    {"text": "a", "spk_audio": "b", "emo_audio": 3},
])
def test_request_schema_matches_pydantic(body):
    """The stdlib request schema accepts and refuses what the JAX server's
    pydantic model does, and reads the same values."""
    from voice_tts_tpu.serving.schemas import TTSRequest as JaxRequest
    from voice_tts_tpu_torch.serving.schemas import TTSRequest, ValidationError
    import pydantic

    try:
        ref = JaxRequest(**body)
    except pydantic.ValidationError:
        ref = None
    try:
        out = TTSRequest.from_json(body)
    except ValidationError:
        out = None
    assert (out is None) == (ref is None)
    if ref is not None:
        assert (out.emo_alpha, out.emotion) == (ref.emo_alpha, ref.emotion)


class _NoEngine:
    """Stands in for an engine: the error paths never reach inference."""

    class cfg:  # noqa: N801
        class server:  # noqa: N801
            request_timeout_s = 5.0


def _status(service, body: bytes) -> int:
    handler = service.server.routes[("POST", "/tts")]
    resp = asyncio.run(handler(Request("POST", "/tts", {}, body)))
    return resp.status


@pytest.mark.parametrize("body", [
    b"",
    json.dumps({"text": "hi", "spk_audio": "zz" * 80}).encode(),
    json.dumps({"text": "hi", "spk_audio": "ab" * 80, "emo_alpha": 1.5}).encode(),
    json.dumps({"spk_audio": "ab" * 80}).encode(),
], ids=["empty_body", "bad_hex", "emo_alpha_out_of_range", "missing_text"])
def test_tts_error_statuses_match_jax(body):
    from voice_tts_tpu.serving.app import TTSService as JaxService
    from voice_tts_tpu_torch.serving.app import TTSService

    jsvc = JaxService()
    jsvc.engines = [_NoEngine()]
    psvc = TTSService(_NoEngine())
    try:
        assert _status(psvc, body) == _status(jsvc, body)
    finally:
        psvc.close()

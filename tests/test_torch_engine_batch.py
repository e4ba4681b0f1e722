"""The port's batched engine paths against the JAX engine's: one tiny engine
with the serving flags (int8 trunk through K1 / K3, int8 KV, folded readout,
`use_fused_batch_decode`, bf16 GPT and conditioning), the port's converted
from the JAX one and run on the CPU (the kernels' plain versions), greedy:
`infer_batch` of three requests over two speakers (the batched sampling
decode through K3 at one shared position, and beam-3 packed into one
12-row K3 decode), and a multi-segment `infer` with `batch_segments` (its
segments decoded together), with the JAX engine's CFM noise handed to the
port."""

import copy

import jax
import numpy as np
import pytest
import torch

from voice_tts_tpu.engine.engine import TTSEngine as JaxEngine
from voice_tts_tpu_torch.audio import encode_wav_int16
from voice_tts_tpu_torch.engine.engine import TTSEngine

SERVING = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
               merge_decode_stages=3, use_fused_batch_decode=True,
               use_fused_beam_decode=True, use_int8_kv=True, fuse_pipeline=True,
               fold_readout=True, use_bf16_conditioning=True)
# five sentences of 7-11 tokens: three segments at 24 tokens a segment
SEGMENT_TEXT = "hello world. how are you. fine thanks. see you soon. bye now."
TEXTS = ("hello world.", "one two.", "a longer text, six.")



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the tiny models' ops are too small to
    share, and the test run's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def prompt_wav(f0: float = 220.0) -> bytes:
    """1 s at 16 kHz: a tone plus white noise (as `test_torch_engine.py`)."""
    sr = 16000
    t = np.arange(sr) / sr
    noise = np.random.default_rng(int(f0)).standard_normal(sr)
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * noise
    return encode_wav_int16((x * 32767).astype(np.float32), sr)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine.tiny(**SERVING)
    params = jax.tree.map(np.asarray, jeng.params)
    extras = {"w2v_mean": np.asarray(jeng.w2v_mean),
              "w2v_std": np.asarray(jeng.w2v_std),
              "emo_matrix": [np.asarray(m) for m in jeng.emo_matrix],
              "spk_matrix": [np.asarray(m) for m in jeng.spk_matrix]}
    cfg = copy.deepcopy(jeng.cfg)
    cfg.engine.release_master_trees = True
    peng = TTSEngine.from_jax_params(cfg, params, jeng.tokenizer, extras, device="cpu")
    return jeng, peng


def _greedy(engine, beams: int):
    g = engine.cfg.generation
    g.do_sample, g.num_beams = False, beams


def _record_jobs(engine, monkeypatch):
    """Each synthesized job's codes, in the order `_mel_jobs` sees them."""
    seen = []
    mel_jobs = engine._mel_jobs

    def rec(jobs, cbucket):
        seen.extend(np.asarray(j["codes"])[:j["code_len"]].tolist() for j in jobs)
        return mel_jobs(jobs, cbucket)
    monkeypatch.setattr(engine, "_mel_jobs", rec)
    return seen


def _share_jax_noise(jeng, peng, monkeypatch):
    """The port's CFM noise: JAX's normal draws from the keys the JAX
    engine's s2mel chain receives, in order."""
    keys = []
    chain = jeng._s2mel_chain

    def rec(*args, **kwargs):
        keys.append(args[9])
        return chain(*args, **kwargs)
    monkeypatch.setattr(jeng, "_s2mel_chain", rec)
    monkeypatch.setattr(peng, "_draw_noise", lambda shape: torch.from_numpy(
        np.array(jax.random.normal(keys.pop(0), tuple(shape)))))


@pytest.mark.parametrize("beams", [1, 3], ids=["k3_shared_position", "beam3_12_rows"])
def test_infer_batch_matches_jax(engines, beams, monkeypatch):
    """Three requests over two speakers: the same codes a request as the
    JAX engine's `infer_batch`, and WAVs of the same lengths, in request
    order; each group's decode is one K3 run (the batched sampling decode,
    or the three requests' beams in one 12-row step) with the serving
    flags."""
    jeng, peng = engines
    _greedy(jeng, beams)
    _greedy(peng, beams)
    reqs = [{"spk_audio_prompt": prompt_wav(220.0 if i != 1 else 330.0), "text": text}
            for i, text in enumerate(TEXTS)]
    jseen, pseen = _record_jobs(jeng, monkeypatch), _record_jobs(peng, monkeypatch)
    ref = jeng.infer_batch(reqs)
    out = peng.infer_batch(reqs)
    assert pseen == jseen and len(pseen) == 3
    assert [len(r.wav) for r in out] == [len(r.wav) for r in ref]
    assert all(len(r.wav) > 0 for r in out)
    assert peng.last_metrics["decode_runs"] == 1
    assert peng.last_metrics["decode_steps"] >= 8


def test_multisegment_infer_matches_jax(engines, monkeypatch):
    """A three-segment greedy beam-3 `infer` with `batch_segments` on both
    engines (the segments decoded together by text bucket: the two of
    bucket 32 in one 6-row K3 run, the one of bucket 16 alone), the JAX
    engine's CFM noise handed to the port: the same codes a segment, and
    an int16 WAV within 8 LSB (f32 s2mel / vocoder and the bf16
    teacher-forced GPT round at other points in the two frameworks)."""
    jeng, peng = engines
    _greedy(jeng, 3)
    _greedy(peng, 3)
    wav = prompt_wav()
    jseen, pseen = _record_jobs(jeng, monkeypatch), _record_jobs(peng, monkeypatch)
    _share_jax_noise(jeng, peng, monkeypatch)
    assert jeng.cfg.engine.batch_segments and peng.cfg.engine.batch_segments
    ref = jeng.infer(wav, SEGMENT_TEXT, max_text_tokens_per_segment=24)
    out = peng.infer(wav, SEGMENT_TEXT, max_text_tokens_per_segment=24)
    assert pseen == jseen and len(pseen) == 3
    assert out.metrics["decode_runs"] == 2 and "synthesis_time" in out.metrics
    assert out.wav.shape == ref.wav.shape and out.wav.size > 0
    diff = np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max()
    assert diff <= 8, diff

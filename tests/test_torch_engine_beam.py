"""The production profile on the port's engine against the JAX engine: one
tiny engine with the serving flags (beam search through the K3 step with
the ancestor table, int8 KV, folded readout, bf16 GPT and bf16
conditioning), the port's converted from the JAX one and run on the CPU
(the kernels' plain versions), greedy beam-3.  And the server's default
profile."""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

import voice_tts_tpu.engine.engine as jax_engine_mod
import voice_tts_tpu_torch.engine.engine as port_engine_mod
from voice_tts_tpu_torch.audio import encode_wav_int16
from voice_tts_tpu_torch.engine.engine import TTSEngine
from voice_tts_tpu_torch.serving import app
from voice_tts_tpu_torch.serving.http import Request

pytest_plugins = ("port_fixtures",)

# `TTSConfig.apply_serving_profile` on the tiny config
SERVING = dict(use_fp16=True, use_int8_decode=True, use_fused_decode=True,
               merge_decode_stages=3, use_fused_batch_decode=True,
               use_fused_beam_decode=True, use_int8_kv=True, fuse_pipeline=True,
               fold_readout=True, use_bf16_conditioning=True)
TEXT = "hello world."
# bf16 conditioning: the two frameworks round the bf16 activations of
# w2v-bert, RepCodec, CAMPPlus and the conformer-perceiver at other points;
# one bf16 ulp is 2^-8 of a value, and a few layers compound it
BF16_TOL = 3e-2


def prompt_wav() -> bytes:
    """1 s at 16 kHz: a tone plus white noise (as `test_torch_engine.py`)."""
    sr = 16000
    t = np.arange(sr) / sr
    noise = np.random.default_rng(0).standard_normal(sr)
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * noise
    return encode_wav_int16((x * 32767).astype(np.float32), sr)


@pytest.fixture(scope="module")
def engines(jax_tiny, jax_port):
    """The JAX engine keeps its f32 masters, from which the port's engine is
    built; the port's releases them (`release_master_trees`, as in the
    serving profile)."""
    jeng = jax_tiny(**SERVING)
    return jeng, jax_port(jeng, release_master_trees=True)


def test_serving_flags_build_bf16_runtime_copies(engines):
    _, peng = engines
    assert peng.gpt is peng.gpt_rt and peng.models["gpt"] is peng.gpt_rt
    assert peng.w2v is peng.w2v_rt and peng.cond_gpt is peng.gpt_rt
    for m in (peng.w2v_rt, peng.repcodec_rt, peng.campplus_rt):
        assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    # the s2mel codebook lookup keeps RepCodec's f32 master
    assert peng.repcodec.quantizer.codebook.dtype == torch.float32
    assert peng._beam_fused_pack() is peng.fused_pack is not None


def test_bf16_conditioning_matches_jax(engines):
    """Each engine conditions on the prompt with its bf16 copies; outputs
    within BF16_TOL * max(1, max|ref|), in the same dtypes."""
    jeng, peng = engines
    wav = prompt_wav()
    jspk, _, jseg = jeng._prepare(wav, None, 1.0, None, False, None, False, TEXT, 120)
    pspk, _, pseg = peng._prepare(wav, None, 1.0, None, False, TEXT, 120)
    assert jseg == pseg
    for key in ("emb", "cond_latents", "spk_emovec", "style", "prompt_condition",
                "ref_mel"):
        ref = np.asarray(jspk[key], np.float32)
        out = pspk[key]
        assert str(out.dtype).split(".")[-1] == str(jspk[key].dtype), key
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= BF16_TOL * max(1.0, np.abs(ref).max()), (key, err)
    assert pspk["mel_frames"] == jspk["mel_frames"]


def _recorder(module, monkeypatch):
    calls = []
    orig = module.beam_decode

    def rec(*args, **kwargs):
        res = orig(*args, **kwargs)
        calls.append(res)
        return res
    monkeypatch.setattr(module, "beam_decode", rec)
    return calls


def test_beam3_infer_matches_jax(engines, monkeypatch):
    """Greedy beam-3 `infer` on both engines, JAX's beam through the Pallas
    K3 in interpret mode with int8 KV: the same codes from the same number
    of decode steps, and an int16 WAV within 8 LSB with the JAX engine's CFM
    noise handed to the port (f32 s2mel / vocoder and the bf16 teacher-forced
    GPT round at other points in the two frameworks)."""
    jeng, peng = engines
    wav = prompt_wav()
    jcalls = _recorder(jax_engine_mod, monkeypatch)
    pcalls = _recorder(port_engine_mod, monkeypatch)
    rng0 = jeng._rng
    ref = jeng.infer(wav, TEXT, do_sample=False, num_beams=3)
    r1, _ = jax.random.split(rng0)
    _, sub_s = jax.random.split(r1)
    peng._draw_noise = lambda shape: torch.from_numpy(
        np.asarray(jax.random.normal(sub_s, tuple(shape))))
    out = peng.infer(wav, TEXT, do_sample=False, num_beams=3)
    assert len(jcalls) == len(pcalls) == 1
    np.testing.assert_array_equal(pcalls[0].codes.numpy(), np.asarray(jcalls[0].codes))
    np.testing.assert_array_equal(pcalls[0].lengths.numpy(), np.asarray(jcalls[0].lengths))
    assert out.metrics["decode_steps"] == pcalls[0].steps >= 5
    assert out.wav.shape == ref.wav.shape and out.wav.size > 0
    diff = np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max()
    assert diff <= 8, diff


def test_one_beam_int8_kv_decode_matches_jax(engines):
    """A `num_beams=1` request under the serving flags takes K1's int8-KV
    branch: the greedy codes equal JAX's fused int8-KV decode (Pallas in
    interpret mode), both from the JAX engine's conditioning."""
    from voice_tts_tpu.models.gpt.decode import decode as jax_decode
    from voice_tts_tpu_torch.models.gpt.decode import decode as port_decode

    jeng, peng = engines
    jspk, jemo, jseg = jeng._prepare(prompt_wav(), None, 1.0, None, False, None,
                                     False, TEXT, 120)
    ids = jeng.tokenizer.convert_tokens_to_ids(jseg[0])
    text = np.zeros((1, 16), np.int32)
    text[0, :len(ids)] = ids
    tlen = np.asarray([len(ids)], np.int32)
    gen = jeng._generation_config({"do_sample": False})
    max_new = jeng.cfg.generation.max_mel_tokens
    ref = jax_decode(jeng.params_gpt_rt, jeng.gpt, gen, jspk["cond_latents"], jemo,
                     jax.numpy.asarray(text), jax.numpy.asarray(tlen),
                     jax.random.PRNGKey(0), max_new=max_new,
                     fused_pack=jeng.fused_pack, int8_kv=True,
                     readout_pack=jeng.readout_pack)
    out = port_decode(peng.gpt_rt, peng._generation_config({"do_sample": False}),
                      torch.from_numpy(np.asarray(jspk["cond_latents"], np.float32)),
                      torch.from_numpy(np.asarray(jemo, np.float32)),
                      torch.from_numpy(text).long(), torch.from_numpy(tlen).long(),
                      max_new, fused_pack=peng.fused_pack,
                      readout_pack=peng.readout_pack, int8_kv=True)
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    assert out.steps >= 8


def test_server_default_profile_is_production(engines, monkeypatch):
    """No arguments -> the serving profile: beam-3 through K3, int8 KV, bf16
    conditioning, and `/debug/worker-info` reports it."""
    _, peng = engines
    args = app.parse_args([])
    assert args.profile == "serving" and app.parse_args(["--profile", "bench"]).profile == "bench"
    built = {}

    def fake_random(cfg, device="cuda", seed=0):
        built["cfg"] = cfg
        return peng
    monkeypatch.setattr(TTSEngine, "random", staticmethod(fake_random))
    app.build_engine(False, "cpu", profile=args.profile)
    e = built["cfg"].engine
    assert built["cfg"].generation.num_beams == 3
    assert built["cfg"].generation.max_mel_tokens == 1500
    assert (e.use_fused_beam_decode and e.use_int8_kv and e.use_bf16_conditioning
            and e.fold_readout and e.release_master_trees)
    app.build_engine(False, "cpu", profile="bench")
    assert built["cfg"].generation.num_beams == 1 and not built["cfg"].engine.use_int8_kv

    service = app.TTSService(peng, profile="serving")
    try:
        handler = service.server.routes[("GET", "/debug/worker-info")]
        resp = asyncio.run(handler(Request("GET", "/debug/worker-info", {}, b"")))
        info = json.loads(json.dumps(resp.payload, default=str))["replicas"][0]
    finally:
        service.close()
    assert info["profile"] == "serving"
    assert info["num_beams"] == peng.cfg.generation.num_beams
    flags = info["engine_flags"]
    assert flags["use_fused_beam_decode"] and flags["use_bf16_conditioning"]
    assert flags["use_int8_kv"] and flags["release_master_trees"]

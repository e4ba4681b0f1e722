"""The plain reference against the program at a tiny size on the CPU, on
the benchmark's weights: the same parameters, and each stage the same
function (the program's f32 paths, where the CPU runs the kernels' plain
versions)."""

import numpy as np
import pytest
import torch

from helpers import tiny_config
from perfbench import traffic
from perfbench.reference.indextts2.config import TTSConfig as RefConfig
from perfbench.reference.indextts2.pipeline import Reference
from perfbench.reference.indextts2.weights import make_models

SEED = 4242424242


@pytest.fixture(scope="module")
def pair():
    from voice_tts_tpu_torch.config import TTSConfig
    from voice_tts_tpu_torch.engine.engine import HashTokenizer, TTSEngine, build_models

    cfg = tiny_config(beams=1)
    cfg["engine"].update(use_int8_decode=False, use_fused_decode=False, use_fp16=False)
    made = make_models(RefConfig.from_dict(cfg), "cpu", SEED)
    pcfg = TTSConfig.from_dict(cfg)
    with torch.device("meta"):
        models = build_models(pcfg)
    for k, m in models.items():
        m.load_state_dict(made[k].state_dict(), strict=True, assign=True)
    engine = TTSEngine(pcfg, models, HashTokenizer(pcfg.gpt.number_text_tokens), {}, "cpu")
    return cfg, engine, Reference(cfg, "cpu", SEED)


def rel(a, b):
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def test_weights_are_the_seeds_and_shaped_as_the_programs():
    from voice_tts_tpu_torch.config import TTSConfig
    from voice_tts_tpu_torch.engine.engine import build_models

    cfg = tiny_config()
    a = make_models(RefConfig.from_dict(cfg), "cpu", SEED)
    b = make_models(RefConfig.from_dict(cfg), "cpu", SEED)
    c = make_models(RefConfig.from_dict(cfg), "cpu", SEED + 1)
    with torch.device("meta"):
        port = build_models(TTSConfig.from_dict(cfg))
    for k in a:
        sa, sb, sc = a[k].state_dict(), b[k].state_dict(), c[k].state_dict()
        sp = port[k].state_dict()
        assert {n: t.shape for n, t in sa.items()} == {n: t.shape for n, t in sp.items()}
        assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert not torch.equal(a["gpt"].mel_head.weight, c["gpt"].mel_head.weight)


def test_conditioning(pair):
    cfg, engine, ref = pair
    wav = traffic.voice_wav(SEED, 1, 1.0)
    spk = engine._speaker_conditioning(wav)
    emo = engine._emotion_conditioning(wav)
    r = ref.conditioning(wav)
    assert rel(spk["cond_latents"], r["cond_latents"]) < 1e-5
    assert rel(emo, r["emovec"]) < 1e-5
    assert rel(spk["style"], r["style"]) < 1e-5
    assert rel(spk["prompt_condition"], r["prompt_condition"]) < 1e-5
    assert rel(spk["ref_mel"], r["ref_mel"]) < 1e-6
    assert spk["mel_frames"] == r["mel_frames"]


def test_text_ids(pair):
    _, engine, ref = pair
    text = "预热一下 模型编译"
    assert ref.text_ids(text) == engine.tokenizer.convert_tokens_to_ids(
        engine.tokenizer.tokenize(text))


def test_latent_and_decode_logits(pair):
    cfg, engine, ref = pair
    spk = ref.conditioning(traffic.voice_wav(SEED, 2, 1.0))
    gpt = engine.gpt
    ids = ref.text_ids("一二三四五六七")
    bucket = 16
    text = torch.zeros(bucket, dtype=torch.long)
    text[:len(ids)] = torch.tensor(ids)
    codes = torch.tensor(np.random.default_rng(0).integers(0, 60, 12))
    padded = torch.cat([codes, torch.zeros(20, dtype=torch.long)])
    with torch.no_grad():
        want = gpt(spk["cond_latents"], spk["emovec"], text[None], torch.tensor([len(ids)]),
                   padded[None], torch.tensor([12]))[0]
    got = ref.latent(spk["cond_latents"], spk["emovec"], text, len(ids), padded, 12)
    assert rel(got, want) < 1e-5
    # the decode: prefill at the bucket, then a step a code over a cache
    logits = ref.decode_logits(spk["cond_latents"], spk["emovec"], ids, codes)
    with torch.no_grad():
        prompt, valid_p = gpt.build_prompt(spk["cond_latents"], spk["emovec"], text[None],
                                           torch.tensor([len(ids)]))
        p = prompt.shape[1]
        t_max = p + 1 + len(codes)
        cache = gpt.gpt.init_cache(1, t_max, torch.float32, "cpu")
        valid = torch.cat([valid_p, torch.ones((1, t_max - p), dtype=torch.bool)], dim=1)
        rows = [gpt.prefill(prompt, valid_p, cache)]
        for t in range(len(codes) - 1):
            rows.append(gpt.decode_step(codes[t:t + 1], t, p + 1 + t, valid, cache))
    assert rel(logits, torch.cat(rows)) < 1e-5


def test_s2mel_and_vocoder(pair):
    cfg, engine, ref = pair
    spk = ref.conditioning(traffic.voice_wav(SEED, 3, 1.0))
    n, cb = 20, 32
    codes = torch.zeros((1, cb), dtype=torch.long)
    codes[0, :n] = torch.tensor(np.random.default_rng(1).integers(0, 60, n))
    code_len = torch.tensor([n])
    latent = torch.randn(1, cb, cfg["gpt"]["model_dim"], generator=torch.Generator().manual_seed(1))
    pb = spk["prompt_condition"].shape[1]
    prompt_len = torch.tensor([spk["mel_frames"]])
    mel_bucket = engine._mel_bucket_for(cb)
    noise = torch.randn(1, cfg["mel"]["num_mels"],
                        pb + mel_bucket, generator=torch.Generator().manual_seed(2))
    engine._draw_noise = lambda shape: noise
    with torch.no_grad():
        want, target = engine._s2mel(latent, codes, code_len, spk["prompt_condition"],
                                     prompt_len, spk["ref_mel"], spk["style"], mel_bucket)
    got = ref.s2mel(latent, codes, code_len, spk["prompt_condition"], prompt_len,
                    spk["ref_mel"], spk["style"], mel_bucket, noise)
    assert int(target[0]) == ref.target_len(n)
    assert rel(got, want) < 1e-5
    with torch.no_grad():
        wav = engine.vocode(want).reshape(-1)
    assert rel(ref.vocode(want), wav) < 1e-5

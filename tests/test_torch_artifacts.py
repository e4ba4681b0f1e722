"""The port's artifact directory (`voice_tts_tpu_torch/utils/artifacts.py`),
`TTSEngine.from_artifacts` and `--model-dir`, against the JAX package's
chain on one published-layout directory written from a tiny random engine
(`published_layout.py`): the JAX engine through `convert_reference_artifacts`,
`save_artifacts` and `from_artifacts`, the port's through its own three.

The tiny engine runs the int8 fused decode step, folded readout and bf16
GPT, greedy.  WAV bound: 8 LSB of int16, the engine tests' (the f32 s2mel /
vocoder and the bf16 teacher-forced GPT round at other points in the two
frameworks; the codes are identical), with the JAX engine's CFM noise
handed to the port."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import published_layout as pl
from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
from voice_tts_tpu.engine.engine import TTSEngine as JaxEngine
from voice_tts_tpu.utils import artifacts as jart
from voice_tts_tpu_torch import cli
from voice_tts_tpu_torch.audio import encode_wav_int16
from voice_tts_tpu_torch.config import TTSConfig
from voice_tts_tpu_torch.engine.engine import (HashTokenizer, TTSEngine,
                                               random_models, tiny_config)
from voice_tts_tpu_torch.serving import app
from voice_tts_tpu_torch.text.sp_model import Piece, PieceType, serialize_model
from voice_tts_tpu_torch.text.tokenizer import TextTokenizer
from voice_tts_tpu_torch.utils import artifacts

FLAGS = dict(use_int8_decode=True, use_fused_decode=True, fold_readout=True,
             fuse_pipeline=True, use_fp16=True)
TEXT = "hello world."
FAMILIES = ("gpt", "s2mel", "vocoder", "campplus", "repcodec", "w2v")


def prompt_wav() -> bytes:
    """1 s at 16 kHz: a tone plus white noise (every mel band well above
    the f32 rounding floor of the DFT sums)."""
    sr = 16000
    t = np.arange(sr) / sr
    noise = np.random.default_rng(0).standard_normal(sr)
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * noise
    return encode_wav_int16((x * 32767).astype(np.float32), sr)


def _reference_files(paths):
    return dict(gpt_checkpoint=paths["gpt"], s2mel_checkpoint=paths["s2mel"],
                vocoder_checkpoint=paths["vocoder"],
                campplus_checkpoint=paths["campplus"],
                semantic_codec_checkpoint=paths["repcodec"],
                w2v_bert_dir=os.path.dirname(paths["w2v"]), w2v_stat=paths["w2v_stat"])


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """(the source states and extras, the layout, the port's artifact dir,
    the port's engine, the JAX engine)."""
    cfg = tiny_config(**FLAGS)
    cfg.server.warmup_mode = "minimal"
    models, extras = random_models(cfg, "cpu", seed=7)
    states = {k: m.state_dict() for k, m in models.items()}
    rng = np.random.default_rng(8)
    h = cfg.w2v_bert.hidden_size
    extras.update(w2v_mean=(0.1 * rng.standard_normal(h)).astype(np.float32),
                  w2v_std=(0.5 + rng.random(h)).astype(np.float32))
    tmp = tmp_path_factory.mktemp("artifacts")
    layout = pl.write_published_layout(str(tmp / "published"), cfg, states, extras)
    paths = layout["paths"]

    pstates, pextras = artifacts.convert_reference_artifacts(
        cfg, emo_matrix=paths["emo_matrix"], spk_matrix=paths["spk_matrix"],
        **_reference_files(paths))
    port_dir = str(tmp / "port")
    artifacts.save_artifacts(port_dir, cfg, pstates, pextras)
    peng = TTSEngine.from_artifacts(port_dir, device="cpu")

    # the JAX loader reads no bare-tensor matrix file (the reference's
    # feat1 / feat2 format), so its chain converts the other files
    jcfg = JaxTTSConfig.from_dict(cfg.to_dict())
    jparams, jextras = jart.convert_reference_artifacts(jcfg, **_reference_files(paths))
    jax_dir = str(tmp / "jax")
    jart.save_artifacts(jax_dir, jcfg, jparams, jextras)
    jeng = JaxEngine.from_artifacts(jax_dir)
    return {"states": states, "extras": extras, "layout": layout, "port_dir": port_dir,
            "peng": peng, "jeng": jeng, "tmp": tmp}


def _infer_pair(jeng, peng):
    wav = prompt_wav()
    rng0 = jeng._rng
    ref = jeng.infer(wav, TEXT, do_sample=False)
    r1, _ = jax.random.split(rng0)
    _, sub_s = jax.random.split(r1)
    peng._draw_noise = lambda shape: torch.tensor(
        np.asarray(jax.random.normal(sub_s, tuple(shape))))
    return ref, peng.infer(wav, TEXT, do_sample=False)


def test_artifact_roundtrip(chain, tmp_path):
    """save -> load keeps the config, every state tensor, the extras and the
    sentencepiece model; the engine holds the source weights (the vocoder's
    weight-norm-folded convolutions within 2^-22 relative) and the matrices
    split by `emo_num`; with `bpe.model` the tokenizer is the BPE one."""
    cfg, states, extras, bpe = artifacts.load_artifacts(chain["port_dir"])
    assert cfg.to_dict() == chain["peng"].cfg.to_dict() and bpe is None
    assert set(states) == set(FAMILIES)
    peng = chain["peng"]
    assert isinstance(peng.tokenizer, HashTokenizer)
    for fam in FAMILIES:
        loaded = peng.models[fam].state_dict()
        for k, src in chain["states"][fam].items():
            if fam == "vocoder" and k.endswith("weight") and src.dim() == 3:
                rel = ((loaded[k].double() - src.double()).abs()
                       / src.double().abs().clamp(min=1e-30)).max()
                assert rel <= 2.0 ** -22, k
            else:
                assert torch.equal(loaded[k], src), (fam, k)
    assert "decoder_out.weight" in peng.models["repcodec"].state_dict()
    np.testing.assert_array_equal(peng.w2v_mean.numpy(), chain["extras"]["w2v_mean"])
    std = chain["extras"]["w2v_std"]
    np.testing.assert_array_equal(peng.w2v_std.numpy(), np.sqrt(std * std))
    for key in ("emo_matrix", "spk_matrix"):
        got = getattr(peng, key)
        assert [m.shape[0] for m in got] == list(cfg.engine.emo_num)
        for a, b in zip(got, chain["extras"][key]):
            np.testing.assert_array_equal(a, b)

    bpe_bytes = serialize_model([Piece("<unk>", 0.0, PieceType.UNKNOWN),
                                 Piece("a", -1.0)])
    artifacts.save_artifacts(str(tmp_path), cfg, states, extras, bpe_bytes)
    cfg2, states2, extras2, bpe2 = artifacts.load_artifacts(str(tmp_path))
    assert bpe2 == bpe_bytes and cfg2.to_dict() == cfg.to_dict()
    for fam in FAMILIES:
        assert all(torch.equal(states2[fam][k], v) for k, v in states[fam].items())
    assert isinstance(TTSEngine.from_artifacts(str(tmp_path), device="cpu").tokenizer,
                      TextTokenizer)


def test_from_artifacts_wav_matches_jax_chain(chain):
    """The same published-layout directory through both chains: the same
    greedy codes, the WAV within 8 LSB."""
    ref, out = _infer_pair(chain["jeng"], chain["peng"])
    assert out.sample_rate == ref.sample_rate
    assert out.wav.shape == ref.wav.shape and out.wav.size > 0
    diff = np.abs(out.wav.astype(np.int32) - ref.wav.astype(np.int32)).max()
    assert diff <= 8, diff


def test_from_artifacts_equals_from_jax_params(chain):
    """`from_artifacts` and `from_jax_params` of the JAX chain's engine hold
    the same weights (RepCodec's decoder aside: the JAX engine's parameter
    tree carries it unused) and give the same WAV from the same noise."""
    jeng, peng = chain["jeng"], chain["peng"]
    params = jax.tree.map(np.asarray, jeng.params)
    params["repcodec"] = {"params": {k: v for k, v in params["repcodec"]["params"].items()
                                     if not k.startswith("decoder_")}}
    extras = {"w2v_mean": np.asarray(jeng.w2v_mean), "w2v_std": np.asarray(jeng.w2v_std),
              "emo_matrix": peng.emo_matrix, "spk_matrix": peng.spk_matrix}
    other = TTSEngine.from_jax_params(jeng.cfg, params, jeng.tokenizer, extras,
                                      device="cpu")
    for fam in FAMILIES:
        a, b = peng.models[fam].state_dict(), other.models[fam].state_dict()
        for k in b:
            assert torch.equal(a[k], b[k]), (fam, k)
    noise = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, peng.cfg.mel.num_mels, 4096)).astype(np.float32))
    for eng in (peng, other):
        eng._draw_noise = lambda shape: noise[..., :shape[-1]].expand(*shape).clone()
    a = peng.infer(prompt_wav(), TEXT, do_sample=False)
    b = other.infer(prompt_wav(), TEXT, do_sample=False)
    np.testing.assert_array_equal(a.wav, b.wav)


@pytest.mark.parametrize("profile", ["serving", "bench", "stock", None])
def test_from_artifacts_profiles(chain, profile):
    """`serving` applies the production profile's engine flags to the saved
    config (the fused int8 pack, folded readout, int8 KV, bf16
    conditioning), `bench` the bench profile (one beam, its buckets, the
    fused pack), None / `stock` keeps the config as saved."""
    eng = TTSEngine.from_artifacts(chain["port_dir"], profile=profile, device="cpu")
    saved = chain["peng"].cfg
    if profile == "serving":
        e = eng.cfg.engine
        assert e.use_int8_kv and e.use_bf16_conditioning and e.use_fused_beam_decode
        assert eng.fused_pack is not None and eng.readout_pack is not None
    elif profile == "bench":
        assert eng.cfg.generation.num_beams == 1 and eng.fused_pack is not None
        assert eng.cfg.engine.text_buckets == (48,)
    else:
        assert eng.cfg.to_dict() == saved.to_dict()
    with pytest.raises(ValueError, match="unknown profile"):
        TTSEngine.from_artifacts(chain["port_dir"], profile="fast", device="cpu")


def test_missing_family_raises(chain, tmp_path):
    """A directory without one family's file: FileNotFoundError naming it,
    as in JAX."""
    for name in os.listdir(chain["port_dir"]):
        if name != "w2v.pt":
            shutil.copy(os.path.join(chain["port_dir"], name), tmp_path / name)
    with pytest.raises(FileNotFoundError, match="w2v"):
        TTSEngine.from_artifacts(str(tmp_path), device="cpu")


def test_split_matrix_groups_matches_jax():
    mat = np.arange(20).reshape(10, 2)
    groups = artifacts.split_matrix_groups(mat, (3, 2, 5))
    ref = jart.split_matrix_groups(mat, (3, 2, 5))
    assert [g.shape[0] for g in groups] == [3, 2, 5]
    for a, b in zip(groups, ref):
        np.testing.assert_array_equal(a, b)


def test_model_dir_server_and_cli(chain, tmp_path):
    """`--model-dir` in the server (`build_engine`, `load_engines`, `main`'s
    arguments) and the CLI: the directory's engine, `--profile stock` its
    config as saved; without a directory `stock` is `TTSConfig()` as it
    stands (`engine_config`, no engine built), as in the JAX server."""
    d = chain["port_dir"]
    args = app.parse_args(["--model-dir", d, "--profile", "stock"])
    assert args.model_dir == d and args.profile == "stock"
    eng = app.build_engine(False, "cpu", profile="stock", model_dir=d)
    assert eng.cfg.to_dict() == chain["peng"].cfg.to_dict()
    assert app.engine_config(False, "stock").to_dict() == TTSConfig().to_dict()
    service = app.TTSService()
    try:
        service.load_engines(device="cpu", profile="serving", model_dir=d)
        assert service.engines[0].cfg.engine.use_int8_kv
        assert service.warmup_stats["mode"] == "minimal"
    finally:
        service.close()
    voice = tmp_path / "voice.wav"
    voice.write_bytes(prompt_wav())
    out = tmp_path / "gen.wav"
    rc = cli.main([TEXT, "-v", str(voice), "-o", str(out), "--model-dir", d,
                   "--profile", "stock", "--device", "cpu"])
    assert rc == 0 and out.stat().st_size > 44

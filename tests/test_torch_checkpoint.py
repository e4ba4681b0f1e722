"""The port's checkpoint converters (`voice_tts_tpu_torch/utils/checkpoint.py`)
against the JAX package's (`voice_tts_tpu/utils/checkpoint.py`) on the same
files, the published-layout writer (`published_layout.py`) against the JAX
renamers, the conditioning branches a loaded config reaches and RepCodec's
downsampling and decoder, all at the tiny config's widths.

Converters and loaders are compared bit for bit (a rename of the same
tensors; weight norm folded in the same float64 arithmetic).  The modules
compute in f32 on both sides: tolerance 2e-4 of max(1, max |jax|) for the
conditioning (the model tests' ceiling), 2e-5 for RepCodec, and identical
greedy codes."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import published_layout as pl
from voice_tts_tpu.config import GenerationConfig as JaxGenerationConfig
from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
from voice_tts_tpu.models.conditioning.repcodec import RepCodec as JRepCodec
from voice_tts_tpu.models.gpt.decode import decode as jax_decode
from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
from voice_tts_tpu.utils import checkpoint as jck
from voice_tts_tpu_torch.config import GenerationConfig
from voice_tts_tpu_torch.engine.engine import build_models, random_models, tiny_config
from voice_tts_tpu_torch.models.conditioning.repcodec import RepCodec
from voice_tts_tpu_torch.models.gpt.decode import decode as port_decode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.utils import checkpoint as pck
from voice_tts_tpu_torch.utils.convert import convert, flatten_params, load_family

pytest_plugins = ("port_fixtures",)

CFG = tiny_config()
NSR = CFG.s2mel.length_regulator.num_sampling_ratios
FAMILIES = ("gpt", "s2mel", "vocoder", "campplus", "repcodec", "w2v")
JAX_CONVERT = {
    "gpt": jck.convert_unified_voice,
    "s2mel": lambda sd: jck.convert_s2mel(sd, NSR),
    "vocoder": jck.convert_bigvgan, "campplus": jck.convert_campplus,
    "repcodec": jck.convert_repcodec,
    "w2v": lambda sd: jck.convert_w2v_bert(sd, CFG.w2v_bert.output_layer)}
PORT_CONVERT = {
    "gpt": pck.convert_unified_voice,
    "s2mel": lambda sd: pck.convert_s2mel(sd, NSR),
    "vocoder": pck.convert_bigvgan, "campplus": pck.convert_campplus,
    "repcodec": pck.convert_repcodec,
    "w2v": lambda sd: pck.convert_w2v_bert(sd, CFG.w2v_bert.output_layer)}
JAX_RENAMER = {
    "gpt": jck.unified_voice_renamer(), "s2mel": jck.s2mel_renamer(NSR),
    "vocoder": jck.bigvgan_renamer(), "campplus": jck.campplus_renamer(),
    "repcodec": jck.repcodec_renamer(),
    "w2v": jck.w2v_bert_renamer(CFG.w2v_bert.output_layer)}


def close(out, ref, tol):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def same_state(port: dict, ref: dict):
    """Same keys, and each tensor equal to the reference's bit for bit."""
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))[:8]
    for k in ref:
        r = torch.from_numpy(np.array(np.asarray(ref[k])))
        assert port[k].dtype == r.dtype and torch.equal(port[k], r), k


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The tiny random engine's states written in the published layout."""
    models, extras = random_models(CFG, "cpu", seed=3)
    states = {k: m.state_dict() for k, m in models.items()}
    h = CFG.w2v_bert.hidden_size
    extras.update(w2v_mean=np.zeros(h, np.float32), w2v_std=np.ones(h, np.float32))
    root = str(tmp_path_factory.mktemp("published"))
    out = pl.write_published_layout(root, CFG, states, extras, seed=4)
    return states, out


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def test_load_state_dict_wrappers_match_jax(layout, tmp_path):
    """Flat, the four single-key wrappers, `.safetensors` and the s2mel
    trainer's module-keyed `net` with and without the EMA shadow: the
    port's loader gives the JAX loader's keys and values."""
    from safetensors.torch import save_file

    states, out = layout
    flat = torch.load(out["paths"]["gpt"], weights_only=False)
    files = {"flat.pth": flat}
    for wrap in ("generator", "model", "state_dict", "net"):
        files[f"{wrap}.pth"] = {wrap: flat, "epoch": 1}
    nested = torch.load(out["paths"]["s2mel"], weights_only=False)["net"]
    ema = {mk: [[t + 1.0 for pk, t in sub.items() if "input_pos" not in pk]]
           for mk, sub in nested.items()}
    files["nested.pth"] = {"net": nested, "epoch": 2}
    files["nested_ema.pth"] = {"net": nested, "ema": ema, "epoch": 2}
    for name, obj in files.items():
        torch.save(obj, tmp_path / name)
    save_file({k: v.contiguous() for k, v in flat.items() if v.dim() > 0},
              str(tmp_path / "flat.safetensors"))
    for name in list(files) + ["flat.safetensors"]:
        path = str(tmp_path / name)
        for ema_on in (False, True):
            same_state(pck.load_state_dict(path, load_ema=ema_on),
                       jck.load_state_dict(path, load_ema=ema_on))
    moved = pck.load_state_dict(str(tmp_path / "nested_ema.pth"), load_ema=True)
    base = pck.load_state_dict(str(tmp_path / "nested_ema.pth"))
    for k in base:
        if "input_pos" in k:
            assert torch.equal(moved[k], base[k])
        else:
            assert torch.equal(moved[k], base[k] + 1.0), k


def test_fold_weight_norm_both_namings_match_jax():
    rng = np.random.default_rng(0)
    sd = {"a.weight_g": rng.random((6, 1, 1), np.float32) + 0.5,
          "a.weight_v": rng.standard_normal((6, 4, 3)).astype(np.float32),
          "a.bias": rng.standard_normal(6).astype(np.float32),
          "b.parametrizations.weight.original0": rng.random((5, 1), np.float32),
          "b.parametrizations.weight.original1":
              rng.standard_normal((5, 7)).astype(np.float32),
          "weight_g": rng.random((3, 1, 1), np.float32),
          "weight_v": rng.standard_normal((3, 2, 5)).astype(np.float32)}
    port = pck.fold_weight_norm(sd)
    ref = jck.fold_weight_norm(sd)
    assert set(port) == {"a.weight", "a.bias", "b.weight", "weight"}
    same_state(port, ref)


# ---------------------------------------------------------------------------
# converters and the writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_converter_matches_jax_and_loads_strictly(layout, family):
    """The published-layout file through the JAX converter and the port's:
    the port's state is `flatten_params` of the JAX tree bit for bit, loads
    strictly into the port's module and holds the written weights (the
    vocoder's weight-norm-folded convolutions within 2^-22 relative: g and
    v round-trip through the f32 product); an unknown key raises KeyError
    on both sides."""
    states, out = layout
    path = out["paths"][family]
    sd = jck.load_state_dict(path)
    port = PORT_CONVERT[family](pck.load_state_dict(path))
    same_state(port, flatten_params(JAX_CONVERT[family](sd)))
    models = build_models(CFG, repcodec_decoder=True)
    load_family(models[family], port)
    for k, src in states[family].items():
        if family == "vocoder" and k.endswith("weight") and src.dim() == 3:
            rel = ((port[k].double() - src.double()).abs()
                   / src.double().abs().clamp(min=1e-30)).max()
            assert rel <= 2.0 ** -22, (k, float(rel))
        else:
            assert torch.equal(port[k], src), k
    bad = dict(sd, **{"unknown.module.weight": np.zeros(2, np.float32)})
    with pytest.raises(KeyError):
        JAX_CONVERT[family](bad)
    with pytest.raises(KeyError):
        PORT_CONVERT[family]({k: torch.from_numpy(np.asarray(v)) for k, v in bad.items()})


@pytest.mark.parametrize("family", FAMILIES)
def test_writer_names_map_back_through_jax_renamer(layout, family):
    """Checked without the port's converters: every name the writer gives a
    port key maps, through the JAX renamer, back to that key, and every
    other key it writes is one the JAX renamer drops or a weight-norm half."""
    states, out = layout

    def renamer(name):
        # `convert_w2v_bert` renames the distance embedding before its rules
        return JAX_RENAMER[family](name.replace(
            "self_attn.distance_embedding.weight", "self_attn.distance_embedding"))
    mapped = set()
    for k in states[family]:
        name = pl.published_name(family, k, CFG)
        assert renamer(name).replace("/", ".") == k, (k, name)
        mapped.add(name)
    for name in out["published"][family]:
        if name in mapped or (family == "repcodec" and name.startswith("decoder.")):
            continue
        if family == "vocoder" and (name.endswith(("weight_g", "weight_v"))
                                    or ".parametrizations.weight.original" in name):
            base = name.rsplit(".weight_", 1)[0] if "weight_" in name.rsplit(".", 1)[1] \
                else name.split(".parametrizations.")[0]
            assert f"{base}.weight" in mapped, name
            continue
        assert renamer(name) is None, name


# ---------------------------------------------------------------------------
# conditioning branches
# ---------------------------------------------------------------------------

def _gpt_pair(condition_type: str):
    pcfg = tiny_config()
    pcfg.gpt.condition_type = condition_type
    jcfg = JaxTTSConfig.from_dict(pcfg.to_dict()).gpt
    c = pcfg.gpt
    model = JUV(jcfg)
    params = jax.jit(functools.partial(model.init, method=JUV.init_all))(
        jax.random.PRNGKey(1), jnp.zeros((1, 6, c.condition_module.input_size)),
        jnp.zeros((1, 6, c.emo_condition_module.input_size)),
        jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 6), jnp.int32), jnp.asarray([6]))
    port = load_family(UnifiedVoice(c), convert("gpt", params)).eval()
    return model, params, port


@pytest.mark.parametrize("condition_type", ["perceiver", "mean_pooled"])
def test_conditioning_branch_and_greedy_decode_match_jax(condition_type):
    """`get_conditioning` under the attention-block branches (the perceiver
    at its own defaults, and the mean-pooled default arm: one latent), then
    an f32 greedy decode from the JAX conditioning: identical codes."""
    model, params, port = _gpt_pair(condition_type)
    c = port.cfg
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((1, 20, c.condition_module.input_size)).astype(np.float32)
    lens = np.asarray([17])
    ref = model.apply(params, jnp.asarray(feats), jnp.asarray(lens),
                      method=JUV.get_conditioning)
    n_lat = c.condition_num_latent if condition_type == "perceiver" else 1
    assert ref.shape == (1, n_lat, c.model_dim)
    with torch.no_grad():
        close(port.get_conditioning(torch.from_numpy(feats), torch.from_numpy(lens)),
              ref, 2e-4)
    emo = rng.standard_normal((1, c.model_dim)).astype(np.float32) * 0.1
    text = rng.integers(2, c.number_text_tokens, (1, 16)).astype(np.int32)
    tlen = np.asarray([11], np.int32)
    jgen = JaxGenerationConfig(do_sample=False, num_beams=1, repetition_penalty=10.0)
    jres = jax_decode(params, model, jgen, ref, jnp.asarray(emo), jnp.asarray(text),
                      jnp.asarray(tlen), jax.random.PRNGKey(0), max_new=12)
    pres = port_decode(port, GenerationConfig(do_sample=False, num_beams=1,
                                              repetition_penalty=10.0),
                       torch.tensor(np.asarray(ref)), torch.from_numpy(emo),
                       torch.from_numpy(text).long(), torch.from_numpy(tlen).long(), 12)
    np.testing.assert_array_equal(pres.codes.numpy(), np.asarray(jres.codes))
    assert int(pres.lengths[0]) == int(np.asarray(jres.lengths)[0])


@pytest.mark.parametrize("condition_type", ["gst", "conformer_encoder"])
def test_broken_reference_branches_raise(condition_type):
    cfg = tiny_config()
    cfg.gpt.condition_type = condition_type
    with pytest.raises(ValueError, match="not supported"):
        UnifiedVoice(cfg.gpt)
    jcfg = JaxTTSConfig.from_dict(cfg.to_dict()).gpt
    with pytest.raises(ValueError, match="not supported"):
        JUV(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 32)), jnp.asarray([6]),
                       method=JUV.get_conditioning)


# ---------------------------------------------------------------------------
# RepCodec downsampling and decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [12, 9])
def test_repcodec_downsampled_codes_and_reconstruct_match_jax(frames):
    """downsample_scale 2: the stride-2 `down` conv before the encoder, the
    nearest x2 upsampling and `up` after the decoder; quantize codes equal,
    the quantized features and `reconstruct` within 2e-5."""
    cfg = tiny_config()
    cfg.semantic_codec.downsample_scale = 2
    c = cfg.semantic_codec
    model = JRepCodec(JaxTTSConfig.from_dict(cfg.to_dict()).semantic_codec)
    params = jax.jit(functools.partial(model.init, method=JRepCodec.init_full))(
        jax.random.PRNGKey(5), jnp.zeros((1, 8, c.hidden_size)))
    port = load_family(RepCodec(c, decoder=True), convert("repcodec", params)).eval()
    x = np.random.default_rng(frames).standard_normal((1, frames, c.hidden_size))
    x = x.astype(np.float32)
    ref_idx, ref_q = model.apply(params, jnp.asarray(x))
    ref_rec = model.apply(params, jnp.asarray(x), method=JRepCodec.reconstruct)
    with torch.no_grad():
        idx, zq = port(torch.from_numpy(x))
        assert idx.shape[1] == (frames + 1) // 2
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        close(zq, ref_q, 2e-5)
        close(port.reconstruct(torch.from_numpy(x)), ref_rec, 2e-5)
    with pytest.raises(ValueError, match="decoder"):
        RepCodec(c).reconstruct(torch.from_numpy(x))


def test_layout_writes_every_file(layout):
    _, out = layout
    for path in out["paths"].values():
        assert os.path.getsize(path) > 0, path
    assert out["bytes"] > 0

"""The port's onboarding (`voice_tts_tpu_torch/utils/onboard.py`) and
quantization quality gate (`utils/quality_gate.py`) against the JAX
package's, at the tiny config's widths, and its profiling hooks
(`utils/profiling.py`).

The config mapping and the coverage / structure reports are compared
exactly.  The quality gate's reference is the bf16 unfused decode step,
which rounds at other points in the two frameworks, by about as much as
the int8 trunk moves the logits: the gate's KL mean and max agree within
15% relative, max |dlogit| within 25%, top-1 agreement and the free-running
prefix matches exactly."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import published_layout as pl
from voice_tts_tpu.config import TTSConfig as JaxTTSConfig
from voice_tts_tpu.models.gpt.unified_voice import UnifiedVoice as JUV
from voice_tts_tpu.models.gpt.unified_voice import n_cond_latents
from voice_tts_tpu.utils import onboard as job
from voice_tts_tpu.utils.checkpoint import load_state_dict as jax_load_state_dict
from voice_tts_tpu.utils.quality_gate import run_quality_gate as jax_gate
from voice_tts_tpu_torch.config import TTSConfig
from voice_tts_tpu_torch.engine.engine import random_models, tiny_config
from voice_tts_tpu_torch.utils import onboard
from voice_tts_tpu_torch.utils.checkpoint import family_renamer, load_state_dict
from voice_tts_tpu_torch.utils.convert import convert
from voice_tts_tpu_torch.utils.quality_gate import SCHEMES, run_quality_gate

pytest_plugins = ("port_fixtures",)

SCHEME_NAMES = list(SCHEMES)


def _yaml_tree(cfg, **changes) -> dict:
    """The published config.yaml tree of `cfg` through a YAML text."""
    tree = pl.published_config(cfg)
    for path, value in changes.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return yaml.safe_load(yaml.safe_dump(tree, sort_keys=False))


@pytest.mark.parametrize("which", ["flagship", "tiny", "perceiver_unknown_keys"])
def test_build_config_from_reference_matches_jax(which):
    """The published key structure maps onto the same config as in JAX
    (`to_dict`) with the same warnings; the flagship tree maps back onto
    `TTSConfig()`, unknown keys only warn."""
    if which == "flagship":
        tree = _yaml_tree(TTSConfig())
    elif which == "tiny":
        tree = _yaml_tree(tiny_config())
    else:
        tree = _yaml_tree(TTSConfig(), **{
            "gpt.condition_type": "perceiver", "gpt.condition_module.bogus_knob": 42,
            "gpt.condition_module.dropout_rate": 0.1, "s2mel.wavenet.bogus": 1,
            "semantic_codec.downsample_scale": 2})
    cfg, warnings = onboard.build_config_from_reference(tree)
    jcfg, jwarnings = job.build_config_from_reference(tree)
    assert cfg.to_dict() == jcfg.to_dict()
    assert warnings == jwarnings and any("version" in w for w in warnings)
    if which == "flagship":
        assert cfg.to_dict() == TTSConfig().to_dict()
    if which == "perceiver_unknown_keys":
        assert cfg.gpt.condition_type == "perceiver"
        assert cfg.semantic_codec.downsample_scale == 2
        assert any("bogus_knob" in w for w in warnings)
        assert not any("dropout_rate" in w for w in warnings)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    cfg = tiny_config()
    models, extras = random_models(cfg, "cpu", seed=11)
    h = cfg.w2v_bert.hidden_size
    extras.update(w2v_mean=np.zeros(h, np.float32), w2v_std=np.ones(h, np.float32))
    root = tmp_path_factory.mktemp("published")
    return cfg, pl.write_published_layout(
        str(root), cfg, {k: m.state_dict() for k, m in models.items()}, extras)


def test_coverage_and_structure_reports_match_jax(layout):
    """On a gpt checkpoint with a dropped key, an unmatched key, a missing
    leaf and a shape mismatch, the port's coverage report and structure diff
    name the same keys as the JAX ones (dots for slashes)."""
    cfg, out = layout
    jcfg = JaxTTSConfig.from_dict(cfg.to_dict())
    sd = jax_load_state_dict(out["paths"]["gpt"])
    sd["gpt.h.0.attn.rotary.inv_freq"] = np.zeros(4, np.float32)       # unmatched
    del sd["speed_emb.weight"]                                          # missing
    sd["mel_head.bias"] = np.zeros(3, np.float32)                       # mismatch
    port_sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    cov = onboard.coverage_report("gpt", port_sd, family_renamer("gpt", cfg))
    jcov = job.coverage_report("gpt", sd, job.FAMILY_RENAMERS["gpt"](jcfg))
    assert cov["unmatched"] == jcov["unmatched"] == ["gpt.h.0.attn.rotary.inv_freq"]
    assert sorted(cov["dropped"]) == sorted(jcov["dropped"])
    assert "gpt.wte.weight" in cov["dropped"] and cov["n_source"] == jcov["n_source"]
    diff = onboard.structure_diff(cov["converted"], onboard.expected_shapes("gpt", cfg))
    jdiff = job.structure_diff(jcov["converted"], job.eval_shape_tree("gpt", jcfg))
    assert diff["missing"] == ["speed_emb.weight"]
    assert diff["mismatched"] == ["mel_head.bias: ckpt(3,) != model(68,)"]
    for key in ("missing", "extra", "mismatched"):
        assert diff[key] == [k.replace("/", ".") for k in jdiff[key]], key


@pytest.mark.parametrize("family", ["gpt", "s2mel", "vocoder", "campplus", "repcodec",
                                    "w2v"])
def test_published_layout_reports_clean(layout, family):
    """Every family of the published layout: no unmatched, missing, extra or
    mismatched key (JAX's report flags w2v-bert's distance embedding as
    missing and extra: its coverage pass skips `convert_w2v_bert`'s rename,
    which the port's renamer carries)."""
    cfg, out = layout
    cov = onboard.coverage_report(family, load_state_dict(out["paths"][family]),
                                  family_renamer(family, cfg))
    diff = onboard.structure_diff(cov["converted"], onboard.expected_shapes(family, cfg))
    assert not cov["unmatched"] and not any(diff.values()), (cov["unmatched"], diff)


def _tiny_widths(monkeypatch):
    """The config.yaml carries no vocoder, CAMPPlus, w2v-bert, mel or
    engine widths (the published models fix them): map the tree, then take
    those from the tiny config."""
    build = onboard.build_config_from_reference

    def tiny_build(tree):
        cfg, warnings = build(tree)
        tiny = tiny_config()
        for name in ("vocoder", "campplus", "w2v_bert", "mel", "engine", "generation"):
            setattr(cfg, name, getattr(tiny, name))
        for name in ("gpt_dim", "gpt_layer_hidden", "gpt_layer_out"):
            setattr(cfg.s2mel, name, getattr(tiny.s2mel, name))
        return cfg, warnings
    monkeypatch.setattr(onboard, "build_config_from_reference", tiny_build)


def test_main_end_to_end_on_tiny_layout(layout, tmp_path, monkeypatch):
    """`main` converts the tiny layout, runs the gates (4 steps) and the
    bench on the CPU, writes the artifacts and the report, exits 0."""
    cfg, out = layout
    _tiny_widths(monkeypatch)
    report_path = tmp_path / "report.json"
    art = tmp_path / "converted"
    rc = onboard.main(out["onboard_args"] + [
        "--out", str(art), "--report-json", str(report_path), "--quality-gates",
        "--gate-steps", "4", "--bench", "--bench-repeats", "1", "--device", "cpu"])
    assert rc == 0
    report = json.loads(report_path.read_text())
    assert set(report["families"]) == {"gpt", "s2mel", "vocoder", "campplus",
                                       "repcodec", "w2v"}
    for fam, row in report["families"].items():
        assert not (row["unmatched"] or row["missing"] or row["extra"]
                    or row["mismatched"]), fam
    assert set(report["quality_gates"]["teacher_forced"]) == set(SCHEMES)
    assert report["bench"]["rtf"] > 0
    assert (art / "extras.pt").exists() and (art / "config.json").exists()
    assert onboard.main(["--gpt", str(tmp_path / "absent.pth"), "--device", "cpu"]) == 1
    assert onboard.main(["--device", "cpu"]) == 1


@pytest.fixture(scope="module")
def gates():
    """The JAX gate (interpret mode) and the port's on the same tiny random
    UnifiedVoice and the JAX gate's own inputs, 4 steps."""
    jc = JaxTTSConfig.tiny().gpt
    cfg = TTSConfig.tiny().gpt
    model = JUV(jc)
    params = jax.jit(functools.partial(model.init, method=JUV.init_all))(
        jax.random.PRNGKey(0), jnp.zeros((1, 6, cfg.condition_module.input_size)),
        jnp.zeros((1, 6, cfg.emo_condition_module.input_size)),
        jnp.ones((1, 8), jnp.int32), jnp.asarray([8]), jnp.zeros((1, 6), jnp.int32),
        jnp.asarray([6]))
    ref = jax_gate(jc, params, steps=4, prompts=1, interpret=True)
    # the JAX gate's draws (PRNGKey(100) and its fold-ins)
    prng = jax.random.PRNGKey(100)
    nc, d = n_cond_latents(jc), jc.model_dim
    bl = min(24, max(jc.max_text_tokens - 2, 4))
    inputs = [{
        "cond": torch.tensor(np.asarray(jax.random.normal(prng, (1, nc, d)) * 0.3)),
        "emo": torch.tensor(np.asarray(
            jax.random.normal(jax.random.fold_in(prng, 1), (1, d)) * 0.1)),
        "text": torch.tensor(np.asarray(jax.random.randint(
            jax.random.fold_in(prng, 2), (1, bl), 2, jc.number_text_tokens))).long()}]
    port = run_quality_gate(cfg, convert("gpt", params), steps=4, device="cpu",
                            inputs=inputs)
    return ref, port


@pytest.mark.parametrize("scheme", SCHEME_NAMES)
def test_quality_gate_matches_jax(gates, scheme):
    ref, port = gates
    r, p = ref["teacher_forced"][scheme], port["teacher_forced"][scheme]
    for key in ("kl_mean", "kl_max"):
        assert abs(p[key] - r[key]) <= 0.15 * r[key], (key, p[key], r[key])
    assert abs(p["max_abs_dlogit"] - r["max_abs_dlogit"]) <= 0.25 * r["max_abs_dlogit"]
    assert p["top1_agreement"] == r["top1_agreement"]
    assert port["free_running"][0][scheme] == ref["free_running"][0][scheme]
    assert port["free_running"][0]["ref_len"] == ref["free_running"][0]["ref_len"]


def test_quality_gate_orderings(gates):
    """The JAX gate's orderings hold on the port: int8 no further from the
    bf16 trajectory than int4, the folded readout adds to int8's delta."""
    _, port = gates
    tf = port["teacher_forced"]
    assert set(tf) == set(SCHEMES)
    for row in tf.values():
        assert np.isfinite(row["kl_mean"]) and row["kl_mean"] >= 0
    assert tf["int8"]["kl_mean"] <= tf["int4"]["kl_mean"]
    assert tf["int8_rofold"]["kl_mean"] >= tf["int8"]["kl_mean"]
    assert port["config"]["device"] == "cpu" and port["config"]["steps"] == 4


def test_profiling_trace_annotate_and_stage_timers(tmp_path):
    """`utils/profiling.py`: `trace` writes a Chrome trace holding the
    `annotate` region; `StageTimers` accumulates a span over two entries."""
    from voice_tts_tpu_torch.utils.profiling import StageTimers, annotate, trace

    with trace(str(tmp_path)):
        with annotate("onboard_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    text = (tmp_path / "trace.json").read_text()
    assert "onboard_region" in text and json.loads(text)["traceEvents"]
    timers = StageTimers()
    for _ in range(2):
        with timers.span("gpt_gen_time"):
            pass
    assert set(timers.values) == {"gpt_gen_time"} and timers.values["gpt_gen_time"] >= 0

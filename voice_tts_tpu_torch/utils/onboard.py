"""One-command checkpoint onboarding (`voice_tts_tpu/utils/onboard.py`):
convert the published IndexTTS-2 checkpoint files, verify them family by
family, then optionally run the quantization quality gates and a warm
end-to-end bench on the converted weights; one report.

Points at the reference checkpoint layout: a model directory holding
`config.yaml` and the torch / safetensors files it names, plus the
families downloaded apart (w2v-bert, semantic codec, CAMPPlus, vocoder).
For every family it

  1. loads the state dict (`checkpoint.load_state_dict`: every wrapper
     shape the reference loaders accept),
  2. reports key coverage: converted / dropped by a rule / UNMATCHED
     source keys,
  3. diffs the converted state against the port's module built on the
     `meta` device: missing keys, extra keys, shape mismatches,
  4. (--quality-gates) the int8 / int4 teacher-forced logit-KL gates on the
     converted GPT weights (`utils.quality_gate`), on `--device`,
  5. (--out) writes the artifact directory (`utils.artifacts`),
  6. (--bench) builds `TTSEngine.from_artifacts(out, profile="serving")`
     on `--device` and measures warm single-request RTF.

Exit code 0 = every requested step passed; 1 otherwise.

    python -m voice_tts_tpu_torch.utils.onboard \\
        --model-dir /models/IndexTTS \\
        --w2v-bert-dir /models/w2v-bert-2.0 \\
        --semantic-codec /models/MaskGCT/semantic_codec/model.safetensors \\
        --campplus /models/campplus_cn_common.bin \\
        --vocoder /models/bigvgan/bigvgan_generator.pt \\
        --out /models/converted --quality-gates --bench
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Tuple

import numpy as np
import torch

from voice_tts_tpu_torch.config import (ConformerConfig, DiTConfig,
                                        LengthRegulatorConfig, RepCodecConfig,
                                        S2MelConfig, TTSConfig, WaveNetConfig)
from voice_tts_tpu_torch.utils.checkpoint import (family_renamer, fold_weight_norm,
                                                  load_state_dict, strip_ddp_prefix)
from voice_tts_tpu_torch.utils.convert import FAMILIES


def build_config_from_reference(y: dict):
    """Map the reference OmegaConf YAML tree onto a TTSConfig.  Unknown keys
    are collected as warnings, not fatal: the dry run's job is to surface
    them.  Returns (cfg, warnings)."""
    cfg = TTSConfig()
    warnings = []

    def fill(dst, src: dict, label: str, skip=()):
        fields = {f.name for f in dataclasses.fields(dst)}
        for k, v in (src or {}).items():
            if k in skip:
                continue
            if k in fields:
                setattr(dst, k, v)
            else:
                warnings.append(f"{label}.{k} = {v!r} (unmapped)")

    g = dict(y.get("gpt", {}))
    for sub in ("condition_module", "emo_condition_module"):
        if sub in g:
            mod = ConformerConfig()
            fill(mod, g.pop(sub), f"gpt.{sub}",
                 skip=("dropout_rate", "positional_dropout_rate",
                       "attention_dropout_rate", "normalize_before",
                       "concat_after", "macaron_style", "use_cnn_module",
                       "activation_type", "pos_enc_layer_type"))
            setattr(cfg.gpt, sub, mod)
    fill(cfg.gpt, g, "gpt",
         skip=("max_conditioning_inputs", "mel_length_compression",
               "train_solo_embeddings", "use_mel_codes_as_input",
               "checkpointing"))

    s = y.get("s2mel", {})
    d = DiTConfig()
    fill(d, s.get("DiT", {}), "s2mel.DiT",
         skip=("content_codebook_size", "content_type", "final_layer_type",
               "style_condition", "class_dropout_prob", "target_type",
               "dropout_rate", "ffn_dropout_rate", "prompt_cfg_rate",
               "time_as_token", "uvit_skip_connection"))
    if "style_encoder" in s and "dim" in s["style_encoder"]:
        d.style_dim = s["style_encoder"]["dim"]
    wn = WaveNetConfig()
    fill(wn, s.get("wavenet", {}), "s2mel.wavenet",
         skip=("style_condition", "p_dropout"))
    lr_src = dict(s.get("length_regulator", {}))
    lr = LengthRegulatorConfig()
    if "sampling_ratios" in lr_src:
        lr.num_sampling_ratios = len(lr_src.pop("sampling_ratios"))
    for k in ("is_discrete", "f0_condition", "n_f0_bins", "vector_quantize"):
        lr_src.pop(k, None)
    if "content_codebook_size" in lr_src:
        lr.codebook_size = lr_src.pop("content_codebook_size")
    lr_src.pop("in_channels", None)  # implied by the semantic codec width
    fill(lr, lr_src, "s2mel.length_regulator")
    cfg.s2mel = S2MelConfig(dit=d, wavenet=wn, length_regulator=lr)

    sc = RepCodecConfig()
    fill(sc, y.get("semantic_codec", {}), "semantic_codec")
    cfg.semantic_codec = sc

    if "emo_num" in y:
        cfg.engine.emo_num = tuple(y["emo_num"])
    if "version" in y:
        warnings.append(f"version = {y['version']!r} (informational)")
    return cfg, warnings


def coverage_report(name: str, sd: dict, renamer) -> dict:
    """Run the family renamer over every (weight-norm-folded) source key."""
    sd = fold_weight_norm(strip_ddp_prefix(sd))
    converted, dropped, unmatched = {}, [], []
    for key, val in sd.items():
        try:
            target = renamer(key)
        except KeyError:
            unmatched.append(key)
            continue
        if target is None:
            dropped.append(key)
        else:
            converted[target] = val
    return {"name": name, "converted": converted, "dropped": dropped,
            "unmatched": unmatched, "n_source": len(sd)}


def expected_shapes(family: str, cfg: TTSConfig) -> Dict[str, Tuple[int, ...]]:
    """The port module's state keys and shapes for a family at `cfg`'s
    widths, built on the `meta` device (no memory); RepCodec with its
    decoder, which the published codec carries."""
    from voice_tts_tpu_torch.engine.engine import build_models

    if family not in FAMILIES:
        raise KeyError(f"unknown model family {family!r}")
    with torch.device("meta"):
        module = build_models(cfg, repcodec_decoder=True)[family]
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def structure_diff(converted: dict, expected: Dict[str, Tuple[int, ...]]) -> dict:
    """Converted keys against the module's (`expected_shapes`)."""
    missing = sorted(set(expected) - set(converted))
    extra = sorted(set(converted) - set(expected))
    mismatched = [
        f"{k}: ckpt{tuple(converted[k].shape)} != model{tuple(expected[k])}"
        for k in sorted(set(converted) & set(expected))
        if tuple(converted[k].shape) != tuple(expected[k])]
    return {"missing": missing, "extra": extra, "mismatched": mismatched}


def _bench(out: str, device: str, repeats: int) -> dict:
    from voice_tts_tpu_torch.audio import encode_wav_int16
    from voice_tts_tpu_torch.engine.engine import TTSEngine

    engine = TTSEngine.from_artifacts(out, profile="serving", device=device)
    sr = engine.cfg.engine.sample_rate
    t = np.arange(5 * sr) / sr
    tone = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    prompt = encode_wav_int16(tone * 32767, sr)
    text = "今天天气真好我们一起出去散步聊天吧."
    t0 = time.perf_counter()
    engine.infer(prompt, text, None)  # cold: conditioning, graph captures
    cold = time.perf_counter() - t0
    rtfs = [engine.infer(prompt, text, None).metrics["rtf"] for _ in range(repeats)]
    return {"rtf": float(np.median(rtfs)), "rtfs": rtfs, "cold_s": cold,
            "repeats": repeats, "profile": "serving", "device": str(engine.device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-dir", help="IndexTTS-2 dir with config.yaml")
    ap.add_argument("--gpt", help="override gpt checkpoint path")
    ap.add_argument("--s2mel", help="override s2mel checkpoint path")
    ap.add_argument("--vocoder", help="BigVGAN generator checkpoint")
    ap.add_argument("--campplus", help="campplus_cn_common.bin")
    ap.add_argument("--semantic-codec", help="MaskGCT semantic codec safetensors")
    ap.add_argument("--w2v-bert-dir", help="facebook/w2v-bert-2.0 dir")
    ap.add_argument("--out", help="write converted artifacts here")
    ap.add_argument("--report-json", help="also dump the report as JSON")
    ap.add_argument("--quality-gates", action="store_true",
                    help="run the int8 / int4 teacher-forced logit-KL gates on "
                         "the converted gpt weights")
    ap.add_argument("--gate-steps", type=int, default=96,
                    help="teacher-forced steps per quality-gate trajectory")
    ap.add_argument("--bench", action="store_true",
                    help="after writing --out, build the serving-profile engine "
                         "from the converted artifacts and measure warm "
                         "single-request RTF")
    ap.add_argument("--bench-repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the quality gates and the bench")
    args = ap.parse_args(argv)

    ycfg, cfg_warnings = {}, []
    paths = {}
    if args.model_dir:
        import yaml
        with open(os.path.join(args.model_dir, "config.yaml")) as f:
            ycfg = yaml.safe_load(f)
        for fam, key in (("gpt", "gpt_checkpoint"), ("s2mel", "s2mel_checkpoint")):
            if ycfg.get(key):
                paths[fam] = os.path.join(args.model_dir, ycfg[key])
    for fam, val in (("gpt", args.gpt), ("s2mel", args.s2mel),
                     ("vocoder", args.vocoder), ("campplus", args.campplus),
                     ("repcodec", args.semantic_codec)):
        if val:
            paths[fam] = val
    if args.w2v_bert_dir:
        paths["w2v"] = os.path.join(args.w2v_bert_dir, "model.safetensors")

    if ycfg:
        cfg, cfg_warnings = build_config_from_reference(ycfg)
    else:
        cfg = TTSConfig()

    print("=" * 72)
    print("onboard: config mapping")
    for w in cfg_warnings:
        print(f"  [cfg] {w}")
    if not paths:
        print("no checkpoint paths given: nothing to convert "
              "(see --help for the expected layout)")
        return 1

    ok = True
    report = {"families": {}, "cfg_warnings": cfg_warnings}
    states = {}
    for fam, path in paths.items():
        print("=" * 72)
        print(f"[{fam}] {path}")
        if not os.path.exists(path):
            print("  MISSING file")
            ok = False
            report["families"][fam] = {"error": "missing file"}
            continue
        t0 = time.perf_counter()
        cov = coverage_report(fam, load_state_dict(path), family_renamer(fam, cfg))
        diff = structure_diff(cov["converted"], expected_shapes(fam, cfg))
        n_conv = len(cov["converted"])
        print(f"  source keys: {cov['n_source']}  converted: {n_conv}  "
              f"dropped-by-rule: {len(cov['dropped'])}  "
              f"UNMATCHED: {len(cov['unmatched'])}  "
              f"({time.perf_counter() - t0:.2f} s)")
        for k in cov["unmatched"][:20]:
            print(f"    unmatched: {k}")
        for k in diff["missing"][:20]:
            print(f"    missing in ckpt: {k}")
        for k in diff["mismatched"][:20]:
            print(f"    shape mismatch: {k}")
        for k in diff["extra"][:10]:
            print(f"    extra vs model: {k}")
        fam_ok = not (cov["unmatched"] or diff["missing"] or diff["mismatched"]
                      or diff["extra"])
        print(f"  => {'OK' if fam_ok else 'PROBLEMS'}")
        ok = ok and fam_ok
        report["families"][fam] = {
            "n_source": cov["n_source"], "n_converted": n_conv,
            "dropped": cov["dropped"], "unmatched": cov["unmatched"], **diff}
        states[fam] = cov["converted"]

    if args.quality_gates and "gpt" in states and ok:
        print("=" * 72)
        print(f"quantization quality gates (converted gpt weights, {args.device})")
        from voice_tts_tpu_torch.utils.quality_gate import run_quality_gate
        gate = run_quality_gate(cfg.gpt, states["gpt"], steps=args.gate_steps,
                                device=args.device)
        report["quality_gates"] = gate
        for name, row in gate["teacher_forced"].items():
            print(f"  [{name}] KL mean {row['kl_mean']:.3e} "
                  f"max {row['kl_max']:.3e} "
                  f"top1 {row['top1_agreement']:.3f}")

    if args.out and ok:
        from voice_tts_tpu_torch.utils.artifacts import (load_matrix, save_artifacts,
                                                         w2v_stats)
        extras = {}
        if ycfg.get("w2v_stat") and args.model_dir:
            extras.update(w2v_stats(os.path.join(args.model_dir, ycfg["w2v_stat"])))
        for key in ("emo_matrix", "spk_matrix"):
            if ycfg.get(key) and args.model_dir:
                extras[key + "_raw"] = load_matrix(os.path.join(args.model_dir, ycfg[key]))
        bpe = None
        bpe_rel = (ycfg.get("dataset") or {}).get("bpe_model")
        if bpe_rel and args.model_dir:
            with open(os.path.join(args.model_dir, bpe_rel), "rb") as f:
                bpe = f.read()
        t0 = time.perf_counter()
        save_artifacts(args.out, cfg, states, extras, bpe)
        print(f"artifacts written to {args.out} ({time.perf_counter() - t0:.2f} s)")

    if args.bench and args.out and ok:
        print("=" * 72)
        print(f"end-to-end bench on the converted artifacts (serving profile, "
              f"{args.device})")
        try:
            report["bench"] = _bench(args.out, args.device, args.bench_repeats)
            print(f"  warm RTF (median of {args.bench_repeats}): "
                  f"{report['bench']['rtf']:.4f}")
        except Exception as exc:  # noqa: BLE001 - report, don't lose the run
            traceback.print_exc()
            print(f"  bench failed: {exc!r}")
            report["bench"] = {"error": repr(exc)}
            ok = False

    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=2)
    print("=" * 72)
    print("RESULT:", "OK" if ok else "PROBLEMS FOUND")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

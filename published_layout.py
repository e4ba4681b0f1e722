"""Write a model directory in the published IndexTTS-2 checkpoint layout
from the PyTorch port's model states: the inverse of the port's checkpoint
converters (`voice_tts_tpu_torch/utils/checkpoint.py`), for loading tests
with random weights while the published files are not at hand.

    <root>/IndexTTS/config.yaml                 the reference's key structure
    <root>/IndexTTS/gpt.pth                     flat UnifiedVoice state dict
    <root>/IndexTTS/s2mel.pth                   {"net": {module: {param: ...}}}
    <root>/IndexTTS/wav2vec2bert_stats.pt       {"mean", "var"}
    <root>/IndexTTS/feat1.pt, feat2.pt          spk / emo matrices (bare tensors)
    <root>/bigvgan/bigvgan_generator.pt         {"generator": ...}, weight norm
    <root>/campplus_cn_common.bin               flat CAMPPlus state dict
    <root>/semantic_codec/model.safetensors     RepCodec with its decoder
    <root>/w2v-bert-2.0/model.safetensors       one layer past the tap

Beside each family's parameters the files carry keys that the converters
drop by rule (alias and mask buffers, anti-alias filters, positional
tables, BatchNorm counters, w2v-bert layers past the tap), and the vocoder
its convolutions as weight-norm pairs: `weight_g` / `weight_v`, and
`parametrizations.weight.original0/1` on `conv_pre` / `conv_post`.
Imports torch, numpy, safetensors, PyYAML and the port; never JAX.

    paths = write_published_layout(root, cfg, states, extras)
    python -m voice_tts_tpu_torch.utils.onboard <paths["onboard_args"]...>
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np
import torch

# the reference's per-file names (config.yaml keys and the download paths)
MODEL_DIR = "IndexTTS"
FILES = {
    "gpt": f"{MODEL_DIR}/gpt.pth",
    "s2mel": f"{MODEL_DIR}/s2mel.pth",
    "w2v_stat": f"{MODEL_DIR}/wav2vec2bert_stats.pt",
    "spk_matrix": f"{MODEL_DIR}/feat1.pt",
    "emo_matrix": f"{MODEL_DIR}/feat2.pt",
    "vocoder": "bigvgan/bigvgan_generator.pt",
    "campplus": "campplus_cn_common.bin",
    "repcodec": "semantic_codec/model.safetensors",
    "w2v": "w2v-bert-2.0/model.safetensors",
}


# ---------------------------------------------------------------------------
# port key -> published key, per family
# ---------------------------------------------------------------------------

def _rules(*pairs):
    return [(re.compile(p), t) for p, t in pairs]


_CONF = r"(conditioning_encoder|emo_conditioning_encoder)"
_PERC = r"(perceiver_encoder|emo_perceiver_encoder)"
_GPT_RULES = _rules(
    (rf"^{_CONF}\.sub_conv(\d*)_(weight|bias)$",
     lambda m: f"{m[1]}.embed.conv.{2 * int(m[2] or 0)}.{m[3]}"),
    (rf"^{_CONF}\.sub_out\.(weight|bias)$", r"\1.embed.out.0.\2"),
    (rf"^{_CONF}\.sub_norm\.(weight|bias)$", r"\1.embed.out.1.\2"),
    (rf"^{_CONF}\.layer_(\d+)\.ff_w(1|2)\.(weight|bias)$",
     r"\1.encoders.\2.feed_forward.w_\3.\4"),
    (rf"^{_CONF}\.layer_(\d+)\.(self_attn|conv_module|norm_\w+)\.(.+)$",
     r"\1.encoders.\2.\3.\4"),
    (rf"^{_CONF}\.after_norm\.(weight|bias)$", r"\1.after_norm.\2"),
    (r"^conditioning_encoder\.init\.(weight|bias)$", r"conditioning_encoder.init.\1"),
    (r"^conditioning_encoder\.attn_(\d+)\.(.+)$", r"conditioning_encoder.attn.\1.\2"),
    (rf"^{_PERC}\.(latents|proj_context\.weight|proj_context\.bias|norm\.gamma)$",
     r"\1.\2"),
    (rf"^{_PERC}\.attn_(\d+)\.(to_q|to_kv|to_out)\.weight$", r"\1.layers.\2.0.\3.weight"),
    (rf"^{_PERC}\.ff_(\d+)\.proj_in\.(weight|bias)$", r"\1.layers.\2.1.0.\3"),
    (rf"^{_PERC}\.ff_(\d+)\.proj_out\.(weight|bias)$", r"\1.layers.\2.1.2.\3"),
    (r"^(text_pos_embedding|mel_pos_embedding)\.weight$", r"\1.emb.weight"),
    (r"^gpt\.h_(\d+)\.ln_(1|2)\.(weight|bias)$", r"gpt.h.\1.ln_\2.\3"),
    (r"^gpt\.h_(\d+)\.attn_c_(attn|proj)\.(weight|bias)$", r"gpt.h.\1.attn.c_\2.\3"),
    (r"^gpt\.h_(\d+)\.mlp_c_(fc|proj)\.(weight|bias)$", r"gpt.h.\1.mlp.c_\2.\3"),
    (r"^(text_embedding|mel_embedding|speed_emb|emovec_layer|emo_layer|text_head"
     r"|mel_head|final_norm|gpt\.ln_f)\.(weight|bias)$", r"\1.\2"),
)

_EST = "models.cfm.estimator"
_S2MEL_RULES = _rules(
    (r"^gpt_layer_(\d)\.(weight|bias)$", r"models.gpt_layer.\1.\2"),
    (r"^length_regulator\.content_in_proj\.(weight|bias)$",
     r"models.length_regulator.content_in_proj.\1"),
    (r"^length_regulator\.conv_(\d+)\.(weight|bias)$",
     lambda m: f"models.length_regulator.model.{3 * int(m[1])}.{m[2]}"),
    (r"^length_regulator\.norm_(\d+)\.(weight|bias)$",
     lambda m: f"models.length_regulator.model.{3 * int(m[1]) + 1}.{m[2]}"),
    (r"^estimator\.(t_embedder2?)\.mlp_(\d)\.(weight|bias)$", rf"{_EST}.\1.mlp.\2.\3"),
    (r"^estimator\.block_(\d+)\.(wqkv|wo)\.weight$",
     rf"{_EST}.transformer.layers.\1.attention.\2.weight"),
    (r"^estimator\.block_(\d+)\.(w[123])\.weight$",
     rf"{_EST}.transformer.layers.\1.feed_forward.\2.weight"),
    (r"^estimator\.block_(\d+)\.(attention_norm|ffn_norm)\.(.+)$",
     rf"{_EST}.transformer.layers.\1.\2.\3"),
    (r"^estimator\.transformer_norm\.(.+)$", rf"{_EST}.transformer.norm.\1"),
    (r"^estimator\.final_layer\.adaLN_1\.(weight|bias)$",
     rf"{_EST}.final_layer.adaLN_modulation.1.\1"),
    (r"^estimator\.final_layer\.linear\.(weight|bias)$", rf"{_EST}.final_layer.linear.\1"),
    (r"^estimator\.wavenet\.in_layer_(\d+)\.conv\.(weight|bias)$",
     rf"{_EST}.wavenet.in_layers.\1.conv.conv.\2"),
    (r"^estimator\.wavenet\.res_skip_(\d+)\.conv\.(weight|bias)$",
     rf"{_EST}.wavenet.res_skip_layers.\1.conv.conv.\2"),
    (r"^estimator\.wavenet\.cond_layer\.conv\.(weight|bias)$",
     rf"{_EST}.wavenet.cond_layer.conv.conv.\1"),
    (r"^estimator\.(cond_projection|cond_x_merge_linear|skip_linear|conv1|conv2"
     r"|res_projection)\.(weight|bias)$", rf"{_EST}.\1.\2"),
)

_VOCODER_RULES = _rules(
    (r"^(conv_pre|conv_post)\.(weight|bias)$", r"\1.\2"),
    (r"^ups_(\d+)\.(weight|bias)$", r"ups.\1.0.\2"),
    (r"^resblocks_(\d+)\.convs(1|2)_(\d+)\.(weight|bias)$", r"resblocks.\1.convs\2.\3.\4"),
    (r"^resblocks_(\d+)\.act_(\d+)\.(alpha|beta)$", r"resblocks.\1.activations.\2.act.\3"),
    (r"^activation_post\.(alpha|beta)$", r"activation_post.act.\1"),
)

_BN = r"(weight|bias|running_mean|running_var)"
_CAMPPLUS_RULES = _rules(
    (r"^head\.(conv\d|bn\d)\.(.+)$", r"head.\1.\2"),
    (r"^head\.layer(\d)_(\d)\.shortcut_conv\.weight$", r"head.layer\1.\2.shortcut.0.weight"),
    (rf"^head\.layer(\d)_(\d)\.shortcut_bn\.{_BN}$", r"head.layer\1.\2.shortcut.1.\3"),
    (r"^head\.layer(\d)_(\d)\.(conv\d|bn\d)\.(.+)$", r"head.layer\1.\2.\3.\4"),
    (r"^tdnn_linear\.weight$", r"xvector.tdnn.linear.weight"),
    (rf"^tdnn_bn\.{_BN}$", r"xvector.tdnn.nonlinear.batchnorm.\1"),
    (rf"^(block\d)_(tdnnd\d+)\.nonlinear(\d)_bn\.{_BN}$",
     r"xvector.\1.\2.nonlinear\3.batchnorm.\4"),
    (r"^(block\d)_(tdnnd\d+)\.(linear1\.weight|cam_layer\..+)$", r"xvector.\1.\2.\3"),
    (rf"^transit(\d)_bn\.{_BN}$", r"xvector.transit\1.nonlinear.batchnorm.\2"),
    (r"^transit(\d)_linear\.weight$", r"xvector.transit\1.linear.weight"),
    (rf"^out_bn\.{_BN}$", r"xvector.out_nonlinear.batchnorm.\1"),
    (r"^dense_linear\.weight$", r"xvector.dense.linear.weight"),
    (rf"^dense_bn\.{_BN}$", r"xvector.dense.nonlinear.batchnorm.\1"),
)

_REPCODEC_RULES = _rules(
    (r"^(encoder|decoder)_backbone\.convnext_(\d+)\.(.+)$", r"\1.0.convnext.\2.\3"),
    (r"^(encoder|decoder)_backbone\.(.+)$", r"\1.0.\2"),
    (r"^(encoder|decoder)_out\.(weight|bias)$", r"\1.1.\2"),
    (r"^(down|up)\.(weight|bias)$", r"\1.\2"),
    (r"^quantizer\.codebook$", r"quantizer.quantizers.0.codebook.weight"),
    (r"^quantizer\.(in_project|out_project)\.(weight|bias)$",
     r"quantizer.quantizers.0.\1.\2"),
)

_W2V_RULES = _rules(
    (r"^fp_layer_norm\.(weight|bias)$", r"feature_projection.layer_norm.\1"),
    (r"^fp_projection\.(weight|bias)$", r"feature_projection.projection.\1"),
    (r"^layer_(\d+)\.self_attn\.distance_embedding$",
     r"encoder.layers.\1.self_attn.distance_embedding.weight"),
    (r"^layer_(\d+)\.(.+)$", r"encoder.layers.\1.\2"),
)

RULES = {"gpt": _GPT_RULES, "s2mel": _S2MEL_RULES, "vocoder": _VOCODER_RULES,
         "campplus": _CAMPPLUS_RULES, "repcodec": _REPCODEC_RULES, "w2v": _W2V_RULES}


def published_name(family: str, key: str, cfg=None) -> str:
    """The published checkpoint key of the port's state key `key`."""
    if family == "s2mel" and key.startswith("length_regulator.conv_out."):
        nsr = cfg.s2mel.length_regulator.num_sampling_ratios
        return f"models.length_regulator.model.{3 * nsr}.{key.rsplit('.', 1)[1]}"
    for pat, tmpl in RULES[family]:
        m = pat.match(key)
        if m:
            return m.expand(tmpl) if isinstance(tmpl, str) else tmpl(m)
    raise KeyError(f"{family}: no published name for {key!r}")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True).contiguous()


def _weight_norm_pair(w: torch.Tensor):
    """(g, v) with g * v / ||v|| = w up to f32 rounding: v = w, g its norm
    over every dim but 0 (torch's weight_norm dim=0)."""
    g = torch.linalg.vector_norm(w.double(), dim=tuple(range(1, w.dim())), keepdim=True)
    return g.to(w.dtype), w


def published_state(family: str, state: Dict[str, torch.Tensor], cfg,
                    gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The published key -> tensor dict of one family (CPU tensors), with
    the keys the converters drop and, for the vocoder, weight-norm pairs;
    `gen` draws what the port's state does not hold (w2v-bert's layer past
    the tap, its masked_spec_embed)."""
    out = {published_name(family, k, cfg): _cpu(v) for k, v in state.items()}
    if family == "gpt":
        out["gpt.wte.weight"] = out["mel_embedding.weight"].clone()
        for i in range(cfg.gpt.layers):
            out[f"gpt.h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    elif family == "s2mel":
        d = cfg.s2mel.dit
        out[f"{_EST}.input_pos"] = torch.arange(d.block_size)
        for t in ("t_embedder", "t_embedder2"):
            out[f"{_EST}.{t}.freqs"] = torch.exp(
                -np.log(10000.0) * torch.arange(128, dtype=torch.float32) / 128)
    elif family == "vocoder":
        for key in [k for k in out if k.endswith(".weight") and out[k].dim() == 3]:
            base = key[:-len("weight")]
            g, v = _weight_norm_pair(out.pop(key))
            if base in ("conv_pre.", "conv_post."):
                out[base + "parametrizations.weight.original0"] = g
                out[base + "parametrizations.weight.original1"] = v
            else:
                out[base + "weight_g"], out[base + "weight_v"] = g, v
        for key in [k for k in out if k.endswith(".act.alpha")]:
            base = key[:-len("act.alpha")]
            out[base + "upsample.filter"] = torch.ones(1, 1, 12) / 12
            out[base + "downsample.lowpass.filter"] = torch.ones(1, 1, 12) / 12
    elif family == "campplus":
        for key in [k for k in out if k.endswith(".running_var")]:
            out[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    elif family == "w2v":
        tap = cfg.w2v_bert.output_layer
        src = f"encoder.layers.{tap - 1}."
        for key in [k for k in out if k.startswith(src)]:
            past = key.replace(src, f"encoder.layers.{tap}.", 1)
            out[past] = torch.randn(out[key].shape, generator=gen) * 0.02
        out["masked_spec_embed"] = torch.rand(cfg.w2v_bert.hidden_size, generator=gen)
    return out


def _split_modules(flat: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """`models.<module>.<param>` -> the s2mel trainer's {module: {param}}."""
    net: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in flat.items():
        _, module, param = key.split(".", 2)
        net.setdefault(module, {})[param] = val
    return net


def published_config(cfg) -> dict:
    """The reference's `config.yaml` tree for `cfg` (the keys the published
    file carries, with `cfg`'s values); `build_config_from_reference` maps
    it back onto `cfg`'s GPT, s2mel and codec widths."""
    g, s, sc = cfg.gpt, cfg.s2mel, cfg.semantic_codec
    d, wn, lr = s.dit, s.wavenet, s.length_regulator

    def conformer(m):
        return {"input_size": m.input_size, "output_size": m.output_size,
                "linear_units": m.linear_units, "attention_heads": m.attention_heads,
                "num_blocks": m.num_blocks, "input_layer": m.input_layer,
                "perceiver_mult": m.perceiver_mult}

    return {
        "dataset": {"sample_rate": 24000, "squeeze": False,
                    "mel": {"sample_rate": 24000, "n_fft": 1024, "hop_length": 256,
                            "win_length": 1024, "n_mels": 100, "mel_fmin": 0,
                            "normalize": False}},
        "gpt": {"model_dim": g.model_dim, "max_mel_tokens": g.max_mel_tokens,
                "max_text_tokens": g.max_text_tokens, "heads": g.heads,
                "use_mel_codes_as_input": True, "mel_length_compression": 1024,
                "layers": g.layers, "number_text_tokens": g.number_text_tokens,
                "number_mel_codes": g.number_mel_codes,
                "start_mel_token": g.start_mel_token, "stop_mel_token": g.stop_mel_token,
                "start_text_token": g.start_text_token,
                "stop_text_token": g.stop_text_token, "train_solo_embeddings": False,
                "condition_type": g.condition_type,
                "condition_num_latent": g.condition_num_latent, "emo_dim": g.emo_dim,
                "condition_module": conformer(g.condition_module),
                "emo_condition_module": conformer(g.emo_condition_module)},
        "semantic_codec": {"codebook_size": sc.codebook_size,
                           "hidden_size": sc.hidden_size,
                           "codebook_dim": sc.codebook_dim, "vocos_dim": sc.vocos_dim,
                           "vocos_intermediate_dim": sc.vocos_intermediate_dim,
                           "vocos_num_layers": sc.vocos_num_layers,
                           "downsample_scale": sc.downsample_scale},
        "s2mel": {
            "preprocess_params": {"sr": cfg.mel.sample_rate, "spect_params": {
                "n_fft": cfg.mel.n_fft, "win_length": cfg.mel.win_size,
                "hop_length": cfg.mel.hop_size, "n_mels": cfg.mel.num_mels,
                "fmin": 0, "fmax": "None"}},
            "dit_type": "DiT", "reg_loss_type": "l1",
            "style_encoder": {"dim": d.style_dim},
            "length_regulator": {"channels": lr.channels, "is_discrete": False,
                                 "in_channels": sc.hidden_size,
                                 "content_codebook_size": lr.codebook_size,
                                 "sampling_ratios": [1] * lr.num_sampling_ratios,
                                 "vector_quantize": False, "n_codebooks": lr.n_codebooks,
                                 "quantizer_dropout": 0.0, "f0_condition": False,
                                 "n_f0_bins": 512},
            "DiT": {"hidden_dim": d.hidden_dim, "num_heads": d.num_heads,
                    "depth": d.depth, "class_dropout_prob": 0.1,
                    "block_size": d.block_size, "in_channels": d.in_channels,
                    "style_condition": True, "final_layer_type": d.final_layer_type,
                    "target": "mel", "content_dim": d.content_dim,
                    "content_codebook_size": 1024, "content_type": "discrete",
                    "f0_condition": False, "n_f0_bins": 512, "content_codebooks": 1,
                    "is_causal": d.is_causal,
                    "long_skip_connection": d.long_skip_connection,
                    "zero_prompt_speech_token": False, "time_as_token": False,
                    "style_as_token": False, "uvit_skip_connection": True,
                    "add_resblock_in_transformer": False},
            "wavenet": {"hidden_dim": wn.hidden_dim, "num_layers": wn.num_layers,
                        "kernel_size": wn.kernel_size, "dilation_rate": wn.dilation_rate,
                        "p_dropout": 0.2, "style_condition": True}},
        "gpt_checkpoint": os.path.basename(FILES["gpt"]),
        "w2v_stat": os.path.basename(FILES["w2v_stat"]),
        "s2mel_checkpoint": os.path.basename(FILES["s2mel"]),
        "emo_matrix": os.path.basename(FILES["emo_matrix"]),
        "spk_matrix": os.path.basename(FILES["spk_matrix"]),
        "emo_num": list(cfg.engine.emo_num),
        "qwen_emo_path": "qwen0.6bemo4-merge/",
        "vocoder": {"type": "bigvgan", "name": "nvidia/bigvgan_v2_22khz_80band_256x"},
        "version": 2.0,
    }


def write_published_layout(root: str, cfg, states: Dict[str, Dict[str, torch.Tensor]],
                           extras: dict, seed: int = 0) -> dict:
    """Write the layout under `root` from the six families' port states
    (f32; RepCodec with or without its decoder: a missing decoder is drawn
    from `seed`) and `extras` (`w2v_mean`, `w2v_std`, and the `emo_matrix`
    / `spk_matrix` groups).  Returns {"paths": {name: path}, "bytes": n,
    "onboard_args": [...]} (the arguments of `utils.onboard` that convert
    it)."""
    import yaml
    from safetensors.torch import save_file

    from voice_tts_tpu_torch.models.conditioning.repcodec import RepCodec
    from voice_tts_tpu_torch.models.layers import init_weights

    gen = torch.Generator().manual_seed(seed)
    paths = {name: os.path.join(root, rel) for name, rel in FILES.items()}
    for path in paths.values():
        os.makedirs(os.path.dirname(path), exist_ok=True)
    rep = dict(states["repcodec"])
    if "decoder_out.weight" not in rep:
        full = init_weights(RepCodec(cfg.semantic_codec, decoder=True), gen)
        rep.update({k: v for k, v in full.state_dict().items()
                    if k.startswith("decoder_")})
    pub = {fam: published_state(fam, rep if fam == "repcodec" else states[fam], cfg, gen)
           for fam in ("gpt", "s2mel", "vocoder", "campplus", "repcodec", "w2v")}

    with open(os.path.join(root, MODEL_DIR, "config.yaml"), "w") as f:
        yaml.safe_dump(published_config(cfg), f, sort_keys=False, allow_unicode=True)
    torch.save(pub["gpt"], paths["gpt"])
    torch.save({"net": _split_modules(pub["s2mel"]), "epoch": 0}, paths["s2mel"])
    torch.save({"generator": pub["vocoder"]}, paths["vocoder"])
    torch.save(pub["campplus"], paths["campplus"])
    save_file(pub["repcodec"], paths["repcodec"])
    save_file(pub["w2v"], paths["w2v"])
    std = torch.as_tensor(np.asarray(extras["w2v_std"], np.float32))
    torch.save({"mean": torch.as_tensor(np.asarray(extras["w2v_mean"], np.float32)),
                "var": std * std}, paths["w2v_stat"])
    for key in ("emo_matrix", "spk_matrix"):
        torch.save(torch.from_numpy(np.concatenate(
            [np.asarray(m, np.float32) for m in extras[key]])), paths[key])
    n_bytes = sum(os.path.getsize(os.path.join(dp, fn))
                  for dp, _, fns in os.walk(root) for fn in fns)
    args: List[str] = [
        "--model-dir", os.path.join(root, MODEL_DIR),
        "--vocoder", paths["vocoder"], "--campplus", paths["campplus"],
        "--semantic-codec", paths["repcodec"],
        "--w2v-bert-dir", os.path.dirname(paths["w2v"])]
    return {"paths": paths, "bytes": n_bytes, "onboard_args": args,
            "published": {fam: sorted(p) for fam, p in pub.items()}}

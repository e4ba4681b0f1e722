"""Checkpoint conversion: the published torch / safetensors state dicts ->
the port's `state_dict`s (`voice_tts_tpu/utils/checkpoint.py`).

One converter per model family.  Every converter

- folds weight norm (`weight_g` / `weight_v` or parametrizations) into
  plain weights, as the reference removes weight norm before inference;
- keeps the torch tensor layouts (the port's layers store torch-layout
  weights), so the mapping is a pure rename;
- drops buffers that are recomputed (anti-alias `filter`, positional
  tables) and dead-at-inference pieces.

A converter returns the port module's flat `state_dict`: the JAX
converter's parameter path with dots for slashes (`flatten_params` of the
JAX tree), CPU tensors with the source's values.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# loading + generic transforms
# ---------------------------------------------------------------------------

def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(np.asarray(v)))


def load_state_dict(path: str, load_ema: bool = False) -> State:
    """Load a .pt / .pth / .bin (torch pickle) or .safetensors file.

    Handles every wrapper shape the reference loaders accept: flat state
    dicts, single-key wrappers (generator / model / state_dict / net), and
    the s2mel trainer's module-keyed nesting `state["net"][module][param]`,
    flattened to the `models.<module>.<param>` names the renamer rules
    expect.  `load_ema=True` substitutes the EMA shadow weights:
    `state["ema"][module][0]` is a positional tensor list aligned with the
    module's parameter order, skipping `input_pos`.  The pickle is loaded
    with `weights_only=False` (the published files hold plain containers
    of tensors, and the trainer's files more): load only trusted files.
    """
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    ema = None
    if isinstance(obj, dict):
        if load_ema and isinstance(obj.get("ema"), dict):
            ema = obj["ema"]
        for key in ("generator", "model", "state_dict", "net"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    if (isinstance(obj, dict) and obj
            and all(isinstance(v, dict) for v in obj.values())):
        # module-keyed nesting (the s2mel trainer's format)
        if ema is not None:
            obj = {mk: dict(sub) for mk, sub in obj.items()}
            for mk, sub in obj.items():
                if mk not in ema:
                    continue
                shadow = ema[mk][0]
                i = 0
                for pk in sub:
                    if "input_pos" in pk:
                        continue
                    if tuple(sub[pk].shape) != tuple(shadow[i].shape):
                        raise ValueError(f"{path}: EMA shadow {mk}[{i}] has shape "
                                         f"{tuple(shadow[i].shape)}, {mk}.{pk} "
                                         f"{tuple(sub[pk].shape)}")
                    sub[pk] = shadow[i]
                    i += 1
        obj = {f"models.{mk}.{pk}": pv
               for mk, sub in obj.items() for pk, pv in sub.items()}
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(obj).__name__}")
    return {k: _tensor(v) for k, v in obj.items()}


def strip_ddp_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove 'module.' prefixes left by DDP training."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def fold_weight_norm(sd: Mapping[str, Any]) -> State:
    """Replace (weight_g, weight_v) pairs with weight = g * v / ||v||.

    Handles both classic `foo.weight_g` and parametrized
    `foo.parametrizations.weight.original0/1` naming.  The norm is over
    every dim but 0 (torch's weight_norm default dim=0), summed in float64;
    g * v is a product in v's dtype, divided by the norm in float64 and
    rounded back: the JAX converter's arithmetic, bit for bit.
    """
    out: State = {}
    done = set()
    for key in sd:
        if key in done:
            continue
        m = re.match(r"^((?:.*\.)?)weight_g$", key)
        p = re.match(r"^((?:.*\.)?)parametrizations\.weight\.original0$", key)
        if m:
            base = m.group(1)  # '' or 'prefix.'
            v_key = base + "weight_v"
        elif p:
            base = p.group(1)
            v_key = base + "parametrizations.weight.original1"
        else:
            continue
        g, v = _tensor(sd[key]).numpy(), _tensor(sd[v_key]).numpy()
        done.update({key, v_key})
        axes = tuple(range(1, v.ndim))
        norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
        out[base + "weight"] = torch.from_numpy(
            (g.reshape(norm.shape) * v / norm).astype(v.dtype))
    for key, val in sd.items():
        if key not in done:
            out[key] = _tensor(val)
    return out


class Renamer:
    """Regex rename rules mapping checkpoint keys to the port's keys; a
    rule whose target is None drops the key."""

    def __init__(self):
        self.rules: list[tuple[re.Pattern, Any]] = []

    def rule(self, pattern: str, repl) -> "Renamer":
        self.rules.append((re.compile(pattern), repl))
        return self

    def __call__(self, key: str):
        for pat, repl in self.rules:
            m = pat.match(key)
            if m:
                if repl is None:
                    return None
                return m.expand(repl) if isinstance(repl, str) else repl(m)
        raise KeyError(f"no rename rule for checkpoint key {key!r}")


def convert(sd: Mapping[str, Any], renamer: Renamer) -> State:
    """Fold weight norm, strip DDP prefixes and rename: the port's state."""
    out: State = {}
    for key, val in fold_weight_norm(strip_ddp_prefix(sd)).items():
        target = renamer(key)
        if target is not None:
            out[target] = val
    return out


# ---------------------------------------------------------------------------
# BigVGAN (reference `s2mel/modules/bigvgan/bigvgan.py`)
# ---------------------------------------------------------------------------

def bigvgan_renamer() -> Renamer:
    r = Renamer()
    r.rule(r"^conv_pre\.(weight|bias)$", r"conv_pre.\1")
    r.rule(r"^ups\.(\d+)\.0\.(weight|bias)$", r"ups_\1.\2")
    r.rule(r"^resblocks\.(\d+)\.convs1\.(\d+)\.(weight|bias)$", r"resblocks_\1.convs1_\2.\3")
    r.rule(r"^resblocks\.(\d+)\.convs2\.(\d+)\.(weight|bias)$", r"resblocks_\1.convs2_\2.\3")
    r.rule(r"^resblocks\.(\d+)\.activations\.(\d+)\.act\.(alpha|beta)$",
           r"resblocks_\1.act_\2.\3")
    r.rule(r"^activation_post\.act\.(alpha|beta)$", r"activation_post.\1")
    r.rule(r"^conv_post\.(weight|bias)$", r"conv_post.\1")
    # anti-alias filter buffers are constants rebuilt from the formula
    r.rule(r".*\.(upsample|downsample|lowpass)[\.\w]*filter$", None)
    return r


def convert_bigvgan(sd: Mapping[str, Any]) -> State:
    return convert(sd, bigvgan_renamer())


# ---------------------------------------------------------------------------
# CAMPPlus (reference `s2mel/modules/campplus/DTDNN.py`)
# ---------------------------------------------------------------------------

def campplus_renamer() -> Renamer:
    bn = r"(weight|bias|running_mean|running_var)"
    r = Renamer()
    r.rule(r".*num_batches_tracked$", None)
    r.rule(r"^head\.conv(\d)\.weight$", r"head.conv\1.weight")
    r.rule(rf"^head\.bn(\d)\.{bn}$", r"head.bn\1.\2")
    r.rule(r"^head\.layer(\d)\.(\d)\.conv(\d)\.weight$", r"head.layer\1_\2.conv\3.weight")
    r.rule(rf"^head\.layer(\d)\.(\d)\.bn(\d)\.{bn}$", r"head.layer\1_\2.bn\3.\4")
    r.rule(r"^head\.layer(\d)\.(\d)\.shortcut\.0\.weight$", r"head.layer\1_\2.shortcut_conv.weight")
    r.rule(rf"^head\.layer(\d)\.(\d)\.shortcut\.1\.{bn}$", r"head.layer\1_\2.shortcut_bn.\3")
    r.rule(r"^xvector\.tdnn\.linear\.weight$", r"tdnn_linear.weight")
    r.rule(rf"^xvector\.tdnn\.nonlinear\.batchnorm\.{bn}$", r"tdnn_bn.\1")
    r.rule(rf"^xvector\.(block\d)\.(tdnnd\d+)\.nonlinear(\d)\.batchnorm\.{bn}$",
           r"\1_\2.nonlinear\3_bn.\4")
    r.rule(r"^xvector\.(block\d)\.(tdnnd\d+)\.linear1\.weight$", r"\1_\2.linear1.weight")
    r.rule(r"^xvector\.(block\d)\.(tdnnd\d+)\.cam_layer\.(linear_local|linear1|linear2)\.(weight|bias)$",
           r"\1_\2.cam_layer.\3.\4")
    r.rule(rf"^xvector\.transit(\d)\.nonlinear\.batchnorm\.{bn}$", r"transit\1_bn.\2")
    r.rule(r"^xvector\.transit(\d)\.linear\.weight$", r"transit\1_linear.weight")
    r.rule(rf"^xvector\.out_nonlinear\.batchnorm\.{bn}$", r"out_bn.\1")
    r.rule(r"^xvector\.dense\.linear\.weight$", r"dense_linear.weight")
    r.rule(rf"^xvector\.dense\.nonlinear\.batchnorm\.{bn}$", r"dense_bn.\1")
    return r


def convert_campplus(sd: Mapping[str, Any]) -> State:
    return convert(sd, campplus_renamer())


# ---------------------------------------------------------------------------
# RepCodec semantic codec (reference `kmeans/repcodec_model.py`)
# ---------------------------------------------------------------------------

def repcodec_renamer() -> Renamer:
    r = Renamer()
    for side in ("encoder", "decoder"):
        r.rule(rf"^{side}\.0\.(embed|norm|final_layer_norm)\.(weight|bias)$",
               rf"{side}_backbone.\1.\2")
        r.rule(rf"^{side}\.0\.convnext\.(\d+)\.(dwconv|norm|pwconv1|pwconv2)\.(weight|bias)$",
               rf"{side}_backbone.convnext_\1.\2.\3")
        r.rule(rf"^{side}\.0\.convnext\.(\d+)\.gamma$", rf"{side}_backbone.convnext_\1.gamma")
        r.rule(rf"^{side}\.1\.(weight|bias)$", rf"{side}_out.\1")
    r.rule(r"^(down|up)\.(weight|bias)$", r"\1.\2")
    r.rule(r"^quantizer\.quantizers\.0\.(in_project|out_project)\.(weight|bias)$",
           r"quantizer.\1.\2")
    r.rule(r"^quantizer\.quantizers\.0\.codebook\.weight$", r"quantizer.codebook")
    return r


def convert_repcodec(sd: Mapping[str, Any]) -> State:
    return convert(sd, repcodec_renamer())


# ---------------------------------------------------------------------------
# w2v-bert-2.0 (HF `Wav2Vec2BertModel`)
# ---------------------------------------------------------------------------

def w2v_bert_renamer(output_layer: int) -> Renamer:
    r = Renamer()
    r.rule(r"^masked_spec_embed$", None)
    r.rule(r"^feature_projection\.layer_norm\.(weight|bias)$", r"fp_layer_norm.\1")
    r.rule(r"^feature_projection\.projection\.(weight|bias)$", r"fp_projection.\1")

    def layer_rule(m):
        idx = int(m.group(1))
        if idx >= output_layer:
            return None  # truncated: layers past the tap are dead weight
        # the relative-position table is a bare parameter in the port
        return f"layer_{idx}.{m.group(2)}".replace(
            "self_attn.distance_embedding.weight", "self_attn.distance_embedding")

    r.rule(r"^encoder\.layers\.(\d+)\.(.+?)\.?$", layer_rule)
    return r


def convert_w2v_bert(sd: Mapping[str, Any], output_layer: int = 17) -> State:
    return convert(sd, w2v_bert_renamer(output_layer))


# ---------------------------------------------------------------------------
# UnifiedVoice GPT (reference `indextts/gpt/model_v2.py`)
# ---------------------------------------------------------------------------

def _add_conformer_rules(r: Renamer, src: str, dst: str) -> None:
    """Rules for a wenet ConformerEncoder subtree (`conformer_encoder.py`)."""
    # Conv2dSubsampling{2,4,6,8}: torch Sequential interleaves ReLU, so conv
    # stage i lives at `embed.conv.{2i}`; the port names stage 0 `sub_conv_*`
    # and stage i > 0 `sub_conv{i}_*` (models/gpt/conformer.py)
    def sub_conv(m):
        stage = int(m.group(1)) // 2
        tag = "" if stage == 0 else str(stage)
        return f"{dst}.sub_conv{tag}_{m.group(2)}"

    r.rule(rf"^{src}\.embed\.conv\.(\d+)\.(weight|bias)$", sub_conv)
    r.rule(rf"^{src}\.embed\.out\.0\.(weight|bias)$", rf"{dst}.sub_out.\1")
    # Conv2dSubsampling6/8 name the output projection `linear`, not `out.0`
    r.rule(rf"^{src}\.embed\.linear\.(weight|bias)$", rf"{dst}.sub_out.\1")
    r.rule(rf"^{src}\.embed\.out\.1\.(weight|bias)$", rf"{dst}.sub_norm.\1")
    r.rule(rf"^{src}\.embed\.pos_enc\..*$", None)
    r.rule(rf"^{src}\.encoders\.(\d+)\.self_attn\.(linear_(?:q|k|v|out|pos))\.(weight|bias)$",
           rf"{dst}.layer_\1.self_attn.\2.\3")
    r.rule(rf"^{src}\.encoders\.(\d+)\.self_attn\.(pos_bias_[uv])$",
           rf"{dst}.layer_\1.self_attn.\2")
    r.rule(rf"^{src}\.encoders\.(\d+)\.feed_forward\.w_1\.(weight|bias)$",
           rf"{dst}.layer_\1.ff_w1.\2")
    r.rule(rf"^{src}\.encoders\.(\d+)\.feed_forward\.w_2\.(weight|bias)$",
           rf"{dst}.layer_\1.ff_w2.\2")
    r.rule(rf"^{src}\.encoders\.(\d+)\.conv_module\.(pointwise_conv1|depthwise_conv|pointwise_conv2)\.(weight|bias)$",
           rf"{dst}.layer_\1.conv_module.\2.\3")
    r.rule(rf"^{src}\.encoders\.(\d+)\.conv_module\.norm\.(weight|bias)$",
           rf"{dst}.layer_\1.conv_module.norm.\2")
    r.rule(rf"^{src}\.encoders\.(\d+)\.(norm_(?:mha|conv|ff|final))\.(weight|bias)$",
           rf"{dst}.layer_\1.\2.\3")
    r.rule(rf"^{src}\.after_norm\.(weight|bias)$", rf"{dst}.after_norm.\1")


def _add_perceiver_rules(r: Renamer, src: str, dst: str) -> None:
    """Rules for a PerceiverResampler subtree (`perceiver.py:224-281`)."""
    r.rule(rf"^{src}\.latents$", rf"{dst}.latents")
    r.rule(rf"^{src}\.proj_context\.(weight|bias)$", rf"{dst}.proj_context.\1")
    r.rule(rf"^{src}\.layers\.(\d+)\.0\.(to_q|to_kv|to_out)\.weight$",
           rf"{dst}.attn_\1.\2.weight")
    r.rule(rf"^{src}\.layers\.(\d+)\.1\.0\.(weight|bias)$", rf"{dst}.ff_\1.proj_in.\2")
    r.rule(rf"^{src}\.layers\.(\d+)\.1\.2\.(weight|bias)$", rf"{dst}.ff_\1.proj_out.\2")
    r.rule(rf"^{src}\.norm\.gamma$", rf"{dst}.norm.gamma")


def unified_voice_renamer() -> Renamer:
    r = Renamer()
    r.rule(r"^inference_model\..*", None)       # weight-shared wrapper
    r.rule(r"^gpt\.wte\..*", None)              # alias of mel_embedding
    r.rule(r"^gpt\.h\.\d+\.attn\.(bias|masked_bias)$", None)  # mask buffers
    r.rule(r"^(cond_mask_pad|emo_cond_mask_pad)\..*", None)
    _add_conformer_rules(r, "conditioning_encoder", "conditioning_encoder")
    # condition_type="perceiver" branch (the reference ctor default): a
    # Conv1d stem + AttentionBlocks instead of the conformer
    r.rule(r"^conditioning_encoder\.init\.(weight|bias)$", r"conditioning_encoder.init.\1")
    r.rule(r"^conditioning_encoder\.attn\.(\d+)\.(norm|qkv|proj_out)\.(weight|bias)$",
           r"conditioning_encoder.attn_\1.\2.\3")
    _add_perceiver_rules(r, "perceiver_encoder", "perceiver_encoder")
    _add_conformer_rules(r, "emo_conditioning_encoder", "emo_conditioning_encoder")
    _add_perceiver_rules(r, "emo_perceiver_encoder", "emo_perceiver_encoder")
    r.rule(r"^(text_embedding|mel_embedding|speed_emb)\.weight$", r"\1.weight")
    r.rule(r"^(text_pos_embedding|mel_pos_embedding)\.emb\.weight$", r"\1.weight")
    r.rule(r"^(emovec_layer|emo_layer|text_head|mel_head)\.(weight|bias)$", r"\1.\2")
    r.rule(r"^final_norm\.(weight|bias)$", r"final_norm.\1")
    r.rule(r"^gpt\.h\.(\d+)\.ln_(1|2)\.(weight|bias)$", r"gpt.h_\1.ln_\2.\3")
    r.rule(r"^gpt\.h\.(\d+)\.attn\.c_(attn|proj)\.(weight|bias)$", r"gpt.h_\1.attn_c_\2.\3")
    r.rule(r"^gpt\.h\.(\d+)\.mlp\.c_(fc|proj)\.(weight|bias)$", r"gpt.h_\1.mlp_c_\2.\3")
    r.rule(r"^gpt\.ln_f\.(weight|bias)$", r"gpt.ln_f.\1")
    return r


def convert_unified_voice(sd: Mapping[str, Any]) -> State:
    return convert(sd, unified_voice_renamer())


# ---------------------------------------------------------------------------
# s2mel / MyModel (reference `s2mel/modules/commons.py:388-438` + DiT + WN)
# ---------------------------------------------------------------------------

def s2mel_renamer(num_sampling_ratios: int) -> Renamer:
    r = Renamer()
    # dead-at-inference / recomputed pieces
    r.rule(r".*t_embedder\d*\.freqs$", None)
    r.rule(r"^models\.cfm\.estimator\.input_pos$", None)
    r.rule(r"^models\.cfm\.estimator\.x_embedder\..*", None)
    r.rule(r"^models\.cfm\.estimator\.(cond_embedder|content_mask_embedder)\..*", None)
    r.rule(r"^models\.length_regulator\.(embedding\.weight|mask_token)$", None)

    r.rule(r"^models\.gpt_layer\.(\d)\.(weight|bias)$", r"gpt_layer_\1.\2")
    r.rule(r"^models\.length_regulator\.content_in_proj\.(weight|bias)$",
           r"length_regulator.content_in_proj.\1")

    def lr_model(m):
        idx, leaf = int(m.group(1)), m.group(2)
        if idx == 3 * num_sampling_ratios:
            return f"length_regulator.conv_out.{leaf}"
        if idx % 3 == 0:
            return f"length_regulator.conv_{idx // 3}.{leaf}"
        if idx % 3 == 1:
            return f"length_regulator.norm_{idx // 3}.{leaf}"
        raise KeyError(f"unexpected length_regulator.model index {idx}")

    r.rule(r"^models\.length_regulator\.model\.(\d+)\.(weight|bias)$", lr_model)

    e = r"^models\.cfm\.estimator\."
    r.rule(e + r"t_embedder\.mlp\.(\d)\.(weight|bias)$", r"estimator.t_embedder.mlp_\1.\2")
    r.rule(e + r"t_embedder2\.mlp\.(\d)\.(weight|bias)$", r"estimator.t_embedder2.mlp_\1.\2")
    r.rule(e + r"transformer\.layers\.(\d+)\.attention\.(wqkv|wo)\.weight$",
           r"estimator.block_\1.\2.weight")
    r.rule(e + r"transformer\.layers\.(\d+)\.feed_forward\.(w[123])\.weight$",
           r"estimator.block_\1.\2.weight")
    r.rule(e + r"transformer\.layers\.(\d+)\.(attention_norm|ffn_norm)\.project_layer\.(weight|bias)$",
           r"estimator.block_\1.\2.project_layer.\3")
    r.rule(e + r"transformer\.layers\.(\d+)\.(attention_norm|ffn_norm)\.norm\.weight$",
           r"estimator.block_\1.\2.norm.weight")
    r.rule(e + r"transformer\.norm\.project_layer\.(weight|bias)$",
           r"estimator.transformer_norm.project_layer.\1")
    r.rule(e + r"transformer\.norm\.norm\.weight$", r"estimator.transformer_norm.norm.weight")
    r.rule(e + r"(cond_projection|cond_x_merge_linear|skip_linear|conv1|res_projection)\.(weight|bias)$",
           r"estimator.\1.\2")
    r.rule(e + r"conv2\.(weight|bias)$", r"estimator.conv2.\1")
    r.rule(e + r"final_layer\.adaLN_modulation\.1\.(weight|bias)$",
           r"estimator.final_layer.adaLN_1.\1")
    r.rule(e + r"final_layer\.linear\.(weight|bias)$", r"estimator.final_layer.linear.\1")
    r.rule(e + r"wavenet\.in_layers\.(\d+)\.conv\.conv\.(weight|bias)$",
           r"estimator.wavenet.in_layer_\1.conv.\2")
    r.rule(e + r"wavenet\.res_skip_layers\.(\d+)\.conv\.conv\.(weight|bias)$",
           r"estimator.wavenet.res_skip_\1.conv.\2")
    r.rule(e + r"wavenet\.cond_layer\.conv\.conv\.(weight|bias)$",
           r"estimator.wavenet.cond_layer.conv.\1")
    return r


def convert_s2mel(sd: Mapping[str, Any], num_sampling_ratios: int = 2) -> State:
    return convert(sd, s2mel_renamer(num_sampling_ratios))


# ---------------------------------------------------------------------------
# Qwen2 / Qwen3 causal LM (the emotion classifier, `models/qwen.py`)
# ---------------------------------------------------------------------------

def qwen_renamer() -> Renamer:
    r = Renamer()
    r.rule(r"^model\.embed_tokens\.weight$", r"embed_tokens.weight")
    r.rule(r"^model\.layers\.(\d+)\.input_layernorm\.weight$",
           r"layer_\1.input_layernorm.weight")
    r.rule(r"^model\.layers\.(\d+)\.post_attention_layernorm\.weight$",
           r"layer_\1.post_attention_layernorm.weight")
    r.rule(r"^model\.layers\.(\d+)\.self_attn\.([qkvo]_proj)\.(weight|bias)$",
           r"layer_\1.\2.\3")
    r.rule(r"^model\.layers\.(\d+)\.self_attn\.([qk]_norm)\.weight$",
           r"layer_\1.\2.weight")
    r.rule(r"^model\.layers\.(\d+)\.mlp\.(gate_proj|up_proj|down_proj)\.weight$",
           r"layer_\1.\2.weight")
    r.rule(r"^model\.norm\.weight$", r"norm.weight")
    r.rule(r"^lm_head\.weight$", r"lm_head.weight")
    r.rule(r"^model\.rotary_emb\..*", None)
    return r


def convert_qwen(sd: Mapping[str, Any]) -> State:
    """A Hugging Face Qwen2 / Qwen3 state -> `QwenLM`'s (the JAX
    `convert_qwen`; a tied model's copy of the head stays, and
    `models.qwen.load_qwen_state` drops it)."""
    return convert(sd, qwen_renamer())


def family_renamer(family: str, cfg) -> Renamer:
    """The renamer of one model family at `cfg` (a `TTSConfig`)."""
    if family == "gpt":
        return unified_voice_renamer()
    if family == "s2mel":
        return s2mel_renamer(cfg.s2mel.length_regulator.num_sampling_ratios)
    if family == "vocoder":
        return bigvgan_renamer()
    if family == "campplus":
        return campplus_renamer()
    if family == "repcodec":
        return repcodec_renamer()
    if family == "w2v":
        return w2v_bert_renamer(cfg.w2v_bert.output_layer)
    raise KeyError(f"unknown model family {family!r}")

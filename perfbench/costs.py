"""Operations and bytes, from the configuration's shapes: the table of
peaks, the bound of each K1 / K3 decode launch (for the rooflines) and the
model FLOPs of a served request (for MFU).

Peaks are NVIDIA's data-sheet numbers for one H100 SXM at its full 700 W
power limit, dense.  A launch's bound is the larger of its bytes over the
memory rate and its operations over the bf16 rate, counting each input
byte once and each output byte once: the int8 trunk (tiles, and the rows
of per-channel constants the chain reads), the folded int8 readout, the
cached K / V the step attends over (with an int8 cache their scales), the
mask bias, a beam's ancestor table, the step's inputs and outputs.  Under
an ancestor table the beams of a request read their histories through the
table; the bytes a step must read are at least one history of `pos`
positions a request, which is what is counted (the table's distinct
entries, which the benchmark cannot see, lie between that and `rows`
histories).

A request's FLOPs count 2 per multiply-add of the models' weights and of
attention at the lengths the request needs (its text, its codes, its mel
frames; not the program's padded buckets): the GPT's prefill, the decode's
rows x steps (beams x codes), the teacher-forced forward, the s2mel (the
regulator, and the DiT with its WaveNet head at 2 x 25 evaluations for
CFG), the vocoder on the real frames, and the new-speaker conditioning for
a voice not yet cached (w2v-bert, RepCodec, CAMPPlus and the GPT's
conformer / perceiver encoders, counted as 2 x parameters x frames, which
undercounts CAMPPlus's 2-D convolutions).
"""

from __future__ import annotations

import functools
import json
from typing import Dict

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12}
MFU_PEAK = PEAK_FLOPS["bf16"]
CHUNK = 16            # decode steps a device-loop chunk executes


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bf16"])


def decode_launch(cfg: dict, rows: int, requests: int, pos: int, kv_int8: bool,
                  table: bool) -> tuple:
    """(bytes, operations) of one K1 / K3 step over `rows` rows of
    `requests` requests at write position `pos`."""
    g, e = cfg["gpt"], cfg["engine"]
    n_layers, d, vocab = g["layers"], g["model_dim"], g["number_mel_codes"]
    readout = bool(e["fold_readout"])
    cached = requests * pos if table else rows * pos
    per_row = (1 if kv_int8 else 2) * d + (4 if kv_int8 else 0)
    n_bytes = (n_layers * 12 * d * d + n_layers * 22 * d * 4
               + ((vocab * (d + 8) + 2 * d * 4 + rows * vocab * 4) if readout else 0)
               + n_layers * 2 * cached * per_row
               + 4 * rows * pos                                   # bias
               + (4 * rows * pos if table else 0)                 # table
               + rows * d * 4 * 2                                 # x, hidden
               + n_layers * 2 * rows * d * (4 if kv_int8 else 2))  # new k, v
    macs = n_layers * 12 * d * d + (vocab * d if readout else 0)
    flops = 2 * rows * macs + 4 * n_layers * d * (rows * pos + rows)
    return n_bytes, flops


def decode_bound_s(cfg: dict, rows: int, requests: int, start: int, steps: int,
                   kv_int8: bool, table: bool) -> float:
    """The least time of `steps` launches, the first at position `start`."""
    return sum(bound_s(*decode_launch(cfg, rows, requests, start + s, kv_int8, table))
               for s in range(steps))


def mel_frames(cfg: dict, seconds: float) -> int:
    """Mel frames of `seconds` of audio at the mel's rate (reflect-padded
    by (n_fft - hop) / 2 on each side)."""
    m = cfg["mel"]
    n = int(seconds * m["sample_rate"]) + (m["n_fft"] - m["hop_size"]) // 2 * 2
    return 1 + (n - m["n_fft"]) // m["hop_size"]


def prompt_len(cfg: dict, text_bucket: int) -> int:
    """The decode's prompt (cond latents, 2 speed rows, start / stop text
    around the bucket); the first decode step writes at this position + 1."""
    return cfg["gpt"]["condition_num_latent"] + 2 + text_bucket + 2


@functools.lru_cache(maxsize=8)
def _params(cfg_json: str) -> Dict[str, int]:
    """Parameter counts of the families and parts the FLOPs need, from the
    reference modules built on the meta device."""
    from perfbench.reference.indextts2.config import TTSConfig
    from perfbench.reference.indextts2.weights import build_models

    with torch.device("meta"):
        m = build_models(TTSConfig.from_dict(json.loads(cfg_json)))

    def count(mod, skip=()):
        return sum(p.numel() for n, p in mod.named_parameters()
                   if not any(n.startswith(s) for s in skip))
    gpt, s2 = m["gpt"], m["s2mel"]
    return {
        "w2v": count(m["w2v"]), "repcodec": count(m["repcodec"]),
        "campplus": count(m["campplus"]),
        "cond_enc": count(gpt.conditioning_encoder) + count(gpt.emo_conditioning_encoder),
        "perceivers": count(gpt.perceiver_encoder) + count(gpt.emo_perceiver_encoder),
        "dit_frame": count(s2.estimator, skip=("t_embedder",)),
        "s2mel_pre": count(s2, skip=("estimator",)),
    }


def params(cfg: dict) -> Dict[str, int]:
    return _params(json.dumps(cfg, sort_keys=True))


def vocoder_flops(cfg: dict, frames: int) -> float:
    """BigVGAN on `frames` mel frames: conv_pre, each stage's transposed
    conv and its AMP resblocks' convolutions, conv_post."""
    v = cfg["vocoder"]
    ch = v["upsample_initial_channel"]
    flops = 2 * v["num_mels"] * ch * 7 * frames
    f = frames
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        out = ch // 2
        flops += 2 * ch * out * k * f
        f *= u
        for rk, dil in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            flops += len(dil) * 2 * (2 * out * out * rk * f)
        ch = out
    return flops + 2 * ch * 7 * f


def request_flops(cfg: dict, text_len: int, codes: int, prompt_frames: int,
                  prompt_seconds: float, cold: bool) -> Dict[str, float]:
    """The model FLOPs of one request of `text_len` tokens that decodes
    `codes` codes, by part."""
    g, e = cfg["gpt"], cfg["engine"]
    n_layers, d, vocab = g["layers"], g["model_dim"], g["number_mel_codes"]
    beams = cfg["generation"]["num_beams"]
    trunk = 12 * d * d * n_layers
    p = params(cfg)
    n_cond = g["condition_num_latent"] + 2

    def causal(tokens):            # QK and PV over a causal window, all layers
        return 2 * n_layers * d * tokens * (tokens + 1)

    prompt = n_cond + text_len + 2 + 1
    parts = {"gpt_prefill": 2 * prompt * trunk + causal(prompt) + 2 * d * vocab}
    steps = max(codes - 1, 0)
    attended = sum(prompt + s + 1 for s in range(steps))
    parts["gpt_decode"] = beams * (2 * steps * (trunk + d * vocab)
                                   + 4 * n_layers * d * attended)
    tf = n_cond + text_len + 2 + codes + 2
    parts["gpt_latent"] = 2 * tf * trunk + causal(tf)
    target = int(torch.floor(torch.tensor(float(codes)) * cfg["s2mel"]["mel_scale_factor"]))
    t = prompt_frames + target
    dit = cfg["s2mel"]["dit"]
    evals = 2 * e["diffusion_steps"]
    parts["s2mel"] = (2 * p["s2mel_pre"] * target
                      + evals * (2 * p["dit_frame"] * t + 4 * dit["depth"]
                                 * dit["hidden_dim"] * t * t))
    parts["vocoder"] = vocoder_flops(cfg, target)
    if cold:
        feats = int(prompt_seconds * 50)          # seamless features, 50 a second
        parts["conditioning"] = 2 * (
            (p["w2v"] + p["repcodec"]) * feats + p["campplus"] * 2 * feats
            + p["cond_enc"] * feats // 2 + p["perceivers"] * g["condition_num_latent"])
    return parts

"""Packed BigVGAN variants (`voice_tts_tpu/models/vocoder/packed.py`): the
nk parallel AMP resblocks of each stage evaluated together.

- `pack_bigvgan` / `bigvgan_packed_apply` (`EngineConfig.use_packed_vocoder`):
  each stage's convolutions become ONE grouped conv (`F.conv1d(...,
  groups=nk)`) after centre-embedding every kernel into the largest size
  (exact under SAME padding: the added taps are zero and the centre stays
  the centre);
- `pack_bigvgan_shared` / `bigvgan_shared_act_apply`
  (`use_shared_act_vocoder`): the convolutions stay dense per block at
  their own kernel sizes.

In both the resblocks' snake parameters stack channel-wise, so each
anti-aliased activation is one K2 launch on (B, nk*C, T): 37 launches per
vocode at the flagship config against the module path's 109.  The stage
output is the mean over the nk slices.  The convolutions are cuDNN's: in
the JAX package they are XLA's, outside any Pallas kernel.

The packs are built once (in the engine) from the port's `BigVGAN` module's
state dict, in the JAX trees' layout: {"conv_pre", "conv_post": {"weight",
"bias"}, "act_post": (alpha, 1 / (beta + 1e-9)), "stages": [{"ups",
"iters": [...]}]}; snake exp / log-scale and 1 / (beta + 1e-9) are applied
at pack time.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from voice_tts_tpu_torch.config import BigVGANConfig
from voice_tts_tpu_torch.ops.aa_activation import aa_snake_activation

Tree = Dict[str, Any]


def can_pack(cfg: BigVGANConfig) -> bool:
    """Packing requires odd kernels and one shared dilation schedule across
    the parallel resblocks (true for every published BigVGAN config)."""
    ks = cfg.resblock_kernel_sizes
    ds = cfg.resblock_dilation_sizes
    return (all(k % 2 == 1 for k in ks)
            and all(tuple(d) == tuple(ds[0]) for d in ds)
            and len(ds) == len(ks))


def sub_state(state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of `state` under `prefix.`, keyed by the rest."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in state.items() if k.startswith(prefix + ".")}


def snake_values(act: Dict[str, torch.Tensor], logscale: bool, has_beta: bool):
    """(alpha, 1 / (beta + 1e-9)) of an activation's state, exp applied if
    log-scale; alpha stands in for beta without one."""
    alpha = act["alpha"]
    beta = act["beta"] if has_beta else act["alpha"]
    if logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    return alpha, 1.0 / (beta + 1e-9)


def pad_kernel(w: torch.Tensor, k_max: int) -> torch.Tensor:
    """Centre-embed odd-k taps into an odd-k_max kernel."""
    pad = (k_max - w.shape[-1]) // 2
    return F.pad(w, (pad, pad)) if pad else w


def _acts(blocks, idx: int, cfg: BigVGANConfig):
    """The nk blocks' act_{idx} values, stacked channel-wise."""
    vals = [snake_values(sub_state(b, f"act_{idx}"), cfg.snake_logscale,
                         cfg.activation == "snakebeta") for b in blocks]
    return torch.cat([v[0] for v in vals]), torch.cat([v[1] for v in vals])


def _pack(state: Dict[str, torch.Tensor], cfg: BigVGANConfig, convs) -> Tree:
    """The tree both variants share; `convs(blocks, m)` gives iteration m's
    conv entries."""
    nk = len(cfg.resblock_kernel_sizes)
    out = {"conv_pre": sub_state(state, "conv_pre"),
           "conv_post": sub_state(state, "conv_post"),
           "act_post": snake_values(sub_state(state, "activation_post"),
                                    cfg.snake_logscale, cfg.activation == "snakebeta")}
    stages = []
    for i in range(len(cfg.upsample_rates)):
        blocks = [sub_state(state, f"resblocks_{i * nk + j}") for j in range(nk)]
        iters = []
        for m in range(len(cfg.resblock_dilation_sizes[0])):
            a1, br1 = _acts(blocks, 2 * m, cfg)
            a2, br2 = _acts(blocks, 2 * m + 1, cfg)
            iters.append({**convs(blocks, m), "a1": a1, "br1": br1, "a2": a2, "br2": br2})
        stages.append({"ups": sub_state(state, f"ups_{i}"), "iters": iters})
    out["stages"] = stages
    return out


@torch.no_grad()
def pack_bigvgan(state: Dict[str, torch.Tensor], cfg: BigVGANConfig) -> Tree:
    """BigVGAN state dict -> packed tree for `bigvgan_packed_apply`."""
    k_max = max(cfg.resblock_kernel_sizes)

    def convs(blocks, m):
        tree = {}
        for c in (1, 2):
            tree[f"w{c}"] = torch.cat([pad_kernel(b[f"convs{c}_{m}.weight"], k_max)
                                       for b in blocks])
            tree[f"b{c}"] = torch.cat([b[f"convs{c}_{m}.bias"] for b in blocks])
        return tree
    return _pack(state, cfg, convs)


@torch.no_grad()
def pack_bigvgan_shared(state: Dict[str, torch.Tensor], cfg: BigVGANConfig) -> Tree:
    """BigVGAN state dict -> tree for `bigvgan_shared_act_apply`: the snake
    parameters stacked channel-wise, each block's convs as they are."""
    def convs(blocks, m):
        return {f"convs{c}": [(b[f"convs{c}_{m}.weight"], b[f"convs{c}_{m}.bias"])
                              for b in blocks] for c in (1, 2)}
    return _pack(state, cfg, convs)


def _conv(x, w, b, padding, dilation=1, groups=1):
    y = F.conv1d(x.to(w.dtype), w, None, 1, padding, dilation, groups)
    return y if b is None else y + b[None, :, None]


def _apply(packed: Tree, mel: torch.Tensor, cfg: BigVGANConfig, convs) -> torch.Tensor:
    """The stage loop both variants share: the nk resblocks' states ride one
    (B, nk*C, T) tensor, each activation one K2 launch; `convs(it, z, c, d,
    second)` runs iteration `it`'s first (dilation d) or second conv
    position on z."""
    nk = len(cfg.resblock_kernel_sizes)
    cp = packed["conv_pre"]
    x = _conv(mel, cp["weight"], cp["bias"], padding=3)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        st = packed["stages"][i]
        ups = st["ups"]
        x = F.conv_transpose1d(x.to(ups["weight"].dtype), ups["weight"], None, u,
                               (k - u) // 2) + ups["bias"][None, :, None]
        c = x.shape[1]
        xs = x.repeat(1, nk, 1)                            # (B, nk*C, T)
        for m, d in enumerate(cfg.resblock_dilation_sizes[0]):
            it = st["iters"][m]
            xt = convs(it, aa_snake_activation(xs, it["a1"], it["br1"]), c, d, False)
            xt = convs(it, aa_snake_activation(xt, it["a2"], it["br2"]), c, 1, True)
            xs = xs + xt
        x = xs.reshape(x.shape[0], nk, c, -1).mean(dim=1)
    a, br = packed["act_post"]
    cp = packed["conv_post"]
    x = _conv(aa_snake_activation(x, a, br), cp["weight"], cp.get("bias"), padding=3)
    return torch.tanh(x) if cfg.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)


def bigvgan_packed_apply(packed: Tree, mel: torch.Tensor,
                         cfg: BigVGANConfig) -> torch.Tensor:
    """mel (B, num_mels, F) -> waveform (B, 1, F * prod(upsample_rates)),
    the module path's function with one grouped conv per conv position."""
    nk = len(cfg.resblock_kernel_sizes)
    k_max = max(cfg.resblock_kernel_sizes)

    def convs(it, z, c, d, second):
        w, b = (it["w2"], it["b2"]) if second else (it["w1"], it["b1"])
        return _conv(z, w, b, padding=(k_max * d - d) // 2, dilation=d, groups=nk)
    return _apply(packed, mel, cfg, convs)


def bigvgan_shared_act_apply(packed: Tree, mel: torch.Tensor,
                             cfg: BigVGANConfig) -> torch.Tensor:
    """mel (B, num_mels, F) -> waveform: each activation one K2 launch a
    dilation iteration; the convs run dense per block on channel slices."""
    ks = cfg.resblock_kernel_sizes

    def convs(it, z, c, d, second):
        return torch.cat([_conv(z[:, j * c:(j + 1) * c], w, b,
                                padding=(ks[j] * d - d) // 2, dilation=d)
                          for j, (w, b) in enumerate(it["convs2" if second else "convs1"])],
                         dim=1)
    return _apply(packed, mel, cfg, convs)

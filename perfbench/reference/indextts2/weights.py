"""The benchmark's random weights: made on the device from the seed and
handed to the program and to the reference alike.

`init_weights` enters every random leaf of a family in a `WeightPlan`; the
plan then draws all of them in two calls on one generator (one normal and
one uniform draw over all leaves) and scales each leaf's slice.  The same
configuration, device and seed give the same tensors, so the reference
makes them again after the measured window instead of keeping a copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .bigvgan import BigVGAN
from .campplus import CAMPPlus
from .config import TTSConfig
from .layers import init_weights
from .repcodec import RepCodec
from .s2mel import S2Mel
from .unified_voice import UnifiedVoice
from .w2v_bert import Wav2Vec2Bert

# the families in the order they are drawn, under the program's names
FAMILIES = ("gpt", "s2mel", "vocoder", "campplus", "repcodec", "w2v")


class WeightPlan:
    """Random leaves entered by the initialisers, drawn together."""

    def __init__(self):
        self.normal_leaves: List[Tuple[torch.Tensor, float, bool]] = []
        self.uniform_leaves: List[Tuple[torch.Tensor, float]] = []

    def normal(self, t: torch.Tensor, std: float, trunc: bool = False) -> None:
        self.normal_leaves.append((t, std, trunc))

    def uniform(self, t: torch.Tensor, limit: float) -> None:
        self.uniform_leaves.append((t, limit))

    @torch.no_grad()
    def draw(self, gen: torch.Generator, device) -> None:
        n = sum(t.numel() for t, _, _ in self.normal_leaves)
        if n:
            flat = torch.randn(n, generator=gen, device=device)
            ofs = 0
            for t, std, trunc in self.normal_leaves:
                x = flat[ofs:ofs + t.numel()].view(t.shape)
                if trunc:
                    x = x.clamp_(-2.0, 2.0)
                t.copy_(x * std)
                ofs += t.numel()
        n = sum(t.numel() for t, _ in self.uniform_leaves)
        if n:
            flat = torch.rand(n, generator=gen, device=device)
            ofs = 0
            for t, limit in self.uniform_leaves:
                t.copy_((flat[ofs:ofs + t.numel()].view(t.shape) * 2.0 - 1.0) * limit)
                ofs += t.numel()


def build_models(cfg: TTSConfig) -> Dict[str, torch.nn.Module]:
    """The six families at `cfg`'s widths, parameters uninitialised."""
    return {
        "gpt": UnifiedVoice(cfg.gpt),
        "s2mel": S2Mel(cfg.s2mel, cfg.semantic_codec.hidden_size),
        "vocoder": BigVGAN(cfg.vocoder),
        "campplus": CAMPPlus(cfg.campplus),
        "repcodec": RepCodec(cfg.semantic_codec),
        "w2v": Wav2Vec2Bert(cfg.w2v_bert),
    }


@torch.no_grad()
def make_models(cfg: TTSConfig, device, seed: int,
                stop_logit_bias: float = 0.0) -> Dict[str, torch.nn.Module]:
    """The six families on `device` in f32, weights drawn from `seed`; the
    stop code's bias in the GPT's mel head lowered by `stop_logit_bias`
    (random weights stop at lengths that depend on the seed; a bias far
    below the other logits makes every request decode to its cap)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.device(dev):
        models = build_models(cfg)
    for name in FAMILIES:
        plan = WeightPlan()
        init_weights(models[name], plan)
        plan.draw(gen, dev)
    models["gpt"].mel_head.bias[cfg.gpt.stop_mel_token] += stop_logit_bias
    return {k: m.eval().requires_grad_(False) for k, m in models.items()}

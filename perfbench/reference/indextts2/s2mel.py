"""s2mel stage: GPT codes + latent -> mel spectrogram
(`voice_tts_tpu/models/s2mel/s2mel.py`).

    latent' = gpt_layer(gpt_latent)         (linear chain, no activations)
    S_infer = vq2emb(codes) + latent'
    cond    = length_regulator(S_infer, floor(1.72 * code_len))
    cat     = [prompt_condition ; cond]
    mel     = CFM(cat, ref_mel, style, 25 steps, cfg 0.7)[:, :, prompt_len:]

All sequence arithmetic runs on static buckets with dynamic valid lengths.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .config import S2MelConfig
from .layers import Linear
from .dit import DiT
from .length_regulator import InterpolateRegulator


class S2Mel(nn.Module):
    def __init__(self, cfg: S2MelConfig, semantic_dim: int):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.gpt_dim] + list(cfg.gpt_layer_hidden) + [cfg.gpt_layer_out]
        self.n_gpt_layers = len(dims) - 1
        for i in range(self.n_gpt_layers):
            setattr(self, f"gpt_layer_{i}", Linear(dims[i], dims[i + 1]))
        self.length_regulator = InterpolateRegulator(cfg.length_regulator,
                                                     semantic_dim)
        self.estimator = DiT(cfg.dit, cfg.wavenet)

    def gpt_layer(self, latent: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_gpt_layers):
            latent = getattr(self, f"gpt_layer_{i}")(latent)
        return latent

    def regulate(self, s, src_len, target_len, out_max: int) -> torch.Tensor:
        return self.length_regulator(s, src_len, target_len, out_max)

    def velocity(self, x, prompt_x, x_lens, t, style, mu, tables=None) -> torch.Tensor:
        return self.estimator(x, prompt_x, x_lens, t, style, mu, tables=tables)


def assemble_condition(prompt_condition: torch.Tensor, prompt_len: torch.Tensor,
                       cond: torch.Tensor, cond_len: torch.Tensor,
                       total_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[prompt_condition[:prompt_len] ; cond[:cond_len]] in a static buffer."""
    b, pb, d = prompt_condition.shape
    frame = torch.arange(total_max, device=cond.device)
    pmask = frame[None, :] < prompt_len[:, None]
    buf = torch.zeros((b, total_max, d), dtype=prompt_condition.dtype,
                      device=cond.device)
    buf[:, :pb] = prompt_condition[:, :total_max]
    buf = torch.where(pmask[..., None], buf, 0.0)
    idx = torch.clamp(frame[None, :] - prompt_len[:, None], 0, cond.shape[1] - 1)
    shifted = torch.gather(cond, 1, idx[..., None].expand(-1, -1, d))
    total_len = prompt_len + cond_len
    cmask = (~pmask) & (frame[None, :] < total_len[:, None])
    return torch.where(cmask[..., None], shifted, buf), total_len


def place_prompt_mel(ref_mel: torch.Tensor, prompt_len: torch.Tensor,
                     total_max: int) -> torch.Tensor:
    """ref_mel (B, 80, P_bucket) -> (B, 80, total_max), zero past prompt_len."""
    b, n_mels, pb = ref_mel.shape
    out = torch.zeros((b, n_mels, total_max), dtype=ref_mel.dtype,
                      device=ref_mel.device)
    out[:, :, :pb] = ref_mel[:, :, :total_max]
    frame = torch.arange(total_max, device=ref_mel.device)
    mask = frame[None, None, :] < prompt_len[:, None, None]
    return torch.where(mask, out, 0.0)


def slice_generated(mel: torch.Tensor, prompt_len: torch.Tensor,
                    out_max: int) -> torch.Tensor:
    """mel (B, 80, total) -> generated region (B, 80, out_max)."""
    frame = torch.arange(out_max, device=mel.device)
    idx = torch.clamp(frame[None, :] + prompt_len[:, None], 0, mel.shape[2] - 1)
    return torch.gather(mel, 2, idx[:, None, :].expand(-1, mel.shape[1], -1))

"""RepCodec semantic codec: w2v-bert features -> discrete semantic codes
(`voice_tts_tpu/models/conditioning/repcodec.py`): VocosBackbone ConvNeXt
encoder + linear, single L2-normalized factorized VQ.  The serving path
uses `forward` (quantize) and `repcodec_vq2emb`."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from voice_tts_tpu_torch.config import RepCodecConfig
from voice_tts_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, normal_


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, intermediate_dim)
        self.pwconv2 = Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def _init(self, gen):
        nn.init.ones_(self.gamma)

    def forward(self, x):
        h = self.norm(self.dwconv(x).transpose(1, 2))
        h = self.gamma * self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + h.transpose(1, 2)


class VocosBackbone(nn.Module):
    def __init__(self, in_dim: int, dim: int, intermediate_dim: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        self.embed = Conv1d(in_dim, dim, 7, padding=3)
        self.norm = LayerNorm(dim, eps=1e-6)
        for i in range(num_layers):
            setattr(self, f"convnext_{i}", ConvNeXtBlock(dim, intermediate_dim))
        self.final_layer_norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        """x (B, C, T) -> (B, T, dim)."""
        x = self.norm(self.embed(x).transpose(1, 2)).transpose(1, 2)
        for i in range(self.num_layers):
            x = getattr(self, f"convnext_{i}")(x)
        return self.final_layer_norm(x.transpose(1, 2))


class FactorizedVQ(nn.Module):
    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.in_project = Conv1d(input_dim, codebook_dim, 1)
        self.codebook = nn.Parameter(torch.empty(codebook_size, codebook_dim))
        self.out_project = Conv1d(codebook_dim, input_dim, 1)

    def _init(self, gen):
        normal_(self.codebook, 1.0, gen)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z (B, D, T) -> (indices (B, T), z_q (B, D, T))."""
        enc = self.in_project(z).transpose(1, 2)
        enc_n = enc / torch.clamp(torch.linalg.vector_norm(enc, dim=-1, keepdim=True),
                                  min=1e-12)
        cb = self.codebook
        cb_n = cb / torch.clamp(torch.linalg.vector_norm(cb, dim=-1, keepdim=True),
                                min=1e-12)
        dist = ((enc_n ** 2).sum(-1, keepdim=True)
                - 2.0 * torch.einsum("btd,kd->btk", enc_n, cb_n)
                + (cb_n ** 2).sum(-1)[None, None, :])
        indices = torch.argmax(-dist, dim=-1)
        z_q = cb[indices].transpose(1, 2)
        return indices, self.out_project(z_q)


class RepCodec(nn.Module):
    """Encoder + quantizer (the decoder is not on the serving path)."""

    def __init__(self, cfg: RepCodecConfig):
        super().__init__()
        if cfg.downsample_scale and cfg.downsample_scale > 1:
            raise NotImplementedError("RepCodec downsampling is not ported")
        self.cfg = cfg
        self.encoder_backbone = VocosBackbone(
            cfg.hidden_size, cfg.vocos_dim, cfg.vocos_intermediate_dim,
            cfg.vocos_num_layers)
        self.encoder_out = Linear(cfg.vocos_dim, cfg.hidden_size)
        self.quantizer = FactorizedVQ(cfg.hidden_size, cfg.codebook_size,
                                      cfg.codebook_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """features (B, T, H) -> (codes (B, T), quantized (B, T, H))."""
        h = self.encoder_out(self.encoder_backbone(x.transpose(1, 2)))
        indices, z_q = self.quantizer(h.transpose(1, 2))
        return indices, z_q.transpose(1, 2)


def repcodec_vq2emb(model: RepCodec, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, T) -> (B, T, H): codebook lookup (indices clipped: bucket
    padding may carry the out-of-vocabulary stop token) + out-projection."""
    q = model.quantizer
    idx = torch.clamp(codes, 0, q.codebook.shape[0] - 1)
    z_q = q.codebook[idx]                                # (B, T, d)
    w = q.out_project.weight                             # (H, d, 1)
    return torch.einsum("btd,hdk->bth", z_q, w) + q.out_project.bias[None, None, :]

"""RepCodec semantic codec: w2v-bert features -> discrete semantic codes
(`voice_tts_tpu/models/conditioning/repcodec.py`): VocosBackbone ConvNeXt
encoder + linear, single L2-normalized factorized VQ, with the stride-2
`down` / `up` convs when `downsample_scale > 1`.  The serving path uses
`forward` (quantize) and `repcodec_vq2emb`; `reconstruct` is the full
autoencode (the decoder, built with `decoder=True`: the published codec
carries its weights)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import RepCodecConfig
from .layers import Conv1d, LayerNorm, Linear, normal_


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
    """Encoder + quantizer, and with `decoder` the decoder (not on the
    serving path)."""

    def __init__(self, cfg: RepCodecConfig, decoder: bool = False):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.downsampled = bool(cfg.downsample_scale and cfg.downsample_scale > 1)
        if self.downsampled:
            self.down = Conv1d(h, h, 3, stride=2, padding=1)
            self.up = Conv1d(h, h, 3, padding=1)
        self.encoder_backbone = VocosBackbone(
            h, cfg.vocos_dim, cfg.vocos_intermediate_dim, cfg.vocos_num_layers)
        self.encoder_out = Linear(cfg.vocos_dim, h)
        self.quantizer = FactorizedVQ(h, cfg.codebook_size, cfg.codebook_dim)
        self.has_decoder = decoder
        if decoder:
            self.decoder_backbone = VocosBackbone(
                h, cfg.vocos_dim, cfg.vocos_intermediate_dim, cfg.vocos_num_layers)
            self.decoder_out = Linear(cfg.vocos_dim, h)

    def _quantize(self, x: torch.Tensor):
        """features (B, T, H) -> (codes (B, T'), z_q (B, H, T')), T' = T
        halved (rounded up) when downsampled."""
        h = x.transpose(1, 2)
        if self.downsampled:
            h = F.gelu(self.down(h))
        h = self.encoder_out(self.encoder_backbone(h))
        return self.quantizer(h.transpose(1, 2))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """features (B, T, H) -> (codes (B, T'), quantized (B, T', H))."""
        indices, z_q = self._quantize(x)
        return indices, z_q.transpose(1, 2)

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        """The full autoencode: features (B, T, H) -> (B, T, H) (T rounded up
        to even when downsampled: nearest x2 upsampling before `up`)."""
        if not self.has_decoder:
            raise ValueError("RepCodec.reconstruct needs the decoder: build "
                             "RepCodec(cfg, decoder=True)")
        _, z_q = self._quantize(x)
        h = self.decoder_out(self.decoder_backbone(z_q))
        if self.downsampled:
            h = self.up(torch.repeat_interleave(h.transpose(1, 2), 2, dim=-1))
            h = h.transpose(1, 2)
        return h


def repcodec_vq2emb(model: RepCodec, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, T) -> (B, T, H): codebook lookup (indices clipped: bucket
    padding may carry the out-of-vocabulary stop token) + out-projection."""
    q = model.quantizer
    idx = torch.clamp(codes, 0, q.codebook.shape[0] - 1)
    z_q = q.codebook[idx]                                # (B, T, d)
    w = q.out_project.weight                             # (H, d, 1)
    return torch.einsum("btd,hdk->bth", z_q, w) + q.out_project.bias[None, None, :]

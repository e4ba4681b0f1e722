"""UnifiedVoice v2: the acoustic-token GPT with speaker / emotion
conditioning (`voice_tts_tpu/models/gpt/unified_voice.py`).

Speaker conditioning by `condition_type`: `conformer_perceiver` (the
published config: conformer + perceiver, `condition_num_latent` latents),
`perceiver` (the reference constructor's default: attention-block encoder +
a perceiver at its own defaults), any other string but `gst` /
`conformer_encoder` the mean-pooled attention-block encoder (one latent);
`gst` and `conformer_encoder` raise, as the reference's own
`get_conditioning` fails on them.

Sequence layout `[cond(32)+emo | speed_half | speed_full | start,text,stop |
start_mel, mel codes...]`; text is right-padded inside a shape bucket with
an attention validity mask.  Dtypes follow the parameters and PyTorch's
promotion (the same rules as JAX's for these ops), so the int8 / bf16
runtime copy (`utils.quantize`) and the f32 master compute as the JAX
package's two parameter trees do.
"""

from __future__ import annotations

import torch
from torch import nn

from .config import GPTConfig
from .cond_encoder import AttentionConditioningEncoder
from .conformer import ConformerEncoder
from .gpt2 import GPT2Stack
from .perceiver import PerceiverResampler
from .layers import Embedding, LayerNorm, Linear


def n_cond_latents(cfg: GPTConfig) -> int:
    """Speaker-conditioning latents in the decode prefix: the perceiver
    branches emit `condition_num_latent`, the mean-pooled arm one."""
    if cfg.condition_type in ("conformer_perceiver", "perceiver"):
        return cfg.condition_num_latent
    return 1


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = c = cfg
        cm, em = c.condition_module, c.emo_condition_module
        if c.condition_type == "conformer_perceiver":
            self.conditioning_encoder = ConformerEncoder(cm)
            self.perceiver_encoder = PerceiverResampler(
                dim=c.model_dim, dim_context=cm.output_size,
                num_latents=c.condition_num_latent, heads=cm.attention_heads,
                ff_mult=cm.perceiver_mult)
        elif c.condition_type == "perceiver":
            # the reference constructor's default: 6 AttentionBlocks, then
            # a PerceiverResampler at its own defaults (heads 8, ff_mult 4,
            # not the condition module's)
            self.conditioning_encoder = AttentionConditioningEncoder(
                cm.input_size, c.model_dim, c.heads)
            self.perceiver_encoder = PerceiverResampler(
                dim=c.model_dim, dim_context=c.model_dim,
                num_latents=c.condition_num_latent)
        elif c.condition_type in ("gst", "conformer_encoder"):
            # the reference's get_conditioning raises on both (gst_encoder is
            # never constructed; the conformer is called with the wrong
            # arity), so no checkpoint can exist for them
            raise ValueError(
                f"condition_type {c.condition_type!r} is not supported: the "
                f"reference's own get_conditioning raises on this branch; use "
                f"'conformer_perceiver', 'perceiver', or any other string "
                f"(mean-pooled default encoder)")
        else:
            # the reference's default arm: a mean-pooled ConditioningEncoder
            # (B, 1, dim)
            self.conditioning_encoder = AttentionConditioningEncoder(
                cm.input_size, c.model_dim, c.heads, mean=True)
        self.emo_conditioning_encoder = ConformerEncoder(em)
        self.emo_perceiver_encoder = PerceiverResampler(
            dim=c.emo_dim, dim_context=em.output_size, num_latents=1,
            heads=em.attention_heads, ff_mult=em.perceiver_mult)
        vocab_text = c.number_text_tokens * c.types + 1
        self.text_embedding = Embedding(vocab_text, c.model_dim)
        self.emovec_layer = Linear(c.emo_dim, c.model_dim)
        self.emo_layer = Linear(c.model_dim, c.model_dim)
        self.mel_embedding = Embedding(c.number_mel_codes, c.model_dim)
        self.gpt = GPT2Stack(c.layers, c.model_dim, c.heads)
        self.mel_pos_embedding = Embedding(c.max_mel_tokens + 3, c.model_dim)
        self.text_pos_embedding = Embedding(c.max_text_tokens + 2, c.model_dim)
        self.final_norm = LayerNorm(c.model_dim)
        self.text_head = Linear(c.model_dim, vocab_text)
        self.mel_head = Linear(c.model_dim, c.number_mel_codes)
        self.speed_emb = Embedding(2, c.model_dim)

    @property
    def param_dtype(self) -> torch.dtype:
        """The compute dtype of the non-trunk weights (bf16 on the int8 and
        bf16 runtime copies, f32 on the master)."""
        return self.final_norm.weight.dtype

    # ---- conditioning ----

    def get_conditioning(self, spk_cond: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
        """spk_cond (B, T, 1024) w2v-bert features -> (B, n_cond_latents,
        model_dim)."""
        if self.cfg.condition_type == "perceiver":
            # no length mask on this branch, as in the reference
            return self.perceiver_encoder(self.conditioning_encoder(spk_cond))
        if self.cfg.condition_type != "conformer_perceiver":
            return self.conditioning_encoder(spk_cond)[:, None, :]
        h, mask = self.conditioning_encoder(spk_cond, lengths)
        ones = torch.ones((h.shape[0], self.cfg.condition_num_latent),
                          dtype=torch.bool, device=h.device)
        return self.perceiver_encoder(h, torch.cat([ones, mask[:, 0, :]], dim=1))

    def get_emovec(self, emo_cond: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
        """emo_cond (B, T, 1024) -> emotion vector (B, model_dim)."""
        h, mask = self.emo_conditioning_encoder(emo_cond, lengths)
        ones = torch.ones((h.shape[0], 1), dtype=torch.bool, device=h.device)
        raw = self.emo_perceiver_encoder(h, torch.cat([ones, mask[:, 0, :]], dim=1))[:, 0]
        return self.emo_layer(self.emovec_layer(raw))

    def conds_latent(self, cond_latents, emo_vec) -> torch.Tensor:
        """[cond + emo | speed_half | speed_full] (B, 34, D)."""
        b = cond_latents.shape[0]
        dev = cond_latents.device
        half = self.speed_emb(torch.ones((b, 1), dtype=torch.long, device=dev))
        full = self.speed_emb(torch.zeros((b, 1), dtype=torch.long, device=dev))
        first = cond_latents + emo_vec[:, None, :]
        dt = torch.promote_types(first.dtype, half.dtype)
        return torch.cat([first.to(dt), half.to(dt), full.to(dt)], dim=1)

    # ---- teacher-forced forward -> mel latent (feeds s2mel) ----

    def forward(self, cond_latents, emo_vec, text_tokens, text_lengths,
                mel_codes, code_lengths) -> torch.Tensor:
        """Returns the GPT mel latent (B, M, D), M = mel_codes.shape[1]."""
        c = self.cfg
        b, l = text_tokens.shape
        m = mel_codes.shape[1]
        dev = text_tokens.device
        pos_t = torch.arange(l, device=dev)
        text_tokens = torch.where(pos_t[None, :] < text_lengths[:, None],
                                  text_tokens, c.stop_text_token)
        pos_m = torch.arange(m, device=dev)
        mel_codes = torch.where(pos_m[None, :] < code_lengths[:, None],
                                mel_codes, c.stop_mel_token)

        def wrap(toks, start, stop):
            s = torch.full((b, 1), start, dtype=toks.dtype, device=dev)
            e = torch.full((b, 1), stop, dtype=toks.dtype, device=dev)
            return torch.cat([s, toks, e], dim=1)

        text_in = wrap(text_tokens, c.start_text_token, c.stop_text_token)
        mel_in = wrap(mel_codes, c.start_mel_token, c.stop_mel_token)
        conds = self.conds_latent(cond_latents, emo_vec)
        text_emb = (self.text_embedding(text_in)
                    + self.text_pos_embedding(torch.arange(l + 2, device=dev))[None])
        mel_emb = (self.mel_embedding(mel_in)
                   + self.mel_pos_embedding(torch.arange(m + 2, device=dev))[None])
        dt = torch.promote_types(conds.dtype, text_emb.dtype)
        emb = torch.cat([conds.to(dt), text_emb.to(dt), mel_emb.to(dt)], dim=1)
        hidden = self.gpt(emb)
        enc = self.final_norm(hidden[:, conds.shape[1]:])
        return enc[:, -(m + 2):][:, :-2]

    # ---- the decode's logits along served codes ----

    def decode_logits(self, cond_latents, emo_vec, text_ids: torch.Tensor,
                      codes: torch.Tensor) -> torch.Tensor:
        """The logits the autoregressive decode sees before each of `codes`
        (N,), given the unpadded text ids (L,): one causal forward over
        [conds | start_text, text, stop_text | start_mel, codes[:-1]] with
        the text at positions 0..L+1 and the codes at mel positions 0..N-1
        (the decode's layout without its bucket padding, which it masks
        out).  Returns (N, vocab) f32: row t predicts codes[t]."""
        c = self.cfg
        dev = text_ids.device
        n = codes.shape[0]
        toks = torch.cat([torch.tensor([c.start_text_token], device=dev), text_ids,
                          torch.tensor([c.stop_text_token], device=dev)])
        text_emb = (self.text_embedding(toks)
                    + self.text_pos_embedding(torch.arange(toks.shape[0], device=dev)))
        mel_in = torch.cat([torch.tensor([c.start_mel_token], device=dev), codes[:-1]])
        mel_emb = (self.mel_embedding(mel_in)
                   + self.mel_pos_embedding(torch.arange(n, device=dev)))
        conds = self.conds_latent(cond_latents, emo_vec)
        dt = torch.promote_types(conds.dtype, text_emb.dtype)
        emb = torch.cat([conds.to(dt), text_emb[None].to(dt), mel_emb[None].to(dt)], dim=1)
        hidden = self.gpt(emb)[:, -n:]
        return self.mel_head(self.final_norm(hidden).float())[0].float()

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

from typing import Tuple

import torch
from torch import nn

from voice_tts_tpu_torch.config import GPTConfig
from voice_tts_tpu_torch.models.gpt.cond_encoder import AttentionConditioningEncoder
from voice_tts_tpu_torch.models.gpt.conformer import ConformerEncoder
from voice_tts_tpu_torch.models.gpt.gpt2 import GPT2Stack, QuantKVCache
from voice_tts_tpu_torch.models.gpt.perceiver import PerceiverResampler
from voice_tts_tpu_torch.models.layers import Embedding, LayerNorm, Linear


def n_cond_latents(cfg: GPTConfig) -> int:
    """Speaker-conditioning latents in the decode prefix: the perceiver
    branches emit `condition_num_latent`, the mean-pooled arm one."""
    if cfg.condition_type in ("conformer_perceiver", "perceiver"):
        return cfg.condition_num_latent
    return 1


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: GPTConfig, int8: bool = False):
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
        self.gpt = GPT2Stack(c.layers, c.model_dim, c.heads, int8,
                             c.pallas_decode_attention)
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
        hidden, _ = self.gpt(emb)
        enc = self.final_norm(hidden[:, conds.shape[1]:])
        return enc[:, -(m + 2):][:, :-2]

    # ---- decode-time pieces ----

    def build_prompt(self, cond_latents, emo_vec, text_tokens, text_lengths
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prompt embeddings (B, P, D) and validity (B, P) for AR decode,
        P = 34 + bucket_len + 2, layout [conds | start,text,stop,(pad)]."""
        c = self.cfg
        b, bl = text_tokens.shape
        dev = text_tokens.device
        conds = self.conds_latent(cond_latents, emo_vec)
        pos = torch.arange(bl + 2, device=dev)
        toks = torch.cat([
            torch.full((b, 1), c.start_text_token, dtype=text_tokens.dtype, device=dev),
            text_tokens,
            torch.full((b, 1), c.stop_text_token, dtype=text_tokens.dtype, device=dev)],
            dim=1)
        in_range = pos[None, :] < (text_lengths[:, None] + 2)
        is_stop = pos[None, :] == (text_lengths[:, None] + 1)
        toks = torch.where(is_stop, c.stop_text_token, toks)
        text_emb = self.text_embedding(toks) + self.text_pos_embedding(pos)[None]
        dt = torch.promote_types(conds.dtype, text_emb.dtype)
        embeds = torch.cat([conds.to(dt), text_emb.to(dt)], dim=1)
        valid = torch.cat([torch.ones((b, conds.shape[1]), dtype=torch.bool,
                                      device=dev), in_range], dim=1)
        return embeds, valid

    def prefill(self, prompt_embeds, valid, kv_cache):
        """Run [prompt | start_mel] through the GPT, filling `kv_cache` in
        place.  Returns logits (B, vocab) at the start_mel position."""
        c = self.cfg
        b, p, _ = prompt_embeds.shape
        dev = prompt_embeds.device
        start = torch.full((b, 1), c.start_mel_token, dtype=torch.long, device=dev)
        start_emb = (self.mel_embedding(start)
                     + self.mel_pos_embedding(torch.zeros((1,), dtype=torch.long,
                                                          device=dev))[None])
        embeds = torch.cat([prompt_embeds, start_emb.to(prompt_embeds.dtype)], dim=1)
        # an int8 QuantKVCache: the compute dtype follows the embeds
        int8_kv = isinstance(kv_cache, QuantKVCache)
        t_max = (kv_cache.kv if int8_kv else kv_cache).shape[5]
        valid_all = torch.cat([valid, torch.ones((b, t_max - p), dtype=torch.bool,
                                                 device=dev)], dim=1)
        dtype = prompt_embeds.dtype if int8_kv else kv_cache.dtype
        hidden, _ = self.gpt(embeds.to(dtype), kv_cache, 0, valid_all)
        return self.readout(hidden[:, -1])

    def embed_decode_token(self, token: torch.Tensor, step) -> torch.Tensor:
        """(B,) token -> (B, D) embedding at mel position step + 1; `step` a
        host int or a 0-d integer tensor on the device (a device loop's)."""
        if isinstance(step, torch.Tensor):
            pos = (step + 1).reshape(1, 1).long()
        else:
            pos = torch.full((1, 1), step + 1, dtype=torch.long, device=token.device)
        return (self.mel_embedding(token[:, None]) + self.mel_pos_embedding(pos))[:, 0]

    def embed_decode_token_rows(self, token: torch.Tensor,
                                steps: torch.Tensor) -> torch.Tensor:
        """Per-row AR-step embedding for continuous batching: token (B,),
        steps (B,) each row's last emitted code index, a device tensor ->
        (B, D), each row at its own mel position steps + 1."""
        return (self.mel_embedding(token[:, None])
                + self.mel_pos_embedding(steps[:, None].long() + 1))[:, 0]

    def readout(self, hidden: torch.Tensor) -> torch.Tensor:
        """final_norm + mel_head on a (B, D) hidden state -> (B, vocab) f32."""
        return self.mel_head(self.final_norm(hidden).float())

    def readout_rows(self, hidden: torch.Tensor) -> torch.Tensor:
        """`readout` of each row of (B, D) alone: a GEMM over more rows may
        sum in another order (cuBLAS picks its kernel by the row count), so
        this keeps a row's logits those of `readout` at batch 1."""
        return torch.cat([self.readout(hidden[i:i + 1]) for i in range(hidden.shape[0])])

    def decode_step(self, token, step: int, cache_index: int, valid, kv_cache):
        """One AR step on the unfused path; `kv_cache` is updated in place."""
        emb = self.embed_decode_token(token, step)[:, None, :]
        dtype = emb.dtype if isinstance(kv_cache, QuantKVCache) else kv_cache.dtype
        hidden, _ = self.gpt(emb.to(dtype), kv_cache, cache_index, valid)
        return self.readout(hidden[:, -1])

"""The plain reference of a served IndexTTS2 request, stage by stage, in
PyTorch and float32 (TF32 off), from the benchmark's own weights
(`weights.make_models`).  It imports nothing of the program.

Stages, each a function of its inputs alone, so that each stage of the
program can be judged from the inputs the program gave it:

- `conditioning(prompt)`: resample, seamless features, w2v-bert, RepCodec,
  the prompt's mel, kaldi fbank + CAMPPlus, the length regulator and the
  conformer-perceiver / emotion encoders (the engine's new-speaker path);
- `text_ids(text)`: the character-hash tokenizer of random-weight runs;
- `latent(...)`: the GPT's teacher-forced forward over the bucket-padded
  text and codes, whose output feeds the s2mel;
- `decode_logits(...)`: the logits the decode sees before each served
  code (the decode's own layout, without its masked bucket padding);
- `s2mel(...)`: the length regulator, the 25-step CFM solve with CFG from
  the given initial noise, the generated region with frames past the
  target zeroed;
- `vocode(mel)`: BigVGAN, the float waveform before int16.

`Reference(..., control=True)` is the control: the same stages one step
below the precision the configuration states (int4 for the int8 GPT trunk,
fp8 weights in bf16 for what runs in bf16, TF32 for what runs in f32;
the s2mel and the vocoder run in f32 in both configurations, so TF32).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
from typing import Dict, List

import numpy as np
import torch

from .config import TTSConfig
from .kaldi import KaldiFbank, SeamlessFeatures
from .mel import MelSpectrogram
from .repcodec import repcodec_vq2emb
from .resample import Resampler
from .s2mel import assemble_condition, place_prompt_mel, slice_generated
from .cfm import cfm_inference
from .wav import load_prompt_audio
from .weights import make_models

SR_MEL = 22050
SR_COND = 16000


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for matmuls and convolutions on or off inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


@torch.no_grad()
def lowered(module: torch.nn.Module, trunk_int4: bool = False) -> torch.nn.Module:
    """A copy of `module` one step below bf16: in bf16, its weights of two
    or more dimensions rounded to fp8 (e4m3, one scale an output row that
    maps the row's largest magnitude to 448); with `trunk_int4`, the GPT
    trunk's (in, out) Conv1D weights (int8 in the program) to 4-bit
    symmetric integers, one scale an output column."""
    out = copy.deepcopy(module)
    for name, p in out.named_parameters():
        if p.dim() < 2:
            continue
        trunk = name.startswith("gpt.h_")
        axis = p.dim() - 1 if trunk else 0
        dims = tuple(d for d in range(p.dim()) if d != axis)
        peak = p.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12)
        if trunk and trunk_int4:
            scale = peak / 7
            p.copy_(torch.clamp(torch.round(p / scale), -7, 7) * scale)
        else:
            scale = peak / 448.0
            p.copy_((p / scale).to(torch.float8_e4m3fn).float() * scale)
    return out.to(torch.bfloat16)


def hash_ids(text: str, vocab_size: int) -> List[int]:
    """The character-hash tokenizer of random-weight runs: one id a
    non-space character, md5 modulo vocab - 10, plus 3."""
    base = vocab_size - 10
    return [int(hashlib.md5(c.encode()).hexdigest(), 16) % base + 3
            for c in text if not c.isspace()]


def pick_bucket(n: int, buckets) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


class Reference:
    def __init__(self, cfg_dict: dict, device, seed: int, control: bool = False,
                 stop_logit_bias: float = 0.0):
        self.cfg = cfg = TTSConfig.from_dict(cfg_dict)
        self.device = dev = torch.device(device)
        self.control = control
        self.models = m = make_models(cfg, dev, seed, stop_logit_bias)
        e = cfg.engine
        # the GPT of the decode and the latent, and the conditioning's
        # families (w2v-bert, RepCodec, CAMPPlus and the GPT's encoders) as
        # the program runs them: f32, or one step below in the control
        self.gpt_rt = m["gpt"]
        self.cond = {k: m[k] for k in ("w2v", "repcodec", "campplus", "gpt")}
        if control:
            if e.use_int8_decode or e.use_fp16:
                self.gpt_rt = lowered(m["gpt"], trunk_int4=e.use_int8_decode)
            if e.use_bf16_conditioning:
                self.cond = {k: lowered(m[k]) for k in ("w2v", "repcodec", "campplus")}
                self.cond["gpt"] = self.gpt_rt
        # TF32 in place of f32 in the control
        self.f32_tf32 = control
        self.mel_fn = MelSpectrogram(cfg.mel, dev)
        self.seamless = SeamlessFeatures(sample_rate=SR_COND, device=dev)
        self.fbank = KaldiFbank(sample_rate=SR_COND, waveform_scale=32768.0, device=dev)
        self.prompt_16k = int(e.max_prompt_seconds * SR_COND)
        self.prompt_22k = int(e.max_prompt_seconds * SR_MEL)
        self.prompt_frames = self.mel_fn.num_frames(self.prompt_22k)
        self._resamplers: Dict[tuple, Resampler] = {}

    def _tf32(self):
        return tf32(self.f32_tf32)

    # ---- conditioning ------------------------------------------------

    def _resample(self, audio: np.ndarray, src: int, dst: int) -> np.ndarray:
        if src == dst:
            return audio
        if (src, dst) not in self._resamplers:
            self._resamplers[(src, dst)] = Resampler(src, dst, self.device)
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(self.device)
        return self._resamplers[(src, dst)](x)[0].cpu().numpy()

    @torch.no_grad()
    def conditioning(self, prompt: bytes) -> Dict[str, torch.Tensor]:
        """The speaker conditioning of a WAV prompt, batch 1:
        cond_latents (1, 32, D), emovec (1, D), style (1, 192),
        prompt_condition (1, P, C), ref_mel (1, 80, P), mel_frames."""
        cfg, dev, m = self.cfg, self.device, self.models
        audio, sr = load_prompt_audio(prompt, cfg.engine.max_prompt_seconds)
        a16 = self._resample(audio, sr, SR_COND)
        a22 = self._resample(audio, sr, SR_MEL)
        n16 = min(len(a16), self.prompt_16k)
        n22 = min(len(a22), self.prompt_22k)
        buf16 = np.zeros((1, self.prompt_16k), np.float32)
        buf16[0, :n16] = a16[:n16]
        pad = (cfg.mel.n_fft - cfg.mel.hop_size) // 2
        pre = np.zeros((1, self.prompt_22k + 2 * pad), np.float32)
        seg = self.mel_fn.pad_reflect(a22[None, :n22])
        pre[:, :seg.shape[1]] = seg
        mel_frames = self.mel_fn.num_frames(n22)
        audio16 = torch.from_numpy(buf16).to(dev)
        n16_t = torch.tensor([n16], device=dev)
        c = self.cond
        with self._tf32():
            feats, mask = self.seamless(audio16, n16_t)
            emb = c["w2v"](feats.to(_dtype(c["w2v"])), mask).float()
            w2v_len = mask.sum(dim=1)
            _, s_ref = c["repcodec"](emb.to(_dtype(c["repcodec"])))
            ref_mel = self.mel_fn.on_prepadded(torch.from_numpy(pre).to(dev))
            fb = self.fbank(audio16)
            fb_frames = torch.clamp(torch.div(n16_t - 400, 160, rounding_mode="floor") + 1,
                                    min=0)
            fmask = torch.arange(fb.shape[1], device=dev)[None, :] < fb_frames[:, None]
            fmean = (fb * fmask[..., None]).sum(dim=1, keepdim=True) / fb_frames[:, None, None]
            fb = (fb - fmean) * fmask[..., None]
            style = c["campplus"](fb.to(_dtype(c["campplus"])), fb_frames).float()
            prompt_condition = m["s2mel"].regulate(
                s_ref.float(), w2v_len, torch.tensor([mel_frames], device=dev),
                self.prompt_frames)
            cond_emb = emb.to(_dtype(c["gpt"]))
            cond_latents = c["gpt"].get_conditioning(cond_emb, w2v_len).float()
            emovec = c["gpt"].get_emovec(cond_emb, w2v_len).float()
        return {"cond_latents": cond_latents, "emovec": emovec, "style": style,
                "prompt_condition": prompt_condition.float(), "ref_mel": ref_mel,
                "mel_frames": mel_frames}

    # ---- text and GPT --------------------------------------------------

    def text_ids(self, text: str) -> List[int]:
        return hash_ids(text, self.cfg.gpt.number_text_tokens)

    @torch.no_grad()
    def latent(self, cond_latents, emovec, text_row, text_len, codes_row,
               code_len) -> torch.Tensor:
        """The teacher-forced latent (M, D) of one row: text_row (bucket,),
        codes_row (cbucket,) as the program padded them."""
        dev, dt = self.device, _dtype(self.gpt_rt)
        with self._tf32():
            out = self.gpt_rt(cond_latents.to(dev, dt), emovec.to(dev, dt),
                                text_row[None].to(dev), torch.tensor([text_len], device=dev),
                                codes_row[None].to(dev), torch.tensor([code_len], device=dev))
        return out[0].float()

    @torch.no_grad()
    def decode_logits(self, cond_latents, emovec, ids: List[int],
                      codes: torch.Tensor) -> torch.Tensor:
        dev, dt = self.device, _dtype(self.gpt_rt)
        with self._tf32():
            return self.gpt_rt.decode_logits(
                cond_latents.to(dev, dt), emovec.to(dev, dt),
                torch.tensor(ids, device=dev), codes.to(dev))

    # ---- s2mel and vocoder ---------------------------------------------

    @torch.no_grad()
    def s2mel(self, latent, codes, code_len, prompt_condition, prompt_len, ref_mel,
              style, mel_bucket: int, noise) -> torch.Tensor:
        """The program's `_s2mel` of one row (batch 1 tensors), from its
        inputs and its initial noise: mel (1, 80, mel_bucket), frames past
        the target zeroed."""
        cfg, dev = self.cfg, self.device
        s2 = self.models["s2mel"]
        f32 = [t.to(dev).float() for t in (latent, prompt_condition, ref_mel, style, noise)]
        latent, prompt_condition, ref_mel, style, noise = f32
        codes, code_len, prompt_len = codes.to(dev), code_len.to(dev), prompt_len.to(dev)
        dt = _dtype(s2)
        with self._tf32():
            s_infer = (repcodec_vq2emb(self.models["repcodec"], codes)
                       + s2.gpt_layer(latent.to(dt)).float())
            target_len = torch.floor(code_len.float() * cfg.s2mel.mel_scale_factor).long()
            cond = s2.regulate(s_infer.to(dt), code_len, target_len, mel_bucket).float()
            total_max = prompt_condition.shape[1] + mel_bucket
            cat, total_len = assemble_condition(prompt_condition, prompt_len, cond,
                                                target_len, total_max)
            prompt_x = place_prompt_mel(ref_mel, prompt_len, total_max)

            def velocity(x, p, lens, t, s, mu, tab):
                return s2.velocity(x.to(dt), p.to(dt), lens, t, s.to(dt),
                                   mu.to(dt)).float()
            mel = cfm_inference(velocity, cat, total_len, prompt_x, prompt_len, style,
                                cfg.engine.diffusion_steps, cfg.engine.inference_cfg_rate,
                                noise=noise)
        gen = slice_generated(mel, prompt_len, mel_bucket)
        frame = torch.arange(mel_bucket, device=dev)
        return torch.where(frame[None, None, :] < target_len[:, None, None], gen, 0.0)

    @torch.no_grad()
    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (1, 80, F) -> float waveform (samples,)."""
        with self._tf32():
            return self.models["vocoder"](mel.to(self.device).float()).reshape(-1)

    def target_len(self, code_len: int) -> int:
        """Mel frames of `code_len` codes: floor(codes x the scale factor) in
        float32, as the s2mel computes it."""
        return int(torch.floor(torch.tensor(float(code_len))
                               * self.cfg.s2mel.mel_scale_factor))


def _dtype(module: torch.nn.Module) -> torch.dtype:
    return next(p.dtype for p in module.parameters() if p.is_floating_point())

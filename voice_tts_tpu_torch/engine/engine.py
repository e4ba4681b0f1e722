"""TTSEngine: the single-request inference path, PyTorch + CUDA
(`voice_tts_tpu/engine/engine.py`: `infer`, `_prepare`, `_decode_cap`,
`_observe_code_len` and both arms of `_synthesize_segment`).

One segment runs eagerly: AR decode -> silence trim -> teacher-forced GPT
latent -> s2mel (length regulator + 25-step CFM) -> BigVGAN (K2 on every
activation) -> int16, with the JAX engine's text / code / mel / prompt
buckets and padded shapes.  The decode is either

- beam search (`num_beams > 1`, the production default): `models/gpt/beam.py`
  at the text bucket's learned decode cap with one full-cap retry, every
  step one K3 launch over the beams with the ancestor table, as the JAX
  engine's beam branch; or
- sampling / greedy (`num_beams == 1`): the K1 step, with the JAX
  `fuse_pipeline` path's code bucket estimate and retry; with
  `spec_decode_k >= 2` the self-speculative decode instead (int4 drafts
  through K1, one int8 verify pass through K6 a round).

New speakers run the conditioning path (resample, seamless features,
w2v-bert, RepCodec, kaldi fbank + CAMPPlus, mel, regulator,
conformer-perceiver), cached by prompt content hash; with
`use_bf16_conditioning` on bf16 copies of w2v-bert, RepCodec and CAMPPlus
and on the bf16 runtime GPT.  Stage timers keep the reference's names.

With `use_int4_decode` the decode pack is int4 (`pack_gpt_int4` of the f32
master, K7) through K1 or K3; with `spec_decode_k >= 2` it stays int8 and
the int4 pack is the draft.  `int4_expand` takes False or "i8sh" (the same
numerics); True, a TPU-only dequant scheme, raises.

s2mel follows the JAX engine's DiT flags: with `use_bf16_s2mel` a bf16
runtime copy of the s2mel module runs the solve (the DiT inputs cast to it,
the CFM state and the velocity f32); `DiTConfig.fused_blocks` runs the
whole block trunk through K8 when the request batch is 1, the prompt plus
mel buckets are at most 768 frames and `can_fuse_dit` holds (the JAX
engine's gate, kept although the card has no VMEM limit); otherwise each
block's attention runs K9 with `fused_attention`, K11 with
`flash_attention`, else the einsum.

`GPTConfig.pallas_decode_attention` sends the decode (beam or sampling, not
spec decode) through the unfused step with K5 attention, as in the JAX
package.  The vocoder follows the JAX engine's variant flags:
`use_packed_vocoder` (grouped convs), `use_shared_act_vocoder` (shared
activations) or `use_fused_vocoder` (the late stages through K10), each
built once here from the BigVGAN module's weights.

Engine flags accepted without effect here: `merge_decode_stages` (a grid
setting of the Mosaic kernels, which the CUDA chain does not have),
`use_fused_batch_decode` (the batched sampling decode: the server takes one
request at a time), and `fuse_pipeline` / `fuse_synthesis` / `cfm_unroll` /
`batch_segments` (graph and dispatch settings of the JAX engine; segments
run one after another).  Left out: `infer_batch`, streaming
(`infer_generator`; `infer(stream_return=True)` raises), the Qwen text
emotion model (`infer(use_emo_text=True)` raises), and `tensor_parallel > 1`
(constructing with it raises).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from voice_tts_tpu_torch.audio import (KaldiFbank, MelSpectrogram, Resampler,
                                       SeamlessFeatures, encode_wav_int16,
                                       load_prompt_audio)
from voice_tts_tpu_torch.config import GenerationConfig, TTSConfig
from voice_tts_tpu_torch.engine import post
from voice_tts_tpu_torch.logging import logger
from voice_tts_tpu_torch.models.conditioning.campplus import CAMPPlus
from voice_tts_tpu_torch.models.conditioning.repcodec import (RepCodec,
                                                              repcodec_vq2emb)
from voice_tts_tpu_torch.models.conditioning.w2v_bert import Wav2Vec2Bert
from voice_tts_tpu_torch.models.gpt.beam import beam_decode
from voice_tts_tpu_torch.models.gpt.decode import decode as gpt_decode
from voice_tts_tpu_torch.models.gpt.decode import spec_decode
from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.models.layers import init_weights
from voice_tts_tpu_torch.models.s2mel.cfm import cfm_inference
from voice_tts_tpu_torch.models.s2mel.dit import DiT
from voice_tts_tpu_torch.models.s2mel.s2mel import (S2Mel, assemble_condition,
                                                    place_prompt_mel,
                                                    slice_generated)
from voice_tts_tpu_torch.models.vocoder.bigvgan import BigVGAN
from voice_tts_tpu_torch.models.vocoder.packed import (bigvgan_packed_apply,
                                                       bigvgan_shared_act_apply,
                                                       can_pack, pack_bigvgan,
                                                       pack_bigvgan_shared)
from voice_tts_tpu_torch.ops.dit_blocks import (can_fuse_dit, pack_dit_blocks,
                                                pack_dit_tables)
from voice_tts_tpu_torch.ops.fused_decode import (check_int4_expand, pack_gpt,
                                                  pack_gpt_int4, pack_readout)
from voice_tts_tpu_torch.ops.fused_vocoder import (bigvgan_fused_apply,
                                                   fused_stage_plan,
                                                   pack_fused_stages)
from voice_tts_tpu_torch.text.tokenizer import TextTokenizer
from voice_tts_tpu_torch.utils.convert import FAMILIES, convert, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

# the K8 trunk's frame limit (prompt bucket + mel bucket), as the JAX engine
FUSED_DIT_MAX_FRAMES = 768


@dataclasses.dataclass
class InferenceResult:
    wav: np.ndarray              # int16 mono
    sample_rate: int
    metrics: Dict[str, float]


class HashTokenizer:
    """Deterministic char-hash tokenizer for random-weight runs without a BPE
    model (copied from `voice_tts_tpu/engine/engine.py:61-85`)."""

    punctuation_marks_tokens = [".", "!", "?"]

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.unk_token_id = 2

    def tokenize(self, text: str) -> List[str]:
        return [c for c in text if not c.isspace()]

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        base = self.vocab_size - 10
        return [int(hashlib.md5(t.encode()).hexdigest(), 16) % base + 3
                for t in tokens]

    def split_segments(self, tokens: List[str], max_text_tokens_per_segment=120,
                       quick_streaming_tokens: int = 0) -> List[List[str]]:
        return TextTokenizer.split_segments_by_token(
            tokens, self.punctuation_marks_tokens, max_text_tokens_per_segment,
            quick_streaming_tokens)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; asking for CUDA without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def bench_config() -> TTSConfig:
    """The flagship widths (`TTSConfig()`) with the decode settings `bench.py`
    uses when no environment variable is set: sampling (top-k 30, top-p 0.8,
    temperature 0.8, repetition penalty 10), num_beams 1, max_mel_tokens
    256, text bucket 48, code bucket 256, 15 s prompts, bf16 GPT with the
    int8 trunk through the fused decode step and the folded readout, float
    KV, f32 s2mel / vocoder / conditioning."""
    cfg = TTSConfig()
    cfg.generation.max_mel_tokens = 256
    cfg.generation.num_beams = 1
    e = cfg.engine
    e.text_buckets = (48,)
    e.code_buckets = (256,)
    e.max_prompt_seconds = 15.0
    e.use_fp16 = True
    e.use_int8_decode = True
    e.use_fused_decode = True
    e.fold_readout = True
    e.use_int8_kv = False
    e.fuse_pipeline = True
    return cfg


def serving_config() -> TTSConfig:
    """The flagship widths with the production serving profile
    (`TTSConfig.serving()`, JAX `config.py:523-559`): beam search with 3
    beams over the reference's sampling settings, max_mel_tokens 1500, the
    default text / code buckets, bf16 GPT with the int8 trunk through K3 and
    the ancestor table, int8 KV, folded readout, bf16 conditioning, f32
    masters released."""
    return TTSConfig.serving()


def tiny_config(**engine_overrides) -> TTSConfig:
    """`TTSConfig.tiny()` with the cross-model widths made consistent, as
    the JAX `TTSEngine.tiny` builds it; `engine_overrides` set cfg.engine."""
    cfg = TTSConfig.tiny()
    cfg.engine.max_prompt_seconds = 1.0
    cfg.generation.max_mel_tokens = 24
    cfg.generation.num_beams = 1
    cfg.w2v_bert.feature_projection_input_dim = 160
    cfg.gpt.condition_module.input_size = cfg.w2v_bert.hidden_size
    cfg.gpt.emo_condition_module.input_size = cfg.w2v_bert.hidden_size
    cfg.semantic_codec.hidden_size = cfg.w2v_bert.hidden_size
    cfg.s2mel.dit.content_dim = cfg.s2mel.length_regulator.channels
    cfg.s2mel.gpt_dim = cfg.gpt.model_dim
    cfg.s2mel.gpt_layer_out = cfg.w2v_bert.hidden_size
    cfg.s2mel.dit.in_channels = cfg.mel.num_mels
    cfg.s2mel.dit.style_dim = cfg.campplus.embedding_size
    cfg.s2mel.wavenet.hidden_dim = cfg.s2mel.dit.hidden_dim
    cfg.vocoder.num_mels = cfg.mel.num_mels
    for k, v in engine_overrides.items():
        if not hasattr(cfg.engine, k):
            raise AttributeError(f"unknown engine config field: {k}")
        setattr(cfg.engine, k, v)
    return cfg


def build_models(cfg: TTSConfig) -> Dict[str, torch.nn.Module]:
    """The six model families at `cfg`'s widths (parameters uninitialised)."""
    return {
        "gpt": UnifiedVoice(cfg.gpt),
        "s2mel": S2Mel(cfg.s2mel, cfg.semantic_codec.hidden_size),
        "vocoder": BigVGAN(cfg.vocoder),
        "campplus": CAMPPlus(cfg.campplus),
        "repcodec": RepCodec(cfg.semantic_codec),
        "w2v": Wav2Vec2Bert(cfg.w2v_bert),
    }


class TTSEngine:
    SR_MEL = 22050
    SR_COND = 16000
    _SPK_CACHE_CAP = 32

    def __init__(self, cfg: TTSConfig, models: Dict[str, torch.nn.Module],
                 tokenizer, extras: Optional[Dict] = None, device="cuda"):
        e = cfg.engine
        if e.tensor_parallel > 1:
            raise ValueError("engine flags not ported to PyTorch yet: ['tensor_parallel']")
        self.device = dev = resolve_device(device)
        # the JAX f32 paths are full f32; cuDNN convolutions default to TF32
        # (about three decimal digits), so turn TF32 off for matmuls and convs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.tokenizer = tokenizer
        extras = extras or {}
        self.models = {k: m.to(dev).eval().requires_grad_(False)
                       for k, m in models.items()}
        self.gpt = self.models["gpt"]
        self.s2mel = self.models["s2mel"]
        self.vocoder = self.models["vocoder"]
        self.campplus = self.models["campplus"]
        self.repcodec = self.models["repcodec"]
        self.w2v = self.models["w2v"]

        # GPT runtime copy for decode + teacher-forced latent: int8 trunk +
        # bf16 rest, or bf16, or the f32 master (as the JAX engine builds);
        # the decode packs, int4 ones from the f32 master, are built here,
        # before `release_master_trees` drops it
        self.fused_pack = self.readout_pack = self.spec_draft_pack = None
        if e.use_int8_decode:
            master = self.gpt.state_dict()
            state = quantize_gpt_state(master)
            self.gpt_rt = UnifiedVoice(cfg.gpt, int8=True).to(dev)
            self._cast_like(self.gpt_rt, state)
            self.gpt_rt.load_state_dict(state)
            if e.use_fused_decode:
                if e.use_int4_decode or e.spec_decode_k >= 2:
                    check_int4_expand(e.int4_expand)
                if e.use_int4_decode:
                    self.fused_pack = pack_gpt_int4(master, cfg.gpt.layers,
                                                    group=e.int4_group)
                else:
                    self.fused_pack = pack_gpt(state, cfg.gpt.layers)
                if e.fold_readout:
                    self.readout_pack = pack_readout(state)
                if e.spec_decode_k >= 2:
                    if e.use_int4_decode:
                        raise ValueError(
                            "spec_decode_k needs the int8 target pack; unset "
                            "use_int4_decode (int4 becomes the DRAFT)")
                    if e.use_int8_kv:
                        raise ValueError(
                            "spec_decode_k has no int8-KV support; unset "
                            "use_int8_kv (the speculative verify kernel "
                            "reads/writes the bf16 cache)")
                    self.spec_draft_pack = pack_gpt_int4(master, cfg.gpt.layers,
                                                         group=e.int4_group)
            del master
        elif e.use_fp16:
            self.gpt_rt = UnifiedVoice(cfg.gpt).to(dev)
            self.gpt_rt.load_state_dict(self.gpt.state_dict())
            self.gpt_rt.to(torch.bfloat16)
        else:
            self.gpt_rt = self.gpt
        self.gpt_rt.eval().requires_grad_(False)

        # cold-prompt conditioning: bf16 copies of w2v-bert, RepCodec and
        # CAMPPlus, and the bf16 runtime GPT for the conformer-perceiver
        # (it never touches the int8 trunk); RepCodec's f32 master stays for
        # the s2mel codebook lookup
        if e.use_bf16_conditioning:
            self.w2v_rt, self.repcodec_rt, self.campplus_rt = (
                copy.deepcopy(m).to(torch.bfloat16)
                for m in (self.w2v, self.repcodec, self.campplus))
            self.cond_gpt = self.gpt_rt
        else:
            self.w2v_rt, self.repcodec_rt, self.campplus_rt = (
                self.w2v, self.repcodec, self.campplus)
            self.cond_gpt = self.gpt
        # s2mel runtime copy: bf16 under use_bf16_s2mel (the speaker
        # conditioning's regulator keeps the f32 master, as the JAX engine);
        # the K8 weight pack is static, so it is built once here
        self.s2mel_rt = (copy.deepcopy(self.s2mel).to(torch.bfloat16)
                         if e.use_bf16_s2mel else self.s2mel)
        dcfg = cfg.s2mel.dit
        self.dit_pack = (pack_dit_blocks(self.s2mel_rt.estimator)
                         if dcfg.fused_blocks and can_fuse_dit(dcfg) else None)
        # vocoder variant, as the JAX engine picks it (`engine.py:205-236`):
        # packed grouped convs, shared activations, or the fused late stages.
        # Departure: the JAX engine ignores `use_fused_vocoder` off a TPU; the
        # port honours it on every device (K10 on a CUDA tensor, its plain
        # version on a CPU one, as K8, K9 and K11)
        self.voc_variant, self.voc_pack = "module", None
        vc = cfg.vocoder
        if e.use_packed_vocoder:
            if can_pack(vc):
                self.voc_variant = "packed"
                self.voc_pack = pack_bigvgan(self.vocoder.state_dict(), vc)
        elif e.use_shared_act_vocoder:
            if can_pack(vc):
                self.voc_variant = "shared_act"
                self.voc_pack = pack_bigvgan_shared(self.vocoder.state_dict(), vc)
        elif e.use_fused_vocoder and any(fused_stage_plan(vc)):
            self.voc_variant = "fused"
            self.voc_pack = pack_fused_stages(self.vocoder.state_dict(), vc)
        if e.release_master_trees:
            # inference never reads the f32 GPT / w2v-bert masters once the
            # runtime copies exist; dropping them frees their device memory
            self.models["gpt"] = self.gpt = self.gpt_rt
            if e.use_bf16_conditioning:
                self.models["w2v"] = self.w2v = self.w2v_rt

        self.mel_fn = MelSpectrogram(cfg.mel, dev)
        self.seamless = SeamlessFeatures(sample_rate=self.SR_COND, device=dev)
        self.fbank = KaldiFbank(sample_rate=self.SR_COND, waveform_scale=32768.0,
                                device=dev)
        h = cfg.w2v_bert.hidden_size
        self.w2v_mean = torch.tensor(np.asarray(extras.get("w2v_mean", np.zeros(h)),
                                                np.float32), device=dev)
        self.w2v_std = torch.tensor(np.asarray(extras.get("w2v_std", np.ones(h)),
                                               np.float32), device=dev)
        self.emo_matrix = extras.get("emo_matrix")
        self.spk_matrix = extras.get("spk_matrix")

        self.prompt_samples_16k = int(e.max_prompt_seconds * self.SR_COND)
        self.prompt_samples_22k = int(e.max_prompt_seconds * self.SR_MEL)
        self.prompt_mel_frames = self.mel_fn.num_frames(self.prompt_samples_22k)
        self._resamplers: Dict[Tuple[int, int], Resampler] = {}
        self._spk_cache: Dict[str, dict] = {}
        self._emo_cache: Dict[str, torch.Tensor] = {}
        self._cap_hint: Dict[int, int] = {}
        self._gen_cache: Dict[tuple, object] = {}
        self.generator = torch.Generator(device=dev).manual_seed(e.seed)
        self.last_metrics: Dict[str, float] = {}

    @staticmethod
    def _float_dtype(module: torch.nn.Module) -> torch.dtype:
        """The compute dtype of a module: its first floating parameter's (the
        int8 runtime GPT's conformer and perceiver weights are bf16)."""
        return next(t.dtype for t in module.parameters() if t.is_floating_point())

    @staticmethod
    def _cast_like(module: torch.nn.Module, state: Dict[str, torch.Tensor]):
        """Give every parameter / buffer the dtype it has in `state` (the
        quantized runtime state is int8 + bf16; the module is built f32)."""
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            t.data = t.data.to(state[name].dtype)

    # ------------------------------------------------------------------
    # factories
    # ------------------------------------------------------------------

    @classmethod
    def random(cls, cfg: TTSConfig, device="cuda", seed: int = 0) -> "TTSEngine":
        """Random-weight engine at the JAX initialisers' scales."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.device(dev):       # initialise in place on the device
            models = build_models(cfg)
            for m in models.values():
                init_weights(m, gen)
        emo_dim = cfg.gpt.model_dim

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).cpu().numpy()
        extras = {
            "emo_matrix": [randn(n, emo_dim) * 0.05 for n in cfg.engine.emo_num],
            "spk_matrix": [randn(n, cfg.campplus.embedding_size)
                           for n in cfg.engine.emo_num],
        }
        return cls(cfg, models, HashTokenizer(cfg.gpt.number_text_tokens),
                   extras, dev)

    @classmethod
    def tiny(cls, device="cpu", seed: int = 0, **engine_overrides) -> "TTSEngine":
        """Miniature random-weight engine (CPU-friendly demos and tests)."""
        return cls.random(tiny_config(**engine_overrides), device, seed)

    @classmethod
    def from_jax_params(cls, cfg, params: Dict[str, dict], tokenizer,
                        extras: Optional[Dict] = None, device="cuda") -> "TTSEngine":
        """Engine from a JAX engine's f32 parameter trees (`engine.params`);
        `cfg` is any config with `to_dict()` (the JAX engine's), read into
        the port's `TTSConfig`."""
        cfg = TTSConfig.from_dict(cfg.to_dict())
        models = build_models(cfg)
        for fam in FAMILIES:
            load_family(models[fam], convert(fam, params[fam]))
        return cls(cfg, models, tokenizer, extras, device)

    # ------------------------------------------------------------------
    # prompt handling
    # ------------------------------------------------------------------

    def _resample(self, audio: np.ndarray, src: int, dst: int) -> np.ndarray:
        if src == dst:
            return audio
        key = (src, dst)
        if key not in self._resamplers:
            self._resamplers[key] = Resampler(src, dst, self.device)
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(self.device)
        return self._resamplers[key](x)[0].cpu().numpy()

    @staticmethod
    def _content_key(audio_input) -> str:
        if isinstance(audio_input, (bytes, bytearray)):
            return hashlib.sha256(audio_input).hexdigest()
        if isinstance(audio_input, str):
            return "path:" + audio_input
        arr = np.asarray(audio_input[0] if isinstance(audio_input, tuple)
                         else audio_input)
        return hashlib.sha256(arr.tobytes()).hexdigest()

    def _prepare_prompt_buffers(self, audio: np.ndarray, sr: int):
        a16 = self._resample(audio, sr, self.SR_COND)
        a22 = self._resample(audio, sr, self.SR_MEL)
        n16 = min(len(a16), self.prompt_samples_16k)
        n22 = min(len(a22), self.prompt_samples_22k)
        buf16 = np.zeros((1, self.prompt_samples_16k), np.float32)
        buf16[0, :n16] = a16[:n16]
        pad = (self.cfg.mel.n_fft - self.cfg.mel.hop_size) // 2
        pre = np.zeros((1, self.prompt_samples_22k + 2 * pad), np.float32)
        seg = self.mel_fn.pad_reflect(a22[None, :n22])
        pre[:, :seg.shape[1]] = seg
        return buf16, n16, pre, self.mel_fn.num_frames(n22)

    def _w2v_features(self, audio16: torch.Tensor, n16: torch.Tensor):
        feats, mask = self.seamless(audio16, n16)
        emb = self.w2v_rt(feats.to(self._float_dtype(self.w2v_rt)), mask)
        return (emb.float() - self.w2v_mean) / self.w2v_std, mask.sum(dim=1)

    @torch.no_grad()
    def _speaker_conditioning(self, spk_audio_prompt) -> dict:
        key = self._content_key(spk_audio_prompt)
        if key in self._spk_cache:
            self._spk_cache[key] = self._spk_cache.pop(key)   # LRU touch
            return self._spk_cache[key]
        audio, sr = load_prompt_audio(spk_audio_prompt,
                                      self.cfg.engine.max_prompt_seconds)
        buf16, n16, pre22, mel_frames = self._prepare_prompt_buffers(audio, sr)
        dev = self.device
        audio16 = torch.from_numpy(buf16).to(dev)
        n16_t = torch.tensor([n16], device=dev)
        emb, w2v_len = self._w2v_features(audio16, n16_t)
        _, s_ref = self.repcodec_rt(emb.to(self._float_dtype(self.repcodec_rt)))
        ref_mel = self.mel_fn.on_prepadded(torch.from_numpy(pre22).to(dev))
        fb = self.fbank(audio16)
        fb_frames = torch.clamp(torch.div(n16_t - 400, 160, rounding_mode="floor") + 1,
                                min=0)
        fmask = torch.arange(fb.shape[1], device=dev)[None, :] < fb_frames[:, None]
        fmean = ((fb * fmask[..., None]).sum(dim=1, keepdim=True)
                 / fb_frames[:, None, None])
        fb = (fb - fmean) * fmask[..., None]
        style = self.campplus_rt(fb.to(self._float_dtype(self.campplus_rt)),
                                 fb_frames).float()
        prompt_condition = self.s2mel.regulate(
            s_ref.to(self._float_dtype(self.s2mel)), w2v_len,
            torch.tensor([mel_frames], device=dev), self.prompt_mel_frames)
        cond_emb = emb.to(self._float_dtype(self.cond_gpt))
        entry = {
            "emb": emb, "w2v_len": w2v_len, "ref_mel": ref_mel, "style": style,
            "prompt_condition": prompt_condition, "mel_frames": mel_frames,
            "cond_latents": self.cond_gpt.get_conditioning(cond_emb, w2v_len),
            "spk_emovec": self.cond_gpt.get_emovec(cond_emb, w2v_len),
        }
        while len(self._spk_cache) >= self._SPK_CACHE_CAP:      # LRU eviction
            self._spk_cache.pop(next(iter(self._spk_cache)))
        self._spk_cache[key] = entry
        return entry

    @torch.no_grad()
    def _emotion_conditioning(self, emo_audio_prompt) -> torch.Tensor:
        key = self._content_key(emo_audio_prompt)
        if key in self._emo_cache:
            self._emo_cache[key] = self._emo_cache.pop(key)
            return self._emo_cache[key]
        audio, sr = load_prompt_audio(emo_audio_prompt,
                                      self.cfg.engine.max_prompt_seconds)
        buf16, n16, _, _ = self._prepare_prompt_buffers(audio, sr)
        emb, length = self._w2v_features(torch.from_numpy(buf16).to(self.device),
                                         torch.tensor([n16], device=self.device))
        emovec = self.cond_gpt.get_emovec(emb.to(self._float_dtype(self.cond_gpt)),
                                          length)
        while len(self._emo_cache) >= 16:
            self._emo_cache.pop(next(iter(self._emo_cache)))
        self._emo_cache[key] = emovec
        return emovec

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def _generation_config(self, overrides: Optional[dict]):
        """The engine's GenerationConfig with `overrides` applied; a key
        that GenerationConfig lacks raises (it is not dropped in silence)."""
        base = self.cfg.generation
        if not overrides:
            return base
        unknown = sorted(k for k in overrides if not hasattr(base, k))
        if unknown:
            raise TypeError(f"infer() got unexpected keyword argument(s) {unknown}: "
                            "neither an infer keyword nor a GenerationConfig field")
        kv = tuple(sorted(overrides.items()))
        if kv not in self._gen_cache:
            self._gen_cache[kv] = dataclasses.replace(base, **dict(kv))
        return self._gen_cache[kv]

    def _mel_bucket_for(self, code_bucket: int) -> int:
        m = int(math.ceil(code_bucket * self.cfg.s2mel.mel_scale_factor))
        return m + (-m) % 16

    def _observe_code_len(self, bucket: int, lengths, hit, cap: int, gen) -> None:
        """Longest observed decode length per text bucket, decaying 5% per
        observation (the JAX engine's adaptive code-bucket estimate)."""
        full = gen.max_mel_tokens
        now = 0
        for n, h in zip(lengths, hit):
            n = full if (h and cap < full) else int(n)
            now = max(now, min(n, full))
        self._cap_hint[bucket] = max(now, int(self._cap_hint.get(bucket, 0) * 0.95))

    def _prepare(self, spk_audio_prompt, emo_audio_prompt, emo_alpha,
                 emo_vector, use_random, text, max_text_tokens_per_segment,
                 quick_streaming_tokens: int = 0):
        """Emotion-source resolution + conditioning + segmentation; the
        first ~`quick_streaming_tokens` tokens stay in smaller unmerged
        segments (the JAX `_prepare`'s knob of the same name)."""
        if emo_vector is not None:
            emo_audio_prompt = None
            scale = max(0.0, min(1.0, emo_alpha))
            if scale != 1.0:
                emo_vector = [int(x * scale * 10000) / 10000 for x in emo_vector]
        if emo_audio_prompt is None:
            emo_audio_prompt = spk_audio_prompt
            emo_alpha = 1.0
        spk = self._speaker_conditioning(spk_audio_prompt)
        emo_emovec = self._emotion_conditioning(emo_audio_prompt)
        emovec = spk["spk_emovec"] + emo_alpha * (emo_emovec - spk["spk_emovec"])
        if emo_vector is not None and self.emo_matrix is not None:
            weights = np.asarray(emo_vector, np.float32)
            style_np = spk["style"][0].cpu().numpy()
            rows = []
            for gi, mat in enumerate(self.emo_matrix):
                spk_mat = np.asarray(self.spk_matrix[gi])
                if use_random:
                    idx = np.random.randint(0, spk_mat.shape[0])
                else:
                    sims = (spk_mat @ style_np) / (
                        np.linalg.norm(spk_mat, axis=1)
                        * np.linalg.norm(style_np) + 1e-9)
                    idx = int(np.argmax(sims))
                rows.append(np.asarray(mat)[idx] * weights[gi])
            emovec_mat = torch.from_numpy(np.sum(rows, axis=0)).to(self.device)[None]
            emovec = emovec_mat + (1.0 - float(weights.sum())) * emovec
        tokens = self.tokenizer.tokenize(text)
        segments = self.tokenizer.split_segments(
            tokens, max_text_tokens_per_segment=max_text_tokens_per_segment,
            quick_streaming_tokens=quick_streaming_tokens)
        return spk, emovec, segments

    def infer(self, spk_audio_prompt, text: str, output_path: Optional[str] = None,
              emo_audio_prompt=None, emo_alpha: float = 1.0,
              emo_vector: Optional[List[float]] = None,
              use_emo_text: bool = False, emo_text: Optional[str] = None,
              use_random: bool = False, interval_silence: int = 200,
              verbose: bool = False, max_text_tokens_per_segment: int = 120,
              stream_return: bool = False, more_segment_before: int = 0,
              **generation_kwargs) -> InferenceResult:
        """Synthesize `text` in the voice of `spk_audio_prompt`.

        The JAX `infer`'s signature.  `more_segment_before` keeps the first
        ~N tokens in smaller unmerged segments; `emo_text` is read only with
        `use_emo_text`, and `verbose` is accepted.  `stream_return=True`
        (the segment generator) and `use_emo_text=True` (the Qwen emotion
        model) are not ported and raise; so does a keyword that is neither
        one of these nor a GenerationConfig field."""
        if stream_return:
            raise NotImplementedError(
                "stream_return=True needs infer_generator, which is not ported")
        if use_emo_text:
            raise NotImplementedError(
                "use_emo_text=True needs the Qwen emotion model, which is not ported")
        gen = self._generation_config(generation_kwargs)
        start = time.perf_counter()
        cfg = self.cfg
        spk, emovec, segments = self._prepare(
            spk_audio_prompt, emo_audio_prompt, emo_alpha, emo_vector,
            use_random, text, max_text_tokens_per_segment, more_segment_before)
        timers = {"gpt_gen_time": 0.0, "gpt_forward_time": 0.0,
                  "s2mel_time": 0.0, "bigvgan_time": 0.0,
                  "prepare_time": time.perf_counter() - start,
                  "decode_steps": 0}
        wavs = [self._synthesize_segment(seg, spk, emovec, timers, gen)
                for seg in segments]
        full = post.insert_interval_silence(wavs, cfg.engine.sample_rate,
                                            interval_silence)
        total = time.perf_counter() - start
        wav_len = len(full) / cfg.engine.sample_rate
        metrics = {**timers, "inference_time": total, "audio_length": wav_len,
                   "rtf": total / wav_len if wav_len > 0 else 0.0}
        logger.info("gpt_gen_time: %.2f s, gpt_forward_time: %.2f s, "
                    "s2mel_time: %.2f s, bigvgan_time: %.2f s, RTF: %.4f",
                    timers["gpt_gen_time"], timers["gpt_forward_time"],
                    timers["s2mel_time"], timers["bigvgan_time"], metrics["rtf"])
        self.last_metrics = metrics
        wav_i16 = full.astype(np.int16)
        if output_path:
            with open(output_path, "wb") as f:
                f.write(encode_wav_int16(wav_i16, cfg.engine.sample_rate))
        return InferenceResult(wav_i16, cfg.engine.sample_rate, metrics)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _draw_noise(self, shape) -> torch.Tensor:
        """CFM initial noise (tests replace this to share the JAX noise)."""
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _decode_cap(self, bucket: int, gen) -> int:
        """Decode-length cap for a text bucket on the beam path: the bucket's
        codes-per-token estimate, never below the longest decode this bucket
        was observed to need (`_observe_code_len`), as a code bucket."""
        e = self.cfg.engine
        if not e.auto_code_bucket:
            return gen.max_mel_tokens
        est = int(e.codes_per_text_token * bucket) + 16
        est = max(est, self._cap_hint.get(bucket, 0) + 1)
        cap = post.pick_bucket(min(est, gen.max_mel_tokens), tuple(e.code_buckets))
        return min(cap, gen.max_mel_tokens)

    def _beam_fused_pack(self):
        """The decode pack for beam search, when enabled and available."""
        if self.cfg.engine.use_fused_beam_decode and self.cfg.generation.num_beams <= 8:
            return self.fused_pack
        return None

    def _decode_beam(self, gen, spk, emovec, text, text_lens, bucket, timers):
        """Beam decode at the text bucket's cap with one full-cap retry when
        the cap was hit (the retry replays the same random stream), then the
        host-side silence trim.  Returns (codes (1, cbucket), code_len (1,),
        cbucket); codes past code_len are 0."""
        e = self.cfg.engine
        gen_state = self.generator.get_state()

        def run(max_new):
            self.generator.set_state(gen_state)
            res = beam_decode(self.gpt_rt, gen, spk["cond_latents"], emovec, text,
                              text_lens, max_new, self.generator,
                              fused_pack=self._beam_fused_pack(),
                              int8_kv=e.use_int8_kv, readout_pack=self.readout_pack)
            timers["decode_steps"] += res.steps
            return res, bool(res.hit_limit[0])

        cap = self._decode_cap(bucket, gen)
        res, hit = run(cap)
        self._observe_code_len(bucket, [int(res.lengths[0])], [hit], cap, gen)
        if hit and cap < gen.max_mel_tokens:
            res, hit = run(gen.max_mel_tokens)
        # the stop token is excluded unless the hypothesis never produced one
        code_len = max(int(res.lengths[0]) - (0 if hit else 1), 1)
        codes_np, code_lens = post.remove_long_silence(
            res.codes.cpu().numpy()[:, :code_len], np.asarray([code_len]),
            self.cfg.gpt.stop_mel_token, e.silent_token)
        code_len = int(code_lens[0])
        cbucket = post.pick_bucket(code_len, tuple(e.code_buckets))
        # pad with 0, an ordinary code: the teacher-forced forward replaces
        # positions past code_len with the stop token, and the regulator never
        # gathers past code_len
        codes = np.zeros((1, cbucket), np.int64)
        codes[0, :code_len] = codes_np[0, :code_len]
        return (torch.from_numpy(codes).to(self.device),
                torch.tensor([code_len], device=self.device), cbucket)

    def _decode_sampled(self, gen, spk, emovec, text, text_lens, text_len,
                        bucket, timers):
        """Sampling / greedy decode with the JAX `fuse_pipeline` path's code
        bucket estimate and its one full-bucket retry when the estimate was
        hit, then the device-side silence trim.  Returns (codes (1, cbucket),
        code_len (1,), cbucket)."""
        e = self.cfg.engine
        codes_b = tuple(e.code_buckets)
        full_cbucket = post.pick_bucket(gen.max_mel_tokens, codes_b)
        if e.auto_code_bucket:
            est = int(text_len * e.codes_per_text_token) + 16
            est = max(est, self._cap_hint.get(bucket, 0) + 1)
            cbucket = post.pick_bucket(min(est, gen.max_mel_tokens), codes_b)
        else:
            cbucket = full_cbucket
        gen_state = self.generator.get_state()
        while True:
            # a retry replays the same random stream
            self.generator.set_state(gen_state)
            max_new = min(cbucket, gen.max_mel_tokens)
            if self.spec_draft_pack is not None:      # spec_decode_k >= 2
                res = spec_decode(self.gpt_rt, gen, spk["cond_latents"], emovec,
                                  text, text_lens, max_new, self.generator,
                                  self.fused_pack, self.spec_draft_pack,
                                  e.spec_decode_k)
                timers["spec_rounds"] = timers.get("spec_rounds", 0) + res.rounds
                timers["spec_accepted"] = timers.get("spec_accepted", 0) + res.accepted
            else:
                res = gpt_decode(self.gpt_rt, gen, spk["cond_latents"], emovec,
                                 text, text_lens, max_new, self.generator,
                                 self.fused_pack, self.readout_pack,
                                 int8_kv=e.use_int8_kv)
            timers["decode_steps"] += res.steps
            if bool(res.hit_limit[0]) and cbucket < full_cbucket:
                self._observe_code_len(bucket, [cbucket], [True], cbucket, gen)
                cbucket = full_cbucket
                continue
            break
        code_len0 = torch.clamp(res.lengths - (~res.hit_limit).long(), min=1)
        codes, code_len = post.remove_long_silence_torch(
            res.codes, code_len0, self.cfg.gpt.stop_mel_token, e.silent_token)
        if cbucket < codes.shape[1]:
            codes = codes[:, :cbucket]
            code_len = torch.clamp(code_len, max=cbucket)
        elif cbucket > codes.shape[1]:
            codes = torch.nn.functional.pad(codes, (0, cbucket - codes.shape[1]))
        return codes, code_len, cbucket

    @torch.no_grad()
    def _synthesize_segment(self, seg_tokens: List[str], spk: dict,
                            emovec: torch.Tensor, timers: dict,
                            gen: GenerationConfig) -> np.ndarray:
        """decode (beam or sampling, see the two `_decode_*`) -> silence
        trim -> latent -> s2mel -> vocoder for one segment."""
        cfg, e, dev = self.cfg, self.cfg.engine, self.device
        ids = self.tokenizer.convert_tokens_to_ids(seg_tokens)
        text_len = len(ids)
        bucket = post.pick_bucket(text_len, e.text_buckets)
        text = torch.zeros((1, bucket), dtype=torch.long)
        text[0, :min(text_len, bucket)] = torch.tensor(ids[:bucket])
        text = text.to(dev)
        text_lens = torch.tensor([min(text_len, bucket)], device=dev)
        pbuckets = tuple(b for b in e.prompt_frame_buckets
                         if b < self.prompt_mel_frames) + (self.prompt_mel_frames,)
        pbucket = post.pick_bucket(spk["mel_frames"], pbuckets)

        # --- AR decode
        t0 = time.perf_counter()
        if gen.num_beams > 1:
            codes, code_len, cbucket = self._decode_beam(
                gen, spk, emovec, text, text_lens, bucket, timers)
        else:
            codes, code_len, cbucket = self._decode_sampled(
                gen, spk, emovec, text, text_lens, text_len, bucket, timers)
        self._sync()
        timers["gpt_gen_time"] += time.perf_counter() - t0

        # --- teacher-forced GPT latent
        t0 = time.perf_counter()
        latent = self.gpt_rt(spk["cond_latents"], emovec, text, text_lens,
                             codes, code_len)
        self._sync()
        timers["gpt_forward_time"] += time.perf_counter() - t0

        # --- s2mel
        t0 = time.perf_counter()
        mel_bucket = self._mel_bucket_for(cbucket)
        mel, target_len = self._s2mel(latent, codes, code_len,
                                      spk["prompt_condition"][:, :pbucket],
                                      torch.tensor([spk["mel_frames"]], device=dev),
                                      spk["ref_mel"][:, :, :pbucket], spk["style"],
                                      mel_bucket)
        self._sync()
        timers["s2mel_time"] += time.perf_counter() - t0

        # --- vocoder
        t0 = time.perf_counter()
        wav = torch.clamp(self.vocode(mel) * 32767.0, -32767.0, 32767.0)
        wav = wav.to(torch.int16).reshape(-1).cpu().numpy()
        timers["bigvgan_time"] += time.perf_counter() - t0
        n_frames = int(target_len[0])
        if gen.num_beams <= 1:
            # the sampling path also learns from successful decodes (the
            # JAX fused pipeline's frame-derived observation)
            obs_codes = max(1, int(math.ceil(
                n_frames / max(cfg.s2mel.mel_scale_factor, 1e-6))))
            self._observe_code_len(bucket, [obs_codes], [False], cbucket, gen)
        return wav[: n_frames * cfg.mel.hop_size]

    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, num_mels, F) -> waveform (B, 1, samples) through the
        configured vocoder variant (`voc_variant`)."""
        if self.voc_variant == "packed":
            return bigvgan_packed_apply(self.voc_pack, mel, self.cfg.vocoder)
        if self.voc_variant == "shared_act":
            return bigvgan_shared_act_apply(self.voc_pack, mel, self.cfg.vocoder)
        if self.voc_variant == "fused":
            return bigvgan_fused_apply(self.vocoder, self.voc_pack, mel)
        return self.vocoder(mel)

    def use_fused_dit(self, batch: int, total_max: int) -> bool:
        """The JAX engine's K8 gate: the pack exists (`fused_blocks` and
        `can_fuse_dit`), one request, at most FUSED_DIT_MAX_FRAMES frames."""
        return (self.dit_pack is not None and batch == 1
                and total_max <= FUSED_DIT_MAX_FRAMES)

    def _s2mel(self, latent, codes, code_len, prompt_condition, prompt_len,
               ref_mel, style, mel_bucket: int):
        """Length regulator + CFM solve; returns (mel (B, 80, mel_bucket)
        with frames past target_len zeroed, target_len)."""
        e = self.cfg.engine
        s2 = self.s2mel_rt
        latent2 = s2.gpt_layer(latent)
        s_infer = repcodec_vq2emb(self.repcodec, codes) + latent2
        target_len = torch.floor(code_len.float()
                                 * self.cfg.s2mel.mel_scale_factor).long()
        cond = s2.regulate(s_infer, code_len, target_len, mel_bucket)
        total_max = prompt_condition.shape[1] + mel_bucket
        cat, total_len = assemble_condition(prompt_condition, prompt_len, cond,
                                            target_len, total_max)
        prompt_x = place_prompt_mel(ref_mel, prompt_len, total_max)
        n_steps = e.diffusion_steps
        est = s2.estimator
        t_mids = torch.linspace(0.0, 1.0, n_steps + 1, device=self.device)[:n_steps]
        tables = est.step_tables(t_mids)
        fused_w = None
        if self.use_fused_dit(cat.shape[0], total_max):
            fused_w = self.dit_pack
            tables["fused_wb"] = pack_dit_tables(est, tables)
        # compute dtype follows the runtime module; the CFM state stays f32
        dt = self._float_dtype(s2)

        def velocity(x, p, lens, t, s, mu, tab):
            return s2.velocity(x.to(dt), p.to(dt), lens, t, s.to(dt), mu.to(dt),
                               tables=tab, fused_w=fused_w).float()
        noise = self._draw_noise((cat.shape[0], prompt_x.shape[1], total_max))
        mel = cfm_inference(velocity, cat, total_len, prompt_x, prompt_len, style,
                            n_steps, e.inference_cfg_rate, noise=noise,
                            tables=lambda i: DiT.table_step(tables, i))
        gen = slice_generated(mel, prompt_len, mel_bucket)
        frame = torch.arange(mel_bucket, device=self.device)
        # frames past target_len still hold CFM noise; zero them so the
        # vocoder's first conv does not smear it into the last valid frames
        gen = torch.where(frame[None, None, :] < target_len[:, None, None], gen, 0.0)
        return gen, target_len

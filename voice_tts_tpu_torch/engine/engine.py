"""TTSEngine: the inference engine, PyTorch + CUDA
(`voice_tts_tpu/engine/engine.py`: `infer`, `infer_generator`,
`infer_batch` and its job machinery, `to_device`, `_prepare`, `_decode_cap`,
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

On a CUDA device the decode loops of the K1 and K3 arms and the CFM solve
run as the JAX package runs them, on the device (`engine/device_loop.py`):
the decode a chunk of CHUNK steps at a time, each chunk a replay of a CUDA
graph captured once per shape key (one host read a chunk), and the 25 Euler
steps one graph a request.  The graphs and their static buffers belong to
the engine (`self.loops`); a key's first request captures them.  The spec
decode and the unfused arms keep their host loops.

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

Several requests, and the segments of a long text, decode together
(`infer_batch`; `infer` with `batch_segments` when `_should_batch_segments`
weighs the card's step times `DECODE_STEP_MS` in favour): grouped by text
bucket in sub-batches of `server.max_batch_size`, padded to a power of 2,
at the bucket's learned cap with one full-cap retry of the rows that hit
it.  Beam search packs `beam_batch_rows // K` requests into one K3 step of
up to 12 rows (`beam_decode_fused_batch`, each request on a stream of its
own); sampling with `use_fused_batch_decode` runs K3 over the rows at one
shared position.  The s2mel and the vocoder then run at the batch of a
code bucket.  `infer_generator` (and `infer(stream_return=True)`) yields
each segment's waveform as it is made; `to_device` moves a replica.

Factories: `from_artifacts` loads a converted model directory
(`utils.artifacts`, written from the published checkpoints by
`utils.onboard`) in the production, bench or saved profile; `random` /
`tiny` build random weights (`random_models`); `from_jax_params` converts a
JAX engine's parameter trees.  Every `condition_type` the JAX package
builds is ported: `conformer_perceiver`, `perceiver` and the mean-pooled
default arm (one conditioning latent).

Engine flags accepted without effect here: `merge_decode_stages` (a grid
setting of the Mosaic kernels, which the CUDA chain does not have), and
`fuse_pipeline` / `fuse_synthesis` / `cfm_unroll` (graph and dispatch
settings of the JAX engine).  Left out: the Qwen text emotion model
(`infer(use_emo_text=True)` raises), and `tensor_parallel > 1`
(constructing with it raises).
"""

from __future__ import annotations

import contextlib
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
from voice_tts_tpu_torch.engine import device_loop, post
from voice_tts_tpu_torch.logging import logger
from voice_tts_tpu_torch.models.conditioning.campplus import CAMPPlus
from voice_tts_tpu_torch.models.conditioning.repcodec import (RepCodec,
                                                              repcodec_vq2emb)
from voice_tts_tpu_torch.models.conditioning.w2v_bert import Wav2Vec2Bert
from voice_tts_tpu_torch.models.gpt.beam import (beam_decode, beam_decode_batch,
                                                 beam_decode_fused_batch)
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
from voice_tts_tpu_torch.text import SentencePieceBPE, TextNormalizer, sp_model
from voice_tts_tpu_torch.text.tokenizer import TextTokenizer
from voice_tts_tpu_torch.utils.artifacts import load_artifacts, split_matrix_groups
from voice_tts_tpu_torch.utils.convert import FAMILIES, convert, load_family
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

# the K8 trunk's frame limit (prompt bucket + mel bucket), as the JAX engine
FUSED_DIT_MAX_FRAMES = 768

# ms a decode step of the flagship bench configuration on one card, the
# rates `_should_batch_segments` weighs: "k1" the one-row K1 device loop,
# "k3_batch" the batched sampling decode's K3 device loop at 4 rows, "eager"
# the unfused step's host loop at 4 rows (medians of 3 runs of 254 and 31
# steps, each decode's wall over its steps: the prefill included, one a row
# in the batched decode).  Measured on NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit by `python -m voice_tts_tpu_torch.scripts.decode_host_time
# --profiles rates`.
DECODE_STEP_MS = {"k1": 1.1121, "k3_batch": 1.8966, "eager": 41.5748}

# the keys an `infer_batch` request dict may hold: `infer`'s keywords that a
# request of a group can carry (every request decodes with the engine's
# GenerationConfig, so a per-request generation field is refused too)
BATCH_REQUEST_KEYS = frozenset({
    "spk_audio_prompt", "text", "emo_audio_prompt", "emo_alpha", "emo_vector",
    "use_emo_text", "emo_text", "use_random", "interval_silence", "verbose",
    "max_text_tokens_per_segment", "more_segment_before", "quick_streaming_tokens"})


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


def on_device(device):
    """A block in which `device` is this thread's current CUDA device (a
    no-op off the card).  The kernels launch on the current device's
    streams, so a thread drives a replica on another card only inside such
    a block, or after `use_device`."""
    if device is None or torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(torch.device(device))


def use_device(device) -> None:
    """Make `device` this thread's current CUDA device for good (a no-op off
    the card): the first call of a thread that drives one replica."""
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)


def apply_bench_profile(cfg: TTSConfig) -> TTSConfig:
    """The decode settings `bench.py` uses when no environment variable is
    set, applied to `cfg` in place (returns it): sampling (top-k 30, top-p
    0.8, temperature 0.8, repetition penalty 10), num_beams 1,
    max_mel_tokens 256, text bucket 48, code bucket 256, 15 s prompts, bf16
    GPT with the int8 trunk through the fused decode step and the folded
    readout, float KV, f32 s2mel / vocoder / conditioning."""
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


def bench_config() -> TTSConfig:
    """The flagship widths (`TTSConfig()`) in the bench profile
    (`apply_bench_profile`)."""
    return apply_bench_profile(TTSConfig())


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


def build_models(cfg: TTSConfig, repcodec_decoder: bool = False
                 ) -> Dict[str, torch.nn.Module]:
    """The six model families at `cfg`'s widths (parameters uninitialised);
    RepCodec with its decoder when `repcodec_decoder` (a loaded codec that
    carries the decoder's weights)."""
    return {
        "gpt": UnifiedVoice(cfg.gpt),
        "s2mel": S2Mel(cfg.s2mel, cfg.semantic_codec.hidden_size),
        "vocoder": BigVGAN(cfg.vocoder),
        "campplus": CAMPPlus(cfg.campplus),
        "repcodec": RepCodec(cfg.semantic_codec, decoder=repcodec_decoder),
        "w2v": Wav2Vec2Bert(cfg.w2v_bert),
    }


def random_models(cfg: TTSConfig, device, seed: int = 0):
    """The six families' f32 masters at the JAX initialisers' scales,
    initialised in place on `device` from one generator seeded `seed`, and
    the random emo / spk matrices drawn after them: (models, extras).  The
    same `cfg`, device and seed give the same tensors."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        models = build_models(cfg)
        for m in models.values():
            init_weights(m, gen)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).cpu().numpy()
    extras = {
        "emo_matrix": [randn(n, cfg.gpt.model_dim) * 0.05 for n in cfg.engine.emo_num],
        "spk_matrix": [randn(n, cfg.campplus.embedding_size) for n in cfg.engine.emo_num],
    }
    return models, extras


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
        # row slots of the request-batched decodes, one stream a job
        self._job_streams: List[torch.Generator] = []
        # the captured device loops (decode chunks, CFM solve) on the card
        self.loops = device_loop.DeviceLoops(dev) if dev.type == "cuda" else None
        self._step_tables: Dict[bool, dict] = {}
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

    def to_device(self, device) -> "TTSEngine":
        """Move the engine to `device` (one replica per GPU, JAX
        `to_device`): every module and runtime copy, the decode, readout,
        DiT and vocoder packs, the frontends' and resamplers' buffers, the
        w2v-bert statistics; the generator continues on the new device from
        a seed drawn from the old one, the device loops become the new
        device's (none on the CPU), and the speaker and emotion caches are
        cleared.  A CUDA engine refuses to move to the CPU."""
        dev = resolve_device(device)
        if self.device.type == "cuda" and dev.type != "cuda":
            raise ValueError(f"to_device: a CUDA engine does not move to {dev}")
        moved: Dict[int, object] = {}

        def put(x):
            if isinstance(x, torch.nn.Module):
                return x.to(dev)
            if isinstance(x, torch.Tensor):
                if id(x) not in moved:      # aliased tensors stay aliased
                    moved[id(x)] = x.to(dev)
                return moved[id(x)]
            if isinstance(x, tuple):
                items = [put(v) for v in x]
                return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
            if isinstance(x, list):
                return [put(v) for v in x]
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            return x

        for name in ("models", "gpt_rt", "w2v_rt", "repcodec_rt", "campplus_rt",
                     "cond_gpt", "s2mel_rt", "fused_pack", "readout_pack",
                     "spec_draft_pack", "dit_pack", "voc_pack", "w2v_mean", "w2v_std"):
            setattr(self, name, put(getattr(self, name)))
        for name in ("gpt", "s2mel", "vocoder", "campplus", "repcodec", "w2v"):
            setattr(self, name, self.models[name])
        for obj in (self.mel_fn, self.seamless, self.seamless.fbank, self.fbank,
                    *self._resamplers.values()):
            for attr, val in list(vars(obj).items()):
                if isinstance(val, torch.Tensor):
                    setattr(obj, attr, put(val))
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                                 device=self.device))
        self.device = dev
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self._job_streams = []
        self.loops = device_loop.DeviceLoops(dev) if dev.type == "cuda" else None
        self._step_tables.clear()
        self._spk_cache.clear()
        self._emo_cache.clear()
        return self

    # ------------------------------------------------------------------
    # factories
    # ------------------------------------------------------------------

    @classmethod
    def random(cls, cfg: TTSConfig, device="cuda", seed: int = 0) -> "TTSEngine":
        """Random-weight engine at the JAX initialisers' scales
        (`random_models`)."""
        dev = resolve_device(device)
        models, extras = random_models(cfg, dev, seed)
        return cls(cfg, models, HashTokenizer(cfg.gpt.number_text_tokens),
                   extras, dev)

    @classmethod
    def from_artifacts(cls, directory: str, profile: Optional[str] = None,
                       device="cuda") -> "TTSEngine":
        """Load a converted model directory (`utils.artifacts`).

        `profile="serving"` applies the production profile
        (`TTSConfig.apply_serving_profile`) to the saved config, "bench"
        the bench profile (`apply_bench_profile`); None / "stock" keeps the
        config as saved.  A missing family raises FileNotFoundError.  The
        tokenizer is the directory's `bpe.model` through the sentencepiece
        reader, else `HashTokenizer`."""
        cfg, states, extras, bpe_bytes = load_artifacts(directory)
        if profile == "serving":
            cfg.apply_serving_profile()
        elif profile == "bench":
            apply_bench_profile(cfg)
        elif profile not in (None, "stock"):
            raise ValueError(f"unknown profile {profile!r} "
                             "(expected 'serving', 'bench' or 'stock')")
        missing = [f for f in FAMILIES if f not in states]
        if missing:
            raise FileNotFoundError(f"missing model families in {directory}: {missing}")
        for key in ("emo_matrix", "spk_matrix"):
            if key + "_raw" in extras:
                extras[key] = split_matrix_groups(extras.pop(key + "_raw"),
                                                  cfg.engine.emo_num)
        if bpe_bytes:
            normalizer = TextNormalizer()
            normalizer.load()
            tokenizer = TextTokenizer(
                SentencePieceBPE(sp_model.parse_model(bpe_bytes)), normalizer)
        else:
            tokenizer = HashTokenizer(cfg.gpt.number_text_tokens)
        models = build_models(
            cfg, repcodec_decoder="decoder_out.weight" in states["repcodec"])
        for fam in FAMILIES:
            load_family(models[fam], states.pop(fam))
        return cls(cfg, models, tokenizer, extras, device)

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

    def _conditioning_forward(self, rows: List[tuple]) -> Dict[str, torch.Tensor]:
        """The new-speaker conditioning of the prompt buffers `rows` (each
        `_prepare_prompt_buffers`'s (buf16, n16, pre22, mel_frames)) in one
        forward over their batch: (B, ...) tensors under the cache entry's
        names (`mel_frames` excepted)."""
        dev = self.device
        audio16 = torch.from_numpy(np.concatenate([r[0] for r in rows])).to(dev)
        n16_t = torch.tensor([r[1] for r in rows], device=dev)
        pre22 = torch.from_numpy(np.concatenate([r[2] for r in rows])).to(dev)
        mel_frames = torch.tensor([r[3] for r in rows], device=dev)
        emb, w2v_len = self._w2v_features(audio16, n16_t)
        _, s_ref = self.repcodec_rt(emb.to(self._float_dtype(self.repcodec_rt)))
        ref_mel = self.mel_fn.on_prepadded(pre22)
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
            s_ref.to(self._float_dtype(self.s2mel)), w2v_len, mel_frames,
            self.prompt_mel_frames)
        cond_emb = emb.to(self._float_dtype(self.cond_gpt))
        return {
            "emb": emb, "w2v_len": w2v_len, "ref_mel": ref_mel, "style": style,
            "prompt_condition": prompt_condition,
            "cond_latents": self.cond_gpt.get_conditioning(cond_emb, w2v_len),
            "spk_emovec": self.cond_gpt.get_emovec(cond_emb, w2v_len),
        }

    def _spk_cache_put(self, key: str, entry: dict) -> None:
        while len(self._spk_cache) >= self._SPK_CACHE_CAP:      # LRU eviction
            self._spk_cache.pop(next(iter(self._spk_cache)))
        self._spk_cache[key] = entry

    @torch.no_grad()
    def _speaker_conditioning(self, spk_audio_prompt) -> dict:
        key = self._content_key(spk_audio_prompt)
        if key in self._spk_cache:
            self._spk_cache[key] = self._spk_cache.pop(key)   # LRU touch
            return self._spk_cache[key]
        audio, sr = load_prompt_audio(spk_audio_prompt,
                                      self.cfg.engine.max_prompt_seconds)
        row = self._prepare_prompt_buffers(audio, sr)
        entry = {**self._conditioning_forward([row]), "mel_frames": row[3]}
        self._spk_cache_put(key, entry)
        return entry

    @torch.no_grad()
    def _speaker_conditioning_batch(self, prompts: List) -> None:
        """Warm the conditioning cache for a group of prompts in one batched
        forward over the new speakers (JAX `_speaker_conditioning_batch`):
        rows padded to a power of 2 by repeating row 0, each new speaker's
        row cached under its content hash as `_speaker_conditioning` would
        cache it.  A row's entry is a rounding away from the speaker's
        entry alone (the GEMMs and FFTs pick their kernels by the row
        count), so a cold speaker's codes may differ between a group and a
        lone request; a cached speaker's do not."""
        missing: Dict[str, tuple] = {}
        for p in prompts:
            key = self._content_key(p)
            if key in self._spk_cache:
                self._spk_cache[key] = self._spk_cache.pop(key)   # LRU touch
            elif key not in missing:
                audio, sr = load_prompt_audio(p, self.cfg.engine.max_prompt_seconds)
                missing[key] = self._prepare_prompt_buffers(audio, sr)
        if not missing:
            return
        rows = list(missing.values())
        rows += [rows[0]] * (self._batch_bucket(len(rows)) - len(rows))
        out = self._conditioning_forward(rows)
        for i, (key, row) in enumerate(missing.items()):
            self._spk_cache_put(key, {**{k: v[i:i + 1] for k, v in out.items()},
                                      "mel_frames": row[3]})

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

    @staticmethod
    def _new_timers(**extra) -> Dict[str, float]:
        """A request's stage timers and decode counts, at 0."""
        return {"gpt_gen_time": 0.0, "gpt_forward_time": 0.0, "s2mel_time": 0.0,
                "bigvgan_time": 0.0, "decode_steps": 0, "decode_runs": 0,
                "decode_chunks": 0, **extra}

    def infer_generator(self, spk_audio_prompt, text: str,
                        emo_audio_prompt=None, emo_alpha: float = 1.0,
                        emo_vector: Optional[List[float]] = None,
                        use_emo_text: bool = False, emo_text: Optional[str] = None,
                        use_random: bool = False, interval_silence: int = 200,
                        verbose: bool = False, max_text_tokens_per_segment: int = 120,
                        quick_streaming_tokens: int = 0, **generation_kwargs):
        """Streaming synthesis (JAX `infer_generator`): a generator of each
        segment's int16 waveform, each followed by the silence gap but the
        last.  `quick_streaming_tokens` keeps the first ~N tokens in smaller
        unmerged segments (sooner first audio).  The keywords are checked
        here (`use_emo_text=True` and unknown keywords raise); the
        conditioning and the segments run as the generator is read."""
        if use_emo_text:
            raise NotImplementedError(
                "use_emo_text=True needs the Qwen emotion model, which is not ported")
        gen = self._generation_config(generation_kwargs)

        def segments():
            spk, emovec, segs = self._prepare(
                spk_audio_prompt, emo_audio_prompt, emo_alpha, emo_vector, use_random,
                text, max_text_tokens_per_segment, quick_streaming_tokens)
            timers = self._new_timers()
            sil = np.zeros(int(self.cfg.engine.sample_rate * interval_silence / 1000.0),
                           dtype=np.int16)
            for i, seg in enumerate(segs):
                yield self._synthesize_segment(seg, spk, emovec, timers, gen)
                if i < len(segs) - 1 and interval_silence > 0:
                    yield sil
        return segments()

    def infer(self, spk_audio_prompt, text: str, output_path: Optional[str] = None,
              emo_audio_prompt=None, emo_alpha: float = 1.0,
              emo_vector: Optional[List[float]] = None,
              use_emo_text: bool = False, emo_text: Optional[str] = None,
              use_random: bool = False, interval_silence: int = 200,
              verbose: bool = False, max_text_tokens_per_segment: int = 120,
              stream_return: bool = False, more_segment_before: int = 0,
              **generation_kwargs):
        """Synthesize `text` in the voice of `spk_audio_prompt`.

        The JAX `infer`'s signature: an InferenceResult, or with
        `stream_return=True` the segment generator (`infer_generator`, with
        `more_segment_before` as its `quick_streaming_tokens`).
        `more_segment_before` keeps the first ~N tokens in smaller unmerged
        segments; `emo_text` is read only with `use_emo_text`, and `verbose`
        is accepted.  A multi-segment text decodes its segments together
        through the batched job path when `_should_batch_segments` says so.
        `use_emo_text=True` (the Qwen emotion model) is not ported and
        raises; so does a keyword that is neither one of these nor a
        GenerationConfig field."""
        if stream_return:
            return self.infer_generator(
                spk_audio_prompt, text, emo_audio_prompt, emo_alpha, emo_vector,
                use_emo_text, emo_text, use_random, interval_silence, verbose,
                max_text_tokens_per_segment, more_segment_before, **generation_kwargs)
        if use_emo_text:
            raise NotImplementedError(
                "use_emo_text=True needs the Qwen emotion model, which is not ported")
        gen = self._generation_config(generation_kwargs)
        start = time.perf_counter()
        cfg = self.cfg
        spk, emovec, segments = self._prepare(
            spk_audio_prompt, emo_audio_prompt, emo_alpha, emo_vector,
            use_random, text, max_text_tokens_per_segment, more_segment_before)
        timers = self._new_timers(prepare_time=time.perf_counter() - start)
        captured = self.loops.stats["capture_s"] if self.loops is not None else 0.0
        if self._should_batch_segments(segments, gen):
            # the segments decode together (wall ~ the longest segment)
            jobs = [{"tokens": seg, "spk": spk, "emovec": emovec} for seg in segments]
            self._run_segment_jobs(jobs, gen, timers)
            wavs = [j["wav"] for j in jobs]
        else:
            wavs = [self._synthesize_segment(seg, spk, emovec, timers, gen)
                    for seg in segments]
        if self.loops is not None:
            timers["capture_time"] = self.loops.stats["capture_s"] - captured
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

    # ------------------------------------------------------------------
    # batched inference (JAX `infer_batch` and its job machinery)
    # ------------------------------------------------------------------

    def infer_batch(self, requests: List[dict]) -> List[InferenceResult]:
        """Synthesize several requests together: the decode and the
        s2mel / vocoder stages batched across their segments (JAX
        `infer_batch`).  Each request dict takes `infer`'s keywords
        (spk_audio_prompt, text, emo_audio_prompt, emo_alpha, emo_vector,
        use_random, interval_silence, max_text_tokens_per_segment,
        more_segment_before or quick_streaming_tokens); every request decodes
        with the engine's GenerationConfig.  Results in request order, with
        `inference_time`, `audio_length` and `rtf`; the group's stage timers
        and decode counts go to `last_metrics`.  A key outside
        `BATCH_REQUEST_KEYS` raises TypeError (it is not dropped in
        silence)."""
        cfg = self.cfg
        start = time.perf_counter()
        for i, req in enumerate(requests):
            unknown = sorted(set(req) - BATCH_REQUEST_KEYS)
            if unknown:
                raise TypeError(f"infer_batch() request {i} has unexpected key(s) "
                                f"{unknown}: requests decode with the engine's "
                                "GenerationConfig")
        if any(req.get("use_emo_text", False) for req in requests):
            raise NotImplementedError(
                "use_emo_text=True needs the Qwen emotion model, which is not ported")
        # one batched conditioning forward for the group's new speakers
        self._speaker_conditioning_batch([req["spk_audio_prompt"] for req in requests])
        prepared, jobs = [], []
        t_prep = time.perf_counter()
        for ri, req in enumerate(requests):
            spk, emovec, segments = self._prepare(
                req["spk_audio_prompt"], req.get("emo_audio_prompt"),
                req.get("emo_alpha", 1.0), req.get("emo_vector"),
                req.get("use_random", False), req["text"],
                req.get("max_text_tokens_per_segment", 120),
                req.get("more_segment_before", req.get("quick_streaming_tokens", 0)))
            prepared.append(req)
            jobs += [{"req": ri, "seg": si, "tokens": seg, "spk": spk, "emovec": emovec}
                     for si, seg in enumerate(segments)]
        timers = self._new_timers(prepare_time=time.perf_counter() - t_prep)
        captured = self.loops.stats["capture_s"] if self.loops is not None else 0.0
        self._run_segment_jobs(jobs, cfg.generation, timers)
        if self.loops is not None:
            timers["capture_time"] = self.loops.stats["capture_s"] - captured
        logger.info("infer_batch: %d req / %d jobs - prepare %.2f s, decode %.2f s, "
                    "synthesis %.2f s", len(requests), len(jobs), timers["prepare_time"],
                    timers["gpt_gen_time"], timers["synthesis_time"])
        results: List[InferenceResult] = []
        total = time.perf_counter() - start
        for ri, req in enumerate(prepared):
            wavs = [j["wav"] for j in sorted((j for j in jobs if j["req"] == ri),
                                             key=lambda j: j["seg"])]
            full = post.insert_interval_silence(wavs, cfg.engine.sample_rate,
                                                req.get("interval_silence", 200))
            wav_len = len(full) / cfg.engine.sample_rate
            results.append(InferenceResult(full.astype(np.int16), cfg.engine.sample_rate, {
                "inference_time": total, "audio_length": wav_len,
                "rtf": total / wav_len if wav_len > 0 else 0.0}))
        self.last_metrics = {**timers, "inference_time": total}
        return results

    def _should_batch_segments(self, segments: List[List[str]], gen) -> bool:
        """Route a multi-segment `infer` to the batched job path only when
        its decode is estimated faster than the segments one after another
        (JAX `_should_batch_segments`): the batched decode pays its step
        time on the longest segment, the sequential one its own on the sum
        (codes scale with the text).  Beam search is the same K3 step
        either way, so it always batches.  The step times are the card's,
        `DECODE_STEP_MS`."""
        if not self.cfg.engine.batch_segments or len(segments) <= 1:
            return False
        if gen.num_beams > 1:
            return True
        lens = [len(s) for s in segments]
        fused_single = self.fused_pack is not None
        fused_batch = fused_single and self.cfg.engine.use_fused_batch_decode
        r_seq = DECODE_STEP_MS["k1"] if fused_single else DECODE_STEP_MS["eager"]
        r_bat = DECODE_STEP_MS["k3_batch"] if fused_batch else DECODE_STEP_MS["eager"]
        return r_bat * max(lens) < r_seq * sum(lens)

    def _run_segment_jobs(self, jobs: List[dict], gen, timers: dict) -> None:
        """Decode and synthesize segment jobs in sub-batches of at most
        `server.max_batch_size` (JAX `_run_segment_jobs`): the decode
        grouped by text bucket, the s2mel / vocoder by code bucket.  Each
        job holds {"tokens", "spk", "emovec"} and gains {"ids", "bucket",
        "codes", "code_len", "cbucket", "text_row", "text_len", "wav"}."""
        cfg = self.cfg
        batch_cap = max(1, cfg.server.max_batch_size)
        t0 = time.perf_counter()
        by_bucket: Dict[int, List[dict]] = {}
        for job in jobs:
            job["ids"] = self.tokenizer.convert_tokens_to_ids(job["tokens"])
            job["bucket"] = post.pick_bucket(len(job["ids"]), cfg.engine.text_buckets)
            by_bucket.setdefault(job["bucket"], []).append(job)
        for bucket, group in by_bucket.items():
            for ofs in range(0, len(group), batch_cap):
                self._decode_jobs(group[ofs:ofs + batch_cap], bucket, gen, timers=timers)
        self._sync()
        timers["gpt_gen_time"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        by_cbucket: Dict[int, List[dict]] = {}
        for job in jobs:
            by_cbucket.setdefault(job["cbucket"], []).append(job)
        for cbucket, group in by_cbucket.items():
            for ofs in range(0, len(group), batch_cap):
                self._mel_jobs(group[ofs:ofs + batch_cap], cbucket)
        timers["synthesis_time"] = (timers.get("synthesis_time", 0.0)
                                    + time.perf_counter() - t0)

    @staticmethod
    def _batch_bucket(n: int) -> int:
        """The power of 2 at or above n: a group's padded batch."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _job_stream(self, slot: int, seed: int) -> torch.Generator:
        """The generator of row slot `slot` of a request-batched decode,
        seeded with a job's seed: one object a slot, kept by the engine (a
        replayed graph holds it), restarted for each group."""
        while len(self._job_streams) <= slot:
            self._job_streams.append(torch.Generator(device=self.device))
        return self._job_streams[slot].manual_seed(seed)

    def _beam_jobs_fused(self, jobs: List[dict], gen, cond, emo, text, lens,
                         max_new: int) -> tuple:
        """Beam-K jobs through K3, request-batched (JAX `_beam_jobs_fused`):
        chunks of `engine.beam_batch_rows // K` requests, clamped to a power
        of 2, each padded to a power of 2 by repeating its first row, one
        `beam_decode_fused_batch` a chunk; a chunk of one request takes
        `beam_decode`.  A single job keeps the engine's own stream; in a
        group, job i draws from its own (`job["seed"]`).  Returns the jobs'
        (codes, lengths, hit_limit) and each decode's result."""
        e = self.cfg.engine
        pack = self._beam_fused_pack()
        k, n = gen.num_beams, len(jobs)
        r_cap = max(1, e.beam_batch_rows // k) if (pack is not None and k <= 4) else 1
        while r_cap & (r_cap - 1):       # a power of 2: a padded chunk fits K3
            r_cap &= r_cap - 1

        def run_single(i, generator):
            return beam_decode(self.gpt_rt, gen, cond[i:i + 1], emo[i:i + 1],
                               text[i:i + 1], lens[i:i + 1], max_new, generator,
                               fused_pack=pack, int8_kv=e.use_int8_kv,
                               readout_pack=self.readout_pack, loops=self.loops)

        if n == 1 and "seed" not in jobs[0]:
            res = run_single(0, self.generator)
            return res.codes, res.lengths, res.hit_limit, [res]
        results, i = [], 0
        while i < n:
            rn = min(r_cap, n - i)
            if rn == 1:
                results.append((1, run_single(i, self._job_stream(0, jobs[i]["seed"]))))
                i += 1
                continue
            rows = list(range(i, i + rn)) + [i] * (self._batch_bucket(rn) - rn)
            streams = [self._job_stream(j, jobs[r]["seed"]) for j, r in enumerate(rows)]
            results.append((rn, beam_decode_fused_batch(
                self.gpt_rt, gen, cond[rows], emo[rows], text[rows], lens[rows],
                max_new, streams, pack, int8_kv=e.use_int8_kv,
                readout_pack=self.readout_pack, loops=self.loops)))
            i += rn
        return (torch.cat([r.codes[:m] for m, r in results]),
                torch.cat([r.lengths[:m] for m, r in results]),
                torch.cat([r.hit_limit[:m] for m, r in results]),
                [r for _, r in results])

    def _decode_jobs(self, jobs: List[dict], bucket: int, gen, force_full_cap: bool = False,
                     gen_state: Optional[torch.Tensor] = None,
                     timers: Optional[dict] = None) -> None:
        """Decode one sub-batch of jobs of a text bucket (JAX `_decode_jobs`):
        padded to a power-of-2 batch (repeating the first job's
        conditioning), at the bucket's learned cap (`_decode_cap`), through
        the batched sampling decode (`decode(fused_batch=...)`: K3 with
        `use_fused_batch_decode`), the request-batched beam
        (`_beam_jobs_fused`) or the plain one (`beam_decode_batch`); the
        real rows teach the cap (`_observe_code_len`), rows that hit a
        reduced cap decode once more at the full cap on the same streams
        (`gen_state` the engine's, the jobs' seeds their own), then each
        row is stop-trimmed and silence-trimmed.  Sets "codes",
        "code_len", "cbucket", "text_row", "text_len" of each job."""
        cfg, e, dev = self.cfg, self.cfg.engine, self.device
        n = len(jobs)
        max_new = gen.max_mel_tokens if force_full_cap else self._decode_cap(bucket, gen)
        if gen_state is None:
            if gen.num_beams > 1 and n > 1:
                # one stream a job (JAX: fold_in of the group's key)
                base = int(torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                                         device=dev))
                for i, job in enumerate(jobs):
                    job["seed"] = base + i
            gen_state = self.generator.get_state()
        else:
            self.generator.set_state(gen_state)
        b = self._batch_bucket(n)
        text = torch.zeros((b, bucket), dtype=torch.long)
        lens = torch.ones((b,), dtype=torch.long)
        for i, job in enumerate(jobs):
            ids = job["ids"][:bucket]
            text[i, :len(ids)] = torch.tensor(ids)
            lens[i] = len(ids)
        text, lens = text.to(dev), lens.to(dev)
        cond = torch.cat([j["spk"]["cond_latents"] for j in jobs]
                         + [jobs[0]["spk"]["cond_latents"]] * (b - n))
        emo = torch.cat([j["emovec"] for j in jobs] + [jobs[0]["emovec"]] * (b - n))
        if gen.num_beams <= 1:
            res = gpt_decode(self.gpt_rt, gen, cond, emo, text, lens, max_new,
                             self.generator, self.fused_pack, self.readout_pack,
                             int8_kv=e.use_int8_kv, loops=self.loops,
                             fused_batch=e.use_fused_batch_decode)
            codes, lengths, hit, runs = res.codes, res.lengths, res.hit_limit, [res]
        elif n == 1 or self._beam_fused_pack() is not None:
            codes, lengths, hit, runs = self._beam_jobs_fused(jobs, gen, cond, emo, text,
                                                              lens, max_new)
        else:
            streams = [self._job_stream(i, job["seed"]) for i, job in enumerate(jobs)]
            res = beam_decode_batch(self.gpt_rt, gen, cond[:n], emo[:n], text[:n],
                                    lens[:n], max_new, streams, loops=self.loops)
            codes, lengths, hit, runs = res.codes, res.lengths, res.hit_limit, [res]
        if timers is not None:
            for res in runs:
                self._count_decode(timers, res)
        codes_np = codes.cpu().numpy()
        lengths_np = lengths.cpu().numpy()[:n]
        hit_np = hit.cpu().numpy()[:n]
        # the padded rows' outputs are dropped and teach nothing
        self._observe_code_len(bucket, lengths_np, hit_np, max_new, gen)
        retry = [i for i in range(n) if hit_np[i] and max_new < gen.max_mel_tokens]
        if retry:
            self._decode_jobs([jobs[i] for i in retry], bucket, gen, True, gen_state,
                              timers)
        for i, job in enumerate(jobs):
            if i in retry:
                continue
            code_len = max(int(lengths_np[i]) - (0 if hit_np[i] else 1), 1)
            row, row_len = post.remove_long_silence(
                codes_np[i:i + 1, :code_len], np.asarray([code_len]),
                cfg.gpt.stop_mel_token, e.silent_token)
            job["codes"] = row[0]
            job["code_len"] = int(row_len[0])
            job["cbucket"] = post.pick_bucket(job["code_len"], tuple(e.code_buckets))
            job["text_row"] = text[i].cpu()
            job["text_len"] = int(lens[i])

    @torch.no_grad()
    def _mel_jobs(self, jobs: List[dict], cbucket: int) -> None:
        """The teacher-forced latent, s2mel and vocoder of decoded jobs of one
        code bucket at one padded batch (JAX `_mel_jobs`); each job's "wav"
        is its row, int16, cut to its `target_len * hop` samples."""
        cfg, e, dev = self.cfg, self.cfg.engine, self.device
        n = len(jobs)
        b = self._batch_bucket(n)
        tbucket = post.pick_bucket(max(j["bucket"] for j in jobs), e.text_buckets)
        text = torch.zeros((b, tbucket), dtype=torch.long)
        tlens = torch.ones((b,), dtype=torch.long)
        codes = torch.zeros((b, cbucket), dtype=torch.long)
        clens = torch.ones((b,), dtype=torch.long)
        for i, job in enumerate(jobs):
            row = job["text_row"][:tbucket]
            text[i, :len(row)] = row
            tlens[i] = job["text_len"]
            codes[i, :job["code_len"]] = torch.from_numpy(
                np.asarray(job["codes"][:job["code_len"]], np.int64))
            clens[i] = job["code_len"]
        text, tlens, codes, clens = (t.to(dev) for t in (text, tlens, codes, clens))

        def padded(rows):
            return torch.cat(rows + [rows[0]] * (b - n))
        spks = [j["spk"] for j in jobs]
        pbuckets = tuple(x for x in e.prompt_frame_buckets
                         if x < self.prompt_mel_frames) + (self.prompt_mel_frames,)
        pbucket = post.pick_bucket(max(s["mel_frames"] for s in spks), pbuckets)
        mel_frames = torch.tensor([s["mel_frames"] for s in spks]
                                  + [spks[0]["mel_frames"]] * (b - n), device=dev)
        latent = self.gpt_rt(padded([s["cond_latents"] for s in spks]),
                             padded([j["emovec"] for j in jobs]), text, tlens, codes, clens)
        mel, target_len = self._s2mel(
            latent, codes, clens, padded([s["prompt_condition"][:, :pbucket] for s in spks]),
            mel_frames, padded([s["ref_mel"][:, :, :pbucket] for s in spks]),
            padded([s["style"] for s in spks]), self._mel_bucket_for(cbucket))
        wav = torch.clamp(self.vocode(mel) * 32767.0, -32767.0, 32767.0)
        wav = wav.to(torch.int16).reshape(b, -1).cpu().numpy()
        hop = cfg.mel.hop_size
        for i, job in enumerate(jobs):
            job["wav"] = wav[i][: int(target_len[i]) * hop]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _draw_noise(self, shape) -> torch.Tensor:
        """CFM initial noise (tests replace this to share the JAX noise)."""
        return torch.randn(shape, generator=self.generator, device=self.device)

    @staticmethod
    def _count_decode(timers: dict, res) -> None:
        """A decode's steps, and its device loop's chunks (each runs CHUNK
        steps: at most CHUNK - 1 of them after the stop)."""
        timers["decode_steps"] += res.steps
        timers["decode_runs"] += 1
        timers["decode_chunks"] += getattr(res, "chunks", 0)

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
                              int8_kv=e.use_int8_kv, readout_pack=self.readout_pack,
                              loops=self.loops)
            self._count_decode(timers, res)
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
                                 int8_kv=e.use_int8_kv, loops=self.loops)
            self._count_decode(timers, res)
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

    def _cfm_tables(self, fused: bool) -> dict:
        """The DiT's tables of the Euler schedule (`step_tables`, and with
        the K8 trunk its packed adaRMS rows), made once: they depend on the
        weights and the step count only."""
        if fused not in self._step_tables:
            n_steps = self.cfg.engine.diffusion_steps
            est = self.s2mel_rt.estimator
            t_mids = torch.linspace(0.0, 1.0, n_steps + 1, device=self.device)[:n_steps]
            tables = est.step_tables(t_mids)
            if fused:
                tables["fused_wb"] = pack_dit_tables(est, tables)
            self._step_tables[fused] = tables
        return self._step_tables[fused]

    def _s2mel(self, latent, codes, code_len, prompt_condition, prompt_len,
               ref_mel, style, mel_bucket: int):
        """Length regulator + CFM solve; returns (mel (B, 80, mel_bucket)
        with frames past target_len zeroed, target_len).  The solve's inputs
        go into the key's static inputs and its 25 steps replay as one graph
        on the card (`device_loop.run_once`)."""
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
        fused = self.use_fused_dit(cat.shape[0], total_max)
        fused_w = self.dit_pack if fused else None
        tables = self._cfm_tables(fused)
        # compute dtype follows the runtime module; the CFM state stays f32
        dt = self._float_dtype(s2)

        def velocity(x, p, lens, t, s, mu, tab):
            return s2.velocity(x.to(dt), p.to(dt), lens, t, s.to(dt), mu.to(dt),
                               tables=tab, fused_w=fused_w).float()

        def solve(a):
            return cfm_inference(velocity, a["cat"], a["total_len"], a["prompt_x"],
                                 a["prompt_len"], a["style"], n_steps,
                                 e.inference_cfg_rate, noise=a["noise"],
                                 tables=lambda i: DiT.table_step(tables, i))
        inputs = {"cat": cat, "total_len": total_len, "prompt_x": prompt_x,
                  "prompt_len": prompt_len, "style": style,
                  "noise": self._draw_noise((cat.shape[0], prompt_x.shape[1], total_max))}
        key = ("cfm", fused, n_steps, e.inference_cfg_rate,
               tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
        mel = device_loop.run_once(inputs, solve, self.loops, key)
        gen = slice_generated(mel, prompt_len, mel_bucket)
        frame = torch.arange(mel_bucket, device=self.device)
        # frames past target_len still hold CFM noise; zero them so the
        # vocoder's first conv does not smear it into the last valid frames
        gen = torch.where(frame[None, None, :] < target_len[:, None, None], gen, 0.0)
        return gen, target_len

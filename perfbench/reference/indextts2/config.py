"""Unified typed configuration tree.

The reference stack spreads configuration across OmegaConf YAML, argparse,
gunicorn config modules, JSON AttrDicts and Munch objects (see
reference `indextts/infer_v2.py:77-199`, `server.py:446-482`,
`s2mel/modules/bigvgan/bigvgan.py:25-28`).  Here everything lives in one
dataclass tree that round-trips to/from plain dicts (and therefore JSON/YAML),
with defaults matching the published IndexTTS2 model family.

Model-size defaults below describe the flagship IndexTTS2 checkpoints
(`IndexTeam/IndexTTS-2`); they are plain fields so smoke tests can shrink them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(x) for x in obj]
    return obj


def _from_dict(cls: Any, data: Any) -> Any:
    if data is None:
        return None
    if dataclasses.is_dataclass(cls):
        kwargs = {}
        hints = {f.name: f for f in dataclasses.fields(cls)}
        for key, val in data.items():
            if key not in hints:
                raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
            ftype = hints[key].type
            sub = _DATACLASS_FIELDS.get((cls, key))
            if sub is not None and isinstance(val, dict):
                kwargs[key] = _from_dict(sub, val)
            else:
                kwargs[key] = val
        return cls(**kwargs)
    return data


@dataclass(eq=False)
class MelConfig:
    """Log-mel frontend (matches reference `s2mel/modules/audio.py:45-82`)."""

    sample_rate: int = 22050
    n_fft: int = 1024
    win_size: int = 1024
    hop_size: int = 256
    num_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None  # None -> sr/2 (slaney mel basis)


@dataclass(eq=False)
class ConformerConfig:
    """wenet-style conformer conditioning encoder
    (reference `indextts/gpt/conformer_encoder.py:439-520`)."""

    input_size: int = 1024
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    input_layer: str = "conv2d2"  # linear | conv2d2 | conv2d | conv2d6 | conv2d8
    perceiver_mult: int = 2
    cnn_module_kernel: int = 15
    pos_enc_layer_type: str = "rel_pos"


@dataclass(eq=False)
class GPTConfig:
    """UnifiedVoice acoustic-token GPT (reference `indextts/gpt/model_v2.py:304-410`)."""

    layers: int = 24
    model_dim: int = 1280
    heads: int = 20
    max_text_tokens: int = 600
    max_mel_tokens: int = 1815
    number_text_tokens: int = 12000
    start_text_token: int = 0
    stop_text_token: int = 1
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    types: int = 1
    condition_num_latent: int = 32
    condition_type: str = "conformer_perceiver"
    emo_dim: int = 1024  # width of the emotion perceiver output
    pallas_decode_attention: bool = False  # bounded-read decode attention
    condition_module: ConformerConfig = field(default_factory=ConformerConfig)
    emo_condition_module: ConformerConfig = field(
        default_factory=lambda: ConformerConfig(num_blocks=4)
    )


@dataclass(eq=False)
class DiTConfig:
    """Flow-matching mel estimator (reference `s2mel/modules/diffusion_transformer.py:103-252`)."""

    hidden_dim: int = 512
    depth: int = 13
    num_heads: int = 8
    in_channels: int = 80
    content_dim: int = 512
    style_dim: int = 192
    is_causal: bool = False
    long_skip_connection: bool = True
    final_layer_type: str = "wavenet"
    rope_base: float = 10000.0
    block_size: int = 8192
    # Pallas flash attention for the DiT's full self-attention (TPU only;
    # falls back to the einsum path elsewhere). Measured 5x SLOWER than the
    # einsum path at serving shapes (b=2, h=8, t~700: per-invocation
    # overhead dominates; the score tensor is only ~16 MB) — keep for
    # long-context DiT configs (t >~ 4k), off by default
    flash_attention: bool = False
    # whole-sequence VMEM Pallas attention (ops/cfm_attention.py): one grid
    # program per (batch, head) holds the full (T, T) f32 score tile in
    # VMEM — no HBM score traffic, no flash-grid overhead. Built for the
    # CFM serving shapes (T <= ~1.5k); TPU only, einsum elsewhere.
    # Takes precedence over flash_attention when both are set.  Measured
    # SLOWER than the XLA einsum at serving shapes (velocity eval 2.37 vs
    # 1.93 ms; 25-step CFM 62.5 vs 46.8 ms at B=2/T=704 on v5e) — XLA's
    # fused attention already keeps the 16 MB score block on-chip here.
    # Kept opt-in for possible long-T DiT configs
    fused_attention: bool = False
    # whole-trunk Pallas megakernel (ops/dit_blocks.py): all `depth` blocks
    # in ONE pallas_call, residual stream resident in VMEM.  Requires the
    # hoisted step tables, batch <= 2, T <= 768, and the flagship FFN
    # geometry (inner == 3*hidden); anything else falls back to the einsum
    # path.  bf16 storage between stages (~1e-2-relative vs f32 einsum).
    # MEASURED ~2x SLOWER than XLA at serving shapes (velocity 3.88 vs
    # 2.23 ms; CFM solve 91 vs 47 ms) — see ops/dit_blocks.py for the
    # analysis; keep OFF unless that revision lands
    fused_blocks: bool = False


@dataclass(eq=False)
class WaveNetConfig:
    hidden_dim: int = 512
    kernel_size: int = 5
    dilation_rate: int = 1
    num_layers: int = 8
    p_dropout: float = 0.0


@dataclass(eq=False)
class LengthRegulatorConfig:
    """(reference `s2mel/modules/length_regulator.py:28-141`)"""

    channels: int = 512
    num_sampling_ratios: int = 2  # number of conv/groupnorm/mish stacks
    codebook_size: int = 8192
    n_codebooks: int = 3
    groups: int = 1


@dataclass(eq=False)
class S2MelConfig:
    dit: DiTConfig = field(default_factory=DiTConfig)
    wavenet: WaveNetConfig = field(default_factory=WaveNetConfig)
    length_regulator: LengthRegulatorConfig = field(default_factory=LengthRegulatorConfig)
    gpt_dim: int = 1280  # input width of gpt_layer MLP (GPT latent width)
    gpt_layer_hidden: Tuple[int, ...] = (256, 128)
    gpt_layer_out: int = 1024
    mel_scale_factor: float = 1.72  # code frames -> mel frames


@dataclass(eq=False)
class BigVGANConfig:
    """(reference `s2mel/modules/bigvgan/config.json` + `bigvgan.py:243-384`)"""

    num_mels: int = 80
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False
    sampling_rate: int = 22050


@dataclass(eq=False)
class RepCodecConfig:
    """Semantic codec over w2v-bert features
    (reference `utils/maskgct/models/codec/kmeans/repcodec_model.py:34-199`)."""

    codebook_size: int = 8192
    hidden_size: int = 1024
    codebook_dim: int = 8
    vocos_dim: int = 384
    vocos_intermediate_dim: int = 2048
    vocos_num_layers: int = 12
    num_quantizers: int = 1
    downsample_scale: int = 1


@dataclass(eq=False)
class CAMPPlusConfig:
    """(reference `s2mel/modules/campplus/DTDNN.py:50-117`)"""

    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128


@dataclass(eq=False)
class W2VBertConfig:
    """facebook/w2v-bert-2.0 (conformer encoder; we run up to `output_layer`).

    Defaults mirror `transformers.Wav2Vec2BertConfig` for w2v-bert-2.0.
    """

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    output_layer: int = 17  # hidden_states[17] per reference `infer_v2.py:208`
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_kernel_size: int = 31


@dataclass(eq=False)
class QwenEmoConfig:
    """Text->emotion classifier LLM (reference `infer_v2.py:795-906`)."""

    enabled: bool = False
    model_dir: Optional[str] = None
    vocab_size: int = 151936
    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    intermediate_size: int = 3072
    max_new_tokens: int = 256


@dataclass(eq=False)
class GenerationConfig:
    """AR sampling defaults (reference `infer_v2.py:598-606`)."""

    do_sample: bool = True
    top_p: float = 0.8
    top_k: int = 30
    temperature: float = 0.8
    length_penalty: float = 0.0
    num_beams: int = 3
    repetition_penalty: float = 10.0
    max_mel_tokens: int = 1500
    max_text_tokens_per_segment: int = 120
    typical_sampling: bool = False
    typical_mass: float = 0.9


@dataclass(eq=False)
class EngineConfig:
    diffusion_steps: int = 25
    inference_cfg_rate: float = 0.7
    interval_silence_ms: int = 200
    max_prompt_seconds: float = 15.0
    emo_num: Tuple[int, ...] = (3, 9, 4, 2, 2, 3, 9, 3)  # rows per emotion group in emo/spk matrices
    sample_rate: int = 22050
    silent_token: int = 52
    # compile-time shape buckets (text tokens / mel codes / prompt frames)
    text_buckets: Tuple[int, ...] = (32, 64, 120)
    code_buckets: Tuple[int, ...] = (256, 512, 1024, 1536)
    # finer prompt steps in the README-recommended 3-10 s range (259-862
    # frames): DiT attention cost scales with (prompt + generated)^2, so a
    # 5 s prompt shouldn't pay a 512-frame bucket
    prompt_frame_buckets: Tuple[int, ...] = (256, 448, 704, 1024, 1536)
    use_fp16: bool = False  # bf16 on TPU when enabled
    # int8 weight-only GPT decode (Pallas fused-dequant GEMV); halves the
    # per-token weight HBM traffic that dominates AR decode
    use_int8_decode: bool = False
    # single-Pallas-call trunk megakernel for batch-1 AR decode (requires
    # use_int8_decode; see ops/fused_decode.py)
    use_fused_decode: bool = False
    # int4 (g128) weight tiles inside the megakernel: halves the per-token
    # weight DMA vs int8 (measured 1.33x tile streaming after the in-kernel
    # unpack cost). RTN int4 is a real quality trade — validate on real
    # checkpoints before enabling in production; prefill/latent stay int8
    use_int4_decode: bool = False
    # self-speculative decoding: draft K-1 tokens with an int4 pack, then
    # verify all of them in ONE int8 megakernel pass (the weight stream —
    # the dominant decode cost — is read once per K tokens).  Rejection
    # sampling keeps the emitted distribution EXACTLY the int8 path's; int4
    # only affects the acceptance rate.  0 = off; 3..6 typical.  Single-
    # request (batch 1, beams 1) path only
    spec_decode_k: int = 0
    # int4 scale-group width along the contraction dim (0 = g128 default).
    # Wider groups = coarser quantization but full-rate MXU sub-dots:
    # group = model_dim // 2 (G=2) turns the 20 half-rate K=64 sub-dots per
    # tile into 2 dense K=D/2 dots.  scripts/int4_quality.py bounds the
    # quality delta per width
    int4_group: int = 0
    # int4 dequant scheme inside the megakernel: False = i32-mask unpack +
    # per-group K=128 sub-dots scaled on the output; True = whole-tile
    # dequant via an MXU-expanded (D/2, D) scale matrix + two dense K=D/2
    # dots (fewer, larger MXU passes); "i8sh" = int8-lane shift unpack
    # (same values as False, the sign extension stays in the 8-bit lanes)
    # + the same sub-dots.  Identical quantization either way; A/B per hw
    int4_expand: bool | str = False
    # run the decode megakernel with N weight tiles per grid step (0 = one
    # tile/step; 3 or 6 = grid (L, 12/N)): identical numerics, N x less
    # fixed per-grid-step overhead (~0.2 us/tile measured).  Costs a larger
    # double-buffered VMEM block (int8 D=1280 N=3: ~9.8 MB of ~16 MB/core;
    # N=6 only fits the nibble-packed int4 tiles).  Default 3: measured
    # RTF 0.0730 -> 0.0715 at bench shape with identical numerics (r2 A/B)
    merge_decode_stages: int = 3
    # release the f32 MASTER trees of families that inference never reads
    # once the runtime trees exist (gpt -> params_gpt_rt; w2v -> the bf16
    # conditioning tree when use_bf16_conditioning): ~4 GB of HBM on the
    # flagship config.  The wave-E server burst OOM'd exactly here — f32
    # masters + int8/bf16 runtime copies + beam caches + batched synthesis
    # left no headroom, and the watchdog's rebuild-on-OOM doubled the
    # footprint.  Off by default (keeps `engine.params` save/convert-able);
    # ON in the serving profile
    release_master_trees: bool = False
    # fold final_norm + mel_head into the decode megakernel (batch-1 path):
    # the head streams as int8 column tiles through the same double-buffered
    # weight pipeline — half the readout DMA (21 MB bf16 -> 10.7 MB int8 per
    # step) and zero extra kernel launches.  Numerics: int8-quantized LOGITS
    # (trunk already int8; delta measured by the quality gate).  Requires
    # use_fused_decode
    fold_readout: bool = False
    # int8 KV cache inside the megakernel (per-position scales, dequant in
    # VMEM): halves the prefix DMA, which grows with context while weight
    # traffic stays flat.  Standard production KV8 — far milder than int4
    # weights (prefill/current-token math stays full precision).  Measured
    # NEUTRAL at bench context (~341 max positions: RTF 0.0744 vs 0.0737 —
    # the VPU dequant offsets the DMA saved on 1-2 cache blocks); the DMA
    # saving scales with prefix length, so enable for long-context configs
    # (max_mel_tokens ~1500, where late steps read 6 blocks/layer).
    # On the batched XLA path (batch > 1 / no megakernel) the same flag
    # stores the cache as a `gpt2.QuantKVCache` — int8 rows with
    # per-(layer,k/v,batch,head,position) scales folded into the attention
    # scores/probs so the dequant convert fuses into the dots; KV-cache
    # DMA is the dominant batch>=8 serving traffic (STATUS.md)
    use_int8_kv: bool = False
    # batched (2 <= B <= 8) decode-step megakernel for continuous-batch
    # serving (requires use_fused_decode's pack): one Pallas call per step
    # over the whole sub-batch, reading only each step's live [0, pos) KV
    # prefix instead of the full padded cache — the dominant batch >= 8
    # serving traffic (~1 GB/step at B=8/Tmax=512/bf16).  Composes with
    # use_int8_kv (int8 cache + per-row/position scales dequantized in VMEM)
    use_fused_batch_decode: bool = False
    # run single-request beam search (the reference DEFAULT, num_beams=3)
    # through the batched megakernel: beams share the decode position, so
    # each step is one Pallas call over the K beams + an XLA cache-row
    # reorder.  Requires use_fused_decode's pack and K <= 8
    use_fused_beam_decode: bool = False
    # REQUEST-BATCHED beam decode: `infer_batch` packs up to
    # beam_batch_rows // num_beams concurrent beam jobs into one
    # R*K-row megakernel (rows per request grouped, per-request ancestor
    # tables) so the weight stream amortizes across requests the way the
    # sampling path batches.  12 -> 4 requests at the beam-3 default — the
    # measured c16 winner (r5 A/B, bench_results/r5/serving_beam3_rows*:
    # aggregate RTF 0.101 sequential / 0.0874 at 6 rows / 0.0772 at 12).
    # Only meaningful with use_fused_beam_decode and num_beams <= 4
    beam_batch_rows: int = 12
    # run teacher-forced latent + s2mel + vocoder as ONE jitted graph with a
    # single host sync (each extra sync costs a round trip on remote-attached
    # chips); per-stage timers require fuse_synthesis=False
    fuse_synthesis: bool = True
    # bf16 conditioning encoders (w2v-bert/RepCodec/CAMPPlus) for the
    # cold-prompt path: a NEW speaker pays the 17-layer w2v-bert forward at
    # the 15 s static shape on every request (measured 244 ms f32 on v5e —
    # bench_results/r4/bench_cold_int8).  bf16 runs those matmuls at MXU
    # rate; LN/softmax stats stay f32 inside the models.  RepCodec's code
    # argmin can flip borderline codes at bf16 — validate on real weights
    # like the other precision trades
    use_bf16_conditioning: bool = False
    # bf16 s2mel (DiT/CFM/regulator) compute; softmax/LN stats stay f32.
    # The reference pins s2mel to fp32 (`infer_v2.py:710-711`) — bf16 trades
    # ~2e-3 mel deviation (within the 1e-2 parity budget) for MXU-rate DiT
    use_bf16_s2mel: bool = False
    # evaluate the 3 parallel AMP resblocks of each vocoder stage as grouped
    # convs + stacked snake activations (exact; ~3x fewer ops per stage).
    # Measured 2.8x SLOWER on v5e (118 vs 43 ms at bench shape,
    # scripts/bench_packed_vocoder.py): XLA lowers feature-grouped convs
    # poorly on TPU. Kept for A/B on other backends; default off.
    # Ignored when the config's resblock schedule can't pack
    # (`packed.can_pack`)
    use_packed_vocoder: bool = False
    # share each vocoder stage's anti-aliased snake activations across the
    # 3 parallel AMP resblocks (one AA call per dilation iteration on
    # (B, 3C, T) instead of three) while keeping dense per-block convs —
    # exact math, 18 -> 6 activation ops per stage.  The AA activation is
    # op-overhead-bound (~0.16-0.31 ms/call regardless of shape,
    # scripts/micro_vocoder_ops.py), so this targets the dominant vocoder
    # cost directly without the grouped-conv penalty of use_packed_vocoder
    use_shared_act_vocoder: bool = False
    # megatron-style tensor parallelism for the GPT over a "tp" mesh axis
    # (attention/MLP matmuls sharded, XLA inserts the ICI all-reduces via
    # sharding propagation — see `parallel/mesh.py` rules).  1 = off: the
    # flagship model fits one chip, so per-chip replicas (serving --workers)
    # remain the default scale-out; >1 is for models exceeding one chip and
    # disables the single-chip fast paths (int8/fused megakernel decode)
    tensor_parallel: int = 1
    # fused Pallas resblock-stage kernels for the late (C <= 192) vocoder
    # stages: one kernel per stage instead of ~300 XLA ops (the vocoder is
    # op-count-bound, see ops/fused_vocoder.py). Interior-exact; the
    # outermost ~80 stage-samples per signal edge see zero- instead of
    # replicate-padded activations. Batch-1 graphs only (batched serving
    # keeps the module path). TPU only; ignored elsewhere
    use_fused_vocoder: bool = False
    # whole-segment single-dispatch pipeline (decode -> device-side
    # silence trim -> synthesis): zero host round trips mid-segment
    # (sampling path only)
    fuse_pipeline: bool = False
    # size the fused-pipeline code bucket from a text-length estimate instead
    # of pinning it to max_mel_tokens' bucket (decode KV cache and CFM/vocoder
    # cost all scale with the bucket, so a 1500-token cap shouldn't make a
    # one-sentence segment pay 1536-bucket synthesis). If the decode hits the
    # estimated cap the segment is re-run once at the full bucket, so output
    # is unaffected by a too-small estimate.
    auto_code_bucket: bool = True
    # codes-per-text-token headroom for that estimate: mel codes run at
    # ~25 Hz, i.e. ~2-3 codes per English BPE token / ~6 per Chinese char
    # (reference `infer_v2.py` segments are <=120 text tokens) — 8 gives
    # >=3x margin so cap-hit retries stay rare
    codes_per_text_token: float = 8.0
    # Euler steps per compiled CFM scan-loop body (lax.scan unroll):
    # identical numerics (steps stay sequential); >1 lets XLA schedule
    # across step boundaries and amortizes loop overhead on the
    # op-overhead-bound DiT eval.  Default 5: measured 0.0716 -> 0.0703
    # RTF on v5e (bench_results/r4/bench_cfm_unroll5; unroll 25 gave
    # 0.0710 — full unroll loses the win to scheduling/ICache pressure)
    cfm_unroll: int = 5
    # batch a multi-segment `infer` call's segments through the same
    # sub-batched decode/synthesis machinery as `infer_batch` (decode wall
    # ~ longest segment instead of the sum; weights amortize across rows).
    # Streaming (`infer_generator`) stays sequential for time-to-first-audio
    batch_segments: bool = True
    seed: int = 0


@dataclass(eq=False)
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8020
    workers: int = 1
    log_level: str = "info"
    request_timeout_s: float = 300.0
    download_timeout_s: float = 30.0
    # precompile the default request path at boot, before /health goes
    # ready: on a cold compile cache the first /tts request otherwise pays
    # the whole beam-3 + synthesis compile inside the 300 s request window
    # and 504s (wave-L server bench finding)
    warmup: bool = True
    # warmup coverage: "workload" compiles one single request per text
    # bucket PLUS grouped infer_batch at every pow-2 batch bucket up to
    # max_batch_size (the graphs a concurrent burst hits — the round-4 c16
    # burst compiled flagship batch graphs mid-traffic because warmup
    # covered only one graph); "minimal" = one short single request
    warmup_mode: str = "workload"
    # drain budget on SIGTERM/SIGINT (reference `gunicorn_config.py:21`)
    graceful_timeout_s: float = 30.0
    max_batch_size: int = 8  # batching cap per decode step / slot count
    # replica watchdog: rebuild an engine replica after a fatal device error
    # or this many consecutive batch failures (in-process analogue of
    # gunicorn worker recycling, reference `gunicorn_config.py:19-22`)
    max_consecutive_failures: int = 3
    # slot-based continuous batching (engine/continuous.py): requests join a
    # RUNNING decode batch mid-flight instead of waiting for the current
    # group to finish.  Requires engine.use_fused_decode (the batched
    # megakernel) and num_beams == 1; the server falls back to grouped
    # infer_batch otherwise
    continuous_batching: bool = False
    # decode steps per continuous-batching dispatch: the host syncs once per
    # chunk (admission latency granularity ~= chunk * ms/step)
    chunk_steps: int = 16


@dataclass(eq=False)
class TTSConfig:
    """Root config for the whole framework."""

    model_dir: Optional[str] = None
    gpt: GPTConfig = field(default_factory=GPTConfig)
    s2mel: S2MelConfig = field(default_factory=S2MelConfig)
    vocoder: BigVGANConfig = field(default_factory=BigVGANConfig)
    semantic_codec: RepCodecConfig = field(default_factory=RepCodecConfig)
    campplus: CAMPPlusConfig = field(default_factory=CAMPPlusConfig)
    w2v_bert: W2VBertConfig = field(default_factory=W2VBertConfig)
    qwen_emo: QwenEmoConfig = field(default_factory=QwenEmoConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    version: str = "2.0-tpu"

    # ---- (de)serialization ----
    def to_dict(self) -> dict:
        return _to_dict(self)

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_dict(cls, data: dict) -> "TTSConfig":
        return _from_dict(cls, data)

    @classmethod
    def from_json(cls, text: str) -> "TTSConfig":
        return cls.from_dict(json.loads(text))

    def apply_serving_profile(self) -> "TTSConfig":
        """Enable the measured-winner fast paths for production serving
        (mutates this config in place; returns self).

        These are the round-3 committed A/B winners (`bench_results/r3/`,
        STATUS.md): the int8 decode megakernel (the ONE real numerics
        delta vs the f32 path — teacher-forced logit KL 4.2e-5/step,
        `bench_results/r3/int4_quality.json`), merged grid stages (exact),
        the batched megakernel for grouped serving (p50 5.08 s vs 7.61 s
        at c16), the ancestor-table fused beam for the reference-default
        num_beams=3 (RTF 0.1243 vs 0.2555 XLA), int8 KV for the production
        long-context cap (max_mel_tokens=1500: long-form 0.0964 vs
        beam/serving-neutral at short form), bf16 GPT compute (matching the
        reference's fp16 autocast, `infer_v2.py:628`), and the fused
        whole-segment pipeline on the sampling path.

        Replaces the reference's deploy-time flag soup
        (`server.py:446-482`, fp16/deepspeed/cuda_kernel argparse): one
        profile, measured, on by default in `serving/app.py` and `cli.py`.
        """
        e = self.engine
        e.use_fp16 = True
        e.use_int8_decode = True
        e.use_fused_decode = True
        e.merge_decode_stages = 3
        e.use_fused_batch_decode = True
        e.use_fused_beam_decode = True
        e.use_int8_kv = True
        e.fuse_pipeline = True
        # round-4 winners: folded int8 readout (r4: 0.0716 -> 0.0705
        # greedy; composes with the beam/batched kernels; logit-KL bound
        # in the quality gate's int8_rofold row), bf16 conditioning for
        # the cold-prompt path (the reference's own fp16 autocast scope)
        e.fold_readout = True
        e.use_bf16_conditioning = True
        e.release_master_trees = True
        return self

    @classmethod
    def serving(cls) -> "TTSConfig":
        """Flagship config with the production serving profile applied."""
        return cls().apply_serving_profile()

    @classmethod
    def tiny(cls) -> "TTSConfig":
        """A miniature config for unit tests / CI (single-core CPU friendly)."""
        cfg = cls()
        cfg.gpt = GPTConfig(
            layers=2, model_dim=64, heads=4, max_text_tokens=32, max_mel_tokens=64,
            number_text_tokens=40, number_mel_codes=68, start_mel_token=66,
            stop_mel_token=67, condition_num_latent=4, emo_dim=32,
            condition_module=ConformerConfig(
                input_size=32, output_size=32, attention_heads=2, linear_units=64,
                num_blocks=1, input_layer="conv2d2", perceiver_mult=2,
            ),
            emo_condition_module=ConformerConfig(
                input_size=32, output_size=32, attention_heads=2, linear_units=64,
                num_blocks=1, input_layer="conv2d2", perceiver_mult=2,
            ),
        )
        cfg.s2mel = S2MelConfig(
            dit=DiTConfig(hidden_dim=64, depth=2, num_heads=4, in_channels=20,
                          content_dim=64, style_dim=16, block_size=256),
            wavenet=WaveNetConfig(hidden_dim=64, kernel_size=5, num_layers=2),
            length_regulator=LengthRegulatorConfig(channels=64, num_sampling_ratios=2,
                                                   codebook_size=64, n_codebooks=1),
            gpt_dim=64, gpt_layer_hidden=(32, 16), gpt_layer_out=32,
        )
        cfg.vocoder = BigVGANConfig(
            num_mels=20, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),),
        )
        cfg.semantic_codec = RepCodecConfig(
            codebook_size=64, hidden_size=32, codebook_dim=8, vocos_dim=16,
            vocos_intermediate_dim=32, vocos_num_layers=2,
        )
        cfg.campplus = CAMPPlusConfig(feat_dim=80, embedding_size=16, growth_rate=4,
                                      bn_size=2, init_channels=16)
        cfg.w2v_bert = W2VBertConfig(hidden_size=32, num_layers=2, num_heads=4,
                                     intermediate_size=64, output_layer=1)
        cfg.mel = MelConfig(sample_rate=22050, n_fft=256, win_size=256, hop_size=64,
                            num_mels=20)
        cfg.engine = EngineConfig(diffusion_steps=4, text_buckets=(16, 32),
                                  code_buckets=(32, 64), prompt_frame_buckets=(32, 64))
        return cfg


# registry of nested dataclass fields for from_dict
_DATACLASS_FIELDS = {}
for _cls in [TTSConfig, GPTConfig, S2MelConfig, QwenEmoConfig]:
    for _f in dataclasses.fields(_cls):
        _default = _f.default_factory() if _f.default_factory is not dataclasses.MISSING else None  # type: ignore[misc]
        if dataclasses.is_dataclass(_default):
            _DATACLASS_FIELDS[(_cls, _f.name)] = type(_default)
for _cls, _name, _sub in [
    (TTSConfig, "gpt", GPTConfig), (TTSConfig, "s2mel", S2MelConfig),
    (TTSConfig, "vocoder", BigVGANConfig), (TTSConfig, "semantic_codec", RepCodecConfig),
    (TTSConfig, "campplus", CAMPPlusConfig), (TTSConfig, "w2v_bert", W2VBertConfig),
    (TTSConfig, "qwen_emo", QwenEmoConfig), (TTSConfig, "mel", MelConfig),
    (TTSConfig, "generation", GenerationConfig), (TTSConfig, "engine", EngineConfig),
    (TTSConfig, "server", ServerConfig),
    (GPTConfig, "condition_module", ConformerConfig),
    (GPTConfig, "emo_condition_module", ConformerConfig),
    (S2MelConfig, "dit", DiTConfig), (S2MelConfig, "wavenet", WaveNetConfig),
    (S2MelConfig, "length_regulator", LengthRegulatorConfig),
]:
    _DATACLASS_FIELDS[(_cls, _name)] = _sub

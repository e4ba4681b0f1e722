"""The port's vocoder variants against the JAX package on the CPU: the packs
(`models/vocoder/packed.py`, `ops/fused_vocoder.py`) against the JAX packs;
K10's plain version (`fused_resblock_stage`) against the JAX kernel in
interpret mode and against the module path; the fused, packed and
shared-activation vocodes against the JAX ones and the module BigVGAN; and
the engine with each flag.  The small BigVGANConfig of
tests/test_fused_vocoder.py, snake parameters moved off zero as that file
does; inputs from numpy with a seed.  The `cuda` case holds K10 against its
plain version on the card."""

import copy

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import BigVGANConfig
from voice_tts_tpu_torch.engine.engine import TTSEngine, tiny_config
from voice_tts_tpu_torch.models.layers import init_weights
from voice_tts_tpu_torch.models.vocoder import packed as ppacked
from voice_tts_tpu_torch.models.vocoder.bigvgan import BigVGAN
from voice_tts_tpu_torch.ops import aa_activation
from voice_tts_tpu_torch.ops import fused_vocoder as k10
from voice_tts_tpu_torch.utils.convert import convert, load_family

try:
    import jax
    import jax.numpy as jnp

    from tests.test_fused_vocoder import CFG as JCFG
    from tests.test_fused_vocoder import _init_model, _module_stage
    from voice_tts_tpu.models.vocoder import packed as jpacked
    from voice_tts_tpu.ops.attic import fused_vocoder as jfv
except ImportError:     # the machine with the card has no JAX: the `cuda` case runs there
    jax = None

# the same widths as tests/test_fused_vocoder.py's CFG
CFG = BigVGANConfig(num_mels=12, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                    upsample_initial_channel=32, resblock_kernel_sizes=(3, 7, 11),
                    resblock_dilation_sizes=((1, 3, 5),) * 3)
DILATIONS = (1, 3, 5)
HALO = 78       # a stage's stencil halo (tests/test_fused_vocoder.py)
# test_bigvgan's tolerance (tests/test_torch_models.py): f32 both sides,
# sums in another order, times max(1, max|ref|)
VOC_TOL = 2e-5


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(out, ref, tol):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def vocoders():
    """The JAX BigVGAN and its parameters (snake parameters + 0.05), and the
    port's module holding the same weights."""
    model, params = _init_model(JCFG)
    params = jax.tree.map(np.asarray, params)
    port = load_family(BigVGAN(CFG), convert("vocoder", params)).eval()
    return model, params, port


def signal(seed, c, t_len, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((1, c, t_len)) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# packs
# ---------------------------------------------------------------------------

def assert_leaf(ours, ref, exp_applied: bool):
    """Weights and biases are copies and zero pads of the same f32 values:
    bit-equal.  Snake values pass through exp, which XLA and PyTorch round
    differently in the last bit for about one value in ten (and the
    reciprocal 1 / (beta + 1e-9) can carry that bit once more): within 2 ulp."""
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, (ours.shape, ref.shape)
    if exp_applied:
        np.testing.assert_array_max_ulp(ours, ref, maxulp=2)
    else:
        np.testing.assert_array_equal(ours, ref)


def test_pack_stage_matches_jax(vocoders):
    _, params, port = vocoders
    state = port.state_dict()
    assert k10.fused_stage_plan(CFG) == jfv.fused_stage_plan(JCFG) == [True, True]
    for stage in (0, 1):
        ours = k10.pack_stage(state, stage, CFG)
        ref = jfv.pack_stage(params, stage, JCFG)
        for name in ("w", "b", "alpha", "brec"):
            assert_leaf(getattr(ours, name), getattr(ref, name), name in ("alpha", "brec"))
        assert ours.kernel_sizes == (3, 7, 11)


@pytest.mark.parametrize("variant", ["packed", "shared"])
def test_packed_trees_match_jax(vocoders, variant):
    _, params, port = vocoders
    if variant == "packed":
        ours = ppacked.pack_bigvgan(port.state_dict(), CFG)
        ref = jpacked.pack_bigvgan(params, JCFG)
    else:
        ours = ppacked.pack_bigvgan_shared(port.state_dict(), CFG)
        ref = jpacked.pack_bigvgan_shared(params, JCFG)
    for name in ("conv_pre", "conv_post"):
        assert set(ours[name]) == set(ref[name])
        for key in ref[name]:
            assert_leaf(ours[name][key], ref[name][key], False)
    for o, r in zip(ours["act_post"], ref["act_post"]):
        assert_leaf(o, r, True)
    assert len(ours["stages"]) == len(ref["stages"]) == 2
    for so, sr in zip(ours["stages"], ref["stages"]):
        for key in ("weight", "bias"):
            assert_leaf(so["ups"][key], sr["ups"][key], False)
        for io, ir in zip(so["iters"], sr["iters"]):
            assert set(io) == set(ir)
            for key in ir:
                if key in ("convs1", "convs2"):
                    for (wo, bo), (wr, br) in zip(io[key], ir[key]):
                        assert_leaf(wo, wr, False)
                        assert_leaf(bo, br, False)
                else:
                    assert_leaf(io[key], ir[key], key.startswith(("a", "br")))


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stage0(vocoders):
    """The JAX kernel in interpret mode (tt 128, four chunks) at stage 0, C
    16, T 512: one ~20 s call, shared by the tests held against it."""
    _, params, _ = vocoders
    x = signal(3, 16, 512)
    ref = np.asarray(jfv.fused_resblock_stage(jnp.asarray(x), jfv.pack_stage(params, 0, JCFG),
                                              DILATIONS, 11, tt=128, interpret=True))
    return x, ref


def test_k10_plain_matches_jax_kernel(vocoders, jax_stage0):
    """The plain K10 against the JAX kernel in interpret mode (tt 128, four
    chunks), C 16, T 512: both zero-pad the signal, so they agree at the
    edges too; f32 both, sums in another order (and over each block's own
    taps here, all 11 there): within 1e-4 of the largest magnitude."""
    _, _, port = vocoders
    x, ref = jax_stage0
    out = k10.fused_resblock_stage(t(x), k10.pack_stage(port.state_dict(), 0, CFG), DILATIONS)
    assert out.shape == ref.shape and out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), err


# the kernel's tolerance on the card (chip_smoke.py's K10_TOL), times max|ref|
K10_TOL = 1e-4


def assert_split_model(x, pack, dilations, ref):
    """The kernel's arithmetic (`fused_resblock_stage_split_plain`: both
    operands of every conv split into TF32 hi and lo, the three products
    lo.hi + hi.lo + hi.hi in f32, lo.lo dropped) against `ref` (the JAX
    kernel) and against the plain K10, within K10_TOL of max|ref|: the
    chosen numerics keep the card's tolerance."""
    split = k10.fused_resblock_stage_split_plain(t(x), pack, dilations).numpy()
    plain = k10.fused_resblock_stage_plain(t(x), pack, dilations).numpy()
    scale = float(np.abs(ref).max())
    assert split.shape == ref.shape
    assert np.abs(split - ref).max() <= K10_TOL * scale
    assert np.abs(split - plain).max() <= K10_TOL * scale
    # the split is not the plain arithmetic (TF32 rounding moves it) but
    # stays far inside the tolerance
    assert 0 < np.abs(split - plain).max() <= 0.1 * K10_TOL * scale


def test_k10_split_model_matches_jax_kernel(vocoders, jax_stage0):
    _, _, port = vocoders
    x, ref = jax_stage0
    assert_split_model(x, k10.pack_stage(port.state_dict(), 0, CFG), DILATIONS, ref)


@pytest.fixture(scope="module")
def tiny_vocoders():
    """The tiny engine's BigVGAN (`TTSConfig.tiny().vocoder`: C 16 and 8 at
    its two fused stages, one resblock of 3 taps at dilations 1 and 3) in
    JAX, snake parameters + 0.05, and the port's with the same weights."""
    from voice_tts_tpu.config import TTSConfig as JTTSConfig

    jcfg, cfg = JTTSConfig.tiny().vocoder, tiny_config().vocoder
    for f in ("num_mels", "upsample_rates", "upsample_initial_channel",
              "resblock_kernel_sizes", "resblock_dilation_sizes"):
        assert getattr(jcfg, f) == getattr(cfg, f), f
    _, params = _init_model(jcfg)
    params = jax.tree.map(np.asarray, params)
    port = load_family(BigVGAN(cfg), convert("vocoder", params)).eval()
    return jcfg, params, cfg, port


@pytest.mark.parametrize("stage,c", [(0, 16), (1, 8)])
def test_k10_split_model_at_tiny_vocoder_stages(tiny_vocoders, stage, c):
    """The split model against the JAX kernel in interpret mode at each
    fused stage of the tiny vocoder (T 384, three 128-sample chunks)."""
    jcfg, params, cfg, port = tiny_vocoders
    dil = tuple(cfg.resblock_dilation_sizes[0])
    x = signal(9 + stage, c, 384)
    ref = np.asarray(jfv.fused_resblock_stage(
        jnp.asarray(x), jfv.pack_stage(params, stage, jcfg), dil,
        max(cfg.resblock_kernel_sizes), tt=128, interpret=True))
    assert_split_model(x, k10.pack_stage(port.state_dict(), stage, cfg), dil, ref)


@pytest.mark.parametrize("stage,c", [(0, 16), (1, 8)])
def test_k10_plain_matches_module_path(vocoders, stage, c):
    """Against the JAX module path (replicate padding): exact to f32 noise
    beyond the stage's 78-sample halo, within 1e-2 of the scale at the
    edges (tests/test_fused_vocoder.py's bounds for the JAX kernel)."""
    _, params, port = vocoders
    x = signal(4 + stage, c, 512)
    ref = np.asarray(_module_stage(params, stage, jnp.asarray(x), JCFG))
    out = k10.fused_resblock_stage(t(x), k10.pack_stage(port.state_dict(), stage, CFG),
                                   DILATIONS).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out[..., HALO:-HALO], ref[..., HALO:-HALO],
                               atol=1e-5 * scale, rtol=1e-4)
    assert np.abs(out - ref).max() < 0.01 * scale


def test_fused_apply_matches_jax_module(vocoders):
    """The port's fused vocode (both stages through the plain K10) against
    the JAX module BigVGAN: beyond 4 halos of the signal edges as
    tests/test_fused_vocoder.py (atol 1e-4, rtol 1e-3), on a 200-frame mel
    so that the interior is not empty (800 samples, 176 inside)."""
    model, params, port = vocoders
    mel = signal(5, CFG.num_mels, 200)
    ref = np.asarray(jax.jit(model.apply)(params, jnp.asarray(mel)))
    packs = k10.pack_fused_stages(port.state_dict(), CFG)
    with torch.no_grad():
        out = k10.bigvgan_fused_apply(port, packs, t(mel)).numpy()
    assert out.shape == ref.shape == (1, 1, 800)
    np.testing.assert_allclose(out[..., 4 * HALO:-4 * HALO], ref[..., 4 * HALO:-4 * HALO],
                               atol=1e-4, rtol=1e-3)
    assert np.abs(out).max() <= 1.0


@pytest.mark.parametrize("variant", ["packed", "shared"])
def test_variant_apply_matches_jax_and_module(vocoders, variant, monkeypatch):
    """The packed / shared-activation vocode against the JAX one (no Pallas
    kernel by default) and against the port's module BigVGAN, within
    test_bigvgan's tolerance; each activation is one K2 call on
    (B, nk*C, T): 2 * 3 dilations per stage and the post activation."""
    model, params, port = vocoders
    mel = signal(6, CFG.num_mels, 24)
    if variant == "packed":
        tree = ppacked.pack_bigvgan(port.state_dict(), CFG)
        apply, japply = ppacked.bigvgan_packed_apply, jpacked.bigvgan_packed_apply
        jtree = jpacked.pack_bigvgan(params, JCFG)
    else:
        tree = ppacked.pack_bigvgan_shared(port.state_dict(), CFG)
        apply, japply = ppacked.bigvgan_shared_act_apply, jpacked.bigvgan_shared_act_apply
        jtree = jpacked.pack_bigvgan_shared(params, JCFG)
    ref = np.asarray(japply(jtree, jnp.asarray(mel), JCFG))
    calls = []
    plain = aa_activation.aa_snake_plain
    monkeypatch.setattr(aa_activation, "aa_snake_plain",
                        lambda x, *a: calls.append(x.shape) or plain(x, *a))
    with torch.no_grad():
        out = apply(tree, t(mel), CFG)
        assert len(calls) == 2 * 2 * 3 + 1
        assert all(s[1] == 3 * c for s, c in zip(calls, [16] * 6 + [8] * 6))
        close(out, ref, VOC_TOL)
        close(out, port(t(mel)).numpy(), VOC_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

FLAGS = {"packed": "use_packed_vocoder", "shared_act": "use_shared_act_vocoder",
         "fused": "use_fused_vocoder"}


@pytest.fixture(scope="module")
def base_engine():
    return TTSEngine.tiny(device="cpu", seed=0)


def engine_with(base, **flags):
    return TTSEngine(tiny_config(**flags), copy.deepcopy(base.models), base.tokenizer,
                     device="cpu")


def tone() -> bytes:
    from voice_tts_tpu_torch.audio import encode_wav_int16

    s = np.arange(16000) / 16000
    return encode_wav_int16((0.3 * np.sin(2 * np.pi * 220 * s) * 32767).astype(np.float32),
                            16000)


@pytest.mark.parametrize("variant", ["packed", "shared_act", "fused"])
def test_engine_serves_with_flag(base_engine, variant, monkeypatch):
    """A tiny engine built with each vocoder flag (no longer refused) takes
    that variant and serves a request; the fused one runs the plain K10 once
    per fused stage (both of the tiny vocoder's) a vocode; the packed and
    shared ones vocode the module path's waveform (within test_bigvgan's
    tolerance), the fused one agrees with it beyond the edge halos."""
    eng = engine_with(base_engine, **{FLAGS[variant]: True})
    assert eng.voc_variant == variant and base_engine.voc_variant == "module"
    stages = []
    plain = k10.fused_resblock_stage_plain
    monkeypatch.setattr(k10, "fused_resblock_stage_plain",
                        lambda x, *a: stages.append(x.shape) or plain(x, *a))
    res = eng.infer(tone(), "hello world.", do_sample=False)
    assert res.wav.size > 0 and res.sample_rate == 22050
    n_fused = sum(k10.fused_stage_plan(eng.cfg.vocoder)) if variant == "fused" else 0
    assert len(stages) == n_fused and (variant != "fused" or n_fused == 2)
    mel = t(signal(7, eng.cfg.vocoder.num_mels, 120))
    stages.clear()
    with torch.no_grad():
        out, ref = eng.vocode(mel), base_engine.vocode(mel)
    assert len(stages) == n_fused
    if variant == "fused":
        edge = 2 * HALO * 4        # two halos at stage 0's rate (4x below the output's)
        np.testing.assert_allclose(out[..., edge:-edge].numpy(),
                                   ref[..., edge:-edge].numpy(), atol=1e-4, rtol=1e-3)
    else:
        close(out, ref.numpy(), VOC_TOL)


def test_engine_refuses_tensor_parallel(base_engine):
    """`tensor_parallel` is no longer refused: the engine builds on the CPU
    with the trunk split over two shards, the fused and int8 decode off (no
    decode pack), and serves a request (the refusal left, more shards than
    cards, is held in tests/test_torch_parallel.py)."""
    from voice_tts_tpu_torch.parallel.tp import TPStack

    eng = engine_with(base_engine, tensor_parallel=2)
    assert eng.tp_mesh.shape == {"tp": 2} and isinstance(eng.gpt_rt.gpt, TPStack)
    assert eng.fused_pack is None and eng.readout_pack is None
    assert eng.gpt_rt.gpt.h_0.qkv_w_shards[0].shape[1] == 3 * eng.cfg.gpt.model_dim // 2
    assert eng.infer(tone(), "hello world.", do_sample=False).wav.size > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("c,t_len", [(16, 700), (48, 1500)])
def test_k10_kernel_matches_plain_on_card(cuda_device, c, t_len, monkeypatch):
    # the plain version's convs in full f32 (cuDNN defaults to TF32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = BigVGANConfig(num_mels=12, upsample_rates=(2,), upsample_kernel_sizes=(4,),
                        upsample_initial_channel=2 * c, resblock_kernel_sizes=(3, 7, 11),
                        resblock_dilation_sizes=((1, 3, 5),) * 3)
    with torch.device(cuda_device):
        voc = init_weights(BigVGAN(cfg), torch.Generator(cuda_device).manual_seed(0))
        for name, p in voc.named_parameters():
            if name.endswith(("alpha", "beta")):
                p.data += 0.05
    pack = k10.pack_stage(voc.state_dict(), 0, cfg)
    x = t(signal(8, c, t_len)).to(cuda_device)
    out = k10.fused_resblock_stage(x, pack, DILATIONS)
    torch.cuda.synchronize()
    ref = k10.fused_resblock_stage_plain(x, pack, DILATIONS)
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err

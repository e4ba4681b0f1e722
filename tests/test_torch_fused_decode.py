"""K1 fused decode step and K4 int8 GEMV: the port's packing and plain
PyTorch versions against the JAX package (Pallas kernels in interpret
mode) at L=2, D=256, H=4, Tmax=256; the kernel wrappers' device dispatch;
and (on a card only) the CUDA kernels against their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voice_tts_tpu.ops import fused_decode as jfd
from voice_tts_tpu.ops.int8_matmul import int8_gemv as jax_int8_gemv
from voice_tts_tpu.utils.quantize import quantize_gpt_params
from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.ops.aa_activation import aa_snake_activation
from voice_tts_tpu_torch.ops.int8_matmul import int8_gemv as port_int8_gemv
from voice_tts_tpu_torch.ops.int8_matmul import int8_gemv_plain
from voice_tts_tpu_torch.utils.convert import flatten_params
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

L, D, H, T_MAX, V = 2, 256, 4, 256, 300


def _gpt_tree(seed=0):
    """A numpy UnifiedVoice sub-tree holding what the packs read."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)
    layers = {}
    for i in range(L):
        layers[f"h_{i}"] = {
            "attn_c_attn": {"weight": n(D, 3 * D), "bias": n(3 * D)},
            "attn_c_proj": {"weight": n(D, D), "bias": n(D)},
            "mlp_c_fc": {"weight": n(D, 4 * D), "bias": n(4 * D)},
            "mlp_c_proj": {"weight": n(4 * D, D), "bias": n(D)},
            "ln_1": {"weight": 1 + n(D, std=0.1), "bias": n(D)},
            "ln_2": {"weight": 1 + n(D, std=0.1), "bias": n(D)},
        }
    return {"params": {
        "gpt": layers,
        "mel_head": {"weight": n(V, D), "bias": n(V)},
        "final_norm": {"weight": 1 + n(D, std=0.1), "bias": n(D)},
    }}


@pytest.fixture(scope="module")
def packs():
    tree = _gpt_tree()
    jax_rt = quantize_gpt_params(jax.tree.map(jnp.asarray, tree))
    jpack = jfd.pack_gpt(jax_rt, L)
    jro = jfd.pack_readout(jax_rt)
    state = quantize_gpt_state(flatten_params(tree))
    return jpack, jro, pfd.pack_gpt(state, L), pfd.pack_readout(state)


def test_pack_gpt_round_trip(packs):
    """int8 tiles bit-equal (the port stores each tile transposed), consts
    equal to 1e-6 (the same f32 values, bf16-rounded biases and LN rows)."""
    jpack, _, ppack, _ = packs
    np.testing.assert_array_equal(ppack.w.transpose(-1, -2).numpy(),
                                  np.asarray(jpack.w))
    np.testing.assert_allclose(ppack.consts.numpy(), np.asarray(jpack.consts),
                               atol=1e-6, rtol=0)


def test_pack_readout_round_trip(packs):
    _, jro, _, pro = packs
    tiles, _, vt = jro.w.shape
    np.testing.assert_array_equal(
        pro.w.numpy(), np.asarray(jro.w).transpose(0, 2, 1).reshape(tiles * vt, D))
    np.testing.assert_allclose(
        pro.consts.numpy(),
        np.asarray(jro.consts).transpose(1, 0, 2).reshape(2, tiles * vt),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(pro.lnf.numpy(), np.asarray(jro.lnf), atol=1e-6)


def test_fused_decode_step_chain_matches_jax(packs):
    """Three chained steps (each writes its kv rows at pos before the next).
    Tolerance 1e-3 * max|ref|: both round every activation to bf16 before
    the int8 products, so the only differences are f32 summation order and
    the rare bf16 rounding that order flips."""
    jpack, jro, ppack, pro = packs
    rng = np.random.default_rng(1)
    cache = (rng.standard_normal((L, 2, 1, T_MAX, D)) * 0.5).astype(np.float32)
    valid = np.ones(T_MAX, bool)
    valid[20:26] = False                        # invalid prompt pads
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)[:, None]
    jcache = jnp.asarray(cache, jnp.bfloat16)
    pcache = torch.from_numpy(cache).to(torch.bfloat16)
    pos = 60
    for step in range(3):
        x = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
        jy, jkv, jlog = jfd.fused_decode_step(
            jnp.asarray(x), jpack, jcache, jnp.asarray(bias), pos + step, H,
            interpret=True, readout_pack=jro)
        py, pkv, plog = pfd.fused_decode_step(
            torch.from_numpy(x), ppack, pcache, torch.from_numpy(bias),
            pos + step, H, readout_pack=pro)
        for name, out, ref in (("hidden", py, jy), ("kv_new", pkv, jkv),
                               ("logits", plog[:, :V], jlog[:, :V])):
            ref = np.asarray(ref, np.float32)
            scale = np.abs(ref).max()
            err = np.abs(out.float().numpy() - ref).max()
            assert err <= 1e-3 * scale, (step, name, err, scale)
        assert int(plog[0, :V].argmax()) == int(np.asarray(jlog)[0, :V].argmax())
        jcache = jfd.apply_kv_update(jcache, jkv, pos + step)
        pfd.apply_kv_update(pcache, pkv, pos + step)


def test_int8_gemv_matches_jax_interpret():
    """bf16 output: equal up to one bf16 rounding of the f32 sums."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.integers(-127, 128, (64, 256)).astype(np.int8)
    s = (rng.random((1, 256)) * 1e-2 + 1e-3).astype(np.float32)
    ref = np.asarray(jax_int8_gemv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                   jnp.asarray(s), interpret=True), np.float32)
    out = port_int8_gemv(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(w), torch.from_numpy(s))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=2 ** -7 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("name", ["fused_decode_step", "int8_gemv",
                                  "aa_snake_activation"])
def test_wrappers_take_plain_version_only_on_cpu(name):
    """A wrapper runs its plain version for CPU tensors only; a tensor on any
    other non-CUDA device is refused, never computed by a fallback."""
    meta = torch.device("meta")
    calls = {
        "fused_decode_step": lambda: pfd.fused_decode_step(
            torch.empty(1, D, device=meta), None, None, None, 0, H),
        "int8_gemv": lambda: port_int8_gemv(
            torch.empty(1, D, device=meta), None, torch.empty(D, device=meta)),
        "aa_snake_activation": lambda: aa_snake_activation(
            torch.empty(1, 2, 8, device=meta), torch.empty(2, device=meta),
            torch.empty(2, device=meta)),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[name]()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_fused_decode_kernel_matches_plain_on_card(packs, cuda_device):
    """The CUDA chain against the plain version on the same card inputs
    (tolerance as in the CPU parity test)."""
    _, _, ppack, pro = packs
    dev = cuda_device
    pack = pfd.FusedDecodePack(*(t.to(dev) for t in ppack))
    ro = pfd.ReadoutPack(*(t.to(dev) for t in pro))
    rng = np.random.default_rng(3)
    cache = torch.from_numpy(rng.standard_normal((L, 2, 1, T_MAX, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bias = torch.zeros((T_MAX, 1), device=dev)
    x = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32)).to(dev)
    out = pfd.fused_decode_step(x, pack, cache, bias, 70, H, readout_pack=ro)
    ref = pfd.fused_decode_step_plain(x, pack, cache, bias, 70, H, readout_pack=ro)
    for a, b in zip(out, ref):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 1e-3 * scale


@pytest.mark.cuda
def test_int8_gemv_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (64, 256)).astype(np.int8))
    s = torch.from_numpy((rng.random((1, 256)) * 1e-2 + 1e-3).astype(np.float32))
    args = [t.to(cuda_device) for t in (x.to(torch.bfloat16), w, s)]
    out = port_int8_gemv(*args).float()
    ref = int8_gemv_plain(*args).float()
    assert float((out - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())

"""K1 and K3 fused decode steps and K4 int8 GEMV: the port's packing, int8-KV
helpers and plain PyTorch versions against the JAX package (Pallas kernels
in interpret mode) at L=2, D=256, H=4, Tmax=256; the kernel wrappers' device
dispatch; and (on a card only) the CUDA kernels against their plain
versions."""

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.ops.aa_activation import aa_snake_activation
from voice_tts_tpu_torch.ops.int8_matmul import int8_gemv as port_int8_gemv
from voice_tts_tpu_torch.ops.int8_matmul import int8_gemv_plain
from voice_tts_tpu_torch.utils.convert import flatten_params
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

try:
    import jax
    import jax.numpy as jnp

    from voice_tts_tpu.ops import fused_decode as jfd
    from voice_tts_tpu.ops.int8_matmul import int8_gemv as jax_int8_gemv
    from voice_tts_tpu.utils.quantize import quantize_gpt_params
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

pytest_plugins = ("port_fixtures",)

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
    """(JAX pack, JAX readout, port pack, port readout); the JAX pair is
    None where JAX is absent (the `cuda` cases need only the port's)."""
    tree = _gpt_tree()
    jpack = jro = None
    if jax is not None:
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


def _close(out, ref, tol=1e-3):
    """max |out - ref| <= tol * max|ref| (the K1/K3 parity bound: both round
    every activation to bf16 before the int8 products, so they differ only in
    f32 summation order and the rare bf16 rounding that order flips)."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _jit_bits(fn, *args):
    """The JAX helper as the decode loops run it: under jit, where XLA turns
    the `/ 127.0` of the scale into a product with the f32 reciprocal."""
    return [np.asarray(a) for a in jax.jit(fn)(*args)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kv_helpers_bit_equal(dtype):
    """Scales and int8 rows of every int8-KV helper equal JAX's bit for bit,
    including an all-zero row (scale floored at 1e-12) and a half-way value
    (round half to even)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((L, 2, 3, 64, 32))
         * rng.random((L, 2, 3, 64, 1)) * 3).astype(np.float32)
    x[0, 0, 0, 3] = 0.0
    x[1, 1, 2, 5, :2] = [127.0, 0.5]            # q = 0.5 exactly -> 0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)

    def same(port, ref):
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a.numpy().view(np.uint8),
                                          np.asarray(b).view(np.uint8))
    same(pfd.quantize_kv_cache(tx[:, :, :1]), _jit_bits(jfd.quantize_kv_cache, jx[:, :, :1]))
    same(pfd.quantize_kv_cache_batch(tx), _jit_bits(jfd.quantize_kv_cache_batch, jx))
    kv = x[:, :, :, 9]                          # (L, 2, 3, 32) new-token rows
    same(pfd.quantize_kv_rows(torch.from_numpy(kv[:, :, 0])),
         _jit_bits(jfd.quantize_kv_rows, jnp.asarray(kv[:, :, 0])))
    cache = np.zeros((L, 2, 3, 64, 32), np.int8)
    scales = np.zeros((L, 3, 64, 2), np.float32)
    same(pfd.apply_kv_update_q_batch(torch.from_numpy(cache.copy()),
                                     torch.from_numpy(scales.copy()),
                                     torch.from_numpy(kv), 11),
         _jit_bits(lambda c, s, n: jfd.apply_kv_update_q_batch(c, s, n, 11),
                   jnp.asarray(cache), jnp.asarray(scales), jnp.asarray(kv)))
    same(pfd.apply_kv_update_q(torch.from_numpy(cache[:, :, :1].copy()),
                               torch.from_numpy(scales[:, 0].copy()),
                               torch.from_numpy(kv[:, :, 0]), 11),
         _jit_bits(lambda c, s, n: jfd.apply_kv_update_q(c, s, n, 11),
                   jnp.asarray(cache[:, :, :1]), jnp.asarray(scales[:, 0]),
                   jnp.asarray(kv[:, :, 0])))
    new = rng.standard_normal((L, 2, 3, 32)).astype(np.float32)
    fcache = rng.standard_normal((L, 2, 3, 64, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        pfd.apply_kv_update_batch(torch.from_numpy(fcache.copy()),
                                  torch.from_numpy(new), 4).numpy(),
        np.asarray(jfd.apply_kv_update_batch(jnp.asarray(fcache), jnp.asarray(new), 4)))


def test_fused_decode_step_int8_kv_chain_matches_jax(packs):
    """K1's int8-KV branch: three chained steps, each writing its quantized
    kv rows and scales at pos before the next; kv_new comes back f32.
    Tolerance as in the float-KV chain."""
    jpack, jro, ppack, pro = packs
    rng = np.random.default_rng(5)
    cache = (rng.standard_normal((L, 2, 1, T_MAX, D)) * 0.5).astype(np.float32)
    bias = np.zeros((T_MAX, 1), np.float32)
    bias[20:26] = -1e30
    # the JAX helpers under jit, as its decode loop runs them
    jcache, jscales = jax.jit(jfd.quantize_kv_cache)(jnp.asarray(cache, jnp.bfloat16))
    pcache, pscales = pfd.quantize_kv_cache(torch.from_numpy(cache).to(torch.bfloat16))
    update_q = jax.jit(jfd.apply_kv_update_q)
    pos = 150
    for step in range(3):
        x = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
        jy, jkv, jlog = jfd.fused_decode_step(
            jnp.asarray(x), jpack, jcache, jnp.asarray(bias), pos + step, H,
            interpret=True, kv_scales=jscales, readout_pack=jro)
        py, pkv, plog = pfd.fused_decode_step(
            torch.from_numpy(x), ppack, pcache, torch.from_numpy(bias),
            pos + step, H, readout_pack=pro, kv_scales=pscales)
        assert pkv.dtype == torch.float32 and jkv.dtype == jnp.float32
        for out, ref in ((py, jy), (pkv, jkv), (plog[:, :V], jlog[:, :V])):
            _close(out, ref)
        assert int(plog[0, :V].argmax()) == int(np.asarray(jlog)[0, :V].argmax())
        jcache, jscales = update_q(jcache, jscales, jkv, pos + step)
        pfd.apply_kv_update_q(pcache, pscales, pkv, pos + step)


@pytest.mark.parametrize("case", ["beam_table_int8_readout", "per_row_pos"])
def test_fused_decode_step_batch_matches_jax(packs, case):
    """K3 plain vs the JAX Pallas kernel in interpret mode.  beam_table_int8
    _readout: B = 3 rows reading their history through a random in-group
    ancestor table, int8 KV, folded readout.  per_row_pos: B = 2 at their own
    positions, one of them an idle slot at 0 (finite outputs), no table,
    bf16 cache.  Tolerance as in the K1 chain."""
    jpack, jro, ppack, pro = packs
    rng = np.random.default_rng(11)
    b = 3 if case == "beam_table_int8_readout" else 2
    cache = (rng.standard_normal((L, 2, b, T_MAX, D)) * 0.5).astype(np.float32)
    bias = np.zeros((b, T_MAX), np.float32)
    bias[:, 20:26] = -1e30
    x = (rng.standard_normal((b, D)) * 0.5).astype(np.float32)
    jcache = jnp.asarray(cache, jnp.bfloat16)
    pcache = torch.from_numpy(cache).to(torch.bfloat16)
    kw_j, kw_p = {}, {}
    if case == "beam_table_int8_readout":
        pos = 140
        src = rng.integers(0, b, (b, T_MAX)).astype(np.int32)
        jcache, jsc = jax.jit(jfd.quantize_kv_cache_batch)(jcache)
        pcache, psc = pfd.quantize_kv_cache_batch(pcache)
        kw_j = dict(kv_scales=jsc, beam_src=jnp.asarray(src), readout_pack=jro)
        kw_p = dict(kv_scales=psc, beam_src=torch.from_numpy(src), readout_pack=pro)
        jpos, ppos = pos, pos
    else:
        pos = np.asarray([97, 0], np.int32)
        jpos, ppos = jnp.asarray(pos), torch.from_numpy(pos)
    jout = jfd.fused_decode_step_batch(jnp.asarray(x), jpack, jcache,
                                       jnp.asarray(bias), jpos, H,
                                       interpret=True, **kw_j)
    pout = pfd.fused_decode_step_batch(torch.from_numpy(x), ppack, pcache,
                                       torch.from_numpy(bias), ppos, H, **kw_p)
    assert all(bool(torch.isfinite(t).all()) for t in pout if t is not None)
    _close(pout[0], jout[0])
    _close(pout[1], jout[1])
    if case == "beam_table_int8_readout":
        assert pout[1].dtype == torch.float32
        _close(pout[2][:, :V], jout[2][:, :V])
        np.testing.assert_array_equal(pout[2][:, :V].argmax(-1).numpy(),
                                      np.asarray(jout[2])[:, :V].argmax(-1))
    else:
        assert pout[1].dtype == torch.bfloat16 and pout[2] is None


def test_k1_plain_is_k3_plain_at_one_row(packs):
    """K1's plain version is K3's at B = 1 (the CUDA chain is shared too)."""
    _, _, ppack, pro = packs
    rng = np.random.default_rng(13)
    cache = torch.from_numpy(rng.standard_normal((L, 2, 1, T_MAX, D)).astype(
        np.float32)).to(torch.bfloat16)
    bias = torch.zeros((T_MAX, 1))
    x = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32))
    y1, kv1, lg1 = pfd.fused_decode_step(x, ppack, cache, bias, 33, H, readout_pack=pro)
    y3, kv3, lg3 = pfd.fused_decode_step_batch(x, ppack, cache, bias.reshape(1, -1),
                                               33, H, readout_pack=pro)
    assert torch.equal(y1, y3) and torch.equal(kv1, kv3[:, :, 0]) and torch.equal(lg1, lg3)


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


@pytest.mark.parametrize("name", ["fused_decode_step", "fused_decode_step_batch",
                                  "int8_gemv", "aa_snake_activation"])
def test_wrappers_take_plain_version_only_on_cpu(name):
    """A wrapper runs its plain version for CPU tensors only; a tensor on any
    other non-CUDA device is refused, never computed by a fallback."""
    meta = torch.device("meta")
    calls = {
        "fused_decode_step": lambda: pfd.fused_decode_step(
            torch.empty(1, D, device=meta), None, None, None, 0, H),
        "fused_decode_step_batch": lambda: pfd.fused_decode_step_batch(
            torch.empty(3, D, device=meta), None,
            torch.empty(L, 2, 3, T_MAX, D, device=meta), None, 0, H),
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["table_int8", "per_row_pos_bf16"])
def test_fused_decode_batch_kernel_matches_plain_on_card(packs, cuda_device, case):
    """K3's CUDA chain against its plain version on the same card inputs:
    B = 3 through an ancestor table with int8 KV, and B = 8 at per-row
    positions (one idle at 0) with a bf16 cache (tolerance as on the CPU)."""
    _, _, ppack, pro = packs
    dev = cuda_device
    pack = pfd.FusedDecodePack(*(t.to(dev) for t in ppack))
    ro = pfd.ReadoutPack(*(t.to(dev) for t in pro))
    rng = np.random.default_rng(6)
    b = 3 if case == "table_int8" else 8
    cache = torch.from_numpy(rng.standard_normal((L, 2, b, T_MAX, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bias = torch.zeros((b, T_MAX), device=dev)
    x = torch.from_numpy(rng.standard_normal((b, D)).astype(np.float32)).to(dev)
    kw = {"readout_pack": ro}
    if case == "table_int8":
        pos = 120
        cache, kw["kv_scales"] = pfd.quantize_kv_cache_batch(cache)
        kw["beam_src"] = torch.from_numpy(
            rng.integers(0, b, (b, T_MAX)).astype(np.int32)).to(dev)
    else:
        pos = torch.tensor([0, 5, 17, 60, 99, 128, 200, 255], dtype=torch.int32,
                           device=dev)
    out = pfd.fused_decode_step_batch(x, pack, cache, bias, pos, H, **kw)
    ref = pfd.fused_decode_step_batch_plain(x, pack, cache, bias, pos, H, **kw)
    for a, r in zip(out, ref):
        scale = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= 1e-3 * scale

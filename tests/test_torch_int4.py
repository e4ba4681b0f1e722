"""K7, the int4 weight branch of the decode steps: the port's `pack_gpt_int4`
against the JAX package's bit for bit, and the plain int4 K1 and K3 steps
against the JAX Pallas kernels in interpret mode at L=2, D=256, H=4,
Tmax=256; the int4 dequant-scheme and engine-flag checks; and (on a card
only) the CUDA chain with an int4 pack against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voice_tts_tpu.ops import fused_decode as jfd
from voice_tts_tpu.utils.quantize import quantize_gpt_params
from voice_tts_tpu_torch.engine.engine import TTSEngine, tiny_config
from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.utils.convert import flatten_params
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

L, D, H, T_MAX, V = 2, 256, 4, 256, 300


def _gpt_tree(seed=0):
    """A numpy UnifiedVoice sub-tree holding what the packs read (f32)."""
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
    # one all-zero group: its scale floors at 1e-12 and its nibbles are 0
    layers["h_1"]["mlp_c_fc"]["weight"][:pfd.group_size(D), 5] = 0.0
    return {"params": {
        "gpt": layers,
        "mel_head": {"weight": n(V, D), "bias": n(V)},
        "final_norm": {"weight": 1 + n(D, std=0.1), "bias": n(D)},
    }}


@pytest.fixture(scope="module")
def packs():
    """JAX and port packs from the same f32 tree: int4 trunk (g = D/2) and
    the int8 readout the engine folds beside it."""
    tree = _gpt_tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    jro = jfd.pack_readout(quantize_gpt_params(jtree))
    state = flatten_params(tree)
    return (jfd.pack_gpt_int4(jtree, L), jro, pfd.pack_gpt_int4(state, L),
            pfd.pack_readout(quantize_gpt_state(state)))


# group_size(256) is 128 = D/2 (one group a half, the flagship's g = D/2
# case); 64 gives two groups a half, as g128 gives five at D = 1280
@pytest.mark.parametrize("group", [0, 64], ids=["group_size_is_half", "g64"])
def test_pack_gpt_int4_bit_equal(group):
    """Nibbles, group scales and consts equal JAX's jitted pack bit for bit
    (the port stores each tile (out, in/2) and the scales (L, 12, D, G))."""
    tree = _gpt_tree(1)
    ref = jfd.pack_gpt_int4(jax.tree.map(jnp.asarray, tree), L, group=group)
    out = pfd.pack_gpt_int4(flatten_params(tree), L, group=group)
    n_groups = D // (group or pfd.group_size(D))
    assert out.w.shape == (L, 12, D, D // 2) and out.w.dtype == torch.int8
    assert out.gscales.shape == (L, 12, D, n_groups)
    np.testing.assert_array_equal(out.w.transpose(-1, -2).numpy(), np.asarray(ref.w))
    np.testing.assert_array_equal(
        out.gscales.transpose(-1, -2).numpy().view(np.uint32),
        np.asarray(ref.gscales).view(np.uint32))
    np.testing.assert_array_equal(out.consts.numpy().view(np.uint32),
                                  np.asarray(ref.consts).view(np.uint32))


def test_pack_gpt_int4_rejects_a_group_that_does_not_divide_the_half():
    with pytest.raises(ValueError, match="divide the packed half"):
        pfd.pack_gpt_int4(flatten_params(_gpt_tree()), L, group=96)


def _close(out, ref, tol=1e-3):
    """max |out - ref| <= tol * max|ref|.  Both sides round each activation
    to bf16 and multiply it by exact small integers, sum each group in f32,
    scale it and add the groups in the same order: they differ only in the
    f32 summation order inside a group and the rare bf16 rounding it flips."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16_kv", "int8_kv"])
def test_int4_k1_chain_matches_jax(packs, int8_kv):
    """The plain int4 K1 step, three chained steps (each writes its kv rows
    at pos before the next) with the folded int8 readout, against JAX's
    `fused_decode_step` with the int4 pack in interpret mode."""
    jpack, jro, ppack, pro = packs
    rng = np.random.default_rng(3)
    cache = (rng.standard_normal((L, 2, 1, T_MAX, D)) * 0.5).astype(np.float32)
    bias = np.zeros((T_MAX, 1), np.float32)
    bias[20:26] = -1e30                          # invalid prompt pads
    jcache = jnp.asarray(cache, jnp.bfloat16)
    pcache = torch.from_numpy(cache).to(torch.bfloat16)
    jsc = psc = None
    if int8_kv:
        jcache, jsc = jax.jit(jfd.quantize_kv_cache)(jcache)
        pcache, psc = pfd.quantize_kv_cache(pcache)
    pos = 90
    for step in range(3):
        x = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
        jy, jkv, jlog = jfd.fused_decode_step(
            jnp.asarray(x), jpack, jcache, jnp.asarray(bias), pos + step, H,
            interpret=True, kv_scales=jsc, readout_pack=jro)
        py, pkv, plog = pfd.fused_decode_step(
            torch.from_numpy(x), ppack, pcache, torch.from_numpy(bias), pos + step,
            H, readout_pack=pro, kv_scales=psc)
        for out, ref in ((py, jy), (pkv, jkv), (plog[:, :V], jlog[:, :V])):
            _close(out, ref)
        assert int(plog[0, :V].argmax()) == int(np.asarray(jlog)[0, :V].argmax())
        if int8_kv:
            jcache, jsc = jax.jit(jfd.apply_kv_update_q)(jcache, jsc, jkv, pos + step)
            pfd.apply_kv_update_q(pcache, psc, pkv, pos + step)
        else:
            jcache = jfd.apply_kv_update(jcache, jkv, pos + step)
            pfd.apply_kv_update(pcache, pkv, pos + step)


def test_int4_k3_step_with_table_matches_jax(packs):
    """The plain int4 K3 step at B = 3 through a random ancestor table, bf16
    cache, folded readout, against JAX's `fused_decode_step_batch` with the
    int4 pack in interpret mode."""
    jpack, jro, ppack, pro = packs
    rng = np.random.default_rng(4)
    b, pos = 3, 130
    cache = (rng.standard_normal((L, 2, b, T_MAX, D)) * 0.5).astype(np.float32)
    bias = np.zeros((b, T_MAX), np.float32)
    bias[:, 20:26] = -1e30
    x = (rng.standard_normal((b, D)) * 0.5).astype(np.float32)
    src = rng.integers(0, b, (b, T_MAX)).astype(np.int32)
    jout = jfd.fused_decode_step_batch(
        jnp.asarray(x), jpack, jnp.asarray(cache, jnp.bfloat16), jnp.asarray(bias),
        pos, H, interpret=True, beam_src=jnp.asarray(src), readout_pack=jro)
    pout = pfd.fused_decode_step_batch(
        torch.from_numpy(x), ppack, torch.from_numpy(cache).to(torch.bfloat16),
        torch.from_numpy(bias), pos, H, beam_src=torch.from_numpy(src),
        readout_pack=pro)
    _close(pout[0], jout[0])
    _close(pout[1], jout[1])
    _close(pout[2][:, :V], jout[2][:, :V])
    np.testing.assert_array_equal(pout[2][:, :V].argmax(-1).numpy(),
                                  np.asarray(jout[2])[:, :V].argmax(-1))


def test_int4_and_int8_steps_agree_within_the_quantization_envelope(packs):
    """The int4 step stays near the int8 step on the same f32 weights (a
    check that the nibble pairing and the group scales are read where the
    pack put them: a swapped half or group gives an error of the order of
    the output).  Bound 0.25 * max|int8|: int4 RTN with g = D/2 keeps about
    three bits of each weight."""
    _, _, ppack, _ = packs
    state = quantize_gpt_state(flatten_params(_gpt_tree()))
    p8 = pfd.pack_gpt(state, L)
    rng = np.random.default_rng(9)
    cache = torch.from_numpy(rng.standard_normal((L, 2, 1, T_MAX, D)).astype(
        np.float32)).to(torch.bfloat16)
    bias = torch.zeros((T_MAX, 1))
    x = torch.from_numpy((rng.standard_normal((1, D)) * 0.5).astype(np.float32))
    y4 = pfd.fused_decode_step(x, ppack, cache, bias, 40, H)[0]
    y8 = pfd.fused_decode_step(x, p8, cache, bias, 40, H)[0]
    assert float((y4 - y8).abs().max()) <= 0.25 * float(y8.abs().max())


@pytest.mark.parametrize("scheme", [False, "i8sh"])
def test_int4_expand_schemes_of_equal_values_are_taken(scheme):
    pfd.check_int4_expand(scheme)


def test_int4_expand_true_is_refused_as_tpu_only():
    with pytest.raises(ValueError, match="TPU-only"):
        pfd.check_int4_expand(True)
    with pytest.raises(ValueError, match="TPU-only"):
        TTSEngine.tiny(use_int8_decode=True, use_fused_decode=True,
                       use_int4_decode=True, int4_expand=True)


@pytest.mark.parametrize("flags", [dict(use_int4_decode=True),
                                   dict(use_int8_kv=True)],
                         ids=["int4_target", "int8_kv"])
def test_spec_decode_refuses_what_the_jax_engine_refuses(flags):
    """Spec decode verifies with the int8 pack and a bf16 cache: combined
    with an int4 decode pack or int8 KV the engine raises, as JAX's does."""
    cfg = tiny_config(use_int8_decode=True, use_fused_decode=True,
                      spec_decode_k=4, **flags)
    with pytest.raises(ValueError, match="spec_decode_k"):
        TTSEngine.random(cfg, device="cpu")


def test_engine_builds_int4_packs_from_the_f32_master():
    """use_int4_decode: the decode pack is `pack_gpt_int4` of the f32 master
    (not of the int8 copy) with the configured group; spec decode keeps the
    int8 pack and drafts with the int4 one; the masters can be released."""
    int4 = TTSEngine.tiny(use_int8_decode=True, use_fused_decode=True,
                          use_int4_decode=True, int4_group=16,
                          release_master_trees=True)
    assert isinstance(int4.fused_pack, pfd.FusedDecodePackInt4)
    d = int4.cfg.gpt.model_dim
    assert int4.fused_pack.gscales.shape[-1] == d // 16
    master = TTSEngine.tiny(use_int8_decode=True, use_fused_decode=True)
    ref = pfd.pack_gpt_int4(master.gpt.state_dict(), master.cfg.gpt.layers, group=16)
    for a, b in zip(int4.fused_pack, ref):
        assert torch.equal(a, b)
    spec = TTSEngine.tiny(use_int8_decode=True, use_fused_decode=True,
                          spec_decode_k=4)
    assert isinstance(spec.fused_pack, pfd.FusedDecodePack)
    assert isinstance(spec.spec_draft_pack, pfd.FusedDecodePackInt4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3])
def test_int4_chain_matches_plain_on_card(packs, cuda_device, rows):
    """K7 through K1 (one row) and K3 (three rows through a table) on the
    card against the plain version on the same inputs (tolerance as on the
    CPU)."""
    _, _, ppack, pro = packs
    dev = cuda_device
    pack = pfd.FusedDecodePackInt4(*(t.to(dev) for t in ppack))
    ro = pfd.ReadoutPack(*(t.to(dev) for t in pro))
    rng = np.random.default_rng(5)
    cache = torch.from_numpy(rng.standard_normal((L, 2, rows, T_MAX, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bias = torch.zeros((rows, T_MAX), device=dev)
    x = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32)).to(dev)
    src = torch.from_numpy(rng.integers(0, rows, (rows, T_MAX)).astype(np.int32)).to(dev)
    out = pfd.fused_decode_step_batch(x, pack, cache, bias, 77, H, beam_src=src,
                                      readout_pack=ro)
    ref = pfd.fused_decode_step_batch_plain(x, pack, cache, bias, 77, H,
                                            beam_src=src, readout_pack=ro)
    for a, r in zip(out, ref):
        scale = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= 1e-3 * scale

"""The split plans of the int8 decode kernels (K4's contraction split, K1 /
K3's split-prefix attention) and their plain twins: the planners at every
path shape, K4 summed by contraction slices against the JAX kernel in
interpret mode, and the K3 step with the split-prefix attention against the
unsplit plain step and the JAX `fused_decode_step_batch` (interpret mode) at
L=2, D=256, H=4, Tmax=512, on the edge cases of the split; then (on a card
only) the CUDA kernels on the same cases, repeat calls bit-equal."""

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.ops import int8_matmul as pim

from test_torch_fused_decode import D, H, L, V, _close, packs  # noqa: F401

try:
    import jax
    import jax.numpy as jnp

    from voice_tts_tpu.ops import fused_decode as jfd
    from voice_tts_tpu.ops.int8_matmul import int8_gemv as jax_int8_gemv
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

pytest_plugins = ("port_fixtures",)

T_MAX = 512
# (D, F) of a GPT layer's four int8 products at the flagship D 1280
PATH_SHAPES = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))


@pytest.mark.parametrize("n", [1, 3, 8, 32])
@pytest.mark.parametrize("d,f", PATH_SHAPES)
def test_plan_int8_gemv_fills_the_card(n, d, f):
    """Every path shape at N 1 / 3 / 8 / 32: at least two blocks an SM, the
    contraction covered by whole 32-row chunks (the last slice shorter),
    slabs of at most 8 rows, and the (splits, N, F) f32 workspace."""
    plan = pim.plan_int8_gemv(n, d, f)
    assert plan.blocks >= pim.MIN_BLOCKS
    assert plan.split_rows % pim.CHUNK == 0 and plan.split_rows <= pim.MAX_SPLIT_ROWS
    assert (plan.splits - 1) * plan.split_rows < d <= plan.splits * plan.split_rows
    assert plan.slab == {1: 1, 3: 4, 8: 8, 32: 8}[n] and plan.slabs * plan.slab >= n
    assert plan.stripes * pim.COLS >= f
    assert plan.partial_numel == plan.splits * n * f


@pytest.mark.parametrize("n,d,f", [(1, 64, 256), (5, 64, 192), (32, 96, 16)])
def test_plan_int8_gemv_small_shapes(n, d, f):
    """Shapes with fewer chunks than the card's blocks want: one chunk a
    slice, every chunk its own slice."""
    plan = pim.plan_int8_gemv(n, d, f)
    assert plan.split_rows == pim.CHUNK and plan.splits == -(-d // pim.CHUNK)
    assert plan.partial_numel == plan.splits * n * f


@pytest.mark.parametrize("pos,t_max,splits", [
    (0, 1792, 1), (1, 1792, 1), (255, 1792, 1), (256, 1792, 1), (257, 1792, 2),
    (1500, 1792, 6), (1792, 1792, 7), (2000, 1792, 7)])
def test_attend_splits_shared_pos(pos, t_max, splits):
    """A shared pos: ceil(pos / 256) splits of the live prefix, at least one
    (a pos-0 row still needs the block that combines its current token)."""
    assert pfd.attend_splits(pos, t_max) == splits
    hd = 64
    assert pfd.attend_workspace(3, 20, hd, splits) == 3 * 20 * splits * (hd + 2)


def test_attend_splits_per_row_pos():
    """Per-row positions stay on the card: the grid covers Tmax, and a split
    past a row's prefix contributes nothing."""
    pos = torch.tensor([0, 17, 1500], dtype=torch.int32)
    assert pfd.attend_splits(pos, 1792) == 7
    assert pfd.attend_splits(pos, 512) == 2


@pytest.mark.parametrize("n,d,f", [(1, 96, 256), (3, 160, 128), (32, 64, 48)])
def test_int8_gemv_split_plain_matches_jax(n, d, f):
    """K4 summed as the kernel cuts it (one f32 partial a contraction slice,
    added in slice order) against the JAX kernel in interpret mode and the
    unsplit plain version: equal up to one bf16 rounding of the f32 sums."""
    rng = np.random.default_rng(n * d + f)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.integers(-127, 128, (d, f)).astype(np.int8)
    s = (rng.random((1, f)) * 1e-2 + 1e-3).astype(np.float32)
    ref = np.asarray(jax_int8_gemv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                   jnp.asarray(s), interpret=True), np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = pim.int8_gemv_split_plain(xb, torch.from_numpy(w), torch.from_numpy(s))
    assert out.dtype == torch.bfloat16 and pim.plan_int8_gemv(n, d, f).splits > 1
    tol = 2 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    plain = pim.int8_gemv_plain(xb, torch.from_numpy(w), torch.from_numpy(s))
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(), atol=tol, rtol=0)


# name: (rows, int8 KV, ancestor table, pos, prompt-pad span under -1e30)
SPLIT_CASES = {
    "pos255_table_int8": (3, True, True, 255, (20, 26)),
    "pos256_table_int8": (3, True, True, 256, (20, 26)),
    "pos257_table_bf16": (3, False, True, 257, (20, 26)),
    "per_row_with_idle_slot_bf16": (4, False, False, [0, 255, 256, 300], (20, 26)),
    "split_under_bias_int8": (3, True, True, 400, (0, 256)),
    "b1_table_bf16": (1, False, True, 300, (20, 26)),
    "b1_table_int8": (1, True, True, 300, (20, 26)),
    "b3_table_bf16": (3, False, True, 300, (20, 26)),
    "b3_table_int8": (3, True, True, 300, (20, 26)),
    "b8_table_bf16": (8, False, True, 300, (20, 26)),
    "b8_table_int8": (8, True, True, 300, (20, 26)),
    "b12_table_bf16": (12, False, True, 300, (20, 26)),
    "b12_table_int8": (12, True, True, 300, (20, 26)),
}


def _split_case(name):
    """numpy inputs of one case: cache (L, 2, B, Tmax, D), bias, x, src, pos."""
    b, _, table, pos, (lo, hi) = SPLIT_CASES[name]
    rng = np.random.default_rng(sorted(SPLIT_CASES).index(name))
    cache = (rng.standard_normal((L, 2, b, T_MAX, D)) * 0.5).astype(np.float32)
    bias = np.zeros((b, T_MAX), np.float32)
    bias[:, lo:hi] = -1e30
    x = (rng.standard_normal((b, D)) * 0.5).astype(np.float32)
    src = rng.integers(0, b, (b, T_MAX)).astype(np.int32) if table else None
    return cache, bias, x, src, (np.asarray(pos, np.int32) if isinstance(pos, list) else pos)


def _port_args(name, ppack, pro, dev="cpu"):
    cache, bias, x, src, pos = _split_case(name)
    int8_kv = SPLIT_CASES[name][1]
    pcache = torch.from_numpy(cache).to(dev, torch.bfloat16)
    kw = {"readout_pack": pfd.ReadoutPack(*(t.to(dev) for t in pro))}
    if int8_kv:
        pcache, kw["kv_scales"] = pfd.quantize_kv_cache_batch(pcache)
    if src is not None:
        kw["beam_src"] = torch.from_numpy(src).to(dev)
    ppos = torch.from_numpy(pos).to(dev) if isinstance(pos, np.ndarray) else pos
    pack = pfd.FusedDecodePack(*(t.to(dev) for t in ppack))
    return (torch.from_numpy(x).to(dev), pack, pcache, torch.from_numpy(bias).to(dev),
            ppos, H), kw


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_prefix_step_matches_plain_and_jax(packs, name):
    """The K3 step with the split-prefix attention (splits of BLOCK_T
    positions, combined in split order) against the unsplit plain step and
    the JAX kernel in interpret mode: hidden rows, kv_new and logits within
    the K1 / K3 parity bound, finite everywhere (an idle pos-0 slot and a
    split wholly under the -1e30 prompt-pad bias included), and the same
    argmax per row as the unsplit step."""
    jpack, jro, ppack, pro = packs
    args, kw = _port_args(name, ppack, pro)
    split = pfd.fused_decode_step_batch_split_plain(*args, **kw)
    plain = pfd.fused_decode_step_batch_plain(*args, **kw)
    assert all(bool(torch.isfinite(t).all()) for t in split)
    for a, r in zip(split, plain):
        _close(a, r.float().numpy())
    np.testing.assert_array_equal(split[2][:, :V].argmax(-1).numpy(),
                                  plain[2][:, :V].argmax(-1).numpy())

    cache, bias, x, src, pos = _split_case(name)
    jcache = jnp.asarray(cache, jnp.bfloat16)
    kw_j = {"readout_pack": jro}
    if SPLIT_CASES[name][1]:
        jcache, kw_j["kv_scales"] = jax.jit(jfd.quantize_kv_cache_batch)(jcache)
    if src is not None:
        kw_j["beam_src"] = jnp.asarray(src)
    jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
    jout = jfd.fused_decode_step_batch(jnp.asarray(x), jpack, jcache, jnp.asarray(bias),
                                       jpos, H, interpret=True, **kw_j)
    _close(split[0], jout[0])
    _close(split[1], jout[1])
    _close(split[2][:, :V], jout[2][:, :V])


def test_split_twin_combines_like_softmax():
    """`_split_prefix_attention` against one softmax over [prefix, current
    token]: live, partly masked, wholly -1e30 and wholly past-the-prefix
    splits, at split widths that cut inside a split and at its edge."""
    g = torch.Generator().manual_seed(5)
    b, p, h, hd = 4, 600, 3, 16
    qh, k, v = (torch.randn(b, *s, generator=g) for s in ((h, hd), (p, h, hd), (p, h, hd)))
    mask = torch.zeros(b, p)
    mask[0, 256:512] = -1e30
    mask[1, 300:] = float("-inf")
    mask[2, :] = float("-inf")
    mask[3, :256] = -1e30
    s_cur, v_cur = torch.randn(b, h, 1, generator=g), torch.randn(b, h, hd, generator=g)
    scores = torch.einsum("bhd,bthd->bht", qh, k) + mask[:, None, :]
    probs = torch.softmax(torch.cat([scores, s_cur], -1), -1)
    ref = torch.einsum("bht,bthd->bhd", probs[..., :p], v) + probs[..., p:] * v_cur
    for split_t in (64, 256, 1024):
        out = pfd._split_prefix_attention(qh, k, v, mask, s_cur, v_cur, split_t)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(pfd._split_prefix_attention(qh, k, v, mask, s_cur, v_cur, 256)[2],
                       v_cur[2])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_prefix_kernel_matches_plain_on_card(packs, cuda_device, name):
    """K3's CUDA chain (split-prefix attention, PDL GEMVs) on every split
    case against the plain step on the same card inputs (tolerance as on
    the CPU), finite, and two calls bit-equal."""
    _, _, ppack, pro = packs
    args, kw = _port_args(name, ppack, pro, cuda_device)
    out = pfd.fused_decode_step_batch(*args, **kw)
    again = pfd.fused_decode_step_batch(*args, **kw)
    ref = pfd.fused_decode_step_batch_plain(*args, **kw)
    for a, a2, r in zip(out, again, ref):
        assert torch.isfinite(a).all() and torch.equal(a, a2)
        assert float((a.float() - r.float()).abs().max()) <= 1e-3 * float(r.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8, 32])
@pytest.mark.parametrize("d,f", PATH_SHAPES)
def test_int8_gemv_kernel_path_shapes_on_card(cuda_device, n, d, f):
    """K4 at every path shape and N 1 / 3 / 8 / 32 against its plain version
    (2^-7 of max|ref|: one bf16 rounding of the sums), bf16 out, two calls
    bit-equal."""
    g = torch.Generator(device=cuda_device).manual_seed(n + d + f)
    x = torch.randn(n, d, generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randint(-127, 128, (d, f), generator=g, device=cuda_device, dtype=torch.int8)
    s = torch.rand(1, f, generator=g, device=cuda_device) * 1e-3 + 1e-4
    out, again = pim.int8_gemv(x, w, s), pim.int8_gemv(x, w, s)
    ref = pim.int8_gemv_plain(x, w, s)
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    assert float((out.float() - ref.float()).abs().max()) <= 2 ** -7 * float(ref.float().abs().max())

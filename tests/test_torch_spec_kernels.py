"""The speculative path's kernels as the CUDA chain runs them: K7, the int4
GEMV (`plan_int4_gemv`, its plain twin `int4_gemv_plain`), and K6's
split-prefix verify attention (`verify_splits`, the plain twin
`fused_decode_verify_split_plain`).  The planners at every path shape; the
twins against the plain versions and the JAX package (`_dot_one_tile`, the
int4 K1 / K3 steps and `fused_decode_verify`, Pallas in interpret mode) at
L=2, D=256, H=4, Tmax=256, K6's int4 branch (the verify over an int4
pack) too; then (on a card only) the CUDA kernels at the planner shapes,
two calls bit-equal."""

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.ops import fused_decode as pfd
from voice_tts_tpu_torch.utils.convert import flatten_params
from voice_tts_tpu_torch.utils.quantize import quantize_gpt_state

from test_torch_fused_decode import D, H, L, T_MAX, V, _close, _gpt_tree

try:
    import jax
    import jax.numpy as jnp

    from voice_tts_tpu.ops import fused_decode as jfd
    from voice_tts_tpu.utils.quantize import quantize_gpt_params
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

FLAGSHIP_D, FLAGSHIP_H = 1280, 20
# the bf16 kv rows: a sum in another order may flip one bf16 rounding, one
# ulp, which is at most 2^-7 of the largest magnitude
KV_TOL = 2 ** -7
# a layer's four int4 GEMVs of the chain at the flagship D 1280: (K, F)
GEMVS = {"qkv": (FLAGSHIP_D, 3 * FLAGSHIP_D), "proj": (FLAGSHIP_D, FLAGSHIP_D),
         "fc": (FLAGSHIP_D, 4 * FLAGSHIP_D), "fc2": (4 * FLAGSHIP_D, FLAGSHIP_D)}


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [128, 640])
@pytest.mark.parametrize("gemv", sorted(GEMVS))
def test_plan_int4_gemv_path_shapes(gemv, group):
    """Every GEMV of the chain at g128 and g640: every column owned, at
    least a block an SM, runs of 8 columns a block (more than one only on
    the LN GEMVs: qkv 3, fc 4), one unit a (run, contraction tile, group),
    and warps enough for the units in as few rounds as 16 warps allow,
    spread evenly, at least 4."""
    k, f = GEMVS[gemv]
    ln = gemv in ("qkv", "fc")
    plan = pfd.plan_int4_gemv(k, f, group, ln)
    assert plan.blocks * 8 * plan.col_blocks == f and plan.blocks >= pfd.SMS
    assert plan.col_blocks == {"qkv": 3, "fc": 4}.get(gemv, 1)
    assert plan.units == plan.col_blocks * (k // (2 * group))
    rounds = -(-plan.units // plan.warps)
    assert rounds == -(-plan.units // pfd.K7_MAX_WARPS)
    assert pfd.K7_MIN_WARPS <= plan.warps <= pfd.K7_MAX_WARPS
    assert plan.warps == pfd.K7_MIN_WARPS or plan.warps * rounds - plan.units < rounds
    if group == 128:
        assert (plan.warps, plan.units) == {"qkv": (15, 15), "proj": (5, 5),
                                            "fc": (10, 20), "fc2": (10, 20)}[gemv]


def test_plan_int4_gemv_tiny_widths():
    """The tiny engine's widths (D 64, g32; D 256, g16 at fc2): one run of
    8 columns a block where the grid is smaller than the card, every unit
    in as few rounds as 16 warps allow, at least 4 warps."""
    assert pfd.plan_int4_gemv(64, 192, 32, True) == pfd.Int4GemvPlan(4, 1, 24, 1)
    assert pfd.plan_int4_gemv(1024, 256, 16, False) == pfd.Int4GemvPlan(16, 1, 32, 32)


VERIFY_PLANS = [(0, 512), (1, 512), (31, 256), (77, 256), (96, 256), (252, 256),
                (300, 512), (320, 512), (508, 512), (1500, 1792), (1788, 1792),
                (4000, 4096)]


@pytest.mark.parametrize("heads", [4, 20])
@pytest.mark.parametrize("pos,t_max", VERIFY_PLANS)
def test_verify_splits_cover_the_prefix(pos, t_max, heads):
    """The splits cover the committed prefix [0, pos) and start inside it
    (none past pos, so none past Tmax), at least one (pos 0 still needs the
    block that combines the tail), widths a multiple of 32 in [32, 256],
    and the grid reaches VERIFY_MIN_BLOCKS unless the width is at a bound;
    the workspace holds every split's (o, m, l) of every row."""
    split_t, splits = pfd.verify_splits(pos, heads, t_max)
    assert split_t % 32 == 0
    assert pfd.VERIFY_MIN_SPLIT <= split_t <= pfd.VERIFY_MAX_SPLIT
    assert splits * split_t >= pos
    assert splits == 1 if pos == 0 else (splits - 1) * split_t < pos <= t_max
    if heads * splits < pfd.VERIFY_MIN_BLOCKS:
        assert split_t in (pfd.VERIFY_MIN_SPLIT, pfd.VERIFY_MAX_SPLIT) or pos == 0
    hd = FLAGSHIP_D // heads
    assert pfd.verify_workspace(heads, splits, 4, hd) == heads * splits * 4 * (hd + 2)


@pytest.mark.parametrize("pos,t_max,want", [(300, 512, (32, 10)), (1500, 1792, (96, 16))])
def test_verify_splits_fill_the_card_at_the_spec_slice(pos, t_max, want):
    """At the spec slice's positions the flagship's 20 heads launch more
    blocks than the card has SMs (200 and 320; the unsplit kernel launched
    80)."""
    assert pfd.verify_splits(pos, FLAGSHIP_H, t_max) == want
    assert FLAGSHIP_H * want[1] > pfd.SMS


# ---------------------------------------------------------------------------
# K7's plain twin
# ---------------------------------------------------------------------------

def _int4_operands(rng, rows, n_kt, group, f=D):
    """x (rows, n_kt * D) f32, nibbles (n_kt, F, D/2), group scales (n_kt,
    F, G) as `pack_gpt_int4` lays them out, and a bias."""
    x = (rng.standard_normal((rows, n_kt * D)) * 0.5).astype(np.float32)
    w = rng.integers(-128, 128, (n_kt, f, D // 2)).astype(np.int8)
    gs = (0.02 / 7 * (1 + 0.1 * np.abs(rng.standard_normal((n_kt, f, D // group))))
          ).astype(np.float32)
    b = (rng.standard_normal(f) * 0.02).astype(np.float32)
    return x, w, gs, b


@pytest.mark.parametrize("group", [64, 128], ids=["g64", "g128_half"])
@pytest.mark.parametrize("n_kt", [1, 4], ids=["one_tile", "fc2_four_tiles"])
@pytest.mark.parametrize("rows", [1, 3])
def test_int4_gemv_plain_matches_dot4_and_jax(rows, n_kt, group):
    """The K7 twin (group sums times their scales in group order, the tile
    sums added in tile order, then the bias) against `_dot4` tile by tile
    (bit-equal at one tile: the same operations) and against the JAX
    `_dot_one_tile` (default scheme) summed as the JAX kernel sums fc2 (the
    bias on the last tile): the same bf16 products, f32 sums in another
    order, 1e-5 of max|ref|."""
    rng = np.random.default_rng(rows * 10 + n_kt + group)
    x, w, gs, b = _int4_operands(rng, rows, n_kt, group)
    out = pfd.int4_gemv_plain(*(torch.from_numpy(a) for a in (x, w, gs, b)))
    tiles = [pfd._dot4(torch.from_numpy(x[:, kt * D:(kt + 1) * D]), torch.from_numpy(w[kt]),
                       torch.from_numpy(gs[kt]), torch.from_numpy(b) if kt == n_kt - 1 else 0.0)
             for kt in range(n_kt)]
    if n_kt == 1:
        assert torch.equal(out, tiles[0])
    _close(out, sum(tiles[1:], tiles[0]).numpy(), tol=1e-5)
    ref = None
    for kt in range(n_kt):
        part = jfd._dot_one_tile(
            jnp.asarray(x[:, kt * D:(kt + 1) * D]), jnp.asarray(w[kt].T),
            None, jnp.asarray(b if kt == n_kt - 1 else np.zeros_like(b))[None],
            jnp.asarray(gs[kt].T), D // group, False)
        ref = part if ref is None else ref + part
    _close(out, ref, tol=1e-5)


@pytest.mark.parametrize("form", ["ln", "ln_gelu", "residual"])
def test_int4_gemv_plain_prologue_and_epilogues(form):
    """The chain's forms of the twin: the LN prologue (qkv), LN then GELU
    (fc), the residual (proj, fc2), each against `_ln` / `_dot4` / GELU
    composed by hand (bit-equal: the same operations)."""
    rng = np.random.default_rng(len(form))
    x, w, gs, b = (torch.from_numpy(a) for a in _int4_operands(rng, 3, 1, 64))
    ln = (1 + 0.1 * torch.from_numpy(rng.standard_normal(D).astype(np.float32)),
          0.1 * torch.from_numpy(rng.standard_normal(D).astype(np.float32)))
    res = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32))
    if form == "residual":
        out = pfd.int4_gemv_plain(x, w, gs, b, res=res, epilogue=pfd._EPI_RESIDUAL)
        ref = res + pfd._dot4(x, w[0], gs[0], b)
    else:
        epi = pfd._EPI_GELU if form == "ln_gelu" else pfd._EPI_NONE
        out = pfd.int4_gemv_plain(x, w, gs, b, ln=ln, epilogue=epi)
        ref = pfd._dot4(pfd._ln(x, *ln), w[0], gs[0], b)
        if epi == pfd._EPI_GELU:
            ref = torch.nn.functional.gelu(ref, approximate="tanh")
    assert torch.equal(out, ref)


def test_int4_gemv_wrapper_takes_the_twin_on_cpu():
    """`int4_gemv` on CPU tensors is the twin (the kernel needs a card)."""
    rng = np.random.default_rng(7)
    args = [torch.from_numpy(a) for a in _int4_operands(rng, 2, 4, 64)]
    assert torch.equal(pfd.int4_gemv(*args), pfd.int4_gemv_plain(*args))


@pytest.fixture(scope="module")
def int4_packs():
    """JAX and port int4 packs (g64: two groups a half at D 256) with the
    int8 readout, from the same f32 tree; the JAX pair is None without JAX."""
    tree = _gpt_tree(3)
    state = flatten_params(tree)
    jpack = jro = None
    if jax is not None:
        jtree = jax.tree.map(jnp.asarray, tree)
        jpack = jfd.pack_gpt_int4(jtree, L, group=64)
        jro = jfd.pack_readout(quantize_gpt_params(jtree))
    return (jpack, jro, pfd.pack_gpt_int4(state, L, group=64),
            pfd.pack_readout(quantize_gpt_state(state)))


@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16_kv", "int8_kv"])
def test_int4_k1_step_in_kernel_order_matches_jax(int4_packs, int8_kv):
    """The int4 K1 step summed as the CUDA chain sums it (the K7 twin's fc2,
    the split-prefix attention) against the plain step and JAX's
    `fused_decode_step` with the int4 pack in interpret mode: hidden and
    logits within 1e-3 of max|ref|, kv_new too (int8 KV: f32 rows) or
    within KV_TOL (bf16 rows), the same argmax."""
    jpack, jro, ppack, pro = int4_packs
    rng = np.random.default_rng(11)
    pos = 90
    cache = (rng.standard_normal((L, 2, 1, T_MAX, D)) * 0.5).astype(np.float32)
    bias = np.zeros((T_MAX, 1), np.float32)
    bias[20:26] = -1e30
    x = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
    pcache, psc = torch.from_numpy(cache).to(torch.bfloat16), None
    jcache, jsc = jnp.asarray(cache, jnp.bfloat16), None
    if int8_kv:
        pcache, psc = pfd.quantize_kv_cache(pcache)
        jcache, jsc = jax.jit(jfd.quantize_kv_cache)(jcache)
    psc_b = None if psc is None else psc.reshape(L, 1, T_MAX, 2)
    args = (torch.from_numpy(x), ppack, pcache, torch.from_numpy(bias).reshape(1, T_MAX),
            pos, H)
    twin = pfd.fused_decode_step_batch_split_plain(*args, kv_scales=psc_b, readout_pack=pro)
    plain = pfd.fused_decode_step_batch_plain(*args, kv_scales=psc_b, readout_pack=pro)
    jout = jfd.fused_decode_step(jnp.asarray(x), jpack, jcache, jnp.asarray(bias), pos, H,
                                 interpret=True, kv_scales=jsc, readout_pack=jro)
    _close(twin[0], jout[0])
    _close(twin[1][:, :, 0], jout[1], tol=KV_TOL if not int8_kv else 1e-3)
    _close(twin[2][:, :V], np.asarray(jout[2])[:, :V])
    for a, p, tol in zip(twin, plain, (1e-3, KV_TOL if not int8_kv else 1e-3, 1e-3)):
        _close(a, p.float().numpy(), tol=tol)
    assert int(twin[2][0, :V].argmax()) == int(np.asarray(jout[2])[0, :V].argmax())


def test_int4_k3_step_in_kernel_order_matches_jax(int4_packs):
    """The int4 K3 step at B = 3 through an ancestor table, in the chain's
    order, against JAX's `fused_decode_step_batch` in interpret mode
    (tolerances as the K1 step's)."""
    jpack, jro, ppack, pro = int4_packs
    rng = np.random.default_rng(12)
    b, pos = 3, 130
    cache = (rng.standard_normal((L, 2, b, T_MAX, D)) * 0.5).astype(np.float32)
    bias = np.zeros((b, T_MAX), np.float32)
    bias[:, 20:26] = -1e30
    x = (rng.standard_normal((b, D)) * 0.5).astype(np.float32)
    src = rng.integers(0, b, (b, T_MAX)).astype(np.int32)
    out = pfd.fused_decode_step_batch_split_plain(
        torch.from_numpy(x), ppack, torch.from_numpy(cache).to(torch.bfloat16),
        torch.from_numpy(bias), pos, H, beam_src=torch.from_numpy(src), readout_pack=pro)
    jout = jfd.fused_decode_step_batch(
        jnp.asarray(x), jpack, jnp.asarray(cache, jnp.bfloat16), jnp.asarray(bias), pos, H,
        interpret=True, beam_src=jnp.asarray(src), readout_pack=jro)
    _close(out[0], jout[0])
    _close(out[1], jout[1], tol=KV_TOL)
    _close(out[2][:, :V], jout[2][:, :V])
    np.testing.assert_array_equal(out[2][:, :V].argmax(-1).numpy(),
                                  np.asarray(jout[2])[:, :V].argmax(-1))


# ---------------------------------------------------------------------------
# K6's split verify twin
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_packs():
    """JAX and port int8 trunk packs of one f32 tree (None for JAX without it)."""
    tree = _gpt_tree(5)
    jpack = None
    if jax is not None:
        jpack = jfd.pack_gpt(quantize_gpt_params(jax.tree.map(jnp.asarray, tree)), L)
    return jpack, pfd.pack_gpt(quantize_gpt_state(flatten_params(tree)), L)


# name: (K, pos, the span under -1e30); Tmax 256, H 4: splits of 32
VERIFY_CASES = {
    "pos77_three_splits": (4, 77, (20, 26)),
    "empty_prefix": (4, 0, (20, 26)),
    "prefix_on_a_split_edge": (4, 96, (20, 26)),
    "k2": (2, 77, (20, 26)),
    "k8": (8, 77, (20, 26)),
    "pos_plus_k_is_tmax": (4, T_MAX - 4, (20, 26)),
    "split_under_the_bias": (4, 77, (32, 64)),
}


def _verify_case(name):
    kk, pos, (lo, hi) = VERIFY_CASES[name]
    rng = np.random.default_rng(sorted(VERIFY_CASES).index(name) + 40)
    cache = (rng.standard_normal((L, 2, 1, T_MAX, D)) * 0.5).astype(np.float32)
    bias = np.zeros((T_MAX, 1), np.float32)
    bias[lo:hi] = -1e30
    x = (rng.standard_normal((kk, D)) * 0.5).astype(np.float32)
    return x, cache, bias, pos


@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_split_verify_matches_plain_and_jax(int8_packs, name):
    """The verify with the CUDA attention's arithmetic (the prefix in the
    splits of `verify_splits`, each row's split partials combined in split
    order, then its causal tail) against the plain verify and JAX's
    `fused_decode_verify` in interpret mode: hidden rows within 1e-3 of
    max|ref|, the bf16 kv rows within KV_TOL, finite (an empty prefix and a
    split wholly under the -1e30 bias included)."""
    jpack, ppack = int8_packs
    x, cache, bias, pos = _verify_case(name)
    split_t, splits = pfd.verify_splits(pos, H, T_MAX)
    assert split_t == 32 and splits == max(1, -(-pos // 32))
    args = (torch.from_numpy(x), ppack, torch.from_numpy(cache).to(torch.bfloat16),
            torch.from_numpy(bias), pos, H)
    twin = pfd.fused_decode_verify_split_plain(*args)
    plain = pfd.fused_decode_verify_plain(*args)
    assert all(bool(torch.isfinite(t.float()).all()) for t in twin)
    _close(twin[0], plain[0].numpy())
    _close(twin[1], plain[1].float().numpy(), tol=KV_TOL)
    jy, jkv = jfd.fused_decode_verify(jnp.asarray(x), jpack, jnp.asarray(cache, jnp.bfloat16),
                                      jnp.asarray(bias), pos, H, interpret=True)
    _close(twin[0], jy)
    _close(twin[1], jkv, tol=KV_TOL)


def test_int4_verify_matches_jax(int4_packs):
    """K6's int4 branch: the verify of K = 4 tokens over an int4 pack (g64)
    at pos 77, summed as the CUDA chain sums it (the split prefix, K7's fc2
    order) and plainly, against JAX's `fused_decode_verify` with
    `pack_gpt_int4`'s pack in interpret mode: hidden rows within 1e-3 of
    max|ref|, the bf16 kv rows within KV_TOL; the wrapper on CPU tensors is
    the plain version."""
    jpack, _, ppack, _ = int4_packs
    x, cache, bias, pos = _verify_case("pos77_three_splits")
    args = (torch.from_numpy(x), ppack, torch.from_numpy(cache).to(torch.bfloat16),
            torch.from_numpy(bias), pos, H)
    twin = pfd.fused_decode_verify_split_plain(*args)
    plain = pfd.fused_decode_verify(*args)
    for a, b in zip(plain, pfd.fused_decode_verify_plain(*args)):
        assert torch.equal(a, b)
    _close(twin[0], plain[0].numpy())
    _close(twin[1], plain[1].float().numpy(), tol=KV_TOL)
    jy, jkv = jfd.fused_decode_verify(jnp.asarray(x), jpack, jnp.asarray(cache, jnp.bfloat16),
                                      jnp.asarray(bias), pos, H, interpret=True)
    for out in (twin, plain):
        _close(out[0], jy)
        _close(out[1], jkv, tol=KV_TOL)


def test_split_attention_tail_is_causal():
    """`_split_attention` with a K-token tail against one softmax over the
    prefix and the tokens each row may see, at split widths that cut inside
    a split and at its edge; a row whose prefix is empty attends its tail."""
    g = torch.Generator().manual_seed(8)
    kk, p, h, hd = 4, 100, 2, 8
    qh, kt, vt = (torch.randn(kk, h, hd, generator=g) for _ in range(3))
    k, v = torch.randn(p, h, hd, generator=g), torch.randn(p, h, hd, generator=g)
    mask = torch.zeros(kk, p)
    mask[:, 32:64] = -1e30
    mask[3] = float("-inf")
    causal = torch.ones(kk, kk, dtype=torch.bool).tril()
    s_tail = torch.where(causal[:, None], torch.einsum("jhd,ihd->jhi", qh, kt),
                         torch.tensor(float("-inf")))
    s_pre = torch.einsum("jhd,thd->jht", qh, k) + mask[:, None, :]
    probs = torch.softmax(torch.cat([s_pre, s_tail], -1), -1)
    ref = (torch.einsum("jht,thd->jhd", probs[..., :p], v)
           + torch.einsum("jhi,ihd->jhd", probs[..., p:], vt))
    v_tail = vt.transpose(0, 1)[None].expand(kk, -1, -1, -1)
    for split_t in (16, 32, 256):
        out = pfd._split_attention(qh, k[None].expand(kk, -1, -1, -1),
                                   v[None].expand(kk, -1, -1, -1), mask, s_tail, v_tail,
                                   split_t)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the kernels, on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 8, 12])
@pytest.mark.parametrize("gemv", sorted(GEMVS))
def test_int4_gemv_kernel_at_planner_shapes_on_card(cuda_device, gemv, rows):
    """K7 at the flagship GEMV shapes in the chain's form (the LN prologue
    on qkv and fc, GELU on fc, the residual on proj and fc2; fc2 as four
    contraction tiles, g128) against its twin on the same card inputs (f32
    sums in another order: 1e-4 of max|ref|; behind the LN, whose
    statistics in another order flip single bf16 roundings, 1e-3), two
    calls bit-equal."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(rows)
    k, f = GEMVS[gemv]
    ln = gemv in ("qkv", "fc")
    n_kt = k // FLAGSHIP_D
    w = torch.randint(-128, 128, (n_kt, f, FLAGSHIP_D // 2), generator=g, device=dev,
                      dtype=torch.int8)
    gs = 0.02 / 7 * (1 + torch.rand(n_kt, f, FLAGSHIP_D // 128, generator=g, device=dev))
    x = torch.randn(rows, k, generator=g, device=dev) * 0.5
    bias = torch.randn(f, generator=g, device=dev) * 0.02
    lnp = ((1 + 0.05 * torch.randn(k, generator=g, device=dev)),
           0.02 * torch.randn(k, generator=g, device=dev)) if ln else None
    res = torch.randn(rows, f, generator=g, device=dev)
    epi = {"qkv": pfd._EPI_NONE, "fc": pfd._EPI_GELU}.get(gemv, pfd._EPI_RESIDUAL)
    out = pfd.int4_gemv(x, w, gs, bias, lnp, res, epi)
    again = pfd.int4_gemv(x, w, gs, bias, lnp, res, epi)
    ref = pfd.int4_gemv_plain(x, w, gs, bias, lnp, res, epi)
    assert torch.equal(out, again)
    tol = 1e-3 if ln else 1e-4
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_kernel_matches_plain_on_card(int8_packs, cuda_device, name):
    """K6's chain (split verify attention, PDL GEMVs) on every verify case
    against the plain verify on the same card inputs (tolerances as on the
    CPU), finite, two calls bit-equal."""
    _, ppack = int8_packs
    dev = cuda_device
    x, cache, bias, pos = _verify_case(name)
    args = (torch.from_numpy(x).to(dev), pfd.FusedDecodePack(*(t.to(dev) for t in ppack)),
            torch.from_numpy(cache).to(dev, torch.bfloat16), torch.from_numpy(bias).to(dev),
            pos, H)
    out, again = pfd.fused_decode_verify(*args), pfd.fused_decode_verify(*args)
    ref = pfd.fused_decode_verify_plain(*args)
    for a, a2, r, tol in zip(out, again, ref, (1e-3, KV_TOL)):
        assert torch.isfinite(a.float()).all() and torch.equal(a, a2)
        assert float((a.float() - r.float()).abs().max()) <= tol * float(r.float().abs().max())


@pytest.mark.cuda
def test_int4_verify_kernel_matches_plain_on_card(int4_packs, cuda_device):
    """K6 over the int4 pack on the card (K7's loader in the verify chain)
    against the split plain verify on the same inputs (tolerances as on the
    CPU), finite, two calls bit-equal, counted as an int4 verify."""
    from voice_tts_tpu_torch.ops.counters import LAUNCHES

    _, _, ppack, _ = int4_packs
    dev = cuda_device
    x, cache, bias, pos = _verify_case("pos77_three_splits")
    args = (torch.from_numpy(x).to(dev), pfd.FusedDecodePackInt4(*(t.to(dev) for t in ppack)),
            torch.from_numpy(cache).to(dev, torch.bfloat16), torch.from_numpy(bias).to(dev),
            pos, H)
    before = {k: LAUNCHES[k] for k in ("fused_decode_verify", "fused_decode_int4")}
    out, again = pfd.fused_decode_verify(*args), pfd.fused_decode_verify(*args)
    assert all(LAUNCHES[k] == n + 2 for k, n in before.items())
    ref = pfd.fused_decode_verify_split_plain(*args)
    for a, a2, r, tol in zip(out, again, ref, (1e-3, KV_TOL)):
        assert torch.isfinite(a.float()).all() and torch.equal(a, a2)
        assert float((a.float() - r.float()).abs().max()) <= tol * float(r.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("pos,t_max", [(300, 512), (1500, 1792)])
def test_verify_kernel_at_flagship_splits_on_card(cuda_device, pos, t_max):
    """K6 at the flagship widths (two random int8 layers, D 1280, 20 heads)
    at the spec slice's positions, on the planner's flagship grid, against
    the plain verify, two calls bit-equal.  Hidden rows within 1e-2 of
    max|ref|: at 1280-wide int8 products f32 sums in another order flip
    single bf16 roundings of the activations (`chip_smoke.py`'s DECODE_TOL,
    the same reason); kv rows within KV_TOL."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(pos)
    n_l, d = 2, FLAGSHIP_D
    consts = torch.zeros((n_l, 28, d), device=dev)
    consts[:, 0:12] = 0.02 * 3 / 127
    consts[:, 12:20] = torch.randn(n_l, 8, d, generator=g, device=dev) * 0.02
    consts[:, 23] = torch.randn(n_l, d, generator=g, device=dev) * 0.02
    consts[:, 24] = consts[:, 26] = 1.0
    pack = pfd.FusedDecodePack(torch.randint(-127, 128, (n_l, 12, d, d), generator=g,
                                             device=dev, dtype=torch.int8), consts)
    cache = torch.randn(n_l, 2, 1, t_max, d, generator=g, device=dev).to(torch.bfloat16)
    bias = torch.zeros((t_max, 1), device=dev)
    bias[70:82] = -1e30
    x = torch.randn(4, d, generator=g, device=dev) * 0.5
    out = pfd.fused_decode_verify(x, pack, cache, bias, pos, FLAGSHIP_H)
    again = pfd.fused_decode_verify(x, pack, cache, bias, pos, FLAGSHIP_H)
    ref = pfd.fused_decode_verify_plain(x, pack, cache, bias, pos, FLAGSHIP_H)
    for a, a2, r, tol in zip(out, again, ref, (1e-2, KV_TOL)):
        assert torch.equal(a, a2)
        err, scale = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
        assert err <= tol * scale, (err, scale)

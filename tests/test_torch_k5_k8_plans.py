"""The redesigned K5 (`ops/decode_attention.py`) and K8 (`ops/dit_blocks.py`)
kernels' planning and decomposition on the CPU: K5's split planner
(`plan_decode_splits`) and K8's GEMM tile planner (`plan_dit_gemm`) at
every path shape and at tiny widths; K5's split decomposition
(`decode_attention_split_plain`: each split's (o, m, l), combined in split
order) against the plain K5 and against the JAX kernel in interpret mode,
at every split width the planner can choose and at the kernel's edges.
Inputs come from numpy with a seed.  The `cuda` cases hold both kernels
against their plain versions on the card, two calls bit-equal."""

import math

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import DiTConfig, WaveNetConfig
from voice_tts_tpu_torch.models.layers import init_weights
from voice_tts_tpu_torch.models.s2mel.dit import DiT
from voice_tts_tpu_torch.ops import decode_attention as k5
from voice_tts_tpu_torch.ops import dit_blocks as k8

try:
    import jax.numpy as jnp

    from voice_tts_tpu.ops.decode_attention import \
        decode_attention as jax_decode_attention
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jnp = None

HEADS = 20              # the GPT's 20 heads of 64
# (B, length) the flagged decode paths give K5: the K5 slice (one beam,
# prompt and text ~85 positions plus up to 256 codes), the K5 beam request
# (beam-3, up to the 512-code cap), and chip_smoke's two timed shapes
PATH_SHAPES = [(1, 1), (1, 86), (1, 200), (1, 343), (3, 86), (3, 300), (3, 600),
               (3, 1571), (1, 2048), (3, 2048)]
# f32: the same arithmetic, sums in another order and over other splits (the
# JAX package's own tolerance for its kernel)
F32_ATOL, F32_RTOL = 2e-5, 1e-4
# bf16 inputs keep f32 sums; the output rounds to bf16, so one flipped
# rounding is one ulp, up to 2^-7 of the largest magnitude
BF16_TOL = 2 ** -7
WIDTHS = [32, 64, 128, 256, 512]
# K5's edges: (B, Tmax, length, each row's -1e30 positions [lo, hi) or
# None): lengths 1, 31, 32, 33 around the 32-position split, a split wholly
# under the bias, length = Tmax, one position past a split boundary at B
# 3, and a row whose whole live prefix is masked (the uniform average)
EDGES = [(1, 512, 1, [None]), (1, 512, 31, [None]), (1, 512, 32, [(8, 9)]),
         (1, 512, 33, [None]), (1, 512, 100, [(32, 64)]), (1, 512, 512, [(40, 52)]),
         (3, 1024, 513, [(40, 52), None, (256, 512)]),
         (3, 512, 40, [(0, 64), (3, 5), None])]


def t(x):
    return torch.from_numpy(np.asarray(x))


def edge_inputs(seed, b, t_max, masked, h=4, hd=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, h, hd, t_max)).astype(np.float32)
    v = rng.standard_normal((b, h, hd, t_max)).astype(np.float32)
    bias = np.zeros((b, t_max), np.float32)
    for i, span in enumerate(masked):
        if span is not None:
            bias[i, span[0]:span[1]] = -1e30
    return q, k, v, bias


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,length", PATH_SHAPES)
def test_plan_decode_splits_covers_the_live_prefix(b, length):
    """A power-of-two width in 32..512 (a multiple of 32), splits that
    cover [0, length) and reach no position past it, at most MAX_BLOCKS
    blocks unless the width is at its cap, and no narrower width that
    would keep within MAX_BLOCKS."""
    width, splits = k5.plan_decode_splits(b, HEADS, length)
    assert width in WIDTHS and width % 32 == 0
    assert (splits - 1) * width < length <= splits * width
    blocks = b * HEADS * splits
    assert blocks <= k5.MAX_BLOCKS or width == k5.SPLIT_MAX
    if width > k5.SPLIT_MIN:
        assert b * HEADS * math.ceil(length / (width // 2)) > k5.MAX_BLOCKS


def test_plan_decode_splits_at_the_timed_shapes_and_tiny_widths():
    assert k5.plan_decode_splits(1, HEADS, 343) == (32, 11)     # 220 blocks
    assert k5.plan_decode_splits(3, HEADS, 1571) == (256, 7)    # 420 blocks
    assert k5.plan_decode_splits(3, HEADS, 513) == (128, 5)     # 300 blocks
    assert k5.plan_decode_splits(2, 4, 5) == (32, 1)
    assert k5.plan_decode_splits(2, 4, 1023) == (32, 32)        # 256 blocks
    assert k5.plan_decode_splits(64, HEADS, 4096) == (512, 8)   # past the cap


@pytest.mark.parametrize("t_len", [704, 768])
def test_plan_dit_gemm_fills_the_card_at_the_dit_slice(t_len):
    """At the DiT slice's frames (T 704, and the fused trunk's cap 768),
    B 2, D 512, every GEMM launches at least 132 blocks: QKV and W1 | W3
    128 x 128 (two warpgroups), Wo and W2 64 x 64."""
    shapes = k8.dit_gemm_shapes(2, t_len, 512)
    tiles = {name: k8.plan_dit_gemm(*s) for name, s in shapes.items()}
    assert {n: (p.bm, p.bn) for n, p in tiles.items()} == {
        "qkv": (128, 128), "wo": (64, 64), "w13": (128, 128), "w2": (64, 64)}
    for name, (m, n, k) in shapes.items():
        p = tiles[name]
        assert p.blocks == math.ceil(m / p.bm) * (n // p.bn) >= k8.GEMM_MIN_BLOCKS
        assert n % p.bn == 0 and k % 64 == 0
    assert tiles["qkv"].blocks == (132 if t_len == 704 else 144)


@pytest.mark.parametrize("b,t_len,d", [(2, 150, 256), (2, 130, 512), (1, 64, 256),
                                       (2, 1408, 256)])
def test_plan_dit_gemm_at_small_and_tiny_widths(b, t_len, d):
    """Below 132 blocks at 128 x 128 every GEMM takes 64 x 64; the tile
    divides N; the big tile where it fills the card."""
    for m, n, k in k8.dit_gemm_shapes(b, t_len, d).values():
        p = k8.plan_dit_gemm(m, n, k)
        big = math.ceil(m / 128) * (n // 128)
        assert (p.bm, p.bn) == ((128, 128) if big >= k8.GEMM_MIN_BLOCKS else (64, 64))
        assert n % p.bn == 0


def test_plan_dit_gemm_refuses_ragged_widths():
    with pytest.raises(ValueError):
        k8.plan_dit_gemm(128, 96, 512)
    with pytest.raises(ValueError):
        k8.plan_dit_gemm(128, 512, 100)


# ---------------------------------------------------------------------------
# K5's split decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("edge", EDGES, ids=lambda e: f"B{e[0]}-T{e[1]}-L{e[2]}")
def test_split_plain_matches_plain(edge, width):
    """Every width the planner can choose, at every edge: the splits'
    (o, m, l) combined in split order give the plain K5's output."""
    b, t_max, length, masked = edge
    q, k, v, bias = (t(a) for a in edge_inputs(0, b, t_max, masked))
    ref = k5.decode_attention_plain(q, k, v, bias, length)
    out = k5.decode_attention_split_plain(q, k, v, bias, length, width)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("edge", EDGES, ids=lambda e: f"B{e[0]}-T{e[1]}-L{e[2]}")
def test_split_plain_matches_plain_bf16(edge):
    """bf16 caches at the planner's own width: within one bf16 ulp."""
    b, t_max, length, masked = edge
    q, k, v, bias = (t(a) for a in edge_inputs(1, b, t_max, masked))
    q, k, v = (a.to(torch.bfloat16) for a in (q, k, v))
    width, _ = k5.plan_decode_splits(b, q.shape[1], length)
    ref = k5.decode_attention_plain(q, k, v, bias, length).float()
    out = k5.decode_attention_split_plain(q, k, v, bias, length, width)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())


@pytest.mark.parametrize("length,width", [(5, 32), (343, 32), (549, 64), (1023, 128),
                                          (512, 256), (1024, 512)])
def test_split_plain_matches_jax_kernel(length, width):
    """The decomposition against the JAX kernel in interpret mode (as
    tests/test_torch_decode_attention.py holds the plain K5)."""
    q, k, v, bias = edge_inputs(2, 2, 1024, [(0, 3), None])
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.asarray(length, jnp.int32), interpret=True))
    out = k5.decode_attention_split_plain(t(q), t(k), t(v), t(bias), length, width)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL, rtol=F32_RTOL)


def test_split_plain_matches_jax_kernel_at_edges():
    """A split wholly under the bias and a fully masked row, at the
    planner's width, against the JAX kernel in interpret mode."""
    for b, t_max, length, masked in (EDGES[4], EDGES[7]):
        q, k, v, bias = edge_inputs(3, b, t_max, masked)
        ref = np.asarray(jax_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
            jnp.asarray(length, jnp.int32), interpret=True))
        width, _ = k5.plan_decode_splits(b, q.shape[1], length)
        out = k5.decode_attention_split_plain(t(q), t(k), t(v), t(bias), length, width)
        np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL, rtol=F32_RTOL)


def test_cpu_tensors_take_the_plain_version():
    """K5 on CPU tensors is the plain version, whatever the planner says."""
    q, k, v, bias = (t(a) for a in edge_inputs(4, 3, 1024, [None] * 3))
    assert torch.equal(k5.decode_attention(q, k, v, bias, 600),
                       k5.decode_attention_plain(q, k, v, bias, 600))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("edge", EDGES + [(1, 512, 343, [(40, 52)]),
                                          (3, 2048, 1571, [(40, 52)] * 3)],
                         ids=lambda e: f"B{e[0]}-T{e[1]}-L{e[2]}")
def test_k5_kernel_at_edges_on_card(cuda_device, dtype, edge):
    """K5 at 20 heads against the plain version and its own split twin,
    two calls bit-equal."""
    b, t_max, length, masked = edge
    q, k, v, bias = (t(a).to(cuda_device)
                     for a in edge_inputs(5, b, t_max, masked, h=HEADS))
    q, k, v = (a.to(dtype) for a in (q, k, v))
    out = k5.decode_attention(q, k, v, bias, length)
    again = k5.decode_attention(q, k, v, bias, length)
    torch.cuda.synchronize()
    ref = k5.decode_attention_plain(q, k, v, bias, length).float()
    width, _ = k5.plan_decode_splits(b, HEADS, length)
    twin = k5.decode_attention_split_plain(q, k, v, bias, length, width).float()
    tol = (1e-5 if dtype == torch.float32 else BF16_TOL) * float(ref.abs().max())
    assert torch.equal(out, again)
    assert float((out.float() - ref).abs().max()) <= tol
    assert float((out.float() - twin).abs().max()) <= tol


@pytest.mark.cuda
def test_k5_kernel_refuses_unaligned_caches_on_card(cuda_device):
    """The caches are read in 16-byte vectors: a Tmax off that grid raises."""
    q = torch.zeros(1, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 64, 36, device=cuda_device, dtype=torch.bfloat16)
    bias = torch.zeros(1, 36, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        k5.decode_attention(q, kv, kv, bias, 20)


@pytest.mark.cuda
@pytest.mark.parametrize("t_len,lens", [(704, (650, 300)), (130, (1, 77))])
def test_k8_kernel_at_flagship_width_on_card(cuda_device, t_len, lens):
    """K8 at D 512, 8 heads, 2 blocks: T 704 runs the 128 x 128 and 64 x 64
    GEMM tiles, T 130 a ragged last tile with one valid key in row 0;
    against the plain version on each row's valid positions (chip_smoke's
    K8_TOL), two calls bit-equal."""
    cfg = DiTConfig(hidden_dim=512, depth=2, num_heads=8, in_channels=8, style_dim=12,
                    content_dim=16)
    with torch.device(cuda_device):
        dit = init_weights(DiT(cfg, WaveNetConfig(hidden_dim=32, num_layers=2,
                                                  kernel_size=3)),
                           torch.Generator(cuda_device).manual_seed(1)).eval()
    rng = np.random.default_rng(9)
    x = t(rng.standard_normal((2, t_len, 512)).astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        wb = k8.pack_dit_tables(dit, dit.step_tables(torch.tensor([0.5], device=cuda_device)))[0]
        pack = k8.pack_dit_blocks(dit)
    cos, sin = k8.rope_tables(t_len, 64, 10000.0, cuda_device)
    lens_t = torch.tensor(lens, device=cuda_device)
    out = k8.dit_block_chain(x, pack, wb, cos, sin, lens_t, 8)
    again = k8.dit_block_chain(x, pack, wb, cos, sin, lens_t, 8)
    torch.cuda.synchronize()
    ref = k8.dit_block_chain_ref(x, pack, wb, cos, sin, lens_t, 8)
    assert torch.equal(out, again)
    for i, n in enumerate(lens):
        err = float((out[i, :n] - ref[i, :n]).abs().max())
        assert err <= 2e-2 * float(ref[i, :n].abs().max()), (i, err)

"""The redesigned vocoder kernels' planning and packing on the CPU: K10's
launch planner (`plan_fused_stage`) at every flagship and tiny fused stage
shape and at the kernel's largest halo; its TF32 split (`tf32_round`) and
the split weight slabs (`kernel_pack`); K2's launch planner
(`plan_aa_snake`) at every activation shape of a 448- and a 2656-frame
vocode and at short and ragged rows; and both wrappers' refusals of a
wrong device, type or shape.  The `cuda` cases hold both kernels against
their plain versions on the card, two calls bit-equal, at K2's edge shapes
and at K10's stage shapes cut short."""

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.config import TTSConfig
from voice_tts_tpu_torch.engine.engine import tiny_config
from voice_tts_tpu_torch.ops import aa_activation as k2
from voice_tts_tpu_torch.ops import fused_vocoder as k10

SMEM_LIMIT = 232448      # the H100's shared memory a block (227 KB)
FLAGSHIP = TTSConfig().vocoder
TINY = tiny_config().vocoder
# K2's tolerance on the card (chip_smoke.py's K2_TOL): f32, a few ulp of
# max(1, max|ref|); K10's (K10_TOL): 1e-4 of max|ref|
K2_TOL, K10_TOL = 1e-5, 1e-4


def stage_shapes(cfg, frames: int):
    """(C, T) after each upsampling stage of `cfg` for `frames` mel frames."""
    shapes, t = [], frames
    for i, u in enumerate(cfg.upsample_rates):
        t *= u
        shapes.append((cfg.upsample_initial_channel // 2 ** (i + 1), t))
    return shapes


def fused_cases():
    """(C, T, k, d) of every pair launch of the fused stages: the flagship's
    at 448 and 2656 frames, the tiny vocoder's at 24 and 200."""
    cases = []
    for cfg, frames in ((FLAGSHIP, 448), (FLAGSHIP, 2656), (TINY, 24), (TINY, 200)):
        plan = k10.fused_stage_plan(cfg)
        for (c, t), fused in zip(stage_shapes(cfg, frames), plan):
            if fused:
                for k in cfg.resblock_kernel_sizes:
                    for d in sorted(set(cfg.resblock_dilation_sizes[0]) | {1}):
                        cases.append((c, t, k, d))
    return cases


FUSED_CASES = fused_cases()
# the largest halo: 15 taps at d 9 (63 samples a side) and 3 at d 64
HALO_CASES = [(c, t, k, d) for c in (8, 24, 48, 96, 192) for t in (1, 100, 700000)
              for k, d in ((15, 9), (3, 64))]


def test_fused_cases_cover_the_flagship_and_tiny_stages():
    shapes = {(c, t) for c, t, _, _ in FUSED_CASES}
    assert {(192, 14336), (96, 28672), (48, 57344), (24, 114688), (192, 84992),
            (24, 679936)} <= shapes
    assert {c for c, _ in shapes} == {192, 96, 48, 24, 16, 8}


@pytest.mark.parametrize("c,t,k,d", FUSED_CASES + HALO_CASES)
def test_plan_fused_stage_fits_and_tiles(c, t, k, d):
    p = k10.plan_fused_stage(c, t, k, d)
    halo = d * (k - 1) // 2
    assert p.threads == 256 and p.ci == 16 and p.stages == 3 and p.nt == 4
    # M: every output channel, in whole 16-row tiles over wm warp rows of mt
    # (an instantiated kernel: pair_kernel in csrc/fused_vocoder.cu), the
    # fewest that hold C; N: (8 / wm) warp columns of nt 8-sample tiles
    assert (p.wm, p.mt) in {(1, 1), (1, 2), (1, 3), (2, 2), (2, 3), (4, 2), (4, 3)}
    cp = k10.padded_channels(c)
    assert cp == 16 * p.wm * p.mt and c <= cp < c + 16 * p.wm
    assert p.bn == (8 // p.wm) * p.nt * 8
    rows = p.bn + -(-2 * halo // 4) * 4
    assert rows % 4 == 0 and rows >= p.bn + 2 * halo
    # x (16 channels of rows + 16) fits in Z's two planes, whose space it shares
    assert p.ci * (rows + 16) <= 2 * rows * 16
    # the two phase planes: 16 rows each of a stride of 4 mod 8 floats (the
    # down pass's 16-byte loads of 8 channels fall in distinct banks)
    phases = p.smem // 4 - (p.stages * 2 * cp * 16 + 2 * rows * 16)
    assert phases % 32 == 0 and (phases // 32) % 8 == 4 and phases // 32 >= rows + 8
    assert p.smem <= SMEM_LIMIT and p.smem % 16 == 0


def test_padded_channels_at_the_flagship_stages():
    """Only the C 24 stage computes padded channels (32: a third more MMA
    work at that stage); the others are whole tiles."""
    assert [k10.padded_channels(c) for c in (192, 96, 48, 24, 16, 8)] == [
        192, 96, 48, 32, 16, 16]


@pytest.mark.parametrize("c,t,k,d", [(12, 100, 3, 1), (200, 100, 3, 1), (24, 0, 3, 1),
                                     (24, 100, 4, 1), (24, 100, 17, 1), (24, 100, 3, 65),
                                     (24, 100, 15, 10), (24, 100, 3, 0)])
def test_plan_fused_stage_refuses(c, t, k, d):
    with pytest.raises(ValueError):
        k10.plan_fused_stage(c, t, k, d)


def test_tf32_round():
    one = 1.0
    v = torch.tensor([one, one + 2 ** -11, one + 2 ** -12, -(one + 2 ** -11), 3.0 + 2 ** -9,
                      0.0, -0.0, 2 ** -126], dtype=torch.float32)
    want = torch.tensor([one, one + 2 ** -10, one, -(one + 2 ** -10), 3.0 + 2 ** -9, 0.0, -0.0,
                         2 ** -126], dtype=torch.float32)
    assert torch.equal(k10.tf32_round(v), want)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi = k10.tf32_round(x)
    lo = k10.tf32_round(x - hi)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(x, dtype=torch.int32))
    assert torch.equal(lo.view(torch.int32) & 0x1FFF, torch.zeros_like(x, dtype=torch.int32))
    assert float(((x - hi).abs() / x.abs()).max()) <= 2 ** -11
    # hi + lo keeps 22 bits: the three-pass product drops lo.lo, about 2^-22
    assert float(((x.double() - hi.double() - lo.double()).abs() / x.abs()).max()) <= 2 ** -21


def test_kernel_pack_slabs_and_cache():
    rng = np.random.default_rng(1)
    n, k_max, c = 2, 3, 16
    w = torch.from_numpy(rng.standard_normal((n, k_max, c, c)).astype(np.float32))
    pack = k10.StagePack(w, torch.zeros(n, c, 1), torch.ones(n, c, 1), torch.ones(n, c, 1),
                         (3,))
    kp = k10.kernel_pack(pack)
    assert kp.w.shape == (n, k_max, c // 8, 1, 2, 32, 4) and kp.w.is_contiguous()
    hi = k10.tf32_round(w)
    lo = k10.tf32_round(w - hi)
    # lane (g, t)'s quad: (o, i) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    for p, tap, s, lane in ((0, 0, 0, 0), (1, 2, 1, 31), (0, 1, 1, 13), (1, 0, 0, 6)):
        g, t = lane // 4, lane % 4
        for q, (o, i) in enumerate(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
            assert kp.w[p, tap, s, 0, 0, lane, q] == hi[p, tap, o, 8 * s + i]
            assert kp.w[p, tap, s, 0, 1, lane, q] == lo[p, tap, o, 8 * s + i]
    # every hi and lo value once
    assert torch.equal(kp.w.flatten().sort().values,
                       torch.cat([hi.flatten(), lo.flatten()]).sort().values)
    # made once a pack, dropped with it
    assert k10.kernel_pack(pack) is kp
    other = k10.StagePack(w.clone(), pack.b, pack.alpha, pack.brec, (3,))
    assert k10.kernel_pack(other) is not kp
    key = id(other.w)
    assert key in k10._KERNEL_PACKS
    del other
    assert key not in k10._KERNEL_PACKS


VOCODE_SHAPES = sorted(set(stage_shapes(FLAGSHIP, 448) + stage_shapes(FLAGSHIP, 2656)))


@pytest.mark.parametrize("rows,t", [(c, t) for c, t in VOCODE_SHAPES]
                         + [(8, t) for t in (1, 3, 7, 13, 511, 512, 513, 2047, 2049, 6146,
                                             10001)] + [(2304, 1792), (65535, 5)])
def test_plan_aa_snake(rows, t):
    p = k2.plan_aa_snake(rows, t)
    assert p.tile in (512, 1024, 2048) and p.threads * 8 == p.tile
    assert p.threads % 32 == 0 and p.threads <= 256
    assert p.tiles == -(-t // p.tile) and (p.tiles - 1) * p.tile < t <= p.tiles * p.tile
    assert p.vec == (t % 4 == 0)
    # x (tile + 16), both phases (tile + 8): under the 48 KB a block takes
    # without an opt-in
    assert p.smem == 4 * (3 * p.tile + 32) <= 48 * 1024
    if t <= 512:
        assert p.tile == 512
    if t > 1024:
        assert p.tile == 2048


@pytest.mark.parametrize("rows,t", [(0, 5), (65536, 5), (8, 0)])
def test_plan_aa_snake_refuses(rows, t):
    with pytest.raises(ValueError):
        k2.plan_aa_snake(rows, t)


def _aa_inputs(c, t, dtype=torch.float32):
    return (torch.zeros(1, c, t, dtype=dtype), torch.ones(c, dtype=dtype),
            torch.ones(c, dtype=dtype))


def test_aa_snake_wrapper_refuses():
    x, a, br = _aa_inputs(4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        k2.aa_snake_cuda(x, a, br)
    with pytest.raises(TypeError):
        k2.aa_snake_cuda(*_aa_inputs(4, 16, torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        k2.aa_snake_cuda(x, torch.ones(5), br)
    with pytest.raises(ValueError, match="contiguous"):
        k2.aa_snake_cuda(torch.zeros(1, 16, 4).transpose(1, 2), a, br)
    with pytest.raises(ValueError):
        k2.aa_snake_cuda(x[0], a, br)
    with pytest.raises(ValueError):
        k2.aa_snake_cuda(torch.zeros(1, 4, 0), a, br)
    with pytest.raises(ValueError, match="device"):
        k2.aa_snake_activation(x.to("meta"), a.to("meta"), br.to("meta"))


def _tiny_pack(c=16, k=3, n_iter=2, dtype=torch.float32):
    n = 2 * n_iter
    return k10.StagePack(torch.zeros(n, k, c, c, dtype=dtype), torch.zeros(n, c, 1, dtype=dtype),
                         torch.ones(n, c, 1, dtype=dtype), torch.ones(n, c, 1, dtype=dtype), (k,))


def test_fused_stage_wrapper_refuses():
    x, dil = torch.zeros(1, 16, 64), (1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        k10.fused_resblock_stage_cuda(x, _tiny_pack(), dil)
    with pytest.raises(TypeError):
        k10.fused_resblock_stage_cuda(x.double(), _tiny_pack(dtype=torch.float64), dil)
    with pytest.raises(ValueError, match="contiguous"):
        k10.fused_resblock_stage_cuda(torch.zeros(1, 64, 16).transpose(1, 2), _tiny_pack(), dil)
    with pytest.raises(ValueError, match="convs in the pack"):
        k10.fused_resblock_stage_cuda(x, _tiny_pack(), (1, 3, 5))
    with pytest.raises(ValueError, match="no plan"):       # C not a multiple of 8
        k10.fused_resblock_stage_cuda(torch.zeros(1, 12, 64), _tiny_pack(c=12), dil)
    with pytest.raises(ValueError, match="no plan"):       # a halo over MAX_HALO
        k10.fused_resblock_stage_cuda(x, _tiny_pack(), (1, 65))
    with pytest.raises(ValueError):
        k10.fused_resblock_stage_cuda(x[0], _tiny_pack(), dil)
    with pytest.raises(ValueError, match="device"):
        k10.fused_resblock_stage(x.to("meta"), _tiny_pack(), dil)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 3, 5, 7, 13, 511, 513, 2047, 2049, 4097, 6146])
def test_aa_snake_kernel_edges_on_card(cuda_device, t):
    g = torch.Generator(cuda_device).manual_seed(t)
    x = torch.randn(2, 8, t, generator=g, device=cuda_device)
    a = torch.exp(0.3 * torch.randn(8, generator=g, device=cuda_device))
    br = 1.0 / (torch.exp(0.3 * torch.randn(8, generator=g, device=cuda_device)) + 1e-9)
    out, out2 = k2.aa_snake_cuda(x, a, br), k2.aa_snake_cuda(x, a, br)
    ref = k2.aa_snake_plain(x, a, br)
    assert torch.equal(out, out2)
    assert float((out - ref).abs().max()) <= K2_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("c,t", [(192, 1000), (96, 2100), (48, 3000), (24, 5000), (16, 70)])
def test_fused_stage_kernel_on_card(cuda_device, c, t, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator(cuda_device).manual_seed(c)
    n, k_max = 18, 11
    pack = k10.StagePack(0.02 * torch.randn(n, k_max, c, c, generator=g, device=cuda_device),
                         0.1 * torch.randn(n, c, 1, generator=g, device=cuda_device),
                         torch.exp(0.3 * torch.randn(n, c, 1, generator=g, device=cuda_device)),
                         torch.exp(0.3 * torch.randn(n, c, 1, generator=g, device=cuda_device)),
                         (3, 7, 11))
    x = 0.3 * torch.randn(1, c, t, generator=g, device=cuda_device)
    out = k10.fused_resblock_stage(x, pack, (1, 3, 5))
    out2 = k10.fused_resblock_stage(x, pack, (1, 3, 5))
    ref = k10.fused_resblock_stage_plain(x, pack, (1, 3, 5))
    assert torch.equal(out, out2)
    assert float((out - ref).abs().max()) <= K10_TOL * float(ref.abs().max())


def test_kernel_pack_pads_output_channels():
    """C 24 computes 32 output channels: the 8 padded rows' weights are 0."""
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 24, 24))
                         .astype(np.float32))
    pack = k10.StagePack(w, torch.zeros(2, 24, 1), torch.ones(2, 24, 1),
                         torch.ones(2, 24, 1), (3,))
    kp = k10.kernel_pack(pack).w
    assert kp.shape == (2, 3, 3, 2, 2, 32, 4)
    # tile 1 holds channels 16-31: rows g + 8 (quads 1 and 3) are 24-31
    assert torch.count_nonzero(kp[:, :, :, 1, :, :, 1::2]) == 0
    assert torch.count_nonzero(kp[:, :, :, 1, :, :, 0::2]) > 0

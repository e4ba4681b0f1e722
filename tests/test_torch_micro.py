"""K12 and K13, the port's tile-stream micro-benchmark kernels
(`voice_tts_tpu_torch/ops/micro_tile.py`, `ops/micro_int4.py`), against the
JAX scripts on the CPU: each script is loaded by path and its own
`make_kernel`, BlockSpecs and scratch run in the same `pl.pallas_call` as its
`run`, with `interpret=True`.  Inputs come from numpy with a seed.  The
shift and mask unpacks are held against numpy on all 256 bytes, and the
entry points' device handling and output lines are checked.  The `cuda`
cases hold the kernels against their plain versions on the card.

The script's `i8sh` and `xp8` do not trace under jax 0.9.0 (`lax.shift_left`
on int8 with a Python 4 raises a TypeError), so the port's `i8sh` is held
against the script's `cur` and `xp8` against `expand`: each pair computes
the same values, (b << 4) >> 4 on int8 being the signed low nibble."""

import importlib.util
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voice_tts_tpu_torch.ops import micro_int4 as mi
from voice_tts_tpu_torch.ops import micro_tile as mt
from voice_tts_tpu_torch.scripts import micro_int4 as micro_int4_script
from voice_tts_tpu_torch.scripts import micro_tile as micro_tile_script

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
except ImportError:     # the machine with the card has no JAX: the `cuda` cases run there
    jax = None

pytest_plugins = ("port_fixtures",)

REPO = Path(__file__).resolve().parents[1]


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return load_script("micro_tile"), load_script("micro_int4")


def jax_tile_call(script, x, w, mode):
    """One call of the K12 Pallas kernel, as the script's `run` builds it."""
    n_tiles, d, _ = w.shape
    return pl.pallas_call(
        script.make_kernel(mode), grid=(n_tiles,),
        in_specs=[pl.BlockSpec((8, d), lambda t: (0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, d, d), lambda t: (t, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, d), lambda t: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, d), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, d), jnp.float32)], interpret=True)(x, w)


def jax_int4_call(script, x, w, gs, mode, per_half):
    """One call of the K13 Pallas kernel, as the script's `run` builds it."""
    n_tiles, half, d = w.shape
    return pl.pallas_call(
        script.make_kernel(mode, d, per_half), grid=(n_tiles,),
        in_specs=[pl.BlockSpec((8, d), lambda t: (0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, half, d), lambda t: (t, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((2 * per_half, d), lambda t: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, d), lambda t: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, d), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, d), jnp.float32)], interpret=True)(x, w, gs)


def jax_run(call, x, iters):
    """The scripts' `run`: `iters` chained calls, x <- 0.5 x + 1e-6 out."""
    return jax.jit(lambda x: jax.lax.fori_loop(
        0, iters, lambda _, x: x * 0.5 + call(x) * 1e-6, x))(x)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------

def tile_inputs(d, n_tiles, mode, seed):
    """w (T, D, D) int8 in [-127, 127]; x (8, D) f32 normal, or for dot8i
    uniform in +-200 with values past the int8 range, where JAX's cast
    saturates and torch's `.to(int8)` would wrap."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (n_tiles, d, d), dtype=np.int8)
    if mode == "dot8i":
        x = rng.uniform(-200, 200, (8, d)).astype(np.float32)
        x[0, :4] = [128.5, -130.2, 300.5, -127.9]
    else:
        x = rng.standard_normal((8, d)).astype(np.float32)
    return x, w


def tile_tolerance(mode, ref):
    """dma / convert / dot8i: integer terms added in the kernel's order, the
    same order here: equal.  dot1 / dot8: the bf16 products' f32 sums run in
    another order than XLA's: relative 1e-6 of max|out|."""
    return 0.0 if mode in ("dma", "convert", "dot8i") else 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("d,n_tiles", [(256, 3), (1280, 2)])
@pytest.mark.parametrize("mode", mt.MODES)
def test_tile_plain_matches_jax_kernel(scripts, mode, d, n_tiles):
    x, w = tile_inputs(d, n_tiles, mode, seed=d + n_tiles)
    ref = np.asarray(jax_tile_call(scripts[0], jnp.asarray(x), jnp.asarray(w), mode))
    out = mt.micro_tile(t(x), t(w), mode).numpy()
    assert np.abs(out - ref).max() <= tile_tolerance(mode, ref)


@pytest.mark.parametrize("mode", mt.MODES)
def test_tile_run_matches_jax_run(scripts, mode):
    """Two chained calls with the outer update (the scripts' `run`); after
    the first the update's own f32 rounding is in both."""
    x, w = tile_inputs(256, 3, mode, seed=5)
    ref = np.asarray(jax_run(lambda x: jax_tile_call(scripts[0], x, jnp.asarray(w), mode),
                             jnp.asarray(x), 2))
    out = mt.run(t(x), t(w), mode, 2).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_saturating_int8_cast_matches_jax():
    """f32 -> int8 truncates toward zero, saturates and sends NaN to 0, as
    JAX's cast does (and torch's `.to(int8)` does not)."""
    v = np.array([128.5, -130.2, 300.5, np.nan, -0.7, 127.9, -128.9, -129.0,
                  np.inf, -np.inf, 5.5, -5.5], np.float32)
    ref = np.asarray(jax.jit(lambda a: a.astype(jnp.int8))(jnp.asarray(v)))
    np.testing.assert_array_equal(mt.saturate_int8(t(v)).numpy(), ref)
    assert not np.array_equal(t(v[:3]).to(torch.int8).numpy(), ref[:3])


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------

def int4_inputs(d, n_tiles, seed, gs_range=(500, 2500)):
    """w (T, D/2, D) int8; gs at U(500, 2500), where the tile term 1e-6 y
    is of the order of acc[0] (at the script's 1e-4..5e-4 it falls below
    acc[0]'s f32 resolution and a wrong y would pass); x bf16-exact."""
    rng = np.random.default_rng(seed)
    per_half = mi.per_half_for(d)
    w = rng.integers(-127, 128, (n_tiles, d // 2, d), dtype=np.int8)
    gs = rng.uniform(*gs_range, (2 * per_half, d)).astype(np.float32)
    x = t(rng.standard_normal((8, d)).astype(np.float32)).to(torch.bfloat16).float().numpy()
    return x, w, gs, per_half


# the script mode each port mode is held against (see the module docstring)
JAX_MODE = {"i8sh": "cur", "xp8": "expand"}


@pytest.mark.parametrize("d,n_tiles", [(512, 1), (512, 3), (1280, 1), (1280, 3)])
@pytest.mark.parametrize("mode", mi.MODES)
def test_int4_plain_matches_jax_kernel(scripts, mode, d, n_tiles):
    """Row 0 (the carried row) against the script's kernel at per_half 2 (D
    512) and 5 (D 1280, the `g2` scale-row quirk); rows 1-7 stay x; `dma`
    (raw bytes, no dot) equal.  One tile: relative 1e-5 (the dots' f32 sums
    in another order).  Three tiles: 1e-3, because the bf16 cast of a carried f32 row that differs in
    its last bit can round to a neighbouring bf16 value on the two sides
    (one bf16 step, 2^-8 relative, of one x0 element's terms)."""
    x, w, gs, per_half = int4_inputs(d, n_tiles, seed=d + n_tiles)
    ref = np.asarray(jax_int4_call(scripts[1], jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(gs), JAX_MODE.get(mode, mode), per_half))
    out = mi.micro_int4(t(x), t(w), t(gs), mode, per_half).numpy()
    np.testing.assert_array_equal(out[1:], x[1:])
    if mode == "dma":
        # raw bytes times 1e-6, the same f32 operations in the same order
        np.testing.assert_array_equal(out[0], ref[0])
        return
    # the tile term moves row 0 by about its own size: a wrong y shows
    assert np.abs(ref[0] - 0.5 ** n_tiles * x[0]).max() > 0.1 * np.abs(ref[0]).max()
    rtol = 1e-5 if n_tiles == 1 else 1e-3
    assert np.abs(out[0] - ref[0]).max() <= rtol * np.abs(ref[0]).max()


def test_int4_run_matches_jax_run(scripts):
    """Two chained calls with the outer update, `cur` at D 512, 2 tiles."""
    x, w, gs, per_half = int4_inputs(512, 2, seed=7)
    ref = np.asarray(jax_run(lambda x: jax_int4_call(
        scripts[1], x, jnp.asarray(w), jnp.asarray(gs), "cur", per_half),
        jnp.asarray(x), 2))
    out = mi.run(t(x), t(w), t(gs), "cur", 2, per_half).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("unpack", [mi.unpack_mask, mi.unpack_shift])
def test_unpacks_match_numpy_on_all_bytes(unpack):
    """Both unpacks give numpy's int8 shifts, (b << 4) >> 4 and b >> 4, on
    every byte value."""
    b = np.arange(-128, 128).astype(np.int8)
    lo, hi = unpack(t(b))
    np.testing.assert_array_equal(lo.numpy().astype(np.int8), (b << 4) >> 4)
    np.testing.assert_array_equal(hi.numpy().astype(np.int8), b >> 4)
    assert lo.min() == -8 and lo.max() == 7 and hi.min() == -8 and hi.max() == 7


@pytest.mark.parametrize("d", [256, 512, 1280])
def test_int4_exchange_plan(d):
    """K13's per-tile exchange (`exchange_plan`): block (cs, ks) reads the
    carried rows of its 64 packed rows, low and high, and the blocks of
    column slice 0 read every row once (they write row 0 out); each carried
    row is the sum of n_ks partials, one from each ks of the row's column
    slice, in ks order, each from a block that writes that column; a block
    waits for the one or two column slices its rows lie in, n_ks producers
    each; the kernel's ring of slabs (`kSlots`, read from the source) is
    as deep as the dependence needs."""
    plan = mi.exchange_plan(d)
    n_blocks = plan.n_cs * plan.n_ks
    assert (plan.n_cs, plan.n_ks) == (d // mi.COLS, d // 2 // mi.KSPLIT)
    assert sorted(r for b in range(0, n_blocks, plan.n_cs) for r in plan.reads[b]) \
        == list(range(d))
    for b, rows in enumerate(plan.reads):
        k0 = (b // plan.n_cs) * mi.KSPLIT
        assert rows == [*range(k0, k0 + mi.KSPLIT), *range(d // 2 + k0, d // 2 + k0 + mi.KSPLIT)]
        sources = {p for r in rows for p in plan.producers[r]}
        assert 1 <= len(plan.waits[b]) <= 2
        assert len(sources) == plan.n_ks * len(plan.waits[b])
        assert {p % plan.n_cs for p in sources} == set(plan.waits[b])
    for r, producers in enumerate(plan.producers):
        assert [p // plan.n_cs for p in producers] == list(range(plan.n_ks))
        assert all(p % plan.n_cs == r // mi.COLS for p in producers)
    src = (REPO / "voice_tts_tpu_torch" / "csrc" / "micro_int4.cu").read_text()
    assert int(re.search(r"constexpr int kSlots = (\d+);", src).group(1)) == mi.SLOTS
    assert plan.slots_needed == (2 if d == 256 else 3) <= mi.SLOTS


def exchange_hazards(plan, slots, tiles, pick):
    """Run the kernel's blocks as an interleaving of steps (block b writes
    tile t into slab t % slots; then, once every producer of its rows has
    written tile t, it reads them), `pick` choosing the next block among
    those that can step; count the partials a reader found overwritten."""
    n = plan.n_cs * plan.n_ks
    sources = [sorted({p for r in rows for p in plan.producers[r]}) for rows in plan.reads]
    held = [[-1] * n for _ in range(slots)]
    written, t, reading, hazards = [0] * n, [0] * n, [False] * n, 0
    while min(t) < tiles:
        ready = [b for b in range(n) if t[b] < tiles and (
            not reading[b] or all(written[p] > t[b] for p in sources[b]))]
        b = pick(ready, t, reading)
        if not reading[b]:
            held[t[b] % slots][b] = t[b]
            written[b] += 1
        else:
            hazards += sum(held[t[b] % slots][p] != t[b] for p in sources[b])
            t[b] += 1
        reading[b] = not reading[b]
    return hazards


@pytest.mark.parametrize("d", [256, 512, 1280])
def test_int4_exchange_ring_never_overwrites_unread_partials(d):
    """No interleaving of the blocks overwrites a partial before every
    reader has read it with the kernel's ring: the block furthest ahead
    always stepping first (the most skew the waits allow), and a random
    order.  One slab fewer than `slots_needed` does overwrite."""
    plan = mi.exchange_plan(d)
    ahead = lambda ready, t, reading: max(ready, key=lambda b: (t[b], reading[b], -b))
    rnd = random.Random(d)
    shuffled = lambda ready, t, reading: rnd.choice(ready)
    assert exchange_hazards(plan, mi.SLOTS, 6, ahead) == 0
    assert exchange_hazards(plan, mi.SLOTS, 6, shuffled) == 0
    assert exchange_hazards(plan, plan.slots_needed - 1, 6, ahead) > 0


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

LINE = re.compile(r"^(\w+)\s*:\s+(\S+) ms/pass\s+(\S+) us/tile\s+(\S+) GB/s\s+"
                  r"events (\S+) ms/pass\s+bound (\S+) ms\s+\[(.+)\]$")


@pytest.mark.parametrize("script,modes", [
    (micro_tile_script, mt.MODES), (micro_int4_script, mi.MODES)])
def test_entry_point_cpu_lines(script, modes, capsys):
    """With `--device cpu` each entry point runs the plain versions and
    prints one parseable line a mode, with the bound of its shapes."""
    results = script.main(["--device", "cpu", "--dim", "256", "--tiles", "4",
                           "--lo", "1", "--hi", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [r["mode"] for r in results] == list(modes)
    assert len(lines) == len(modes)
    nbytes = 4 * 256 * 256 // (2 if script is micro_int4_script else 1)
    for mode, line in zip(modes, lines):
        m = LINE.match(line)
        assert m, line
        assert m.group(1) == mode and m.group(5) == "n/a"
        assert m.group(7) == "cpu, plain versions"
        assert float(m.group(6)) == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-3)
        float(m.group(2))


def test_int4_entry_point_modes(capsys):
    results = micro_int4_script.main(["--device", "cpu", "--dim", "256", "--tiles", "2",
                                      "--lo", "1", "--hi", "2", "--modes", "dma,xp8"])
    assert [r["mode"] for r in results] == ["dma", "xp8"]
    with pytest.raises(SystemExit):
        micro_int4_script.main(["--device", "cpu", "--modes", "dma,nope"])


@pytest.mark.parametrize("module", ["micro_tile", "micro_int4"])
def test_entry_point_refuses_without_cuda(module):
    """Without a card the default `--device cuda` exits at once, non-zero,
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", f"voice_tts_tpu_torch.scripts.{module}"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "ms/pass" not in out.stdout


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_tiles", [(256, 9), (256, 1), (256, 3), (256, 5),
                                       (512, 1), (512, 3), (512, 5)])
@pytest.mark.parametrize("mode", mt.MODES)
def test_tile_kernel_matches_plain_on_card(cuda_device, mode, d, n_tiles):
    """2 and 4 column slices; 1-9 tiles (a last group of 1-4 tiles): the
    kernel's partials sum in another order than the plain tile-by-tile
    adds."""
    x, w = (t(a).to(cuda_device) for a in tile_inputs(d, n_tiles, mode, seed=3))
    out = mt.micro_tile(x, w, mode)
    torch.cuda.synchronize()
    ref = mt.micro_tile_plain(x, w, mode)
    scale = float(ref.abs().max())
    tol = 9 * 2 ** -23 if mode in ("dma", "convert", "dot8i") else 1e-5
    assert float((out - ref).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_tiles", [(512, 3), (512, 1), (512, 2), (512, 16), (512, 288),
                                       (1280, 1), (1280, 2), (1280, 3), (1280, 16), (1280, 288)])
@pytest.mark.parametrize("mode", mi.MODES)
def test_int4_kernel_matches_plain_on_card(cuda_device, mode, d, n_tiles):
    """End to end up to 3 tiles (relative 1e-3, as in the tests against
    JAX).  Then, at scales that keep the carried row's size over a whole
    pass (`carry_gs_range`), the last tile against one plain tile from the
    kernel's own row after n - 1 tiles: relative 1e-5, the dots' f32 sums
    in another order, for every tile's exchange and the ring of slabs."""
    on_card = lambda a: t(a).to(cuda_device) if isinstance(a, np.ndarray) else a
    x, w, gs, per_half = map(on_card, int4_inputs(d, n_tiles, seed=4))
    out = mi.micro_int4(x, w, gs, mode, per_half)
    torch.cuda.synchronize()
    ref = mi.micro_int4_plain(x, w, gs, mode, per_half)
    assert torch.equal(out[1:], ref[1:])
    if n_tiles <= 3:
        tol = 0.0 if mode == "dma" else 1e-3
        assert float((out[0] - ref[0]).abs().max()) <= tol * float(ref[0].abs().max())
    rng = np.random.default_rng(5)
    gs = on_card(rng.uniform(*micro_int4_script.carry_gs_range(d), tuple(gs.shape))
                 .astype(np.float32))
    row = mi.micro_int4(x, w[:n_tiles - 1], gs, mode, per_half) if n_tiles > 1 else x
    out = mi.micro_int4(x, w, gs, mode, per_half)
    torch.cuda.synchronize()
    step = mi.micro_int4_plain(row, w[n_tiles - 1:], gs, mode, per_half)
    assert torch.equal(out[1:], step[1:])
    tol = 0.0 if mode == "dma" else 1e-5
    assert float((out[0] - step[0]).abs().max()) <= tol * float(step[0].abs().max())

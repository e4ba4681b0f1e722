"""Micro-benchmark K13: the per-tile cost of each int4 unpack and dot
strategy of the decode weights, a row carried from tile to tile (288 packed
(D/2, D) tiles at D 1280, 236 MB; `voice_tts_tpu_torch/ops/micro_int4.py`):
`dma` (the stream floor), `cur`, `i8sh`, `g2`, `dense`, `expand`, `xp8`.
The port of `scripts/micro_int4.py`, with its arguments; prints one line a
mode.

    python -m voice_tts_tpu_torch.scripts.micro_int4 [--dim 1280 --tiles 288
        --lo 20 --hi 60 --modes dma,cur,...] [--device cuda]

`--device cpu` runs the plain versions (a small --dim and --tiles there).
"""

from __future__ import annotations

import argparse

import torch

from voice_tts_tpu_torch.ops import micro_int4 as mi
from voice_tts_tpu_torch.scripts import stream_bench


def make_inputs(d: int, tiles: int, dev: torch.device, gs_range=(1e-4, 5e-4)):
    """w (tiles, d/2, d) int8 in [-127, 127] (seed 0), x (8, d) f32 normal
    (seed 1), gs (2 per_half, d) f32 uniform in `gs_range` (seed 2), made on
    the device; and per_half."""
    per_half = mi.per_half_for(d)
    g = torch.Generator(device=dev)
    w = torch.randint(-127, 128, (tiles, d // 2, d), generator=g.manual_seed(0),
                      dtype=torch.int8, device=dev)
    x = torch.randn((mi.ROWS, d), generator=g.manual_seed(1), device=dev)
    lo, hi = gs_range
    gs = torch.rand((2 * per_half, d), generator=g.manual_seed(2), device=dev) * (hi - lo) + lo
    return x, w, gs, per_half


def carry_gs_range(d: int) -> tuple:
    """Scales U(-b, b) at which the carried row keeps its size over a whole
    pass: acc[0] <- 0.5 acc[0] + 1e-6 y, y's rms sqrt(D E[nib^2] E[s^2])
    times x's (E[nib^2] = 21.5 for bytes uniform in [-127, 127], E[s^2] =
    b^2 / 3), so 0.25 + 1e-12 D 21.5 b^2 / 3 = 1; zero-mean scales, since
    the nibbles' mean (-0.5) times positive scales is a common mode that
    grows from tile to tile.  At the defaults' 1e-4..5e-4 (and at 500..2500)
    the row halves each tile and is zero long before tile 288."""
    b = (0.75e12 * 3 / (21.5 * d)) ** 0.5
    return -b, b


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=1280)
    ap.add_argument("--tiles", type=int, default=288)
    ap.add_argument("--lo", type=int, default=20)
    ap.add_argument("--hi", type=int, default=60)
    ap.add_argument("--modes", default=",".join(mi.MODES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel; the default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in mi.MODES]
    if unknown:
        ap.error(f"unknown modes {unknown}; choose from {','.join(mi.MODES)}")
    dev = stream_bench.pick_device(args.device)
    x, w, gs, per_half = make_inputs(args.dim, args.tiles, dev)
    label = stream_bench.device_label(dev)
    results = []
    for mode in modes:
        r = stream_bench.measure(
            lambda x, iters, mode=mode: mi.run(x, w, gs, mode, iters, per_half),
            x, args.lo, args.hi, w.numel(), args.tiles, dev)
        print(stream_bench.format_line(mode, r, label), flush=True)
        results.append({"mode": mode, **r})
    return results


if __name__ == "__main__":
    main()

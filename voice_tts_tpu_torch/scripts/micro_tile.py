"""Micro-benchmark K12: the per-tile cost of streaming a decode step's int8
weights (288 (D, D) tiles at D 1280, 472 MB) with each compute stage: none
(`dma`), the bf16 convert, a bf16 product from 1 or 8 rows, an int8 product
(`voice_tts_tpu_torch/ops/micro_tile.py`).  The port of
`scripts/micro_tile.py`, with its arguments; prints one line a mode.

    python -m voice_tts_tpu_torch.scripts.micro_tile [--dim 1280 --tiles 288
        --lo 20 --hi 60] [--device cuda]

`--device cpu` runs the plain versions (a small --dim and --tiles there).
"""

from __future__ import annotations

import argparse

import torch

from voice_tts_tpu_torch.ops import micro_tile as mt
from voice_tts_tpu_torch.scripts import stream_bench


def make_inputs(d: int, tiles: int, dev: torch.device):
    """w (tiles, d, d) int8 in [-127, 127] (seed 0), x (8, d) f32 normal
    (seed 1), made on the device."""
    g = torch.Generator(device=dev)
    w = torch.randint(-127, 128, (tiles, d, d), generator=g.manual_seed(0),
                      dtype=torch.int8, device=dev)
    x = torch.randn((mt.ROWS, d), generator=g.manual_seed(1), device=dev)
    return x, w


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=1280)
    ap.add_argument("--tiles", type=int, default=288)
    ap.add_argument("--lo", type=int, default=20)
    ap.add_argument("--hi", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel; the default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    dev = stream_bench.pick_device(args.device)
    x, w = make_inputs(args.dim, args.tiles, dev)
    label = stream_bench.device_label(dev)
    results = []
    for mode in mt.MODES:
        r = stream_bench.measure(
            lambda x, iters, mode=mode: mt.run(x, w, mode, iters), x, args.lo,
            args.hi, w.numel(), args.tiles, dev)
        print(stream_bench.format_line(mode, r, label), flush=True)
        results.append({"mode": mode, **r})
    return results


if __name__ == "__main__":
    main()

"""Timing shared by the tile-stream micro-benchmarks (`micro_tile`,
`micro_int4`), as the JAX scripts time: a pass is
(t(hi) - t(lo)) / (hi - lo) over two runs of `hi` and `lo` chained passes,
each run after a warm-up and ended by a host read of the sum, which cancels
the dispatch overhead; CUDA events around the `hi` run give a second figure.
GB/s counts the weight bytes of a pass; the bound is those bytes over the
H100's 3.35 TB/s."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def pick_device(name: str) -> torch.device:
    """The device to run on; asking for CUDA without one exits at once (the
    benchmark times the kernels: there is no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this benchmark times the GPU "
                         "kernels (--device cpu runs their plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"unsupported device {dev}")
    return dev


def device_label(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu, plain versions"


def timed(run: Callable, x: torch.Tensor, iters: int,
          dev: torch.device) -> tuple[float, Optional[float]]:
    """Host seconds of `run(x + 1, iters)` after a warm-up `run(x, iters)`,
    each ended by a host read of the sum; and the CUDA-event ms of the timed
    run (None on the CPU)."""
    float(run(x, iters).sum())
    events = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    if events:
        events[0].record()
    total = run(x + 1.0, iters).sum()
    if events:
        events[1].record()
        torch.cuda.synchronize(dev)
    float(total)
    seconds = time.perf_counter() - t0
    return seconds, events[0].elapsed_time(events[1]) if events else None


def measure(run: Callable, x: torch.Tensor, lo: int, hi: int, n_bytes: int,
            n_tiles: int, dev: torch.device) -> dict:
    """One mode's time a pass, per tile, GB/s, event time a pass and bound."""
    t_lo, _ = timed(run, x, lo, dev)
    t_hi, event_ms = timed(run, x, hi, dev)
    dt = (t_hi - t_lo) / (hi - lo)
    return {"ms": dt * 1e3, "us_per_tile": dt / n_tiles * 1e6,
            "gb_per_s": n_bytes / dt / 1e9 if dt > 0 else float("nan"),
            "event_ms": event_ms / hi if event_ms is not None else None,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bytes": n_bytes}


def format_line(mode: str, r: dict, label: str) -> str:
    """The JAX scripts' line (ms a pass, us a tile, GB/s) plus the event
    time and the bound, and the device."""
    events = f"{r['event_ms']:.3f}" if r["event_ms"] is not None else "n/a"
    return (f"{mode:8s}: {r['ms']:7.3f} ms/pass  {r['us_per_tile']:6.2f} us/tile  "
            f"{r['gb_per_s']:6.1f} GB/s  events {events} ms/pass  "
            f"bound {r['bound_ms']:.4g} ms  [{label}]")

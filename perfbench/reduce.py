"""Reductions the per-layer readers (`metrics/<name>.py`) share.

A reader's `ctx` holds the traced part of a `--trace 1` run's window
(all of it, or the engine calls begun in the mix's first `trace_seconds`):

- "config": the engine configuration as run; "mix": the traffic mix;
- "window": {"start", "end", "seconds"} on `time.monotonic()`, the trace's
  span;
- "requests": the load generator's records of the requests those calls
  served ("id", "due" (open loops), "sent", "done", "ok", "text", "voice",
  "text_len", "cold", "audio_s");
- "calls": the traced engine calls ("start", "end", "n", "texts",
  "metrics": the engine's `last_metrics` after the call, "launches": its
  K1 / K3 decode runs, see `cell.launches_of`);
- "batch_sizes": the traced calls' group sizes;
- "graphs_delta": graphs the device loops captured in the whole window;
- "launches": the kernels' launch counters over the whole window;
- "device": the reduced device trace (`trace.read`);
- "card": the card's name and power limit; "prompt_frames",
  "prompt_seconds": the prompts' mel frames and seconds.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from perfbench import costs


def audio_s(ctx: Dict) -> float:
    return sum(r["audio_s"] for r in ctx["requests"])


def k_bound_s(ctx: Dict, kernels=("K1", "K3")) -> float:
    """The least time of the calls' K1 / K3 launches (`costs`)."""
    cfg = ctx["config"]
    return sum(costs.decode_bound_s(cfg, d["rows"], d["requests"], d["start"], d["steps"],
                                    d["kv_int8"], d["table"])
               for c in ctx["calls"] for d in c["launches"] if d["kernel"] in kernels)


def roofline_pct(ctx: Dict, kernels) -> Optional[float]:
    dev = ctx["device"]
    bound = k_bound_s(ctx, kernels)
    if dev is None or bound <= 0 or dev["groups"]["decode_chain"] <= 0:
        return None
    return 100.0 * bound / dev["groups"]["decode_chain"]


def flops(ctx: Dict) -> float:
    """Model FLOPs of the window's finished requests (`costs`)."""
    cfg = ctx["config"]
    hop, sr = cfg["mel"]["hop_size"], cfg["mel"]["sample_rate"]
    total = 0.0
    for r in ctx["requests"]:
        if not r["ok"]:
            continue
        frames = round(r["audio_s"] * sr / hop)
        codes = int(frames / cfg["s2mel"]["mel_scale_factor"]) + 1
        while int(codes * cfg["s2mel"]["mel_scale_factor"]) > frames:
            codes -= 1
        total += sum(costs.request_flops(cfg, r["text_len"], codes, ctx["prompt_frames"],
                                         ctx["prompt_seconds"], r["cold"]).values())
    return total


def idle_pct(ctx: Dict) -> Optional[float]:
    dev = ctx["device"]
    if dev is None or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def group_mean(ctx: Dict) -> Optional[float]:
    b = ctx["batch_sizes"]
    return statistics.fmean(b) if b else None


def call_of(ctx: Dict) -> Dict[str, Dict]:
    """The engine call that served each text."""
    return {t: c for c in ctx["calls"] for t in c["texts"]}

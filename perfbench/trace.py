"""The device trace of a `--trace 1` run: kineto (CUPTI) over the window's
engine calls, or a closed loop's calls begun in the mix's first
`trace_seconds` (`service.py` starts and stops it between calls), reduced
to the device's busy time (the union of the spans of every
kernel, copy and fill: under programmatic dependent launch neighbouring
kernels overlap, so their summed time overcounts), the union of the spans
of named kernel groups, the kernels' summed times by name, and the idle
gaps labelled by the benchmark's spans around the engine calls and their
stages (`service.py`, on `time.monotonic()`, which the trace's clock is
matched to when the profiler starts) that the host was in.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Tuple

# kernel groups whose union of spans a metric reads
GROUPS = {"decode_chain": re.compile(r"dq_gemv_kernel|attend_split_kernel")}
OUTSIDE = "between engine calls (HTTP, queue, gather window)"
SHORT = "gaps under 20 us (launch and dependency stalls)"
SHORT_NS = 20_000


class Profiler:
    """Kineto (CUPTI) over the card's activity, or off the card the host's
    (which has no device events: a rehearsal's), started and stopped
    through `torch.autograd`'s own enable / disable, which hand back the
    raw events: `torch.profiler.profile.stop` may first turn millions of
    kernel spans into Python objects, which outlasts a run's limit."""

    def __init__(self, cuda: bool = True):
        import torch
        from torch.autograd import profiler as autograd_profiler

        spec = autograd_profiler.profile(use_device="cuda" if cuda else None,
                                         use_kineto=True, use_cpu=not cuda)
        try:
            self.config = spec.config(create_trace_id=False)
        except TypeError:                   # the signature of older torch
            self.config = spec.config()
        self.activities = spec.kineto_activities
        self.results = None
        torch.autograd._prepare_profiler(self.config, self.activities)
        torch.autograd._enable_profiler(self.config, self.activities)
        self.offset_ns = time.time_ns() - time.monotonic_ns()

    def stop(self) -> None:
        import torch

        self.results = torch.autograd._disable_profiler()


def start(cuda: bool = True) -> Profiler:
    return Profiler(cuda)


def _union(spans: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, merged intervals) of sorted spans."""
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def read(prof, start_mono: float, end_mono: float, spans: List[tuple]) -> Dict:
    """The window [start_mono, end_mono] (`time.monotonic()`) of a stopped
    profiler; `spans` (name, start, end on the same clock) label the idle
    gaps (see `reduce_events`)."""
    from torch.autograd import DeviceType

    off = prof.offset_ns
    events = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
              for ev in prof.results.events()
              if ev.device_type() == DeviceType.CUDA]
    return reduce_events(events, int(start_mono * 1e9) + off, int(end_mono * 1e9) + off,
                         [(n, int(a * 1e9) + off, int(b * 1e9) + off) for n, a, b in spans])


def reduce_events(events: List[tuple], w0: int, w1: int, spans: List[tuple]) -> Dict:
    """Device events (start ns, end ns, name) clipped to the window [w0, w1]:
    busy seconds (their union), each group's union, each name's summed
    seconds, and the idle gaps' seconds by the shortest span (name, start
    ns, end ns) around each gap's middle (gaps under 20 us lumped)."""
    dev = sorted((max(s, w0), min(e, w1), n) for s, e, n in events if e > w0 and s < w1)
    busy, merged = _union([(s, e) for s, e, _ in dev])
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    groups = {g: _union([(s, e) for s, e, n in dev if rx.search(n)])[0] / 1e9
              for g, rx in GROUPS.items()}
    gaps, prev = [], w0
    for s, e in merged + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    labels = sorted(((a, b, n) for n, a, b in spans), key=lambda x: x[1] - x[0])
    idle: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        lab = SHORT if e - s < SHORT_NS else next(
            (n for a, b, n in labels if a <= mid <= b), OUTSIDE)
        idle[lab] = idle.get(lab, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9, "groups": groups,
            "kernel_s": by_name, "events": len(dev),
            "breakdown": {"device_ops": [[n[:200], v] for n, v in top],
                          "idle_gaps": [[n, v] for n, v in
                                        sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}}

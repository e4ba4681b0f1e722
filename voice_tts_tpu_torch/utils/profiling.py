"""Profiling / tracing hooks (`voice_tts_tpu/utils/profiling.py`).

The engine reproduces the reference's stage timers (manual perf_counter
spans and RTF logging); this module adds the device layer: a
`torch.profiler` trace around any code region, exported as a Chrome trace
(chrome://tracing, Perfetto), with named regions that show on the host
timeline and, as NVTX ranges, to CUDA tools.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host and, where there is one, CUDA activity) and
    write `<log_dir>/trace.json`, a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a captured trace (and an NVTX range on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StageTimers:
    """Accumulating wall-clock spans with the reference's field names."""

    def __init__(self):
        self.values: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.values[name] = self.values.get(name, 0.0) + (
                time.perf_counter() - t0)

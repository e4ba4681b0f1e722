"""Median wall seconds of the window's engine calls (the benchmark's span
around the service's call into the engine)."""

import statistics


def read(ctx):
    walls = [c["end"] - c["start"] for c in ctx["calls"]]
    return statistics.median(walls) if walls else None

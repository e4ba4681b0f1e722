"""Median seconds from a request's due time to the start of the engine call
that served it: the service's queue and gather window, and the HTTP and
hex work before it."""

import statistics

from perfbench import reduce


def read(ctx):
    calls = reduce.call_of(ctx)
    waits = [calls[r["text"]]["start"] - (r["due"] if r["due"] is not None else r["sent"])
             for r in ctx["requests"] if r["ok"] and r["text"] in calls]
    return statistics.median(waits) if waits else None

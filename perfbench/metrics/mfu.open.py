"""Model FLOPs of the window's finished requests over the summed seconds of
the engine calls at the card's bf16 dense peak, in percent (in an open
loop the offered rate sets the window, so the engine's busy time is the
base)."""

from perfbench import costs, reduce


def read(ctx):
    busy = sum(c["end"] - c["start"] for c in ctx["calls"])
    return 100.0 * reduce.flops(ctx) / (busy * costs.MFU_PEAK) if busy > 0 else None

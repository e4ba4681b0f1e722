"""Model FLOPs of the window's finished requests (`costs.request_flops`)
over the window's seconds at the card's bf16 dense peak, in percent."""

from perfbench import costs, reduce


def read(ctx):
    w = ctx["window"]["seconds"]
    return 100.0 * reduce.flops(ctx) / (w * costs.MFU_PEAK) if w > 0 else None

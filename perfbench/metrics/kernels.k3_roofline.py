"""K3's share of its roofline, in percent: the least time of the window's K3
launches (`costs.decode_launch` at each launch's rows, position, KV dtype
and table) over the union of the spans of K3's kernels in the trace."""

from perfbench import reduce


def read(ctx):
    return reduce.roofline_pct(ctx, ("K3",))

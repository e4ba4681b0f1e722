"""The decode kernels' (K1 and K3) share of their roofline, in percent, as
`kernels.k3_roofline` counts it, over both kernels' launches."""

from perfbench import reduce


def read(ctx):
    return reduce.roofline_pct(ctx, ("K1", "K3"))

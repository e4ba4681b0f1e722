"""Percent of the window in which no kernel, copy or fill ran on the card
(the union of their spans in the device trace)."""

from perfbench import reduce


def read(ctx):
    return reduce.idle_pct(ctx)

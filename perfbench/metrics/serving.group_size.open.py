"""Mean requests an engine call (`TTSService.batch_sizes` of the window)."""

from perfbench import reduce


def read(ctx):
    return reduce.group_mean(ctx)

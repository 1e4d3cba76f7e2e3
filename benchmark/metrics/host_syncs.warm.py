"""Host syncs a stage-0 warm-up step, in and outside the spans."""

from benchmark.runners.train_warm import reading


def read(ctx):
    return reading(ctx, "host_syncs")

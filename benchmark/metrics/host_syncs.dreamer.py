"""Host syncs a dreamer unit (its loss step and ``maintain``), in and outside
the spans."""

from benchmark.runners.dreamer_step import reading


def read(ctx):
    return reading(ctx, "host_syncs")

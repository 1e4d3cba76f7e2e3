"""Device ms of one ``soar.densify``: a ``maintain`` that densifies, the
re-skinning of every slot included."""

from benchmark.runners.dreamer_step import reading


def read(ctx):
    return reading(ctx, "densify_ms")

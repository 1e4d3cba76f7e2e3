"""Device ms a dreamer step inside ``soar.field``: the four views' attribute-field
queries, which nothing reads (``use_explicit``), forward and backward."""

from benchmark.runners.dreamer_step import reading


def read(ctx):
    return reading(ctx, "field_ms")

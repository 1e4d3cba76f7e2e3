"""A turntable view's useful work against the H100's float32 peak, over
the traced views' time: (the field query, the skinning and the composite's
operations) / float32 peak / seconds a view."""

from benchmark.trace import mfu


def read(ctx):
    return mfu(ctx, "view")

"""The forward composite kernel's share of its roofline over one traced
turntable view: the summed least time of the view's launches over the
kernel's device time in it."""

from benchmark.trace import roofline


def read(ctx):
    return roofline(ctx, "view", "composite_fwd")

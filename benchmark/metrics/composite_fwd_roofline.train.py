"""The forward composite kernel's share of its roofline over one traced
training step: the summed least time of the launches recorded in the step
over the kernel's device time in it."""

from benchmark.trace import roofline


def read(ctx):
    return roofline(ctx, "step", "composite_fwd")

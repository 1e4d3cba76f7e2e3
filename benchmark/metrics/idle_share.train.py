"""Share of the traced window of training steps in which no kernel ran on
the device: 1 - (the union of the kernels' intervals / the window)."""

from benchmark.trace import idle_share


def read(ctx):
    return idle_share(ctx, "step")

"""Share of the traced window of stage-0 warm-up steps (no guidance) in
which no kernel ran on the device: 1 - (the union of the kernels' intervals
/ the window)."""

from benchmark.trace import idle_share


def read(ctx):
    return idle_share(ctx, "step")

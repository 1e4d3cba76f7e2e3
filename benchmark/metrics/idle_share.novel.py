"""Share of the traced window of novel-pose views in which no kernel ran on
the device: 1 - (the union of the kernels' intervals / the window)."""

from benchmark.runners.novel_pose import live
from benchmark.trace import idle_share


def read(ctx):
    return idle_share(ctx, "view") if live(ctx) else None

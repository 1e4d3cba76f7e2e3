"""Aten ops the host dispatches for one replayed novel-pose view (the
frame's parameters sliced and copied in, the graphs' replays, the
composites' launches and the images' copies to the host)."""

from benchmark.runners.novel_pose import live


def read(ctx):
    return float(ctx["aten_ops"]) if live(ctx) else None

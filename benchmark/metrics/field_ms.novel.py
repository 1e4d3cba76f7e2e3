"""Device ms a novel-pose view inside ``soar.field``: the attribute field's
query at every surfel (its two hash encodes and the heads), which a view
repeats although its answer does not depend on the pose."""

from benchmark.runners.novel_pose import reading


def read(ctx):
    return reading(ctx, "soar.field")

"""Device ms a novel-pose view inside ``soar.pose`` and the spans under it
(``soar.pose.lbs``, ``soar.pose.skin``), the field's query left out: the
55-joint LBS, the [N, 55] skinning blend and the surfel frames."""

from benchmark.runners.novel_pose import reading


def read(ctx):
    return reading(ctx, "soar.pose", prefix=True)

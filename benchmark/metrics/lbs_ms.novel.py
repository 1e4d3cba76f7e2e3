"""Device ms a novel-pose view inside ``soar.pose.lbs``: ``smplx_forward``'s
blend shapes (10 betas, 10 expressions, 486 pose directions), the 54-step
kinematic chain and the joints' affines."""

from benchmark.runners.novel_pose import reading


def read(ctx):
    return reading(ctx, "soar.pose.lbs")

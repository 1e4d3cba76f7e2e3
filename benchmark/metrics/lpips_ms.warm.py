"""Device ms a stage-0 warm-up step inside ``soar.lpips``: the bf16 VGG16
over the front and back normal passes' LPIPS terms, forward and the
backward mapped to it."""

from benchmark.runners.train_warm import reading


def read(ctx):
    return reading(ctx, "lpips_ms")

"""Device ms a dreamer step inside ``soar.guidance``: the MVDream UNet's CFG
forward and the VAE encoder's forward, and the backward mapped to them."""

from benchmark.runners.dreamer_step import reading


def read(ctx):
    return reading(ctx, "guidance_ms")

"""The training step's useful work against the H100's peaks, over the
traced steps' time: (bf16 FLOPs / bf16 peak + float32 FLOPs and composite
operations / float32 peak) / seconds a step."""

from benchmark.trace import mfu


def read(ctx):
    return mfu(ctx, "step")

"""Aten ops the host dispatches for one training step."""


def read(ctx):
    return float(ctx["aten_ops"]) if ctx.get("unit") == "step" else None

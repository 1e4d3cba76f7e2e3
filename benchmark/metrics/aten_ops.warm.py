"""Aten ops the host dispatches for one stage-0 warm-up step (no
guidance)."""


def read(ctx):
    return float(ctx["aten_ops"]) if ctx.get("unit") == "step" else None

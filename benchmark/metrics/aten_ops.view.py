"""Aten ops the host dispatches for one turntable view (render and the
images' copies to the host)."""


def read(ctx):
    return float(ctx["aten_ops"]) if ctx.get("unit") == "view" else None

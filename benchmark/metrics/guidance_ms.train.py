"""Device ms a training step of the kernels launched inside the
benchmark's ranges around the UNet's forward and the VAE encoder's forward
and backward (module hooks; device time, not a span)."""


def read(ctx):
    if ctx.get("unit") != "step" or not ctx.get("range_device_s_per_unit"):
        return None
    return 1e3 * ctx["range_device_s_per_unit"]

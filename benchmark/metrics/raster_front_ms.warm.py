"""Device ms a stage-0 warm-up step inside the raster front end
(``soar.raster.preprocess``, ``.sort`` and ``.gather``) of the step's six
renders (four gen views, the GT pass, the normal pass), forward and the
backward mapped to them."""

from benchmark.runners.train_warm import reading


def read(ctx):
    return reading(ctx, "raster_front_ms")

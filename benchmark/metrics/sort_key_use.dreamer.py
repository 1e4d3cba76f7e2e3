"""100 x the sorted keys that land in a tile over the keys sorted
(``raster.keys_in_tiles`` / ``raster.keys``), over a dreamer step's 8 passes."""

from benchmark.runners.dreamer_step import reading


def read(ctx):
    return reading(ctx, "sort_key_use")

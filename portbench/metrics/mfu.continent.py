"""Useful FLOPs per second of the window's passes over the configuration's
peak, in %: `generator_tile_flops` of each 1000^2 tile's kept output."""

from portbench.readers import generator_mfu_pct


def read(ctx):
    return generator_mfu_pct(ctx, "continent_tiles_per_s", ctx["cell"].traffic["tile_out"])

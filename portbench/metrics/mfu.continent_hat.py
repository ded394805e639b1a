"""Useful FLOPs per second of the window's passes over the configuration's
peak, in %: `counts.hat.hat_tile_flops` of each 1000^2 tile's kept output
(lr = tile_out / 4 + 2), at the window's rate; `mfu.continent`'s
convention."""

from portbench.counts import peaks
from portbench.counts.hat import hat_tile_flops


def read(ctx):
    rate = ctx["window"]["metrics"].get("continent_tiles_per_s")
    if not rate:
        return None
    cfg = ctx["cell"].config
    flops = hat_tile_flops(cfg["generator"], ctx["cell"].traffic["tile_out"] // 4 + 2)
    return 100.0 * rate * flops["total"] / peaks.TENSOR_CORE_FLOPS[cfg["peak"]]

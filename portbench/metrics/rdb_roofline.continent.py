"""The trunk's (`ops.rdb`) bound over its device time per forward (CUDA
events around `Generator.trunk`), in %: `counts.layers.trunk` at the
trunk's multiplicand precision."""

from portbench.readers import trunk_roofline_pct as read  # noqa: F401

"""The tail's (`ops.tail`: offset convs, K2, K3) bound over its device time
per forward (CUDA events around `Generator.tail`), in %: `counts.layers.tail`."""

from portbench.readers import tail_roofline_pct as read  # noqa: F401

"""The least time the card could take for one call of a generator layer.

A layer's bound is the larger of two times: its required operations
(`counts.model`'s conventions) at the tensor-core peak of its multiplicand
precision, and its input read once plus its output written once at the HBM
rate (`counts.peaks`). The work is counted at the shapes the layer is called
with. A faster route for the same work cannot beat either term, so a share
`bound / measured time` stays at or under 100% by construction.
"""

from __future__ import annotations

from typing import Dict

from portbench.counts import peaks

TAPS = 9


def dense_block_macs(base: int, growth: int) -> int:
    """MACs per pixel of one dense block: 5 3x3 convs, base + j * growth in."""
    return TAPS * sum((base + j * growth) * (growth if j < 4 else base) for j in range(5))


def dense_block_params(base: int, growth: int) -> int:
    return dense_block_macs(base, growth) + 4 * growth + base


def bound(flops: float, nbytes: float, precision: str) -> Dict[str, float]:
    """{'s', 'by'}: the bound in seconds and which term sets it."""
    t_ops = flops / peaks.peak_flops(precision)
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    return {"s": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes"}


def trunk(batch: int, side: int, blocks: int, base: int, growth: int,
          precision: str) -> Dict[str, float]:
    """`Generator.trunk` on a (batch, side, side, base) float32 activation:
    3 * blocks dense blocks with ``precision`` multiplicands; bytes are the
    activation in, the trunk's output out and the weights at the
    multiplicand width."""
    px = batch * side * side
    flops = 2.0 * px * 3 * blocks * dense_block_macs(base, growth)
    nbytes = 2 * px * base * 4 + 3 * blocks * dense_block_params(base, growth) * \
        peaks.BYTES[precision]
    return bound(flops, nbytes, precision)


def tail(batch: int, side: int, base: int, out_channels: int = 1) -> Dict[str, float]:
    """`Generator.tail` on a (batch, side, side, base) float32 activation: two
    offset convs (base -> 18), the base -> base deformable conv and the
    base -> out_channels one (sampling 4 MACs per tap and channel, then
    the contraction), in fp32."""
    px = batch * side * side
    offsets = TAPS * base * 18
    sampling = TAPS * base * 4
    macs = 2 * offsets + 2 * sampling + TAPS * base * base + TAPS * base * out_channels
    weights = 2 * (offsets + 18) + TAPS * base * (base + out_channels) + base + out_channels
    nbytes = px * base * 4 + px * out_channels * 4 + weights * 4
    return bound(2.0 * px * macs, nbytes, "fp32")

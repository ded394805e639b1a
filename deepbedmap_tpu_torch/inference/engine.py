"""Halo'd tile-predict-stitch engine.

Counterpart of ``deepbedmap_tpu/inference/engine.py`` (reference semantics
deepbedmap.py:689-736): inputs are padded once by ``halo + 1`` low-res
px (times each raster's resolution ratio; by ``'edge'``, or any mode
``jnp.pad`` takes, ``pad_hw``), every tile crop has the same size,
and each tile's forward output loses ``halo * scale`` px per side before it
is written into the canvas. The JAX ``lax.scan`` over tiles is a Python loop
here. Crops are taken in unpadded coordinates, keeping correct
georegistration (the reference's continent loop is 1 km off, see the JAX
module docstring).

``forward_fn(x, w1, w2, w3)`` takes and returns NHWC tensors; the inputs are
dicts of NHWC tensors keyed X/W1/W2/W3 on the device the forward runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# resolution ratio of each conditioning raster relative to the low-res bed grid
INPUT_RATIOS = {"X": 1, "W1": 10, "W2": 2, "W3": 1}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static tiling geometry for an (out_h, out_w) output canvas."""

    out_h: int
    out_w: int
    tile_out: int = 1000  # output px per tile side
    halo_lr: int = 18  # discarded low-res halo per side ("xtrapad")
    scale: int = 4

    def __post_init__(self):
        for name, v in (("out_h", self.out_h), ("out_w", self.out_w)):
            if v % self.tile_out:
                raise ValueError(
                    f"{name}={v} must be a multiple of tile_out={self.tile_out}"
                )
        if self.tile_out % self.scale:
            raise ValueError(
                f"tile_out={self.tile_out} must be a multiple of scale={self.scale}"
            )

    @property
    def tile_lr(self) -> int:
        return self.tile_out // self.scale

    @property
    def pad_lr(self) -> int:
        # halo + 1 px for the input block's valid convolution
        return self.halo_lr + 1

    @property
    def crop_lr(self) -> int:
        return self.tile_lr + 2 * self.pad_lr

    @property
    def discard_hr(self) -> int:
        return self.halo_lr * self.scale

    @property
    def grid(self) -> Tuple[int, int]:
        return self.out_h // self.tile_out, self.out_w // self.tile_out

    @property
    def num_tiles(self) -> int:
        gy, gx = self.grid
        return gy * gx

    @property
    def lr_shape(self) -> Tuple[int, int]:
        return self.out_h // self.scale, self.out_w // self.scale


def pad_edge(a: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Edge-replicate padding of the H and W axes of an NHWC tensor."""
    nchw = a.permute(0, 3, 1, 2)
    return F.pad(nchw, (left, right, top, bottom), mode="replicate").permute(0, 2, 3, 1)


# the modes of jnp.pad (numpy's, with its defaults: constant_values 0,
# end_values 0, stat_length the whole axis, reflect_type 'even')
PAD_MODES = ("constant", "edge", "linear_ramp", "maximum", "mean", "median", "minimum",
             "reflect", "symmetric", "wrap", "empty")
_INDEX_MODES = ("reflect", "symmetric", "wrap")  # pure gathers of the axis ('edge' too)
_STAT_MODES = ("maximum", "mean", "median", "minimum")


def _pad_axis(a: torch.Tensor, dim: int, p: int, mode: str) -> torch.Tensor:
    """``a`` padded by ``p`` on both sides of ``dim`` as ``np.pad`` pads one
    axis, on ``a``'s device."""
    n = a.shape[dim]
    if mode in _INDEX_MODES:
        # the source index of every padded position: np.pad of the index
        # vector itself, which also repeats the reflection where p > n
        idx = np.pad(np.arange(n), (p, p), mode=mode)
        return a.index_select(dim, torch.from_numpy(idx).to(a.device))
    shape = list(a.shape)
    shape[dim] = p
    if mode in ("constant", "empty"):
        # jnp.pad fills 'empty' with zeros too
        side = torch.zeros(shape, dtype=a.dtype, device=a.device)
        return torch.cat([side, a, side], dim)
    if mode in _STAT_MODES:
        if mode == "median":
            # numpy's median: the mean of the two middle values of an even count
            s = a.sort(dim).values
            stat = (s.narrow(dim, (n - 1) // 2, 1) + s.narrow(dim, n // 2, 1)) / 2
        elif mode == "mean":
            stat = a.mean(dim, keepdim=True)
        else:
            stat = getattr(a, "amax" if mode == "maximum" else "amin")(dim, keepdim=True)
        side = stat.expand(shape)
        return torch.cat([side, a, side], dim)
    # linear_ramp to end value 0: position i of a side's p is edge * i / p,
    # counted from the outer end (np.linspace(0, edge, p, endpoint=False))
    view = [1] * a.dim()
    view[dim] = p
    ramp = (torch.arange(p, device=a.device, dtype=a.dtype) / p).view(view)
    before = a.narrow(dim, 0, 1) * ramp
    after = (a.narrow(dim, n - 1, 1) * ramp).flip(dim)
    return torch.cat([before, a, after], dim)


def pad_hw(a: torch.Tensor, p: int, mode: str = "edge") -> torch.Tensor:
    """``jnp.pad(a, ((0, 0), (p, p), (p, p), (0, 0)), mode=mode)`` of an NHWC
    tensor, on its device. As numpy, H is padded first and W then from the
    H-padded array, so the corners of 'linear_ramp' and the statistic modes
    come from the padded first axis."""
    if mode not in PAD_MODES:
        raise ValueError(f"pad mode {mode!r}: one of {PAD_MODES}")
    if mode == "edge":  # one replicate pad, the continent's band padding too
        return pad_edge(a, p, p, p, p)
    return _pad_axis(_pad_axis(a, 1, p, mode), 2, p, mode)


def pad_inputs(inputs: Dict[str, torch.Tensor], plan: TilePlan,
               mode: str = "edge") -> Dict[str, torch.Tensor]:
    """Pad each NHWC raster by pad_lr * its resolution ratio per side, by
    ``mode`` (``pad_hw``)."""
    padded = {}
    lh, lw = plan.lr_shape
    for key, ratio in INPUT_RATIOS.items():
        a = inputs[key]
        if a.shape[1] != ratio * lh or a.shape[2] != ratio * lw:
            raise ValueError(f"{key}: shape {tuple(a.shape)}, expected "
                             f"{(ratio * lh, ratio * lw)} spatially")
        padded[key] = pad_hw(a, plan.pad_lr * ratio, mode)
    return padded


def _crop_tile(
    padded: Dict[str, torch.Tensor], plan: TilePlan, ty: int, tx: int
) -> Dict[str, torch.Tensor]:
    """Fixed-size crops of all four rasters for tile (ty, tx)."""
    crops = {}
    for key, ratio in INPUT_RATIOS.items():
        size = plan.crop_lr * ratio
        y0 = ty * plan.tile_lr * ratio
        x0 = tx * plan.tile_lr * ratio
        crops[key] = padded[key][:, y0 : y0 + size, x0 : x0 + size]
    return crops


def _discard_halo(pred: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    d = plan.discard_hr
    return pred[:, d : pred.shape[1] - d, d : pred.shape[2] - d]


def make_tile_forward(forward_fn: Callable[..., torch.Tensor], plan: TilePlan) -> Callable:
    """Single-tile path: crop -> forward -> discard halo. Returns a function
    (padded_inputs, ty, tx) -> (1, tile_out, tile_out, 1)."""

    def tile_forward(padded, ty: int, tx: int) -> torch.Tensor:
        c = _crop_tile(padded, plan, ty, tx)
        return _discard_halo(forward_fn(c["X"], c["W1"], c["W2"], c["W3"]), plan)

    return tile_forward


def make_tile_group_forward(
    forward_fn: Callable[..., torch.Tensor], plan: TilePlan
) -> Callable:
    """Batched-tile path: crop B tiles, stack them on the batch dim, ONE
    forward. Returns (padded_inputs, tys, txs) -> (B, tile_out, tile_out)."""

    def group_forward(padded, tys: Sequence[int], txs: Sequence[int]) -> torch.Tensor:
        crops = [_crop_tile(padded, plan, ty, tx) for ty, tx in zip(tys, txs)]
        batch = {k: torch.cat([c[k] for c in crops]) for k in INPUT_RATIOS}
        pred = forward_fn(batch["X"], batch["W1"], batch["W2"], batch["W3"])
        return _discard_halo(pred, plan)[..., 0]

    return group_forward


def predict_region_tiled(
    forward_fn: Callable[..., torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    plan: TilePlan,
    pad_mode: str = "edge",
) -> torch.Tensor:
    """Tile-predict-stitch over the full grid. ``inputs`` are unpadded NHWC
    rasters covering exactly the output bbox, padded by ``pad_mode``.
    Returns (1, out_h, out_w, 1)."""
    padded = pad_inputs(inputs, plan, pad_mode)
    tile_forward = make_tile_forward(forward_fn, plan)
    gy, gx = plan.grid
    t = plan.tile_out
    canvas = torch.zeros((1, plan.out_h, plan.out_w, 1), device=inputs["X"].device)
    for ty in range(gy):
        for tx in range(gx):
            canvas[:, ty * t : (ty + 1) * t, tx * t : (tx + 1) * t] = tile_forward(
                padded, ty, tx
            )
    return canvas


def predict_region(
    forward_fn: Callable[..., torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    plan: TilePlan,
    pad_mode: str = "edge",
) -> torch.Tensor:
    """Untiled single-shot prediction of the whole region (one big 'tile').
    Equal to ``predict_region_tiled`` where the halo covers the generator's
    far field (seam equivalence)."""
    padded = pad_inputs(inputs, plan, pad_mode)
    return _discard_halo(
        forward_fn(padded["X"], padded["W1"], padded["W2"], padded["W3"]), plan
    )

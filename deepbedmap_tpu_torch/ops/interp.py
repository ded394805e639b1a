"""Sampling on regular grids: bilinear, Keys bicubic and nearest, on tensors.

Counterpart of ``deepbedmap_tpu/ops/interp.py``: the numerical core of the
tiler (``data.tiler.selective_tile``), of the ground-truth inputs
(``data.groundtruth``) and of grdtrack-style point sampling
(``evalx.track``). Each sampler runs on the device of its ``data`` tensor.

Grid convention (the reference's xarray rasters): cell centers at
``x = x0 + res*(j + 0.5)``, ``y = y1 - res*(i + 0.5)``; x0/y1 are the outer
left/top edges and rows run top to bottom.

Coordinates are float32, as in JAX. The JAX package runs with 64-bit types
off: ``jnp.asarray`` of a float64 coordinate array gives float32, and x0, y1
and res enter as weak-typed Python floats, so ``(xs - x0) / res - 0.5`` is
computed in float32. At Antarctic magnitudes (|x| ~ 1.6e6 m, one ulp 0.125 m)
that decides whether a sample at the first or last cell center is inside the
grid, and so where the output is NaN (and, downstream, gapfilled). The port
therefore casts coordinates to float32 and does the same float32 operations
in the same order: its NaN masks are JAX's bit for bit. The constants are
0-dim float32 tensors on the data's device, because PyTorch on CUDA divides
by a host scalar as a multiplication by its reciprocal, which rounds
differently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.device import resolve_device

Window = Tuple[int, int, int, int]  # (row0, col0, H, W), see sample_grid_bilinear


def as_f32(a, device) -> torch.Tensor:
    """A copy of an array as a float32 tensor on ``device``: what
    ``jnp.asarray`` gives for it in JAX with 64-bit types off (float64
    rounded to nearest)."""
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _fractional_indices(data, xs, ys, x0, y1, res):
    """(fi, fj): the samples' fractional array indices, 0 at the first cell
    center, in float32 as JAX computes them."""
    xs = xs.to(data.device, torch.float32)
    ys = ys.to(data.device, torch.float32)
    r = _scalar(res, data)
    fj = (xs - _scalar(x0, data)) / r - 0.5
    fi = (_scalar(y1, data) - ys) / r - 0.5
    return fi, fj


def _inside_hull(fi, fj, h: int, w: int) -> torch.Tensor:
    """xarray.interp's rule: NaN as soon as the sample lies outside the
    [first, last] cell-center range in either axis."""
    return (fi >= 0.0) & (fi <= h - 1) & (fj >= 0.0) & (fj <= w - 1)


def _grid(data: torch.Tensor, window: Optional[Window]) -> Window:
    return (0, 0) + tuple(data.shape) if window is None else window


def sample_grid_bilinear(
    data: torch.Tensor,  # (H, W)
    xs: torch.Tensor,  # sample x coords, any shape
    ys: torch.Tensor,  # sample y coords, same shape
    x0: float,
    y1: float,
    res: float,
    window: Optional[Window] = None,
) -> torch.Tensor:
    """Bilinearly sample a grid at projected coordinates.

    Samples at exact cell centers return the cell value; samples outside the
    cell-center hull return NaN (xarray.interp's NaN-outside behaviour,
    which selective_tile relies on). ``window`` (row0, col0, H, W) says that
    ``data`` holds the cells from row0 and col0 on of an H x W grid whose
    outer edges are x0 and y1, and every cell the samples reach: the result
    is the whole grid's, bit for bit.
    """
    r0, c0, h, w = _grid(data, window)
    fi, fj = _fractional_indices(data, xs, ys, x0, y1, res)
    i0 = torch.floor(fi)
    j0 = torch.floor(fj)
    di = fi - i0
    dj = fj - j0
    i0 = i0.long()
    j0 = j0.long()

    def at(ii, jj):
        return data[ii.clamp(0, h - 1) - r0, jj.clamp(0, w - 1) - c0]

    v00 = at(i0, j0)
    v01 = at(i0, j0 + 1)
    v10 = at(i0 + 1, j0)
    v11 = at(i0 + 1, j0 + 1)

    top = v00 * (1.0 - dj) + v01 * dj
    bot = v10 * (1.0 - dj) + v11 * dj
    out = top * (1.0 - di) + bot * di
    return torch.where(_inside_hull(fi, fj, h, w), out, float("nan"))


def _keys_weights(t: torch.Tensor, a: float = -0.5):
    """Cubic-convolution weights (Keys 1981, a=-0.5: GMT's default bicubic
    grid interpolant) for the 4 taps at integer offsets {-1, 0, 1, 2} around a
    sample with fractional part ``t``."""

    def k(s):
        s = s.abs()
        s2 = s * s
        s3 = s2 * s
        inner = (a + 2.0) * s3 - (a + 3.0) * s2 + 1.0
        outer = a * s3 - 5.0 * a * s2 + 8.0 * a * s - 4.0 * a
        return torch.where(s <= 1.0, inner, torch.where(s < 2.0, outer, 0.0))

    return [k(t + 1.0), k(t), k(t - 1.0), k(t - 2.0)]


def sample_grid_bicubic(
    data: torch.Tensor,  # (H, W)
    xs: torch.Tensor,
    ys: torch.Tensor,
    x0: float,
    y1: float,
    res: float,
) -> torch.Tensor:
    """Bicubic (Keys cubic convolution, a=-0.5) sampling, GMT grdtrack's
    default interpolant. The outer taps clamp to the edge rows and columns;
    samples outside the cell-center hull return NaN, the bilinear sampler's
    rule. Reproduces polynomials up to degree 2 and interpolates
    node values."""
    h, w = data.shape
    fi, fj = _fractional_indices(data, xs, ys, x0, y1, res)
    i0 = torch.floor(fi)
    j0 = torch.floor(fj)
    di = fi - i0
    dj = fj - j0
    i0 = i0.long()
    j0 = j0.long()

    wi = _keys_weights(di)
    wj = _keys_weights(dj)

    out = torch.zeros_like(fi, dtype=data.dtype)
    for oi in range(4):
        row = torch.zeros_like(out)
        ii = (i0 + (oi - 1)).clamp(0, h - 1)
        for oj in range(4):
            jj = (j0 + (oj - 1)).clamp(0, w - 1)
            row = row + wj[oj] * data[ii, jj]
        out = out + wi[oi] * row
    return torch.where(_inside_hull(fi, fj, h, w), out, float("nan"))


def sample_grid_nearest(
    data: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    x0: float,
    y1: float,
    res: float,
    window: Optional[Window] = None,
) -> torch.Tensor:
    """Nearest-neighbour sampling (selective_tile's ``interpolate=False``).
    Rounds half to even, as ``jnp.round``, and is inside where the rounded
    index is on the grid: another rule than the bilinear hull's. ``window``
    as for ``sample_grid_bilinear``."""
    r0, c0, h, w = _grid(data, window)
    fi, fj = _fractional_indices(data, xs, ys, x0, y1, res)
    i = torch.round(fi).long()
    j = torch.round(fj).long()
    inside = (i >= 0) & (i < h) & (j >= 0) & (j < w)
    out = data[i.clamp(0, h - 1) - r0, j.clamp(0, w - 1) - c0]
    return torch.where(inside, out, float("nan"))


def window_coords(
    bounds: Tuple[float, float, float, float],  # (xmin, ymin, xmax, ymax)
    resolution: float,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Target cell-center coordinates (float32, on ``device``) of a window at
    a resolution: y from top - res/2 down to bottom + res/2, x from
    left + res/2 up (data_prep.py:695-696). Built as ``selective_tile``
    builds its centers, in float64 and then rounded to float32; JAX's
    ``jnp.linspace`` in float32 lies within one ulp of the larger endpoint
    of it."""
    dev = resolve_device(device)
    xmin, ymin, xmax, ymax = bounds
    half = resolution / 2.0
    ny = int(round((ymax - ymin) / resolution))
    nx = int(round((xmax - xmin) / resolution))
    ys = as_f32(np.linspace(ymax - half, ymin + half, ny), dev)
    xs = as_f32(np.linspace(xmin + half, xmax - half, nx), dev)
    return xs, ys

"""The model's inputs for one region, worked out again from the source
rasters: the published workflow's `get_model_inputs` (deepbedmap.py:132-213;
data_prep.py:622-741), in NumPy.

Each input is the source raster sampled bilinearly at the cell centres of
the window grown by 1 km a side: X the bed at 1000 m (voids filled with
-5000), W1 the surface at 100 m (left as it is), W2 the two velocity
components resampled to 500 m (voids 0), W3 the accumulation at 1000 m
(voids 0). Centres run from the top-left inward, spaced by the resolution,
made in float64 and then rounded to float32. A sample's fractional indices
are taken in float32, as the published JAX code computes them with 64-bit
types off: at |x| ~ 1.6e6 m a float32 ulp is 0.125 m, which decides whether
a sample at the hull's edge is inside (a value) or outside (NaN). A NaN
corner makes the sample NaN, as xarray's interpolation does.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

F32 = np.float32


def centres(bounds: Sequence[float], res: float, padding: float) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) float32 cell centres of ``bounds`` grown by ``padding``."""
    xmin, ymin, xmax, ymax = bounds
    left, bottom, right, top = xmin - padding, ymin - padding, xmax + padding, ymax + padding
    ny = int(round((top - bottom) / res))
    nx = int(round((right - left) / res))
    half = res / 2.0
    ys = np.linspace(top - half, bottom + half, ny).astype(F32)
    xs = np.linspace(left + half, right - half, nx).astype(F32)
    return xs, ys


def bilinear(data: np.ndarray, left: float, top: float, res: float, xs: np.ndarray,
             ys: np.ndarray) -> np.ndarray:
    """``data`` (H, W), cell centres at left + res (j + 1/2), top - res (i + 1/2),
    sampled on the grid ys x xs -> (len(ys), len(xs)) float32, NaN outside
    the hull of cell centres."""
    h, w = data.shape
    fj = (xs - F32(left)) / F32(res) - F32(0.5)
    fi = (F32(top) - ys) / F32(res) - F32(0.5)
    i0, j0 = np.floor(fi), np.floor(fj)
    di, dj = (fi - i0)[:, None], (fj - j0)[None, :]
    i0, j0 = i0.astype(np.int64), j0.astype(np.int64)
    r0, r1 = np.clip(i0, 0, h - 1), np.clip(i0 + 1, 0, h - 1)
    c0, c1 = np.clip(j0, 0, w - 1), np.clip(j0 + 1, 0, w - 1)
    one = F32(1.0)
    top_row = data[np.ix_(r0, c0)] * (one - dj) + data[np.ix_(r0, c1)] * dj
    bottom_row = data[np.ix_(r1, c0)] * (one - dj) + data[np.ix_(r1, c1)] * dj
    out = top_row * (one - di) + bottom_row * di
    inside = ((fi >= 0) & (fi <= h - 1))[:, None] & ((fj >= 0) & (fj <= w - 1))[None, :]
    return np.where(inside, out, F32(np.nan)).astype(F32)


def model_inputs(bounds: Sequence[float], rasters: Dict[str, tuple],
                 padding: float = 1000.0) -> Dict[str, np.ndarray]:
    """NCHW float32 X, W1, W2, W3 for ``bounds``; ``rasters`` maps each
    source (bed_lowres, surface, velocity_x, velocity_y, accumulation) to
    (data, left, top, res)."""

    def tile(name, res=None, fill=None):
        data, left, top, src_res = rasters[name]
        xs, ys = centres(bounds, src_res if res is None else res, padding)
        out = bilinear(data, left, top, src_res, xs, ys)
        if fill is not None:
            out = np.where(np.isnan(out), F32(fill), out)
        return out[None, None]

    vx = tile("velocity_x", 500.0, 0.0)
    vy = tile("velocity_y", 500.0, 0.0)
    return {"X": tile("bed_lowres", fill=-5000.0), "W1": tile("surface"),
            "W2": np.concatenate([vx, vy], axis=1), "W3": tile("accumulation", fill=0.0)}

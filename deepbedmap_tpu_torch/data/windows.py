"""Training-window proposal + spatial filtering (reference data_prep.py:501-615).

A copy of ``deepbedmap_tpu/data/windows.py`` (numpy only) on the port's
``Raster``.

- ``get_window_bounds``: stepped sliding window over a raster, keeping only
  fully-valid (no-NaN) windows, returning projected-coordinate bboxes scanned
  top-down/left-right like the reference.
- ``filter_within_polygon``: replaces the geopandas sjoin-within-buffered-
  grounding-line step (data_prep.py:599-607) without GEOS: a window passes if
  all four corners are inside the polygon or within ``buffer`` of it
  (even-odd point-in-polygon + exact point-segment distance, vectorised).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from deepbedmap_tpu_torch.data.raster import Raster

Bounds = Tuple[float, float, float, float]  # (xmin, ymin, xmax, ymax)


def get_window_bounds(
    raster: Raster,
    height: int = 36,
    width: int = 36,
    step: int = 3,
) -> List[Bounds]:
    """Propose fully-valid (height x width) windows every ``step`` px.

    Matches the reference doctest semantics (data_prep.py:513-521): windows
    scan from the raster's top row down, and only windows containing zero
    NaN/nodata pixels survive.
    """
    assert height == width, "square windows only (reference assertion)"
    assert height % 2 == 0

    invalid = np.isnan(raster.masked())
    h, w = invalid.shape
    if h < height or w < width:
        return []

    # sliding-window validity via a 2-D summed-area table (O(HW), no
    # skimage): window is valid iff its invalid-count is 0
    counts = np.zeros((h + 1, w + 1), np.int64)
    np.cumsum(invalid, axis=0, out=counts[1:, 1:])
    np.cumsum(counts[1:, 1:], axis=1, out=counts[1:, 1:])
    rows = np.arange(0, h - height + 1, step)
    cols = np.arange(0, w - width + 1, step)
    r0 = counts[np.ix_(rows, cols)]
    r1 = counts[np.ix_(rows + height, cols)]
    r2 = counts[np.ix_(rows, cols + width)]
    r3 = counts[np.ix_(rows + height, cols + width)]
    window_invalid = r3 - r1 - r2 + r0

    res = raster.res
    bounds: List[Bounds] = []
    for i, j in np.argwhere(window_invalid == 0):
        top_px = rows[i]
        left_px = cols[j]
        xmin = raster.left + left_px * res
        ymax = raster.top - top_px * res
        bounds.append((xmin, ymax - height * res, xmin + width * res, ymax))
    return bounds


def _point_in_polygon(px: np.ndarray, py: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Even-odd rule, vectorised over points. poly: (V, 2) closed or open."""
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.zeros(px.shape, bool)
    for ax, ay, bx, by in zip(x0, y0, x1, y1):
        crosses = (ay > py) != (by > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = ax + (py - ay) * (bx - ax) / (by - ay)
        inside ^= crosses & (px < xint)
    return inside


def _dist_to_polygon(px: np.ndarray, py: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Min distance from each point to the polygon boundary (segments)."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    d = np.full(px.shape, np.inf)
    for (ax, ay), (bx, by) in zip(a, b):
        vx, vy = bx - ax, by - ay
        denom = vx * vx + vy * vy
        if denom == 0:
            dd = np.hypot(px - ax, py - ay)
        else:
            t = np.clip(((px - ax) * vx + (py - ay) * vy) / denom, 0.0, 1.0)
            dd = np.hypot(px - (ax + t * vx), py - (ay + t * vy))
        d = np.minimum(d, dd)
    return d


def filter_within_polygon(
    window_bounds: Sequence[Bounds],
    polygon: np.ndarray,  # (V, 2) vertices in the same CRS
    buffer: float = 10_000.0,
) -> List[int]:
    """Indices of windows whose four corners all lie within the polygon
    buffered by ``buffer`` map units (reference: 10 km grounding-line buffer,
    data_prep.py:599-607)."""
    wb = np.asarray(window_bounds, np.float64)
    corners_x = wb[:, [0, 0, 2, 2]].ravel()
    corners_y = wb[:, [1, 3, 1, 3]].ravel()
    inside = _point_in_polygon(corners_x, corners_y, polygon)
    near = np.zeros_like(inside)
    outside = ~inside
    if outside.any():
        near[outside] = (
            _dist_to_polygon(corners_x[outside], corners_y[outside], polygon)
            <= buffer
        )
    ok = (inside | near).reshape(-1, 4).all(axis=1)
    return np.nonzero(ok)[0].tolist()

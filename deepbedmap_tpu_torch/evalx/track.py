"""grdtrack-style grid sampling at scattered points, and RMSE.

Counterpart of ``deepbedmap_tpu/evalx/track.py``, on a device. Reference:
``gmt.grdtrack`` samples each candidate DEM at ground-truth xyz points, an
error column is formed, and RMSE summarises it (deepbedmap.py:530-573;
per-epoch test metric srgan_train.py:1460-1464). GMT's default interpolation
is bicubic (Keys cubic convolution, a=-0.5), so ``method="bicubic"`` is the
default here too, with ``"bilinear"``/``"nearest"`` available (GMT
``-nl``/``-nn``). Points outside the grid give NaN and are left out of the
RMSE.
"""

from __future__ import annotations

import csv

import numpy as np
import torch

from deepbedmap_tpu_torch.data.pipeline import parse_floats
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.ops.interp import (
    as_f32,
    sample_grid_bicubic,
    sample_grid_bilinear,
    sample_grid_nearest,
)
from deepbedmap_tpu_torch.ops.metrics import rmse

_SAMPLERS = {
    "bicubic": sample_grid_bicubic,
    "bilinear": sample_grid_bilinear,
    "nearest": sample_grid_nearest,
}


def grdtrack(
    raster_data: torch.Tensor,  # (H, W)
    xs: torch.Tensor,
    ys: torch.Tensor,
    left: float,
    top: float,
    res: float,
    method: str = "bicubic",
) -> torch.Tensor:
    """Sample a grid at projected points, on the grid's device; NaN outside.

    ``method``: 'bicubic' (GMT grdtrack default), 'bilinear' or 'nearest'.
    """
    return _SAMPLERS[method](raster_data, xs, ys, left, top, res)


def _sample(raster: Raster, x, y, method: str, dev) -> torch.Tensor:
    return grdtrack(as_f32(raster.masked(), dev), as_f32(x, dev), as_f32(y, dev),
                    raster.left, raster.top, raster.res, method=method)


def elevation_residuals(
    raster: Raster,
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    method: str = "bicubic",
    device="cuda",
) -> np.ndarray:
    """Residuals grid-minus-track at each survey point (NaN outside grid),
    sampled on ``device``."""
    sampled = _sample(raster, x, y, method, resolve_device(device))
    return sampled.cpu().numpy() - np.asarray(z)


def track_rmse(
    raster: Raster,
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    method: str = "bicubic",
    device="cuda",
) -> float:
    """RMSE of grid vs. xyz track elevations, NaN-aware, on ``device`` (the
    reference's headline quality metric, srgan_train.py:1422-1466)."""
    dev = resolve_device(device)
    return float(rmse(_sample(raster, x, y, method, dev), as_f32(z, dev)))


def read_track_csv(path: str, columns=("x", "y", "z")):
    """The ``columns`` of a comma-separated track file with a header row, found
    by name, as float64 numpy arrays: what the JAX package reads with
    ``pandas.read_csv(path)[list(columns)]`` (``serve.py:_evaluate``,
    ``cli.py:cmd_evaluate``), without pandas, which the card's machine does
    not have. As pandas reads them: fields and header names may be quoted;
    other columns, in any order, are ignored; an empty field or one of
    pandas' NA strings is NaN, and so is a field missing from a short row;
    numbers are parsed as pandas' C parser parses them
    (``data.pipeline.parse_floats``);
    blank lines are skipped; CRLF line endings are read; a file with only
    its header gives empty arrays. A field that is not a number raises
    ``ValueError``."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    header = rows[0] if rows else []
    missing = [c for c in columns if c not in header]
    if missing:
        raise ValueError(f"{path}: no column {missing} in header {header}")
    at = [header.index(c) for c in columns]
    out = []
    for i in at:
        try:
            out.append(parse_floats([row[i] if i < len(row) else "" for row in rows[1:]]))
        except ValueError as e:
            raise ValueError(f"{path}: column {header[i]!r}: {e}") from None
    return tuple(out)

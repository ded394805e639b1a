"""Ground-truth assembly and the model's inputs for one region (reference L5).

Counterpart of ``deepbedmap_tpu/data/groundtruth.py``, sampling on a device:

- ``get_image_with_bounds``: merge one or more NetCDF grids into a Raster and
  check the deep-learning geometry (shape divisible by 4)
  (deepbedmap.py:63-111);
- ``get_model_inputs``: cut the X/W1/W2/W3 conditioning stack for a bounding
  box from the source rasters with the reference's conventions
  (deepbedmap.py:132-213): BEDMAP2 gapfilled with -5000, velocity and
  accumulation with 0, REMA left as it is (NaN included), all with 1 km of
  context padding; velocity resampled to 500 m;
- ``gapfill_from_coarse``: fill voids in a fine raster with bilinear samples
  of a coarse raster (the reference's one-off REMA 100 m <- 200 m fill,
  data_prep.py:838-877).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.data.raster import Raster, read_netcdf
from deepbedmap_tpu_torch.data.tiler import selective_tile
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.ops.interp import as_f32, sample_grid_bilinear

Bounds = Tuple[float, float, float, float]  # (xmin, ymin, xmax, ymax)


def get_image_with_bounds(
    filepaths: Sequence[str], strict_multiple_of: int = 4
) -> Raster:
    """Load one or more NetCDF grids; for several, mosaic over their union
    extent (NaN where uncovered). Warns when the shape isn't divisible by the
    super-resolution factor (deepbedmap.py:102-107)."""
    rasters = [read_netcdf(p) for p in filepaths]
    if len(rasters) == 1:
        merged = rasters[0]
    else:
        res = rasters[0].res
        assert all(abs(r.res - res) < 1e-6 for r in rasters), "mixed resolutions"
        xmin = min(r.bounds[0] for r in rasters)
        ymin = min(r.bounds[1] for r in rasters)
        xmax = max(r.bounds[2] for r in rasters)
        ymax = max(r.bounds[3] for r in rasters)
        width = int(round((xmax - xmin) / res))
        height = int(round((ymax - ymin) / res))
        canvas = np.full((height, width), np.nan, np.float32)
        for r in rasters:
            row0 = int(round((ymax - r.top) / res))
            col0 = int(round((r.left - xmin) / res))
            canvas[row0 : row0 + r.height, col0 : col0 + r.width] = r.masked()
        merged = Raster(canvas, left=xmin, top=ymax, res=res)

    shape = merged.data.shape
    if any(s % strict_multiple_of for s in shape):
        print(
            f"WARN: Image shape {shape} should be divisible by "
            f"{strict_multiple_of} for DeepBedMap"
        )
    return merged


def get_model_inputs(
    window_bound: Bounds,
    bed_lowres: Raster,  # BEDMAP2 bed @1000m
    surface: Raster,  # REMA ice surface @100m
    velocity_x: Raster,  # MEaSUREs VX (native ~450m)
    velocity_y: Raster,
    accumulation: Raster,  # snow accumulation @1000m
    padding: float = 1000.0,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """The reference's (X, W1, W2, W3) conditioning stack for a bounding box
    (deepbedmap.py:164-200): NCHW float32 tensors on ``device``."""
    kw = dict(padding=padding, device=device)
    X = selective_tile(bed_lowres, [window_bound], gapfiller=-5000.0, **kw)
    W1 = selective_tile(surface, [window_bound], **kw)
    VX = selective_tile(velocity_x, [window_bound], resolution=500.0, gapfiller=0.0, **kw)
    VY = selective_tile(velocity_y, [window_bound], resolution=500.0, gapfiller=0.0, **kw)
    W3 = selective_tile(accumulation, [window_bound], gapfiller=0.0, **kw)
    return {"X": X, "W1": W1, "W2": torch.cat([VX, VY], dim=1), "W3": W3}


def gapfill_from_coarse(fine: Raster, coarse: Raster, device="cuda") -> Raster:
    """Fill NaN voids in ``fine`` with bilinear samples of ``coarse``, taken
    on ``device`` (reference REMA 100 m <- 200 m_filled,
    data_prep.py:838-877)."""
    dev = resolve_device(device)
    data = fine.masked().copy()
    voids = np.argwhere(np.isnan(data))
    if len(voids):
        ys = fine.top - fine.res * (voids[:, 0] + 0.5)
        xs = fine.left + fine.res * (voids[:, 1] + 0.5)
        fill = sample_grid_bilinear(
            as_f32(coarse.masked(), dev), as_f32(xs, dev), as_f32(ys, dev),
            coarse.left, coarse.top, coarse.res,
        )
        data[voids[:, 0], voids[:, 1]] = fill.cpu().numpy()
    return Raster(
        data, left=fine.left, top=fine.top, res=fine.res, crs=fine.crs,
        nodata=fine.nodata,
    )

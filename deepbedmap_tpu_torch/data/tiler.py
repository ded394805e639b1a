"""Windowed tile extraction: the reference's ``selective_tile``
(data_prep.py:622-741) as one vectorised sample of every window.

Counterpart of ``deepbedmap_tpu/data/tiler.py:selective_tile``, on a device.
It keeps the reference's coordinate conventions:

- window bounds optionally extended by ``padding`` map units per side;
- target cell centers ``linspace(top - res/2, bottom + res/2)`` (y down) and
  ``linspace(left + res/2, right - res/2)`` (data_prep.py:695-696), built in
  float64 with numpy and only then rounded to float32, as JAX does;
- masked values propagate as NaN, then ``gapfiller`` replaces them, or a
  warning names the tiles with missing data (data_prep.py:719-738).

``save_array_to_grid`` writes a (1, H, W) array as a GeoTIFF (and, on
request, NetCDF, whose writer imports ``h5py`` inside).
"""

from __future__ import annotations

import warnings
from dataclasses import replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.data.raster import EPSG_3031, Raster, write_netcdf
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.ops.interp import (
    as_f32,
    sample_grid_bilinear,
    sample_grid_nearest,
)
from deepbedmap_tpu_torch.utils.profiling import count, span


def _reach(raster: Raster, xs_f64: np.ndarray, ys_f64: np.ndarray):
    """(row0, row1, col0, col1): the rows and columns of ``raster`` that
    samples in the float64 extent of ``xs_f64`` x ``ys_f64`` can reach. The
    margin, two cells plus eight float32 ulps of the coordinates, covers the
    samplers' float32 rounding and their second tap; rows and columns are
    clipped to the raster, where the samplers clamp."""
    mag = float(max(abs(raster.left), abs(raster.top), np.abs(xs_f64).max(),
                    np.abs(ys_f64).max()))
    margin = 2 + int(np.ceil(8 * float(np.spacing(np.float32(mag))) / raster.res))

    def span(lo: float, hi: float, n: int):
        start = min(max(int(np.floor(lo)) - margin, 0), n - 1)
        return start, max(min(int(np.floor(hi)) + margin + 1, n), start + 1)

    fj = (np.array([xs_f64.min(), xs_f64.max()]) - raster.left) / raster.res - 0.5
    fi = (raster.top - np.array([ys_f64.max(), ys_f64.min()])) / raster.res - 0.5
    return span(*fi, raster.height) + span(*fj, raster.width)


def selective_tile(
    raster: Raster,
    window_bounds: Sequence[Tuple[float, float, float, float]],
    padding: float = 0.0,
    resolution: Optional[float] = None,
    gapfiller: Optional[float] = None,
    interpolate: bool = True,
    device="cuda",
) -> torch.Tensor:
    """Extract (N, 1, H, W) float32 tiles on ``device``, in the reference's
    NCHW layout.

    ``window_bounds`` are (xmin, ymin, xmax, ymax); all must share one shape
    (the reference sizes every window from the first, data_prep.py:679-680).
    Telemetry spans (``utils.profiling``): ``tiler.cut`` (the grid, the
    reach, the masked host slice), ``tiler.upload`` (grid and slice to the
    device; ``tiler.upload_bytes``), ``tiler.sample`` (sampler and fill),
    and without a ``gapfiller`` ``tiler.nan_check`` (a host sync).
    """
    assert len(window_bounds), "no windows"
    dev = resolve_device(device)
    res = float(raster.res if resolution is None else resolution)
    half = res / 2.0

    with span("tiler.cut"):
        x0, y0, x1, y1 = window_bounds[0]
        ny = int(round(((y1 + padding) - (y0 - padding)) / res))
        nx = int(round(((x1 + padding) - (x0 - padding)) / res))

        bounds = np.asarray(window_bounds, np.float64)
        lefts = bounds[:, 0] - padding
        bottoms = bounds[:, 1] - padding
        rights = bounds[:, 2] + padding
        tops = bounds[:, 3] + padding

        # per-window target cell centers, shape (N, ny) / (N, nx)
        ys64 = np.linspace(tops - half, bottoms + half, num=ny, axis=-1)
        xs64 = np.linspace(lefts + half, rights - half, num=nx, axis=-1)

        # only the cells the samples reach go to the device (a continental
        # source holds gigabytes); the grid's own edges keep JAX's float32
        # arithmetic
        r0, r1, c0, c1 = _reach(raster, xs_f64=np.concatenate([lefts + half, rights - half]),
                                ys_f64=np.concatenate([tops - half, bottoms + half]))
        cut = replace(raster, data=raster.data[r0:r1, c0:c1]).masked()
    with span("tiler.upload"):
        ys, xs, data = as_f32(ys64, dev), as_f32(xs64, dev), as_f32(cut, dev)
    count("tiler.upload_bytes", 4 * (ys64.size + xs64.size + cut.size))
    with span("tiler.sample"):
        n = len(bounds)
        gx = xs[:, None, :].expand(n, ny, nx)
        gy = ys[:, :, None].expand(n, ny, nx)
        sampler = sample_grid_bilinear if interpolate else sample_grid_nearest
        tiles = sampler(data, gx, gy, raster.left, raster.top, raster.res,
                        window=(r0, c0, raster.height, raster.width))[:, None]
        mask = torch.isnan(tiles)
        if gapfiller is not None:
            tiles = tiles.masked_fill(mask, gapfiller)
    if gapfiller is not None:
        return tiles
    with span("tiler.nan_check"):
        bad = torch.nonzero(mask.flatten(1).any(dim=1)).flatten().tolist()
    if bad:
        warnings.warn(
            f"tiles {bad} have missing data, pass a gapfiller value",
            stacklevel=2,
        )
    return tiles


def save_array_to_grid(
    array: np.ndarray,  # (1, H, W) CHW, like the reference contract
    window_bound: Tuple[float, float, float, float],
    outfilepath: str,
    nodataval: float = -2000.0,
    dtype=None,
    save_netcdf: bool = False,
    crs: Optional[str] = None,
    compress: bool = True,
) -> None:
    """Save a (1, H, W) array as GeoTIFF (+ optional NetCDF) — the reference's
    save_array_to_grid (data_prep.py:779-834), GDAL replaced by the native
    codec in ``data.geotiff``."""
    if array.ndim != 3 or array.shape[0] != 1:
        raise ValueError(f"expected a (1, H, W) array, got {array.shape}")
    xmin, ymin, xmax, ymax = window_bound
    h, w = array.shape[1:]
    raster = Raster(
        data=np.asarray(array[0], np.float32),
        left=float(xmin),
        top=float(ymax),
        res=(xmax - xmin) / w,
        crs=crs or EPSG_3031,
        nodata=nodataval,
    )
    out = array[0] if dtype is None else np.asarray(array[0], dtype)
    geotiff.write_geotiff(
        f"{outfilepath}.tif",
        out,
        left=raster.left,
        top=raster.top,
        res=raster.res,
        nodata=nodataval,
        compress=compress,
    )
    if save_netcdf:
        write_netcdf(raster, f"{outfilepath}.nc")

"""Raster abstraction: a plain (H, W) array + georeferencing, and NetCDF I/O.

Counterpart of ``deepbedmap_tpu/data/raster.py`` (``Raster``, ``read_netcdf``,
``write_netcdf``), copied because importing the JAX package loads JAX. Grid
convention: cell centers at x0 + res*(j+0.5), y1 - res*(i+0.5); row 0 is the
top row.

NetCDF-4 files (HDF5-based, what `gmt surface` and xarray write) are read and
written through h5py, imported inside the two functions only: the card's
machine has no h5py, and nothing else of the port needs it. ``read_raster``
reads either format by extension (GeoTIFF through ``data.geotiff``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from deepbedmap_tpu_torch.data import geotiff

EPSG_3031 = (
    "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0 +k=1 +x_0=0 +y_0=0 "
    "+datum=WGS84 +units=m +no_defs"
)  # the reference's hardcoded CRS string (data_prep.py:784)


@dataclasses.dataclass
class Raster:
    data: np.ndarray  # (H, W) float32, NaN = missing
    left: float  # outer x bound of column 0
    top: float  # outer y bound of row 0
    res: float  # square pixel size in CRS units
    crs: str = EPSG_3031
    nodata: Optional[float] = None

    def __post_init__(self):
        if self.data.ndim != 2:
            raise ValueError(f"Raster data must be 2-D, got {self.data.shape}")

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax) outer bounds."""
        return (
            self.left,
            self.top - self.height * self.res,
            self.left + self.width * self.res,
            self.top,
        )

    @property
    def x_centers(self) -> np.ndarray:
        return self.left + self.res * (np.arange(self.width) + 0.5)

    @property
    def y_centers(self) -> np.ndarray:
        return self.top - self.res * (np.arange(self.height) + 0.5)

    def masked(self) -> np.ndarray:
        """Data with nodata turned into NaN."""
        if self.nodata is None:
            return self.data
        out = self.data.astype(np.float32, copy=True)
        out[out == self.nodata] = np.nan
        return out

    def crop(self, bounds: Tuple[float, float, float, float]) -> "Raster":
        """Crop to (xmin, ymin, xmax, ymax), snapped outward to the pixel grid
        and clipped to the raster (``gmt grdcut -R``)."""
        xmin, ymin, xmax, ymax = bounds
        j0 = max(int(np.floor((xmin - self.left) / self.res)), 0)
        j1 = min(int(np.ceil((xmax - self.left) / self.res)), self.width)
        i0 = max(int(np.floor((self.top - ymax) / self.res)), 0)
        i1 = min(int(np.ceil((self.top - ymin) / self.res)), self.height)
        if i0 >= i1 or j0 >= j1:
            raise ValueError(f"crop {bounds} does not intersect {self.bounds}")
        return Raster(
            data=np.ascontiguousarray(self.data[i0:i1, j0:j1]),
            left=self.left + j0 * self.res,
            top=self.top - i0 * self.res,
            res=self.res,
            crs=self.crs,
            nodata=self.nodata,
        )

    @classmethod
    def from_centers(cls, data: np.ndarray, x: np.ndarray, y: np.ndarray, **kw) -> "Raster":
        """Build from cell-center coordinate vectors (xarray-style). ``y`` may
        run in either direction; data is flipped to top-down storage."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        res = float(abs(x[1] - x[0])) if len(x) > 1 else float(abs(y[1] - y[0]))
        data = np.asarray(data)
        if len(y) > 1 and y[1] > y[0]:  # bottom-up -> flip to top-down
            data = data[::-1]
            y = y[::-1]
        return cls(
            data=np.ascontiguousarray(data, np.float32),
            left=float(x[0] - res / 2),
            top=float(y[0] + res / 2),
            res=res,
            **kw,
        )


# --------------------------------------------------------------------------
# NetCDF-4 (HDF5) I/O via h5py: covers xarray/gmt-written .nc grids.
# --------------------------------------------------------------------------

def read_netcdf(
    path: str,
    var: Optional[str] = None,
    bounds: Optional[Tuple[float, float, float, float]] = None,
) -> Raster:
    """Read a 2-D grid from a NetCDF-4 file (z/x/y layout like the
    reference's highres/*.nc gmt-surface outputs).

    ``bounds``: (xmin, ymin, xmax, ymax) window; only the intersecting
    hyperslab is read from disk (h5py reads just those chunks), so a crop of
    a multi-GB grid costs IO proportional to the window. Snap semantics match
    ``Raster.crop`` / `gmt grdcut` (outward to pixel edges, clipped to the
    grid)."""
    import h5py

    with h5py.File(path, "r") as f:
        if var is None:
            candidates = [
                k
                for k, v in f.items()
                if isinstance(v, h5py.Dataset) and v.ndim == 2
            ]
            assert candidates, f"no 2-D variable in {path}: {list(f)}"
            var = candidates[0]
        dset = f[var]
        # coordinate variables per CF: 1-D datasets named like the dims
        dims = [
            (d.label or name)
            for d, name in zip(dset.dims, ("y", "x"))
        ] if dset.dims else ["y", "x"]
        yname = dims[0] or "y"
        xname = dims[1] or "x"
        y = f[yname][...] if yname in f else np.arange(dset.shape[0]) + 0.5
        x = f[xname][...] if xname in f else np.arange(dset.shape[1]) + 0.5
        if bounds is None:
            data = dset[...]
        else:
            xmin, ymin, xmax, ymax = bounds
            res = (
                float(abs(x[1] - x[0])) if len(x) > 1
                else float(abs(y[1] - y[0]))
            )
            jsel = (x + res / 2 > xmin) & (x - res / 2 < xmax)
            isel = (y + res / 2 > ymin) & (y - res / 2 < ymax)
            if not (jsel.any() and isel.any()):
                raise ValueError(f"window {bounds} does not intersect {path}")
            j0, j1 = int(np.argmax(jsel)), len(x) - int(np.argmax(jsel[::-1]))
            i0, i1 = int(np.argmax(isel)), len(y) - int(np.argmax(isel[::-1]))
            data = dset[i0:i1, j0:j1]  # lazy hyperslab read
            x, y = x[j0:j1], y[i0:i1]
        nodata = None
        if "_FillValue" in dset.attrs:
            nodata = float(np.ravel(dset.attrs["_FillValue"])[0])
    return Raster.from_centers(data, x, y, nodata=nodata)


def write_netcdf(raster: Raster, path: str, var: str = "z") -> None:
    """Write a NetCDF-4 grid readable by xarray/GMT (z with y/x coords,
    CF-ish attributes, y descending top-down like the reference outputs)."""
    import h5py

    with h5py.File(path, "w") as f:
        y = f.create_dataset("y", data=raster.y_centers.astype(np.float64))
        x = f.create_dataset("x", data=raster.x_centers.astype(np.float64))
        z = f.create_dataset(var, data=raster.data.astype(np.float32))
        y.make_scale("y")
        x.make_scale("x")
        z.dims[0].attach_scale(y)
        z.dims[1].attach_scale(x)
        z.attrs["crs"] = raster.crs
        if raster.nodata is not None:
            z.attrs["_FillValue"] = np.float32(raster.nodata)
        y.attrs["units"] = "m"
        x.attrs["units"] = "m"


def read_raster(path: str, bounds: Optional[Tuple[float, float, float, float]] = None
                ) -> Raster:
    """Read a grid as a Raster from GeoTIFF (``.tif``/``.tiff``; nodata becomes
    NaN, the continent product is an int16 GeoTIFF, deepbedmap.py:749-756) or
    else NetCDF: the JAX CLI's ``_read_raster_any``.

    ``bounds``: optional (xmin, ymin, xmax, ymax) window; only the
    intersecting blocks (or hyperslab) are read, clipped outward to pixel
    edges."""
    if not path.endswith((".tif", ".tiff")):
        return read_netcdf(path, bounds=bounds)
    if bounds is None:
        data, meta = geotiff.read_geotiff(path)
    else:
        info = geotiff.read_geotiff_meta(path)
        res, left, top = info["res"], info["left"], info["top"]
        xmin, ymin, xmax, ymax = bounds
        data, meta = geotiff.read_geotiff_window(
            path,
            (int(np.floor((top - ymax) / res)), int(np.ceil((top - ymin) / res))),
            (int(np.floor((xmin - left) / res)), int(np.ceil((xmax - left) / res))),
        )
    data = data.astype(np.float32)
    if meta.get("nodata") is not None:
        data = np.where(data == meta["nodata"], np.nan, data)
    return Raster(data, left=meta["left"], top=meta["top"], res=meta["res"])

"""Raster abstraction: a plain (H, W) array + georeferencing.

Counterpart of the ``Raster`` class of ``deepbedmap_tpu/data/raster.py``,
copied because importing the JAX package loads JAX. Grid convention: cell
centers at x0 + res*(j+0.5), y1 - res*(i+0.5); row 0 is the top row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

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

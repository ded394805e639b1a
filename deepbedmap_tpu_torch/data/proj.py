"""Polar stereographic projection (EPSG:4326 <-> EPSG:3031).

A copy of ``deepbedmap_tpu/data/proj.py`` (numpy only), so that the port
loads nothing of the JAX package.

The reference reprojects survey points through pyproj/PROJ
(data_prep.py:322-334); this image has no PROJ, so the framework carries the
Antarctic Polar Stereographic transform itself (Snyder 1987, "Map Projections —
A Working Manual", south polar aspect with standard parallel, eqs. 21-33..36 /
15-9; WGS84 ellipsoid, lat_ts = -71, lon_0 = 0). Vectorised NumPy, host-side.

Conventions (matching PROJ's +proj=stere +lat_0=-90 +lat_ts=-71):
  x = rho * sin(lon - lon_0),  y = rho * cos(lon - lon_0),
with rho >= 0 shrinking to 0 at the South Pole; k = 1 on the -71 parallel.
"""

from __future__ import annotations

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2 - _F)
_E = np.sqrt(_E2)

_LAT_TS = -71.0  # standard parallel (true scale), EPSG:3031
_LON_0 = 0.0


def _t_south(lat_rad):
    """Snyder's isometric-latitude factor for the south aspect: t -> 0 at the
    South Pole, evaluated at the (negative) geodetic latitude."""
    sin_lat = np.sin(lat_rad)
    return np.tan(np.pi / 4 + lat_rad / 2) / (
        (1 + _E * sin_lat) / (1 - _E * sin_lat)
    ) ** (_E / 2)


_LAT_TS_RAD = np.deg2rad(_LAT_TS)
_M_C = np.cos(_LAT_TS_RAD) / np.sqrt(1 - _E2 * np.sin(_LAT_TS_RAD) ** 2)
_T_C = _t_south(_LAT_TS_RAD)


def lonlat_to_xy(lon, lat):
    """EPSG:4326 (degrees) -> EPSG:3031 (metres)."""
    lon = np.asarray(lon, np.float64)
    lat = np.asarray(lat, np.float64)
    lam = np.deg2rad(lon - _LON_0)
    phi = np.deg2rad(lat)

    rho = _A * _M_C * _t_south(phi) / _T_C
    return rho * np.sin(lam), rho * np.cos(lam)


def xy_to_lonlat(x, y):
    """EPSG:3031 (metres) -> EPSG:4326 (degrees)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    rho = np.hypot(x, y)
    t = rho * _T_C / (_A * _M_C)

    # fixed-point iteration for geodetic latitude (south aspect)
    phi = 2 * np.arctan(t) - np.pi / 2
    for _ in range(8):
        sin_phi = np.sin(phi)
        phi = (
            2 * np.arctan(t * ((1 + _E * sin_phi) / (1 - _E * sin_phi)) ** (_E / 2))
            - np.pi / 2
        )
    lam = np.arctan2(x, y)
    return np.rad2deg(lam) + _LON_0, np.rad2deg(phi)


def parallel_radius(lat_deg: float) -> float:
    """True radius of a parallel on the ellipsoid (for scale checks)."""
    phi = np.deg2rad(lat_deg)
    return float(_A * np.cos(phi) / np.sqrt(1 - _E2 * np.sin(phi) ** 2))

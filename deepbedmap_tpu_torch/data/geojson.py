"""GeoJSON ingestion/emission for the tile-filtering step.

A copy of ``deepbedmap_tpu/data/geojson.py`` (json and numpy only).

The reference loads a buffered MultiPolygon grounding line with geopandas and
spatial-joins training tiles ``within`` it, then writes the surviving tile
outlines to ``model/train/tiles_3031.geojson`` plus an EPSG:4326 twin
(data_prep.py:585-615). This module provides the same capability without
GEOS/GDAL: a GeoJSON reader that understands Polygon / MultiPolygon (with
holes) inside Feature / FeatureCollection / GeometryCollection wrappers, an
even-odd + boundary-distance buffered-membership test, and a bbox-polygon
FeatureCollection writer.

Shapefile sources (the reference's MEaSUREs grounding line ships as .shp)
are expected to be converted to GeoJSON host-side (e.g. ``ogr2ogr -f
GeoJSON``); the pipeline consumes the GeoJSON.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from deepbedmap_tpu_torch.data.proj import lonlat_to_xy, xy_to_lonlat
from deepbedmap_tpu_torch.data.windows import (
    Bounds,
    _dist_to_polygon,
    _point_in_polygon,
)


@dataclass(frozen=True)
class PolygonSet:
    """A MultiPolygon: list of (outer_ring, [hole_rings]) in one CRS.

    Rings are (V, 2) float arrays; closure (first == last vertex) optional.
    """

    polygons: Tuple[Tuple[np.ndarray, Tuple[np.ndarray, ...]], ...]

    @property
    def num_polygons(self) -> int:
        return len(self.polygons)

    def contains(self, px: np.ndarray, py: np.ndarray) -> np.ndarray:
        """Even-odd containment; holes excluded (xor across a polygon's rings)."""
        px = np.asarray(px, np.float64)
        py = np.asarray(py, np.float64)
        result = np.zeros(px.shape, bool)
        for outer, holes in self.polygons:
            inside = _point_in_polygon(px, py, outer)
            for hole in holes:
                inside ^= _point_in_polygon(px, py, hole)
            result |= inside
        return result

    def boundary_distance(self, px: np.ndarray, py: np.ndarray) -> np.ndarray:
        """Min distance to any ring boundary (outer or hole)."""
        px = np.asarray(px, np.float64)
        py = np.asarray(py, np.float64)
        d = np.full(px.shape, np.inf)
        for outer, holes in self.polygons:
            d = np.minimum(d, _dist_to_polygon(px, py, outer))
            for hole in holes:
                d = np.minimum(d, _dist_to_polygon(px, py, hole))
        return d

    def contains_buffered(
        self, px: np.ndarray, py: np.ndarray, buffer: float
    ) -> np.ndarray:
        """Membership in the ``buffer``-dilated set: inside, or within
        ``buffer`` of any boundary (matches shapely ``poly.buffer(b)``
        semantics for points: outers dilate, holes erode)."""
        inside = self.contains(px, py)
        outside = ~inside
        if buffer > 0 and outside.any():
            near = np.zeros_like(inside)
            near[outside] = (
                self.boundary_distance(px[outside], py[outside]) <= buffer
            )
            return inside | near
        return inside


def _rings(coords) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    outer = np.asarray(coords[0], np.float64)[:, :2]
    holes = tuple(np.asarray(h, np.float64)[:, :2] for h in coords[1:])
    return outer, holes


def _collect_geometry(geom, out: List) -> None:
    gtype = geom["type"]
    if gtype == "Polygon":
        out.append(_rings(geom["coordinates"]))
    elif gtype == "MultiPolygon":
        for poly in geom["coordinates"]:
            out.append(_rings(poly))
    elif gtype == "GeometryCollection":
        for g in geom["geometries"]:
            _collect_geometry(g, out)
    else:
        raise ValueError(f"unsupported GeoJSON geometry type {gtype!r}")


def load_polygons(source, reproject_lonlat: bool = False) -> PolygonSet:
    """Read Polygon/MultiPolygon geometry from a GeoJSON file path, JSON
    string, or already-parsed dict.

    ``reproject_lonlat=True`` converts EPSG:4326 lon/lat vertices to
    EPSG:3031 metres with the package's polar-stereographic transform.
    """
    if isinstance(source, dict):
        doc = source
    elif isinstance(source, str) and os.path.exists(source):
        with open(source) as f:
            doc = json.load(f)
    else:
        doc = json.loads(source)

    polys: List = []
    dtype = doc.get("type")
    if dtype == "FeatureCollection":
        for feat in doc["features"]:
            _collect_geometry(feat["geometry"], polys)
    elif dtype == "Feature":
        _collect_geometry(doc["geometry"], polys)
    else:
        _collect_geometry(doc, polys)
    assert polys, "no polygons found in GeoJSON source"

    if reproject_lonlat:
        def rp(ring):
            x, y = lonlat_to_xy(ring[:, 0], ring[:, 1])
            return np.stack([x, y], axis=1)

        polys = [(rp(outer), tuple(rp(h) for h in holes)) for outer, holes in polys]

    return PolygonSet(tuple((o, tuple(h)) for o, h in polys))


def filter_within_polygons(
    window_bounds: Sequence[Bounds],
    polygons: PolygonSet,
    buffer: float = 10_000.0,
) -> List[int]:
    """Indices of windows whose four corners all lie within the buffered
    MultiPolygon (reference: 10 km-buffered grounding line sjoin-within,
    data_prep.py:599-607)."""
    wb = np.asarray(window_bounds, np.float64)
    if wb.size == 0:
        return []
    corners_x = wb[:, [0, 0, 2, 2]].ravel()
    corners_y = wb[:, [1, 3, 1, 3]].ravel()
    ok = polygons.contains_buffered(corners_x, corners_y, buffer)
    ok = ok.reshape(-1, 4).all(axis=1)
    return np.nonzero(ok)[0].tolist()


def write_tiles_geojson(
    window_bounds: Sequence[Bounds],
    path: str,
    to_lonlat: bool = False,
) -> None:
    """Write tile bboxes as a GeoJSON FeatureCollection (the reference's
    ``tiles_3031.geojson`` / ``tiles_4326.geojson`` pair, data_prep.py:608-615).

    ``to_lonlat=True`` emits EPSG:4326 vertices (the twin file); otherwise
    vertices stay in projected EPSG:3031 metres.
    """
    features = []
    for i, (xmin, ymin, xmax, ymax) in enumerate(window_bounds):
        ring = [
            (xmin, ymin), (xmax, ymin), (xmax, ymax), (xmin, ymax), (xmin, ymin)
        ]
        if to_lonlat:
            xs = np.asarray([p[0] for p in ring])
            ys = np.asarray([p[1] for p in ring])
            lon, lat = xy_to_lonlat(xs, ys)
            ring = list(zip(lon.tolist(), lat.tolist()))
        features.append(
            {
                "type": "Feature",
                "properties": {"id": i},
                "geometry": {"type": "Polygon", "coordinates": [list(ring)]},
            }
        )
    crs = (
        {"type": "name", "properties": {"name": "urn:ogc:def:crs:OGC:1.3:CRS84"}}
        if to_lonlat
        else {"type": "name", "properties": {"name": "urn:ogc:def:crs:EPSG::3031"}}
    )
    doc = {"type": "FeatureCollection", "crs": crs, "features": features}
    with open(path, "w") as f:
        json.dump(doc, f)

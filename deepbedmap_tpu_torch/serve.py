"""Model serving: a small HTTP inference service over the port's DeepBedMap.

Counterpart of ``deepbedmap_tpu/serve.py`` (stdlib only, threaded):

    GET  /healthz            -> {"status": "ok", "model": {...}}
    POST /predict            {"bounds": [xmin, ymin, xmax, ymax],
                              "rasters": {name: path, ...},      # server-side
                              "out": "path"                       # optional
                             }
                             -> {"out": path, "shape": [...], "bounds": [...]}
                             (writes NetCDF; add "format": "geotiff" for .tif)
    POST /evaluate           {"dem": path, "track": path.csv, "method": ...}
                             -> {"rmse_m": ..., "points": ...}
    POST /dem                {"product": dem.tif, "bounds": [...] |
                              "rows"/"cols": [...], "page": L, "out"?,
                              "values"?: true}
                             -> crop of a finished DEM product via windowed
                             strip/tile reads (overview pages included) —
                             stats + optional file/inline values

Design notes:
- the model lives in the DeepBedMap instance on ``dbm.device``; ``/predict``
  and ``/evaluate`` run there, on the server's worker threads. Requests
  share the device's stream; the forward keeps no state between calls, so
  concurrent requests give the same answers as one at a time;
- rasters are referenced by server-visible path (DEM sources are tens of GB;
  deployments mount the data volume next to the server), read by extension:
  GeoTIFF (``.tif``/``.tiff``) through the port's own codec, anything else
  as NetCDF, which needs ``h5py``. Track files are read without pandas
  (``evalx.read_track_csv``). A machine without h5py serves preloaded
  rasters (``raster_cache``) and GeoTIFF files.

Security model:
- the server binds 127.0.0.1 by default; exposing it wider requires an
  explicit host AND should set ``token`` (bearer auth on every endpoint but
  /healthz);
- every request path (rasters, dem, track, out) must resolve inside
  ``data_root`` (default: the server's working directory) — requests cannot
  probe or write arbitrary server files;
- request bodies are capped at ``max_body_bytes`` (one up to 16x the cap is
  read away before the error answer, so the client gets the answer, not a
  reset connection); predict windows are capped
  at ``max_window_px`` output pixels per side, and the client's crop padding
  likewise.

Start from the CLI: ``python -m deepbedmap_tpu_torch serve --npz W.npz
--port 8500`` — or in-process via ``make_server`` (used by the tests), whose
caller turns TF32 off (``device.disable_tf32``) as ``serve_forever`` does.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.data.raster import Raster, read_raster, write_netcdf
from deepbedmap_tpu_torch.device import disable_tf32
from deepbedmap_tpu_torch.evalx.track import read_track_csv, track_rmse


def make_server(
    dbm,  # api.DeepBedMap
    host: str = "127.0.0.1",
    port: int = 0,
    raster_cache: Optional[dict] = None,
    data_root: Optional[str] = None,
    token: Optional[str] = None,
    max_body_bytes: int = 1 << 20,
    max_window_px: int = 8192,
    cache_entries: int = 16,
    bucket_px: int = 0,
) -> ThreadingHTTPServer:
    """Build (not start) a ThreadingHTTPServer serving ``dbm``.

    ``raster_cache``: optional {name: Raster} preloaded inputs; paths in
    requests fall back to reading the file (GeoTIFF or NetCDF, cached
    thereafter, keyed on (path, mtime) and bounded to ``cache_entries``
    rasters).
    ``data_root``: directory request paths must resolve into (default cwd).
    ``token``: if set, every endpoint except /healthz requires
    ``Authorization: Bearer <token>``.
    ``bucket_px``: if > 0 (multiple of 4), round each predict window up to
    the next power-of-two multiple of this many output pixels per axis and
    slice the result back to the requested bounds, so that windows come in
    O(log^2 max_window_px) shapes. The JAX server needs that to bound its
    compiles, one per window shape; the port compiles nothing per shape, so
    here it only fixes the shapes, at up to 4x the compute on worst-fit
    windows. The served rasters must cover the bucketed (expanded
    east/south) window, else the expansion area is gap-filled.
    """
    if bucket_px and (bucket_px < 4 or bucket_px % 4):
        # output px come 4-per-lowres-px (250 m vs 1000 m grids): buckets
        # must stay aligned to the 1000 m input grid
        raise ValueError(f"bucket_px must be a multiple of 4, got {bucket_px}")

    root = os.path.realpath(data_root or os.getcwd())
    preloaded = dict(raster_cache or {})
    cache: dict = {}  # (path, mtime) -> Raster, insertion-ordered
    cache_lock = threading.Lock()

    def resolve(path: str) -> str:
        """Confine a request path to data_root (realpath => symlink-safe)."""
        real = os.path.realpath(os.path.join(root, path))
        if os.path.commonpath([real, root]) != root:
            raise PermissionError(f"path escapes data root: {path}")
        return real

    def get_raster(path: str) -> Raster:
        if path in preloaded:  # named preloads need no disk access
            return preloaded[path]
        real = resolve(path)
        key = (real, os.stat(real).st_mtime_ns)
        with cache_lock:
            if key in cache:
                return cache[key]
        raster = read_raster(real)
        with cache_lock:
            # drop stale entries for the same path, then bound the cache
            for k in [k for k in cache if k[0] == real]:
                del cache[k]
            while len(cache) >= cache_entries:
                del cache[next(iter(cache))]
            cache[key] = raster
        return raster

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            if n < 0 or n > max_body_bytes:
                # negative Content-Length would make rfile.read(n) read to
                # EOF, defeating the cap — reject it alongside oversize bodies
                if n <= 16 * max_body_bytes:
                    self._discard(n)
                raise ValueError(f"request body {n} B > {max_body_bytes} B cap")
            return json.loads(self.rfile.read(n)) if n else {}

        def _discard(self, n: int) -> None:
            """Read ``n`` bytes of an oversize body away in 64 KiB chunks:
            closing on unread data resets the connection, and a client
            still sending would get a broken pipe instead of the answer."""
            while n > 0:
                chunk = self.rfile.read(min(n, 1 << 16))
                if not chunk:
                    return
                n -= len(chunk)

        def _authorized(self) -> bool:
            if token is None:
                return True
            return self.headers.get("Authorization") == f"Bearer {token}"

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(
                    {
                        "status": "ok",
                        "model": {
                            "num_residual_blocks": dbm.cfg.num_residual_blocks,
                            "residual_scaling": dbm.cfg.residual_scaling,
                            "resolution": dbm.resolution,
                            "device": str(dbm.device),
                        },
                    }
                )
            self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                if not self._authorized():
                    return self._json({"error": "unauthorized"}, 401)
                req = self._body()
                if self.path == "/predict":
                    return self._predict(req)
                if self.path == "/evaluate":
                    return self._evaluate(req)
                if self.path == "/dem":
                    return self._dem(req)
                self._json({"error": "not found"}, 404)
            except PermissionError as e:
                self._json({"error": f"{type(e).__name__}: {e}"}, 403)
            except Exception as e:  # surface the failure to the client
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        def _predict(self, req):
            bounds = tuple(float(v) for v in req["bounds"])
            xmin, ymin, xmax, ymax = bounds
            px = max(xmax - xmin, ymax - ymin) / dbm.resolution
            if px > max_window_px:
                raise ValueError(
                    f"window {px:.0f} px exceeds max_window_px={max_window_px}"
                )
            # cap the client-supplied crop padding too — otherwise it re-opens
            # the resource hole max_window_px closes (padding enlarges every
            # raster crop by 2*padding/res px per side)
            padding = float(req.get("padding", 1000.0))
            max_padding = max_window_px * dbm.resolution
            if not (0.0 <= padding <= max_padding):
                raise ValueError(
                    f"padding {padding} m outside [0, {max_padding}] m cap"
                )
            rasters = {k: get_raster(v) for k, v in req["rasters"].items()}
            if bucket_px:
                dem = self._predict_bucketed(bounds, rasters, padding)
            else:
                dem = dbm.predict(bounds, rasters, padding=padding)
            out = req.get("out")
            result = {"shape": list(dem.data.shape), "bounds": list(bounds)}
            if out:
                out_real = resolve(out)
                if req.get("format") == "geotiff":
                    geotiff.write_geotiff(
                        out_real, dem.data, dem.left, dem.top, dem.res,
                        nodata=-2000.0, compress=True,
                    )
                else:
                    write_netcdf(dem, out_real)
                result["out"] = out
            return self._json(result)

        def _predict_bucketed(self, bounds, rasters, padding):
            """Round the window up to the next power-of-two multiple of
            ``bucket_px`` output pixels per axis (expanding east/south so the
            origin is unchanged), predict, and slice back to the requested
            pixels."""
            xmin, ymin, xmax, ymax = bounds
            res = dbm.resolution
            w_px = max(1, int(round((xmax - xmin) / res)))
            h_px = max(1, int(round((ymax - ymin) / res)))

            def up(n: int) -> int:
                b = bucket_px
                while b < n:
                    b *= 2
                return b

            bw, bh = up(w_px), up(h_px)
            big = dbm.predict(
                (xmin, ymax - bh * res, xmin + bw * res, ymax),
                rasters,
                padding=padding,
            )
            return Raster(
                np.ascontiguousarray(big.data[:h_px, :w_px]),
                left=xmin, top=ymax, res=res,
            )

        def _dem(self, req):
            """Serve a crop of a finished DEM product (the continent GeoTIFF)
            through windowed strip/tile reads — only the intersecting blocks
            decode.

            {"product": "dem.tif",
             "bounds": [xmin, ymin, xmax, ymax]  # EPSG:3031 m, OR
             "rows": [r0, r1], "cols": [c0, c1], # pixel window (half-open)
             "page": L,                          # overview level, default 0
             "out": "crop.nc",                   # optional; "format": "geotiff"
             "values": true}                     # inline data (small windows)
            """
            real = resolve(req["product"])
            page = int(req.get("page", 0))
            info = geotiff.read_geotiff_meta(real, page)
            res, left, top = info["res"], info["left"], info["top"]
            if "bounds" in req:
                if res is None:
                    raise ValueError("product has no georeferencing")
                xmin, ymin, xmax, ymax = (float(v) for v in req["bounds"])
                c0 = int(np.floor((xmin - left) / res))
                c1 = int(np.ceil((xmax - left) / res))
                r0 = int(np.floor((top - ymax) / res))
                r1 = int(np.ceil((top - ymin) / res))
            else:
                r0, r1 = (int(v) for v in req["rows"])
                c0, c1 = (
                    (int(v) for v in req["cols"])
                    if "cols" in req else (0, info["width"])
                )
            r0, r1 = max(0, r0), min(info["height"], r1)
            c0, c1 = max(0, c0), min(info["width"], c1)
            if max(r1 - r0, c1 - c0) > max_window_px:
                raise ValueError(
                    f"window {r1 - r0}x{c1 - c0} px exceeds "
                    f"max_window_px={max_window_px}"
                )
            arr, meta = geotiff.read_geotiff_window(
                real, (r0, r1), (c0, c1), page=page
            )
            data = arr.astype(np.float32)
            if meta["nodata"] is not None:
                data = np.where(data == meta["nodata"], np.nan, data)
            valid = np.isfinite(data)
            result = {
                "shape": list(arr.shape),
                "left": meta["left"], "top": meta["top"], "res": meta["res"],
                "page": page,
                "stats": {
                    "valid_pct": round(float(valid.mean()) * 100, 2),
                    "min": float(np.nanmin(data)) if valid.any() else None,
                    "max": float(np.nanmax(data)) if valid.any() else None,
                    "mean": float(np.nanmean(data)) if valid.any() else None,
                },
            }
            out = req.get("out")
            if out:
                out_real = resolve(out)
                if req.get("format") == "geotiff":
                    geotiff.write_geotiff(
                        out_real, arr, meta["left"], meta["top"], meta["res"],
                        nodata=meta["nodata"], compress=True,
                    )
                else:
                    write_netcdf(
                        Raster(data, left=meta["left"], top=meta["top"],
                               res=meta["res"]),
                        out_real,
                    )
                result["out"] = out
            if req.get("values"):
                if arr.size > 65536:
                    raise ValueError(
                        f"values requested for {arr.size} px window "
                        "(inline cap 65536); use 'out' instead"
                    )
                result["values"] = [
                    [None if not np.isfinite(v) else float(v) for v in row]
                    for row in data
                ]
            return self._json(result)

        def _evaluate(self, req):
            dem = get_raster(req["dem"])
            x, y, z = read_track_csv(resolve(req["track"]))
            rmse = track_rmse(dem, x, y, z, method=req.get("method", "bicubic"),
                              device=dbm.device)
            return self._json({"rmse_m": float(rmse), "points": int(len(x))})

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(
    dbm,
    host: str = "127.0.0.1",
    port: int = 8500,
    data_root: Optional[str] = None,
    token: Optional[str] = None,
    bucket_px: int = 0,
) -> None:
    """Serve ``dbm`` until interrupted, in fp32 (``device.disable_tf32``).
    The JAX server first turns on JAX's persistent compilation cache; the
    port has nothing to compile per request shape, and its CUDA kernels and
    TIFF codec are built once into ``build/`` and reused across restarts, so
    there is no counterpart."""
    disable_tf32()
    server = make_server(
        dbm, host, port, data_root=data_root, token=token, bucket_px=bucket_px
    )
    print(f"serving DeepBedMap on {host}:{server.server_port} ({dbm.device})",
          flush=True)
    server.serve_forever()

"""Whole-continent inference: row-band streaming around the tiled engine.

Counterpart of ``deepbedmap_tpu/inference/continent.py``: one device
(``predict_continent``), a mesh of ranks (``predict_continent_sharded``, each
band's tiles split over the mesh by ``parallel.sharded_predict_tiles``), the
streamed GeoTIFF product ``predict_continent_to_geotiff`` on either, and the
buffered ``save_continent_dem``; ``inference.multihost`` splits the bands
over processes instead. On a mesh every rank holds the whole host rasters,
as JAX's single-host mesh path does, and every rank computes. The
full-resolution conditioning rasters stay on the host as numpy arrays; one
row band of tiles at a time moves to the device with its vertical halo taken
from the neighbouring bands' real rows, so band-streamed output equals the
whole-region engine. Only a band's real rows leave the host; its edge rows
are the engine's edge padding, made on the device, and the conditioning
rasters are clipped to >= 0 on the device (deepbedmap.py:663-665).
The int16 LZW GeoTIFF goes through ``data.geotiff`` and its native codec.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.inference.engine import INPUT_RATIOS, TilePlan, pad_edge
from deepbedmap_tpu_torch.utils.profiling import count, recording, span


def _make_band_predictor(
    forward_fn: Callable[..., torch.Tensor],
    plan: TilePlan,
    clip_conditioning: bool,
    tile_loop: str = "scan",
    tiles_per_dispatch: int = 1,
):
    """(band inputs with vertical halo) -> (tile_out, out_w) strip on the device.

    The band's tiles run in a host loop, ``tiles_per_dispatch`` of them stacked
    on the batch dim per forward. ``tile_loop`` is accepted for the JAX
    signature: 'scan' and 'host' are the same loop here. A trailing remainder
    group clamps its tile indices to the last tile (recomputing it into the
    same strip slot), so any grid width works.
    """
    if tile_loop not in ("scan", "host"):
        raise ValueError(f"tile_loop must be 'scan' or 'host', got {tile_loop!r}")
    if tiles_per_dispatch < 1:
        raise ValueError(f"tiles_per_dispatch must be >= 1, got {tiles_per_dispatch}")
    gx = plan.grid[1]
    b = tiles_per_dispatch
    t_out = plan.tile_out

    def prep(band_inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        padded = {}
        for key, ratio in INPUT_RATIOS.items():
            a = band_inputs[key]
            if clip_conditioning and key != "X":
                a = a.clamp_min(0.0)
            # horizontal halo: edge padding; the vertical halo is in the band
            p = plan.pad_lr * ratio
            padded[key] = pad_edge(a, 0, 0, p, p)
        return padded

    def tile_group(padded: Dict[str, torch.Tensor], txs) -> torch.Tensor:
        crops = {}
        for key, ratio in INPUT_RATIOS.items():
            size, step = plan.crop_lr * ratio, plan.tile_lr * ratio
            crops[key] = torch.cat(
                [padded[key][:, :, t * step : t * step + size] for t in txs]
            )
        pred = forward_fn(crops["X"], crops["W1"], crops["W2"], crops["W3"])
        d = plan.discard_hr
        return pred[:, d : pred.shape[1] - d, d : pred.shape[2] - d, 0]

    def band_predict(band_inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        count("continent.tiles", gx)
        with span("continent.dispatch"):
            padded = prep(band_inputs)
            strip = torch.zeros((t_out, plan.out_w), device=band_inputs["X"].device)
            for g in range(-(-gx // b)):
                txs = [min(g * b + i, gx - 1) for i in range(b)]
                preds = tile_group(padded, txs)
                for i, tx in enumerate(txs):
                    strip[:, tx * t_out : (tx + 1) * t_out] = preds[i]
        return strip

    return band_predict


def _run_band_pipeline(
    dispatch: Callable[[Dict[str, np.ndarray], int], object],
    fetch: Callable[[object], np.ndarray],
    inputs_host: Dict[str, np.ndarray],
    gy: int,
    consume: Callable[[int, np.ndarray], None],
    progress: Optional[Callable[[int, int], None]],
    prefetch: int,
) -> None:
    """Band loop that dispatches ``prefetch`` bands ahead of the blocking
    fetch; ``prefetch=0`` is the strict serial loop. On a card nothing in a
    dispatch waits for the card: ``_band_inputs`` copies a band's real rows
    on an upload stream and the current stream waits on their event, and
    the single-device fetch (``_StripDownloads``) copies each strip on a
    download stream once the band's launches are issued, so a fetch waits
    for its own band alone. One loop is the telemetry's ``continent.pass``:
    per band ``continent.fetch`` and ``continent.consume`` here, the slice,
    upload and dispatch spans inside ``dispatch``."""
    pending: deque = deque()

    def drain_one():
        band, fut = pending.popleft()
        with span("continent.fetch"):
            strip = fetch(fut)
        with span("continent.consume"):
            consume(band, strip)
        if progress is not None:
            progress(band + 1, gy)

    with span("continent.pass", range=False):
        for band in range(gy):
            count("continent.bands")
            pending.append((band, dispatch(inputs_host, band)))
            while len(pending) > max(prefetch, 0):
                drain_one()
        while pending:
            drain_one()


class _UploadRing:
    """The state of ``_band_inputs`` on a CUDA device: the upload stream and
    a ring of ``slots`` device buffers for the bands' real rows (per raster
    NCHW, allocated at a slot's first use). A slot is written again only
    after the event recorded on the current stream once its last band was
    read out of it; the upload stream waits on that event alone, never on
    the current stream's queue."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [None] * max(slots, 1)
        self.calls = 0

    def take(self, shapes: Dict[str, Tuple[int, ...]]
             ) -> Tuple[Dict[str, torch.Tensor], "torch.cuda.Event"]:
        """The next slot (at its first use, a float32 buffer of each
        raster's shape): its buffers, and the event after which they may be
        written."""
        i = self.calls % len(self.slots)
        self.calls += 1
        if self.slots[i] is None:
            bufs = {k: torch.empty(s, dtype=torch.float32, device=self.device)
                    for k, s in shapes.items()}
            # new buffers' memory may have served work still queued on the
            # current stream: their first writer waits for it
            self.slots[i] = (bufs, torch.cuda.current_stream(self.device).record_event())
        return self.slots[i]

    def release(self) -> None:
        """The slot last taken has been read out on the current stream."""
        i = (self.calls - 1) % len(self.slots)
        self.slots[i] = (self.slots[i][0],
                         torch.cuda.current_stream(self.device).record_event())


def _page_locked(plane: torch.Tensor, pinned: bool) -> torch.Tensor:
    """``plane`` where it is a page-locked contiguous float32 block, else its
    copy in a staging buffer from torch's page-locked cache (which does not
    hand the buffer out again before the copy out of it is done)."""
    if pinned and plane.dtype == torch.float32 and plane.is_contiguous():
        return plane
    return torch.empty(plane.shape, dtype=torch.float32, pin_memory=True).copy_(plane)


def _band_inputs(
    inputs_host: Dict[str, np.ndarray], plan: TilePlan, band: int, device="cuda",
    ring: Optional[_UploadRing] = None,
) -> Dict[str, torch.Tensor]:
    """One vertical-halo'd row band of the host rasters on ``device``: per
    raster NHWC float32, edge-padded at the region's borders. Only the rows
    that exist leave the host, as views of the caller's arrays; the edge
    rows are replicated and each raster put channel-last on the device.

    On a CUDA device each raster's channel planes are copied without a host
    wait on ``ring``'s upload stream (a one-slot ring of this call's own
    when none is given), from the caller's memory where it is page-locked,
    else once through a page-locked staging buffer; the current stream
    waits on the copies' event, so every caller reads the band in stream
    order. On the CPU the padding runs on views of the host arrays.

    Telemetry per raster: ``continent.slice`` (the cut of views and any
    staging copy), ``continent.upload`` (issuing the copies and the device
    side's padding), the bytes sent in ``continent.upload_bytes.pinned`` or
    ``.pageable`` by their source, and the copy in ``continent.copies.async``
    (on a side stream) or ``continent.copies.sync``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    lh, lw = plan.lr_shape
    r0 = band * plan.tile_lr - plan.pad_lr
    r1 = (band + 1) * plan.tile_lr + plan.pad_lr
    shapes = {}  # of the device buffers: NCHW, the band's rows with their halo
    for key, ratio in INPUT_RATIOS.items():
        n, h, w, c = inputs_host[key].shape
        if h != ratio * lh or w != ratio * lw:
            raise ValueError(f"{key}: shape {inputs_host[key].shape}, expected "
                             f"{(ratio * lh, ratio * lw)} spatially")
        shapes[key] = (n, c, (r1 - r0) * ratio, w)
    if cuda:
        ring = ring if ring is not None else _UploadRing(device, 1)
        bufs, writable = ring.take(shapes)
        ring.stream.wait_event(writable)
        current = torch.cuda.current_stream(device)
    out = {}
    for key, ratio in INPUT_RATIOS.items():
        lo, hi = max(0, r0 * ratio), min(ratio * lh, r1 * ratio)
        with span("continent.slice"):
            # (N, C, rows, W): each channel's rows are one block of an NCHW
            # caller's memory (api.py hands the loop NHWC views of NCHW)
            sl = np.asarray(inputs_host[key][:, lo:hi])
            if min(sl.strides) < 0:  # torch has no negative strides
                sl = np.ascontiguousarray(sl)
            real = torch.as_tensor(sl).permute(0, 3, 1, 2)
            pinned = (cuda or recording()) and real.is_pinned()
            if cuda:
                planes = {(n, c): _page_locked(real[n, c], pinned)
                          for n in range(real.shape[0]) for c in range(real.shape[1])}
        with span("continent.upload"):
            if cuda:
                buf = bufs[key]
                with torch.cuda.stream(ring.stream):
                    for (n, c), p in planes.items():
                        buf[n, c, : hi - lo].copy_(p, non_blocking=True)
                    copied = ring.stream.record_event()
                current.wait_event(copied)
                real = buf[:, :, : hi - lo]
            out[key] = pad_edge(real.permute(0, 2, 3, 1).float(), lo - r0 * ratio,
                                r1 * ratio - hi, 0, 0).contiguous()
        count("continent.copies." + ("async" if cuda else "sync"))
        if recording():
            count("continent.upload_bytes." + ("pinned" if pinned else "pageable"),
                  4 * real.numel())
    if cuda:
        ring.release()
    return out


class _StripDownloads:
    """The single-device fetch. On a CUDA device ``start`` records an event
    on the current stream once a band's launches are issued; a download
    stream waits on it alone and copies the strip into a page-locked buffer
    of its own from torch's caching allocator, and ``fetch`` waits on that
    copy's event only (``continent.fetch.waited`` counts the bands whose
    copy was not done when asked). Every strip owns its buffer, so a
    consumer may hold it as long as it likes (the product's writer queue).
    On the CPU the strip is the result."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def start(self, strip: torch.Tensor):
        if self.stream is None:
            count("continent.copies.sync")
            return strip, None, None
        host = torch.empty(strip.shape, dtype=strip.dtype, pin_memory=True)
        launched = torch.cuda.current_stream(self.device).record_event()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(launched)
            host.copy_(strip, non_blocking=True)
            done = self.stream.record_event()
        count("continent.copies.async")
        # the device strip stays referenced until its copy has been waited on
        return strip, host, done

    def fetch(self, pending) -> np.ndarray:
        strip, host, done = pending
        if done is None:
            return strip.numpy()
        if not done.query():
            count("continent.fetch.waited")
        done.synchronize()
        return host.numpy()


def _make_band_pipeline(
    forward_fn: Callable[..., torch.Tensor],
    plan: TilePlan,
    clip_conditioning: bool,
    tile_loop: str,
    tiles_per_dispatch: int,
    device,
    prefetch: int,
):
    """(dispatch, fetch) of the single-device band loop on ``device`` (see
    ``device.resolve_device``): each band's upload into a ring of
    ``prefetch + 1`` slots, its tiles, its strip's download."""
    band_predict = _make_band_predictor(
        forward_fn, plan, clip_conditioning, tile_loop=tile_loop,
        tiles_per_dispatch=tiles_per_dispatch,
    )
    device = resolve_device(device)
    ring = _UploadRing(device, max(prefetch, 0) + 1) if device.type == "cuda" else None
    downloads = _StripDownloads(device)

    def dispatch(inputs_host: Dict[str, np.ndarray], band: int):
        return downloads.start(band_predict(_band_inputs(inputs_host, plan, band, device,
                                                         ring)))

    return dispatch, downloads.fetch


def predict_continent(
    forward_fn: Callable[..., torch.Tensor],
    inputs_host: Dict[str, np.ndarray],  # NHWC numpy, full region, unpadded
    plan: TilePlan,
    clip_conditioning: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    tile_loop: str = "scan",
    prefetch: int = 1,
    tiles_per_dispatch: int = 2,
    device="cuda",
) -> np.ndarray:
    """Predict the full (out_h, out_w) DEM band by band on ``device`` (the
    card unless the caller asks for the CPU; see ``device.resolve_device``);
    returns the host canvas (float32)."""
    gy, _ = plan.grid
    dispatch, fetch = _make_band_pipeline(forward_fn, plan, clip_conditioning, tile_loop,
                                          tiles_per_dispatch, device, prefetch)
    canvas = np.empty((plan.out_h, plan.out_w), np.float32)

    def consume(band: int, strip: np.ndarray) -> None:
        canvas[band * plan.tile_out : (band + 1) * plan.tile_out] = strip

    _run_band_pipeline(dispatch, fetch, inputs_host, gy, consume, progress, prefetch)
    return canvas


def _make_sharded_band_pipeline(
    forward_fn: Callable[..., torch.Tensor],
    plan: TilePlan,
    mesh,
    clip_conditioning: bool,
    tiles_per_dispatch: int = 1,
):
    """(dispatch, fetch) for one mesh-sharded row band: ``dispatch`` slices
    the band off the host rasters onto this rank's device and predicts its
    tiles over the mesh (returns the (gx, T, T) tiles on the device);
    ``fetch`` copies them back as the (tile_out, out_w) host strip. Shared by
    the buffered (``predict_continent_sharded``), streamed
    (``predict_continent_to_geotiff`` with ``mesh``) and multi-process
    (``inference.multihost``, through ``dispatch.dispatch_band``) paths, so
    their band geometry and numerics cannot diverge."""
    from deepbedmap_tpu_torch.parallel.api import sharded_predict_tiles
    from deepbedmap_tpu_torch.parallel.mesh import mesh_device

    device = mesh_device(mesh)
    gx = plan.grid[1]
    band_plan = TilePlan(out_h=plan.tile_out, out_w=plan.out_w, tile_out=plan.tile_out,
                         halo_lr=plan.halo_lr, scale=plan.scale)

    def dispatch_band(band_inputs) -> torch.Tensor:
        """Predict ONE halo'd band (numpy or tensors, NHWC) over the mesh."""
        count("continent.tiles", gx)
        with span("continent.dispatch"):
            prepped = {}
            for key, ratio in INPUT_RATIOS.items():
                a = torch.as_tensor(band_inputs[key], dtype=torch.float32).to(device)
                if clip_conditioning and key != "X":
                    a = a.clamp_min(0.0)
                # horizontal halo: edge padding; the vertical halo rows are
                # real data from _band_inputs
                p = band_plan.pad_lr * ratio
                prepped[key] = pad_edge(a, 0, 0, p, p)
            tiles = sharded_predict_tiles(forward_fn, prepped, band_plan, mesh,
                                          prepadded=True, tiles_per_dispatch=tiles_per_dispatch)
        if tiles.shape != (gx, plan.tile_out, plan.tile_out):
            raise AssertionError(f"band tiles {tuple(tiles.shape)}")
        return tiles

    def dispatch(inputs_host: Dict[str, np.ndarray], band: int) -> torch.Tensor:
        return dispatch_band(_band_inputs(inputs_host, plan, band, device))

    dispatch.dispatch_band = dispatch_band

    def fetch(tiles: torch.Tensor) -> np.ndarray:
        return tiles.cpu().numpy().transpose(1, 0, 2).reshape(plan.tile_out, plan.out_w)

    return dispatch, fetch


def _make_sharded_band_strip(
    forward_fn: Callable[..., torch.Tensor],
    plan: TilePlan,
    mesh,
    clip_conditioning: bool,
) -> Callable[[Dict[str, np.ndarray], int], np.ndarray]:
    """(inputs_host, band) -> (tile_out, out_w) strip: the blocking form of
    ``_make_sharded_band_pipeline``, for callers that want one band now."""
    dispatch, fetch = _make_sharded_band_pipeline(forward_fn, plan, mesh, clip_conditioning)
    return lambda inputs_host, band: fetch(dispatch(inputs_host, band))


def predict_continent_sharded(
    forward_fn: Callable[..., torch.Tensor],
    inputs_host: Dict[str, np.ndarray],
    plan: TilePlan,
    mesh,
    clip_conditioning: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    prefetch: int = 1,
    tiles_per_dispatch: int = 1,
) -> np.ndarray:
    """Band streaming x mesh-sharded tiles, on every rank of ``mesh`` (a
    ``parallel.make_mesh`` mesh; every rank calls it with the same host
    rasters): each band moves to every rank's device with its real vertical
    halo, and its tiles are split over the ranks
    (``parallel.sharded_predict_tiles``). Every rank returns the whole
    canvas. ``prefetch``: bands dispatched ahead of the blocking fetch."""
    gy, _ = plan.grid
    dispatch, fetch = _make_sharded_band_pipeline(
        forward_fn, plan, mesh, clip_conditioning, tiles_per_dispatch=tiles_per_dispatch
    )
    canvas = np.empty((plan.out_h, plan.out_w), np.float32)

    def consume(band: int, strip: np.ndarray) -> None:
        canvas[band * plan.tile_out : (band + 1) * plan.tile_out] = strip

    _run_band_pipeline(dispatch, fetch, inputs_host, gy, consume, progress, prefetch)
    return canvas


def predict_continent_to_geotiff(
    forward_fn: Callable[..., torch.Tensor],
    inputs_host: Dict[str, np.ndarray],
    plan: TilePlan,
    bounds: Tuple[float, float, float, float],  # (xmin, ymin, xmax, ymax)
    outfilepath: str,
    clip_conditioning: bool = True,
    nodataval: float = -2000.0,
    compress: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    tile_loop: str = "scan",
    rows_per_strip: Optional[int] = None,
    prefetch: int = 1,
    overviews: int = 0,
    predictor: bool = False,
    tiles_per_dispatch: int = 2,
    device="cuda",
    mesh=None,
) -> Optional[str]:
    """Band-streamed inference on ``device`` piped straight into the int16
    LZW GeoTIFF ``{outfilepath}.tif``; returns its path.

    ``mesh``: split each band's tiles over the ranks of a
    ``parallel.make_mesh`` mesh, on the mesh's devices (``device`` is then
    unused); every rank computes, only the mesh's first rank writes and
    returns the path, the others return None. The strips equal
    ``predict_continent_sharded``'s canvas rows.

    A writer thread LZW-encodes and writes band strip i while the device
    computes band i+1 (the native LZW call and the main thread's wait on a
    strip's download release the GIL); what the writer has left when the
    band loop ends, at least the last band and with ``overviews`` the
    pyramid's pages, is paid after it.
    On an H100 host (8 cores, 3 x 3 tiles of 1000^2) the streamed product
    took 4-10% less time per tile than the buffered one with the same
    single-page output, and ~10% more with 2 overview pages and
    PREDICTOR=2, which cost ~0.2 s of host writing. Peak host memory is two
    strips instead of the full canvas. The reference computes everything,
    then pays the full write afterwards (deepbedmap.py:744-756).

    ``rows_per_strip``: TIFF strip height. Default (None) picks ~8 uniform
    sub-strips per band so each band LZW-encodes on ~8 native threads;
    0 = one strip per band.

    ``prefetch``: bands dispatched ahead of the blocking fetch (see
    ``_run_band_pipeline``). 0 = serial.

    ``overviews``: 2x pyramid levels appended as chained TIFF pages, built
    incrementally from the strips (nodata-aware block means; the
    gdaladdo -r average convention) — see ``GeoTiffStripWriter``.

    ``predictor``: TIFF PREDICTOR=2 horizontal differencing before the LZW.
    Data-dependent: smaller on smooth fields, slightly larger when the bed
    roughness approaches white noise at the 250 m posting.

    A failure in the forward or in the writer thread removes the partial
    file and re-raises in the caller.
    """
    gy, _ = plan.grid
    if rows_per_strip is None:
        for d in (8, 10, 5, 4, 2):
            if plan.tile_out % d == 0:
                rows_per_strip = plan.tile_out // d
                break
        else:
            rows_per_strip = 0  # no uniform divisor: one strip per band
    if mesh is not None:
        from deepbedmap_tpu_torch.parallel.mesh import mesh_rank

        dispatch, fetch = _make_sharded_band_pipeline(
            forward_fn, plan, mesh, clip_conditioning, tiles_per_dispatch=tiles_per_dispatch
        )
        if mesh_rank(mesh) != 0:
            _run_band_pipeline(dispatch, fetch, inputs_host, gy,
                               lambda band, strip: None, None, prefetch)
            return None
    else:
        dispatch, fetch = _make_band_pipeline(forward_fn, plan, clip_conditioning, tile_loop,
                                              tiles_per_dispatch, device, prefetch)
    tw = _ThreadedStripWriter(
        outfilepath, plan, bounds, nodataval, compress,
        rows_per_strip or None, overviews, predictor,
    )
    try:
        _run_band_pipeline(
            dispatch, fetch, inputs_host, gy, lambda band, strip: tw.put(strip), progress,
            prefetch,
        )
        tw.close()
    except BaseException:
        tw.abort()
        raise
    return tw.path


class _ThreadedStripWriter:
    """``GeoTiffStripWriter`` fed from a drain thread, so that the LZW encode
    overlaps the device's next band. ``put`` re-raises any pending
    writer-thread error; ``abort`` leaves no open handle and no partial
    product behind."""

    def __init__(
        self, outfilepath, plan, bounds, nodataval, compress,
        rows_per_strip, overviews, predictor,
    ):
        xmin, ymin, xmax, ymax = bounds
        self.path = f"{outfilepath}.tif"
        self._writer = geotiff.GeoTiffStripWriter(
            self.path,
            height=plan.out_h,
            width=plan.out_w,
            left=xmin,
            top=ymax,
            res=(xmax - xmin) / plan.out_w,
            dtype=np.int16,
            nodata=nodataval,
            compress=compress,
            rows_per_strip=rows_per_strip,
            overviews=overviews,
            predictor=predictor,
        )
        self._strips: queue.Queue = queue.Queue(maxsize=2)
        self._error: list = []
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        failed = False
        while True:
            strip = self._strips.get()
            if strip is None:
                return
            if failed:
                continue  # keep consuming so the producer's put() never blocks
            try:
                self._writer.write_strip(strip)
            except Exception as e:  # surface in the producer thread
                self._error.append(e)
                failed = True

    def put(self, strip: np.ndarray) -> None:
        if self._error:
            raise self._error[0]
        self._strips.put(strip)

    def _join(self):
        self._strips.put(None)
        self._thread.join()

    def close(self) -> None:
        self._join()
        if self._error:
            # the file is partial: the caller's except path calls abort()
            raise self._error[0]
        self._writer.close()

    def abort(self) -> None:
        self._join()
        self._writer.abort()


def save_continent_dem(
    canvas: np.ndarray,
    bounds: Tuple[float, float, float, float],  # (xmin, ymin, xmax, ymax)
    outfilepath: str,
    nodataval: float = -2000.0,
) -> None:
    """int16 + LZW + tiled GeoTIFF ``{outfilepath}.tif``, like the
    reference's final product (deepbedmap.py:749-756)."""
    xmin, ymin, xmax, ymax = bounds
    h, w = canvas.shape
    out = np.where(np.isfinite(canvas), canvas, nodataval).astype(np.int16)
    geotiff.write_geotiff(
        f"{outfilepath}.tif",
        out,
        left=xmin,
        top=ymax,
        res=(xmax - xmin) / w,
        nodata=nodataval,
        compress=True,
        tiled=True,
    )

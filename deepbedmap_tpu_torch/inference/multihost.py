"""Continent inference with the row bands distributed over processes.

Counterpart of ``deepbedmap_tpu/inference/multihost.py``. JAX runs one
process per host of a pod, each driving its host's chips; the port runs one
process per card (``parallel.distributed.initialize``), and this is the path
in which a process reads only its own bands:

- **bands -> processes, round-interleaved**: band ``b`` belongs to rank
  ``b % P``. In round ``r`` the P ranks compute the contiguous band group
  ``r*P .. r*P+P-1``, a rank past the grid's last band a zero dummy strip,
  and one stacked ``all_gather`` per round hands rank 0 the next in-order
  strips, which the streamed GeoTIFF writer needs.
- **tiles -> the process's own mesh**: a rank predicts its band on its own
  card, or over a ``mesh`` that must hold no rank but the caller (JAX's
  process-local mesh; bands are what is distributed here). Vertical halos
  are real neighbour rows, so the output equals the single-process paths.
- **data stays process-local**: ``band_source`` may be a callable
  ``band -> {X, W1, W2, W3}`` of halo-extended NHWC rows (numpy or
  tensors), so each rank reads only its own bands; a dict of the whole
  rasters is sliced with the shared band geometry
  (``continent._band_inputs``).

An exception on any rank leaves its peers waiting in the next
``all_gather`` until the group's timeout raises there. With world size 1
(no group, or a one-rank group) this is the single-device path, with no
collective.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.inference.continent import (
    _band_inputs,
    _make_band_predictor,
    _make_sharded_band_pipeline,
    _ThreadedStripWriter,
)
from deepbedmap_tpu_torch.inference.engine import TilePlan
from deepbedmap_tpu_torch.parallel.distributed import process_count, process_index

BandSource = Union[Dict[str, np.ndarray], Callable[[int], Dict[str, np.ndarray]]]


def _make_local_strip_fn(
    forward_fn, plan: TilePlan, mesh, clip_conditioning: bool, tile_loop: str, device
) -> Callable[[Dict[str, np.ndarray]], torch.Tensor]:
    """band inputs (halo'd NHWC dict) -> (tile_out, out_w) strip on this
    rank's device: over ``mesh`` (which must hold this rank alone) or with
    the single-device band predictor."""
    if mesh is not None:
        ranks = mesh.mesh.flatten().tolist()
        if ranks != [process_index()]:
            raise ValueError(
                f"multihost inference splits BANDS over the processes; its mesh "
                f"shards tiles over this process's own devices only, but the "
                f"mesh spans ranks {ranks} and this is rank {process_index()}"
            )
        dispatch, _ = _make_sharded_band_pipeline(forward_fn, plan, mesh, clip_conditioning)
        return lambda band_inputs: dispatch.dispatch_band(band_inputs).permute(
            1, 0, 2).reshape(plan.tile_out, plan.out_w)
    band_predict = _make_band_predictor(forward_fn, plan, clip_conditioning,
                                        tile_loop=tile_loop)
    return lambda band_inputs: band_predict(
        {k: torch.as_tensor(v, dtype=torch.float32).to(device)
         for k, v in band_inputs.items()})


def _rounds(
    forward_fn,
    band_source: BandSource,
    plan: TilePlan,
    mesh,
    clip_conditioning: bool,
    tile_loop: str,
    consume0: Callable[[int, np.ndarray], None],
    progress,
    device,
) -> None:
    """The round loop: rank ``pid`` computes band ``r*P + pid`` (a zero
    dummy past the grid), one stacked all_gather per round, rank 0 consumes
    the round's strips in band order."""
    p_count, pid = process_count(), process_index()
    gy, _ = plan.grid
    if mesh is not None:
        from deepbedmap_tpu_torch.parallel.mesh import mesh_device

        device = mesh_device(mesh)
    else:
        device = resolve_device(device)
    if callable(band_source):
        load = band_source
    else:
        load = lambda band: _band_inputs(band_source, plan, band, device)
    strip_fn = _make_local_strip_fn(forward_fn, plan, mesh, clip_conditioning, tile_loop,
                                    device)
    shape = (plan.tile_out, plan.out_w)

    for r in range(-(-gy // p_count)):
        band = r * p_count + pid
        if band < gy:
            strip = strip_fn(load(band)).contiguous()
            if tuple(strip.shape) != shape:
                raise AssertionError(f"band {band}: strip {tuple(strip.shape)} != {shape}")
        else:
            strip = torch.zeros(shape, device=device)  # dummy past the grid's edge
        if p_count > 1:
            gathered = [torch.empty_like(strip) for _ in range(p_count)]
            dist.all_gather(gathered, strip)
        else:
            gathered = [strip]
        if pid == 0:
            strips = torch.stack(gathered).cpu().numpy()
            for p in range(p_count):
                b = r * p_count + p
                if b < gy:
                    consume0(b, strips[p])
                    if progress is not None:
                        progress(b + 1, gy)


def predict_continent_multihost(
    forward_fn: Callable[..., torch.Tensor],
    band_source: BandSource,
    plan: TilePlan,
    mesh=None,
    clip_conditioning: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    tile_loop: str = "scan",
    device="cuda",
) -> Optional[np.ndarray]:
    """The full (out_h, out_w) DEM with bands distributed over the
    processes; every rank calls it. Returns the canvas on rank 0 and None on
    every other rank (the canvas is held once, not P times); ``progress``
    fires on rank 0 only. ``device``: this rank's device when ``mesh`` is
    None (the card unless the caller asks for the CPU)."""
    canvas = (np.empty((plan.out_h, plan.out_w), np.float32)
              if process_index() == 0 else None)

    def consume0(band: int, strip: np.ndarray) -> None:
        canvas[band * plan.tile_out : (band + 1) * plan.tile_out] = strip

    _rounds(forward_fn, band_source, plan, mesh, clip_conditioning, tile_loop, consume0,
            progress, device)
    return canvas


def predict_continent_multihost_to_geotiff(
    forward_fn: Callable[..., torch.Tensor],
    band_source: BandSource,
    plan: TilePlan,
    bounds: Tuple[float, float, float, float],  # (xmin, ymin, xmax, ymax)
    outfilepath: str,
    mesh=None,
    clip_conditioning: bool = True,
    nodataval: float = -2000.0,
    compress: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    tile_loop: str = "scan",
    rows_per_strip: Optional[int] = None,
    overviews: int = 0,
    predictor: bool = False,
    device="cuda",
) -> Optional[str]:
    """Band-distributed inference streamed into ONE int16 LZW GeoTIFF on rank
    0, whose writer thread encodes while the next round computes and
    gathers. Returns the product's path on rank 0, None elsewhere. The
    writer's options are ``continent.predict_continent_to_geotiff``'s; a
    failure removes the partial file and re-raises."""
    if rows_per_strip is None:
        for d in (8, 10, 5, 4, 2):
            if plan.tile_out % d == 0:
                rows_per_strip = plan.tile_out // d
                break
        else:
            rows_per_strip = 0

    if process_index() != 0:
        _rounds(forward_fn, band_source, plan, mesh, clip_conditioning, tile_loop,
                lambda band, strip: None, None, device)
        return None

    tw = _ThreadedStripWriter(
        outfilepath, plan, bounds, nodataval, compress,
        rows_per_strip or None, overviews, predictor,
    )
    try:
        _rounds(forward_fn, band_source, plan, mesh, clip_conditioning, tile_loop,
                lambda band, strip: tw.put(strip), progress, device)
        tw.close()
    except BaseException:
        tw.abort()
        raise
    return tw.path

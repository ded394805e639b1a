"""Whole-continent inference: row-band streaming around the tiled engine.

Counterpart of ``deepbedmap_tpu/inference/continent.py`` (``predict_continent``
and its helpers; the GeoTIFF writer and the mesh paths are not ported yet).
The full-resolution conditioning rasters stay on the host as numpy arrays;
one row band of tiles at a time moves to the device with its vertical halo
taken from the neighbouring bands' real rows, so band-streamed output equals
the whole-region engine. Edge bands use the engine's edge padding, and the
conditioning rasters are clipped to >= 0 on the device (deepbedmap.py:663-665).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.inference.engine import INPUT_RATIOS, TilePlan, pad_edge


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
    fetch: CUDA launches are asynchronous, so the next band's host slicing
    and transfer overlap the current band's device work. ``prefetch=0`` is
    the strict serial loop."""
    pending: deque = deque()

    def drain_one():
        band, fut = pending.popleft()
        consume(band, fetch(fut))
        if progress is not None:
            progress(band + 1, gy)

    for band in range(gy):
        pending.append((band, dispatch(inputs_host, band)))
        while len(pending) > max(prefetch, 0):
            drain_one()
    while pending:
        drain_one()


def _band_inputs(
    inputs_host: Dict[str, np.ndarray], plan: TilePlan, band: int, device="cuda"
) -> Dict[str, torch.Tensor]:
    """Slice one vertical-halo'd row band out of the host rasters (edge
    padding at region borders) and move it to ``device``."""
    lh, lw = plan.lr_shape
    pad = plan.pad_lr
    r0 = band * plan.tile_lr - pad
    r1 = (band + 1) * plan.tile_lr + pad
    out = {}
    for key, ratio in INPUT_RATIOS.items():
        a = inputs_host[key]
        if a.shape[1] != ratio * lh or a.shape[2] != ratio * lw:
            raise ValueError(f"{key}: shape {a.shape}, expected "
                             f"{(ratio * lh, ratio * lw)} spatially")
        rr0, rr1 = r0 * ratio, r1 * ratio
        top_pad = max(0, -rr0)
        bot_pad = max(0, rr1 - ratio * lh)
        sl = a[:, max(0, rr0) : min(ratio * lh, rr1)]
        if top_pad or bot_pad:
            sl = np.pad(sl, ((0, 0), (top_pad, bot_pad), (0, 0), (0, 0)), mode="edge")
        out[key] = torch.from_numpy(np.ascontiguousarray(sl, np.float32)).to(device)
    return out


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
    band_predict = _make_band_predictor(
        forward_fn, plan, clip_conditioning, tile_loop=tile_loop,
        tiles_per_dispatch=tiles_per_dispatch,
    )
    device = resolve_device(device)
    canvas = np.empty((plan.out_h, plan.out_w), np.float32)

    def consume(band: int, strip: np.ndarray) -> None:
        canvas[band * plan.tile_out : (band + 1) * plan.tile_out] = strip

    _run_band_pipeline(
        lambda ih, band: band_predict(_band_inputs(ih, plan, band, device)),
        lambda strip: strip.cpu().numpy(),
        inputs_host, gy, consume, progress, prefetch,
    )
    return canvas

"""Packaged training-array builder (reference data_prep.py:745-930), on a
device.

Counterpart of ``deepbedmap_tpu/data/builder.py``. The reference composes
its X/W1/W2/W3/Y training arrays inline in the notebook: per-survey high-res
tiles (no interpolation), BEDMAP2 low-res bed with a 1 km context pad,
gap-filled REMA surface elevation, MEaSUREs velocity x/y resampled to 500 m
and concatenated on the channel axis, Arthern accumulation — then
``np.save``s the five arrays. ``build_training_arrays`` is that whole
section as one function: rasters + window bounds in, hash-pinned
:class:`TileDataset` out. Every tile is sampled on the device
(``data.tiler.selective_tile``), the arrays are assembled and filtered
there, and they come to the host once, for ``np.save``, when ``out_dir``
is given.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.data.dataset import ARRAY_KEYS, TileDataset, content_hash
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.data.tiler import selective_tile
from deepbedmap_tpu_torch.data.windows import Bounds
from deepbedmap_tpu_torch.device import resolve_device


def build_training_arrays(
    highres: Mapping[str, Raster],
    window_bounds: Mapping[str, Sequence[Bounds]],
    lowres: Raster,
    surface: Raster,
    velocity: Tuple[Raster, Raster],
    accumulation: Raster,
    padding: float = 1000.0,
    velocity_resolution: float = 500.0,
    lowres_gapfiller: Optional[float] = None,
    drop_invalid: bool = True,
    out_dir: Optional[str] = None,
    device="cuda",
) -> TileDataset:
    """Assemble the X/W1/W2/W3/Y training arrays on ``device``.

    Args:
      highres: per-survey gridded bed rasters keyed by survey/grid name
        (the reference groups ``tiles_3031.geojson`` rows by ``grid_name``,
        data_prep.py:745-750).
      window_bounds: per-survey window bboxes over each high-res grid
        (same keys as ``highres``).
      lowres: BEDMAP2 bed (1000 m) — tiled with a ``padding`` context ring
        into (N, 1, 11, 11) for 36 px windows (data_prep.py:766-769).
      surface: gap-filled REMA surface elevation (100 m) -> (N, 1, 110, 110).
      velocity: (VX, VY) MEaSUREs rasters, each resampled to
        ``velocity_resolution`` (500 m) and concatenated channel-wise ->
        (N, 2, 22, 22) (data_prep.py:895-909).
      accumulation: Arthern accumulation (1000 m) -> (N, 1, 11, 11).
      lowres_gapfiller: optional nodata fill for X (the reference training
        build uses none — windows are pre-filtered to valid regions; the
        inference fetcher uses -5000, deepbedmap.py:170).
      drop_invalid: drop tiles where any array still contains NaN after
        tiling (keeps the on-disk arrays finite, as the reference's
        pre-filtered windows guarantee by construction).
      out_dir: if given, ``np.save`` the five arrays there with the
        reference filenames (X_data.npy, ...) plus a content-hash pin
        (data_prep.py:925-930 + the quilt hash-pinning role).

    Returns the assembled :class:`TileDataset` (NHWC tensors on ``device``).
    """
    if set(highres) != set(window_bounds):
        raise ValueError(f"surveys {sorted(highres)} != window keys {sorted(window_bounds)}")
    dev = resolve_device(device)
    names = sorted(highres)
    per_grid: List[torch.Tensor] = []
    all_bounds: List[Bounds] = []
    for name in names:
        wb = list(window_bounds[name])
        if not wb:
            continue
        per_grid.append(selective_tile(highres[name], wb, interpolate=False, device=dev))
        all_bounds.extend(wb)
    if not per_grid:
        raise ValueError("no windows over any high-res grid")

    def tile(raster, **kw):
        return selective_tile(raster, all_bounds, padding=padding, device=dev, **kw)

    vx = tile(velocity[0], resolution=velocity_resolution)
    vy = tile(velocity[1], resolution=velocity_resolution)
    if vx.shape != vy.shape:
        raise ValueError(f"velocity tiles differ: {tuple(vx.shape)} != {tuple(vy.shape)}")
    # reference shape contract for 36 px @250 m windows with 1 km padding:
    # X (n,1,11,11) W1 (n,1,110,110) W2 (n,2,22,22) W3 (n,1,11,11) Y (n,1,36,36)
    arrays: Dict[str, torch.Tensor] = {
        "X": tile(lowres, gapfiller=lowres_gapfiller),
        "W1": tile(surface),
        "W2": torch.cat([vx, vy], dim=1),
        "W3": tile(accumulation),
        "Y": torch.cat(per_grid, dim=0),
    }

    if drop_invalid:
        ok = torch.stack([~torch.isnan(a).flatten(1).any(dim=1) for a in arrays.values()]
                         ).all(dim=0)
        arrays = {k: a[ok] for k, a in arrays.items()}

    if out_dir is not None:
        host = {k: arrays[k].cpu().numpy() for k in ARRAY_KEYS}
        os.makedirs(out_dir, exist_ok=True)
        for key, arr in host.items():
            np.save(os.path.join(out_dir, f"{key}_data.npy"), arr)
        with open(os.path.join(out_dir, "CONTENT_HASH"), "w") as f:
            f.write(content_hash(host) + "\n")

    return TileDataset({k: arrays[k].permute(0, 2, 3, 1).contiguous() for k in ARRAY_KEYS})

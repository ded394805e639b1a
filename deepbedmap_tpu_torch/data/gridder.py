"""Vector -> raster gridding: blockmedian + tension-spline + masking
(reference L1, data_prep.py:353-441).

Counterpart of ``deepbedmap_tpu/data/gridder.py``, without pandas and JAX.
``get_region`` rounds point bounds outward to increments (gmt info -I);
``blockmedian`` reduces points to per-block medians with GMT's node-centered
block semantics, on a device; ``xyz_to_grid`` solves the GMT-surface system
exactly on the host (``ops.gmt_surface``, numpy and scipy) or, for grids
above ``_EXACT_NODE_LIMIT`` nodes, relaxes it on the device
(``ops.spline``), masks far-from-data cells and resamples gridline -> pixel
registration, returning a Raster. Points come as ``data.pipeline.XYZ`` or any
object with ``.x``, ``.y``, ``.z`` columns.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.data.pipeline import XYZ
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.ops import gmt_surface
from deepbedmap_tpu_torch.ops.spline import (
    distance_mask,
    gridline_to_pixel,
    solve_tension_spline,
)

# above this many gridline nodes the exact sparse solve gives way to the
# device-side relaxation solver (assembly + LU get slow on one host core)
_EXACT_NODE_LIMIT = 300_000


def _column(xyz_data, name: str) -> np.ndarray:
    return np.asarray(getattr(xyz_data, name), np.float64)


def get_region(
    xyz_data, round_increment: int = 250, mode: str = "round"
) -> Tuple[float, float, float, float]:
    """Bounding region rounded outward to the increment
    (reference get_region via `gmt info -I`, data_prep.py:353-378).
    Returns (xmin, xmax, ymin, ymax) — GMT's -R order. NaN coordinates are
    skipped, as pandas' ``min`` / ``max`` skip them.

    ``mode``:
      'round'   — plain outward rounding to the increment (default; the data
                  contract — every point is inside, grid edges on increments).
      'surface' — additionally reproduce `gmt info -Is` (what the reference
                  calls): after rounding, pad the *shorter* axis so both axes
                  span the SAME number of increments — floor(deficit/2) cells
                  on the min side, the rest on the max side. Derived from the
                  reference doctest (data_prep.py:365-370): x [580.8, 8324.4],
                  y [205.8, 9507.1] -> '-250/9500/0/9750', i.e. y plainly
                  rounded (39 intervals) and x padded 32 -> 39 intervals with
                  3 cells left / 4 cells right. Only empty border cells are
                  added (masked to NaN downstream); data content is identical.
    """
    x, y = _column(xyz_data, "x"), _column(xyz_data, "y")
    inc = float(round_increment)
    xmin = np.floor(np.nanmin(x) / inc) * inc
    xmax = np.ceil(np.nanmax(x) / inc) * inc
    ymin = np.floor(np.nanmin(y) / inc) * inc
    ymax = np.ceil(np.nanmax(y) / inc) * inc
    if mode == "surface":
        nx = int(round((xmax - xmin) / inc))
        ny = int(round((ymax - ymin) / inc))
        if nx < ny:
            pad = ny - nx
            xmin -= (pad // 2) * inc
            xmax += (pad - pad // 2) * inc
        elif ny < nx:
            pad = nx - ny
            ymin -= (pad // 2) * inc
            ymax += (pad - pad // 2) * inc
    return (float(xmin), float(xmax), float(ymin), float(ymax))


def _segment_median(cell: torch.Tensor, values: torch.Tensor, starts, counts):
    """Median of ``values`` within each run of equal ``cell`` ids (runs given
    by ``starts`` / ``counts`` in id order), NaN skipped; a run of only NaN
    gives NaN. The mean of the two middle values for an even count, as
    pandas' groupby median computes it ((a + b) / 2)."""
    # lexicographic sort by (cell, value): by value, then stably by cell
    by_value = torch.argsort(values, stable=True)  # NaN last
    order = by_value[torch.argsort(cell[by_value], stable=True)]
    v = values[order]
    nan = torch.isnan(v).to(torch.int64)
    n_nan = torch.zeros_like(counts).index_add_(
        0, torch.repeat_interleave(torch.arange(len(counts), device=v.device), counts), nan)
    n = counts - n_nan
    lo = starts + torch.clamp((n - 1) // 2, min=0)
    hi = starts + torch.clamp(n // 2, min=0)
    med = (v[lo] + v[hi]) / 2.0
    odd = (n % 2) == 1
    med = torch.where(odd, v[lo], med)
    return torch.where(n > 0, med, torch.nan)


def blockmedian(
    xyz_data,
    region: Tuple[float, float, float, float],
    spacing: float = 250.0,
    device="cuda",
) -> XYZ:
    """Per-block medians of x, y and z (reference gmt.blockmedian,
    data_prep.py:407), computed in float64 on ``device``: a sort by (cell,
    value) and segment medians. Rows come out in cell-id order, as JAX's
    ``groupby("_cell").median()`` gives them.

    GMT's block tools default to GRIDLINE registration: blocks are CENTERED
    on the grid nodes (edge blocks half-sized), not aligned with pixel
    cells. Output position is the independent median of the x's and y's in
    the block, matching blockmedian's default (not -Q)."""
    dev = resolve_device(device)
    xmin, xmax, ymin, ymax = region
    x, y, z = (torch.tensor(_column(xyz_data, k), device=dev) for k in "xyz")
    inside = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    x, y, z = x[inside], y[inside], z[inside]
    nx = int(round((xmax - xmin) / spacing)) + 1
    ny = int(round((ymax - ymin) / spacing)) + 1
    col = torch.clamp(torch.floor((x - xmin) / spacing + 0.5).to(torch.int64), 0, nx - 1)
    row = torch.clamp(torch.floor((y - ymin) / spacing + 0.5).to(torch.int64), 0, ny - 1)
    cell = row * nx + col
    _, counts = torch.unique(cell, sorted=True, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    x, y, z = (_segment_median(cell, v, starts, counts).cpu().numpy() for v in (x, y, z))
    return XYZ(x, y, z)


def _raster(z_pix: np.ndarray, xmin: float, ymax: float, spacing: float) -> Raster:
    return Raster(data=z_pix.astype(np.float32), left=float(xmin), top=float(ymax),
                  res=float(spacing), nodata=None)


def xyz_to_grid(
    xyz_data,
    region: Tuple[float, float, float, float],
    spacing: float = 250.0,
    tension: float = 0.35,
    mask_cell_radius: int = 3,
    iterations: int = 500,
    backend: str = "auto",
    offset_correction: bool = True,
    device="cuda",
) -> Raster:
    """Grid xyz points to a pixel-registered Raster
    (reference xyz_to_grid, data_prep.py:382-441):
    blockmedian -> surface solve on gridline nodes -> mask cells
    > mask_cell_radius from data -> gridline->pixel resample.

    ``backend``:
      'exact' — assemble and solve the converged GMT-surface linear system
                on the host (ops.gmt_surface): Briggs off-node constraints,
                tensioned free-edge BCs, LS-plane detrend. Calibrated against
                the reference's published GMT golden (~20 m max on the
                doctest cloud; see tests/test_gridder.py).
      'relax' — the relaxation solver (ops.spline) on ``device``,
                approximate but fast for very large grids; honours
                ``iterations`` and ``offset_correction`` (first-order
                gradient correction of node-snapped constraints).
      'auto'  — 'exact' unless the node count exceeds 300,000
                (``_EXACT_NODE_LIMIT``).

    The block medians are taken on ``device`` for every backend.
    """
    if backend not in ("auto", "exact", "relax"):
        raise ValueError(f"backend {backend!r}: 'auto', 'exact' or 'relax'")
    xmin, xmax, ymin, ymax = region
    nx = int(round((xmax - xmin) / spacing)) + 1
    ny = int(round((ymax - ymin) / spacing)) + 1
    med = blockmedian(xyz_data, region, spacing, device=device)

    if backend == "auto":
        backend = "exact" if nx * ny <= _EXACT_NODE_LIMIT else "relax"

    if backend == "exact":
        # south-up gridline solve, then flip to north-up raster rows
        z_south = gmt_surface.surface(med.x, med.y, med.z, region, spacing,
                                      tension=tension)
        z = np.asarray(z_south[::-1], np.float64)
        col = np.clip(np.floor((med.x - xmin) / spacing + 0.5).astype(int), 0, nx - 1)
        row = np.clip(np.floor((ymax - med.y) / spacing + 0.5).astype(int), 0, ny - 1)
        has_data = np.zeros((ny, nx), bool)
        has_data[row, col] = True
        far = distance_mask(has_data, mask_cell_radius)
        z = np.where(far, np.nan, z)
        return _raster(gmt_surface.grid_to_pixel(z), xmin, ymax, spacing)

    # --- relaxation backend (large grids) -----------------------------------
    row, col = relax_nodes(med, region, spacing)
    data, has_data = node_constraints(row, col, med.z, (ny, nx))

    def solve(d):
        return solve_tension_spline(d, has_data, tension=tension,
                                    iterations=iterations, device=device)

    if offset_correction:
        z0 = solve(data).cpu().numpy()
        gy, gx = np.gradient(z0, spacing)
        node_x = xmin + col * spacing
        node_y = ymax - row * spacing
        dx = med.x - node_x
        dy = med.y - node_y
        z_corr = (
            med.z
            - gx[row, col] * dx
            - (-gy[row, col]) * dy  # row axis runs top-down: d/dy = -d/drow
        )
        data, has_data = node_constraints(row, col, z_corr, (ny, nx))

    z = solve(data)
    far = torch.as_tensor(distance_mask(has_data, mask_cell_radius), device=z.device)
    z = torch.where(far, torch.nan, z)
    return _raster(gridline_to_pixel(z).cpu().numpy(), xmin, ymax, spacing)


def relax_nodes(med: XYZ, region, spacing: float):
    """(row, col) of the north-up gridline node each block median snaps to
    in the relax backend (``np.round``, JAX's arithmetic)."""
    xmin, xmax, ymin, ymax = region
    nx = int(round((xmax - xmin) / spacing)) + 1
    ny = int(round((ymax - ymin) / spacing)) + 1
    col = np.clip(np.round((med.x - xmin) / spacing).astype(int), 0, nx - 1)
    row = np.clip(np.round((ymax - med.y) / spacing).astype(int), 0, ny - 1)
    return row, col


def node_constraints(row, col, z_values, shape):
    """The relax backend's constraint grid: the float32 mean of the values
    snapped to each node (``np.add.at``), and the mask of constrained
    nodes."""
    data = np.zeros(shape, np.float32)
    count = np.zeros(shape, np.float32)
    np.add.at(data, (row, col), z_values.astype(np.float32))
    np.add.at(count, (row, col), 1.0)
    has = count > 0
    data[has] /= count[has]
    return data, has

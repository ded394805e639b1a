"""Figure factory (reference paper_figures.py, PyGMT/GMT replaced by
matplotlib): DEM maps with hillshade, side-by-side comparisons (the paper's
bicubic/groundtruth/prediction panels), elevation+roughness transects, and
track-error histograms (deepbedmap.py:577-626).

Counterpart of ``deepbedmap_tpu/viz/figures.py``. The hillshades and the
transect samples are computed on ``device`` (the card unless the caller asks
for the CPU) by ``viz.analysis.hillshade`` and ``evalx.track.grdtrack``; the
drawing is JAX's matplotlib code, copied. matplotlib is imported inside the
functions that draw.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.evalx.track import grdtrack
from deepbedmap_tpu_torch.ops.interp import as_f32
from deepbedmap_tpu_torch.viz.analysis import as_grid, hillshade


def _extent(raster: Raster):
    xmin, ymin, xmax, ymax = raster.bounds
    return (xmin, xmax, ymin, ymax)


def transect(grid, raster: Raster, xs: np.ndarray, ys: np.ndarray, device="cuda") -> np.ndarray:
    """``grid`` (a tensor, or an array copied to ``device``) on ``raster``'s
    georeferencing, sampled bicubically at (xs, ys) on the grid's device (NaN
    outside), as a numpy array."""
    g = as_grid(grid, device)
    return grdtrack(g, as_f32(xs, g.device), as_f32(ys, g.device), raster.left,
                    raster.top, raster.res).cpu().numpy()


def plot_dem(
    raster: Raster,
    ax=None,
    cmap: str = "BrBG_r",
    shade: bool = True,
    title: Optional[str] = None,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    device="cuda",
):
    """Shaded-relief DEM map (reference fig.grdimage + -I shading)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 7))
    data = raster.masked()
    im = ax.imshow(
        data, cmap=cmap, extent=_extent(raster), vmin=vmin, vmax=vmax,
        interpolation="nearest",
    )
    if shade:
        hs = hillshade(np.nan_to_num(data), raster.res, device=device).cpu().numpy()
        ax.imshow(
            hs, cmap="gray", alpha=0.3, extent=_extent(raster),
            interpolation="bilinear",
        )
    if title:
        ax.set_title(title)
    ax.set_xlabel("Polar Stereographic X (m)")
    ax.set_ylabel("Polar Stereographic Y (m)")
    plt.colorbar(im, ax=ax, shrink=0.7, label="Elevation (m)")
    return ax


def plot_comparison(
    rasters: Dict[str, Raster],
    cmap: str = "BrBG_r",
    figsize=(16, 5),
    device="cuda",
):
    """Side-by-side DEM panels sharing a colour scale (the paper's Fig. 3/4
    style comparisons of BEDMAP2 / bicubic / DeepBedMap / groundtruth)."""
    import matplotlib.pyplot as plt

    vmin = min(np.nanmin(r.masked()) for r in rasters.values())
    vmax = max(np.nanmax(r.masked()) for r in rasters.values())
    fig, axes = plt.subplots(1, len(rasters), figsize=figsize, squeeze=False)
    for ax, (name, raster) in zip(axes[0], rasters.items()):
        plot_dem(raster, ax=ax, cmap=cmap, title=name, vmin=vmin, vmax=vmax, device=device)
    fig.tight_layout()
    return fig


def plot_transect(
    rasters: Dict[str, Raster],
    xs: np.ndarray,
    ys: np.ndarray,
    ax=None,
    device="cuda",
):
    """Sample each raster along a transect and plot elevation profiles
    (reference paper_figures.py:940-998 transect figures)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    dist = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(xs), np.diff(ys)))])
    for name, raster in rasters.items():
        z = transect(raster.masked(), raster, xs, ys, device=device)
        ax.plot(dist / 1000.0, z, label=name)
    ax.set_xlabel("Distance along transect (km)")
    ax.set_ylabel("Elevation (m)")
    ax.legend()
    return ax


def plot_error_histogram(
    residuals: Dict[str, np.ndarray], bins: int = 100, ax=None
):
    """Histogram of grid-minus-track residuals per model
    (reference deepbedmap.py:577-626)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    for name, res in residuals.items():
        res = res[np.isfinite(res)]
        rmse = float(np.sqrt(np.mean(res**2))) if len(res) else float("nan")
        ax.hist(res, bins=bins, histtype="step", label=f"{name} (RMSE {rmse:.1f} m)")
    ax.set_xlabel("Elevation error (m)")
    ax.set_ylabel("Count")
    ax.legend()
    return ax

"""Paper-figure factory (reference paper_figures.py, 1220 LoC of GMT/PyGMT +
TikZ machinery, re-expressed with matplotlib — the renderer this image ships).

Each ``fig_*`` function reproduces one of the reference paper's figure types:

- ``plot_3d_view``        — grdview-style 3-D DEM perspective
                            (deepbedmap.py:242-295)
- ``fig_input_thumbnails``— per-input raster panels, fig1a-e thumbnails that
                            compose with the architecture diagram (Figure 1)
- ``fig_3d_comparison``   — 2x2 grid of 3-D views, Figure 3 / AC2 Figure 1
                            (paper_figures.py:622-667, 1125-1166)
- ``fig_dem_overview``    — whole-continent DEM + grounding line + study-region
                            and training-tile rectangles, key figure / Figure 2
                            (paper_figures.py:510-587)
- ``closeup_fig``         — annotated hillshaded closeup, Figure 4
                            (paper_figures.py:673-733)
- ``fig_roughness_grids`` — 2x2 elevation + rolling-std roughness maps with
                            transect points, Figure 5 (paper_figures.py:1021-1077)
- ``fig_transect``        — stacked 1-D elevation/roughness profiles along a
                            survey track, Figure 6 (paper_figures.py:1083-1112)
- ``fig_architecture``    — generator block diagram, the TikZ network drawing
                            (paper_figures.py:139-505)

All functions take the framework's ``Raster`` and return matplotlib figures;
they never call ``plt.show()`` so they run headless (Agg) in tests/CI.

Counterpart of ``deepbedmap_tpu/viz/paper.py``. The hillshades, roughness
grids and transect samples are computed on ``device`` (the card unless the
caller asks for the CPU) by ``viz.analysis`` and ``evalx.track.grdtrack``;
``closeup_window``, ``roughness`` and ``transect_profiles`` are those
computations alone, without matplotlib. The drawing is JAX's matplotlib
code, copied; matplotlib is imported inside the functions that draw.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.viz.analysis import hillshade, standard_deviation_2d
from deepbedmap_tpu_torch.viz.figures import _extent, transect

# The paper's fixed study regions (paper_figures.py:510-516), (left, bottom,
# right, top) in EPSG:3031 metres.
REGION_PINE_ISLAND = (-1631500.0, -259000.0, -1536500.0, -95000.0)
REGION_THWAITES = (-1550000.0, -550000.0, -1250000.0, -300000.0)


def plot_3d_view(
    raster: Raster,
    ax=None,
    elev: float = 60.0,
    azim: float = 202.5,
    zmin: float = -1400.0,
    cmap: str = "BrBG_r",
    title: Optional[str] = None,
    zlabel: Optional[str] = None,
    vertical_exaggeration: float = 10.0,
    max_dim: int = 400,
):
    """3-D perspective view of a DEM (reference plot_3d_view via gmt grdview,
    deepbedmap.py:242-295).

    ``azim`` follows the GMT convention — degrees from North of the viewpoint
    (202.5 = looking from the SSW); matplotlib's azimuth is measured from the
    +x axis, so it is set to ``90 - azim``. ``zmin`` is the base plane the
    surface sits on (grdview ``plane=``); ``vertical_exaggeration`` mirrors the
    reference's hardcoded 10x zscale. Grids larger than ``max_dim`` per side
    are strided down first — matplotlib's surface renderer is O(cells).
    """
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
    data = raster.masked()
    step = max(1, int(np.ceil(max(data.shape) / max_dim)))
    z = data[::step, ::step]
    x = raster.x_centers[::step]
    y = raster.y_centers[::step]
    xg, yg = np.meshgrid(x, y)

    zplot = np.where(np.isfinite(z), z, zmin)
    ax.plot_surface(
        xg,
        yg,
        zplot,
        rstride=1,
        cstride=1,
        facecolors=plt.get_cmap(cmap)(
            plt.Normalize(np.nanmin(z), np.nanmax(z))(zplot)
        ),
        linewidth=0,
        antialiased=False,
        shade=True,
    )
    ax.set_zlim(bottom=zmin)
    # 10x vertical exaggeration: scale the z box so res-units of elevation
    # render 10x taller than the same distance in x/y
    xspan = x[-1] - x[0]
    zspan = max(float(np.nanmax(z)) - zmin, 1.0)
    ax.set_box_aspect((1, (y[0] - y[-1]) / xspan, vertical_exaggeration * zspan / xspan))
    ax.view_init(elev=elev, azim=90.0 - azim)
    ax.set_xlabel("Polar Stereographic X (m)")
    ax.set_ylabel("Polar Stereographic Y (m)")
    if zlabel:
        ax.set_zlabel(zlabel)
    if title:
        ax.set_title(title)
    return ax


def fig_3d_comparison(
    rasters: Dict[str, Raster],
    zmins: Optional[Dict[str, float]] = None,
    cmaps: Optional[Dict[str, str]] = None,
    zlabel: str = "Bed elevation (metres)",
    ncols: int = 2,
):
    """Grid of 3-D perspective views — the paper's Figure 3 qualitative bed
    comparison (DeepBedMap / BEDMAP2 / difference / BedMachine panels,
    paper_figures.py:622-667). Panel titles get a), b), ... prefixes."""
    import matplotlib.pyplot as plt

    n = len(rasters)
    nrows = -(-n // ncols)
    fig = plt.figure(figsize=(7 * ncols, 5.5 * nrows))
    for idx, (name, raster) in enumerate(rasters.items()):
        ax = fig.add_subplot(nrows, ncols, idx + 1, projection="3d")
        plot_3d_view(
            raster,
            ax=ax,
            zmin=(zmins or {}).get(name, -1400.0),
            cmap=(cmaps or {}).get(name, "BrBG_r"),
            title=f"{chr(ord('a') + idx)}) {name}",
            zlabel=zlabel,
        )
    fig.tight_layout()
    return fig


def fig_dem_overview(
    dem: Raster,
    grounding_line=None,  # data.geojson.PolygonSet, drawn as ring outlines
    study_regions: Optional[Dict[str, Tuple[float, float, float, float]]] = None,
    training_tiles: Optional[np.ndarray] = None,  # (T, 4) xmin,ymin,xmax,ymax
    cmap: str = "BrBG_r",
    series: Tuple[float, float] = (-2000.0, 4500.0),
    key_figure: bool = False,
):
    """Whole-continent DEM overview — the paper's key figure / Figure 2
    (paper_figures.py:510-587): DEM image, grounding-line outline, and (unless
    ``key_figure``) study-region + training-tile rectangles with a legend."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots(figsize=(10, 8.5))
    data = dem.masked()
    im = ax.imshow(
        data,
        cmap=cmap,
        vmin=series[0],
        vmax=series[1],
        extent=_extent(dem),
        interpolation="nearest",
    )
    if grounding_line is not None:
        for outer, holes in grounding_line.polygons:
            for ring in (outer, *holes):
                ax.plot(ring[:, 0], ring[:, 1], color="black", linewidth=0.4)
    if not key_figure:
        palette = ["purple", "gold", "orange", "red", "green"]
        for color, (name, (xmin, ymin, xmax, ymax)) in zip(
            palette, (study_regions or {}).items()
        ):
            ax.add_patch(
                Rectangle(
                    (xmin, ymin),
                    xmax - xmin,
                    ymax - ymin,
                    fill=False,
                    edgecolor=color,
                    linewidth=1.5,
                    label=name,
                )
            )
        if training_tiles is not None and len(training_tiles):
            for i, (xmin, ymin, xmax, ymax) in enumerate(training_tiles):
                ax.add_patch(
                    Rectangle(
                        (xmin, ymin),
                        xmax - xmin,
                        ymax - ymin,
                        fill=False,
                        edgecolor="darkorange",
                        linewidth=0.7,
                        label="Training regions" if i == 0 else None,
                    )
                )
        if study_regions or training_tiles is not None:
            ax.legend(loc="lower left", framealpha=0.9)
    fig.colorbar(im, ax=ax, shrink=0.6, label="Elevation (m)")
    ax.set_xlabel("Polar Stereographic X (m)")
    ax.set_ylabel("Polar Stereographic Y (m)")
    return fig


def closeup_window(dem: Raster, midx: float, midy: float, size: float = 100_000.0):
    """``closeup_fig``'s window of ``dem`` (the masked cells of ``2*size``
    metres centred on (midx, midy), cut at the grid's top and left edges)
    and its extent (xmin, xmax, ymin, ymax)."""
    xmin, xmax = midx - size, midx + size
    ymin, ymax = midy - size, midy + size
    j0 = int((xmin - dem.left) / dem.res)
    j1 = int(np.ceil((xmax - dem.left) / dem.res))
    i0 = int((dem.top - ymax) / dem.res)
    i1 = int(np.ceil((dem.top - ymin) / dem.res))
    i0, j0 = max(i0, 0), max(j0, 0)
    window = dem.masked()[i0:i1, j0:j1]
    extent = (
        dem.left + j0 * dem.res,
        dem.left + j1 * dem.res,
        dem.top - i1 * dem.res,
        dem.top - i0 * dem.res,
    )
    return window, extent


def closeup_fig(
    dem: Raster,
    letter: str,
    name: str,
    midx: float,
    midy: float,
    annotations: Sequence[Tuple[float, float, str]] = (),
    size: float = 100_000.0,
    ax=None,
    cmap: str = "BrBG_r",
    series: Tuple[float, float] = (-2000.0, 4500.0),
    device="cuda",
):
    """Annotated closeup of a DEM area — the paper's Figure 4 panels
    (paper_figures.py:673-733): hillshaded window of ``2*size`` metres centred
    on (midx, midy) with white-boxed text annotations; the hillshade is
    computed on ``device``."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))
    window, extent = closeup_window(dem, midx, midy, size)
    ax.imshow(
        window,
        cmap=cmap,
        vmin=series[0],
        vmax=series[1],
        extent=extent,
        interpolation="nearest",
    )
    hs = hillshade(np.nan_to_num(window), dem.res, device=device).cpu().numpy()
    ax.imshow(hs, cmap="gray", alpha=0.35, extent=extent, interpolation="bilinear")
    for x, y, text in annotations:
        ax.text(
            x,
            y,
            text,
            fontsize=12,
            fontweight="bold",
            ha="center",
            bbox=dict(facecolor="white", edgecolor="none", pad=2),
        )
    ax.set_title(f"{letter}) {name}")
    ax.set_xlabel("Polar Stereographic X (m)")
    ax.set_ylabel("Polar Stereographic Y (m)")
    return ax


def roughness(raster: Raster, window: int = 5, device="cuda") -> torch.Tensor:
    """The rolling-std roughness grid of ``raster`` with its voids as 0
    (``standard_deviation_2d`` of ``nan_to_num``), on ``device``."""
    return standard_deviation_2d(np.nan_to_num(raster.masked()), window, device=device)


def fig_roughness_grids(
    grids: Dict[str, Raster],
    window: int = 5,
    transect_xy: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    max_stddev: float = 200.0,
    device="cuda",
):
    """Figure 5: panel a) the first grid's elevation with transect points,
    then one rolling-std roughness map per grid (paper_figures.py:1021-1077;
    the reference's window_length=5 rolling 2-D standard deviation),
    computed on ``device``."""
    import matplotlib.pyplot as plt

    names = list(grids)
    n = 1 + len(names)
    ncols = 2
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(8 * ncols, 7 * nrows))
    axes = np.atleast_2d(axes)

    first = grids[names[0]]
    ax0 = axes.flat[0]
    im = ax0.imshow(
        first.masked(),
        cmap="BrBG_r",
        extent=_extent(first),
        interpolation="nearest",
    )
    if transect_xy is not None:
        ax0.plot(
            transect_xy[0],
            transect_xy[1],
            ".",
            color="orange",
            markersize=2,
            label="Transect points",
        )
        ax0.legend(loc="lower left")
    ax0.set_title(f"a) {names[0]} DEM")
    fig.colorbar(im, ax=ax0, shrink=0.8, label="Elevation (m)")

    for idx, name in enumerate(names):
        ax = axes.flat[idx + 1]
        rough = roughness(grids[name], window, device=device).cpu().numpy()
        im = ax.imshow(
            rough,
            cmap="viridis",
            vmin=0.0,
            vmax=max_stddev,
            extent=_extent(grids[name]),
            interpolation="nearest",
        )
        ax.set_title(f"{chr(ord('b') + idx)}) {name} roughness")
        fig.colorbar(im, ax=ax, shrink=0.8, label="Standard deviation (m)")
    for ax in axes.flat[n:]:
        ax.set_visible(False)
    fig.tight_layout()
    return fig


def transect_profiles(
    grids: Dict[str, Raster], xs: np.ndarray, ys: np.ndarray, window: int = 5, device="cuda"
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``fig_transect``'s profiles: per grid, its elevation and its roughness
    (``roughness``) sampled bicubically at (xs, ys) on ``device``."""
    out = {}
    for name, raster in grids.items():
        z = transect(raster.masked(), raster, xs, ys, device=device)
        r = transect(roughness(raster, window, device=device), raster, xs, ys)
        out[name] = (z, r)
    return out


def fig_transect(
    grids: Dict[str, Raster],
    xs: np.ndarray,
    ys: np.ndarray,
    window: int = 5,
    elev_range: Optional[Tuple[float, float]] = None,
    rough_range: Optional[Tuple[float, float]] = None,
    device="cuda",
):
    """Figure 6: elevation (top) and roughness (bottom) sampled along a survey
    track, one line per model (paper_figures.py:1083-1112). Sampling uses the
    bicubic grdtrack default, like the reference's gmt.grdtrack calls; the
    profiles are computed on ``device``."""
    import matplotlib.pyplot as plt

    fig, (ax_e, ax_r) = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    for name, (z, r) in transect_profiles(grids, xs, ys, window, device=device).items():
        ax_e.plot(xs / 1000.0, z, ".", markersize=2, label=name)
        ax_r.plot(xs / 1000.0, r, ".", markersize=2, label=name)
    ax_e.set_ylabel("Elevation (m)")
    ax_r.set_ylabel("Roughness (m)")
    ax_r.set_xlabel("Polar Stereographic X (km)")
    if elev_range:
        ax_e.set_ylim(elev_range)
    if rough_range:
        ax_r.set_ylim(rough_range)
    ax_e.legend(markerscale=4)
    fig.tight_layout()
    return fig


def fig_input_thumbnails(
    rasters: Dict[str, Raster],
    cmaps: Optional[Dict[str, str]] = None,
    shade: Tuple[str, ...] = ("bedmap2", "deepbedmap"),
    device="cuda",
):
    """Model input/output thumbnail panels — the reference's fig1a-e
    (paper_figures.py:75-132): one small image per conditioning raster
    (BEDMAP2 bed, REMA surface, MEaSUREs velocity, accumulation) plus the
    predicted DEM, composed alongside the architecture diagram into the
    paper's Figure 1. Elevation panels named in ``shade`` get a Lambertian
    hillshade intensity overlay (the reference's grdimage ``I="+d"``),
    computed on ``device``."""
    import matplotlib.pyplot as plt

    defaults = {
        "bedmap2": "jet",
        "rema": "viridis",
        "measures": "magma",
        "accumulation": "YlGnBu",
        "deepbedmap": "jet",
    }
    cmaps = {**defaults, **(cmaps or {})}

    n = len(rasters)
    fig, axes = plt.subplots(n, 1, figsize=(3.0, 2.6 * n))
    if n == 1:
        axes = [axes]
    for ax, (name, raster) in zip(axes, rasters.items()):
        if isinstance(raster, (tuple, list)):  # (vx, vy) pair: magnitude
            data = np.hypot(raster[0].masked(), raster[1].masked())
            raster = raster[0]
        else:
            data = raster.masked()
        ax.imshow(
            data,
            cmap=cmaps.get(name.lower(), "viridis"),
            extent=_extent(raster),
            interpolation="nearest",
        )
        if name.lower() in shade:
            shaded = hillshade(np.nan_to_num(np.asarray(data)), device=device)
            ax.imshow(
                shaded.cpu().numpy(),
                cmap="gray",
                alpha=0.35,
                extent=_extent(raster),
                interpolation="nearest",
            )
        ax.set_title(name, fontsize=8)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    return fig


def fig_architecture(
    num_residual_blocks: int = 12,
    residual_scaling: float = 0.1,
):
    """Generator architecture block diagram — matplotlib stand-in for the
    reference's TikZ/plot-neural-network drawing (paper_figures.py:139-505):
    four input branches -> concat -> RRDB trunk -> upsample -> deformable
    output layers, annotated with channel counts."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import FancyArrowPatch, FancyBboxPatch

    fig, ax = plt.subplots(figsize=(14, 6))
    ax.set_xlim(0, 14)
    ax.set_ylim(0, 6)
    ax.axis("off")

    def box(x, y, w, h, label, color):
        ax.add_patch(
            FancyBboxPatch(
                (x, y),
                w,
                h,
                boxstyle="round,pad=0.05",
                facecolor=color,
                edgecolor="black",
                linewidth=0.8,
            )
        )
        ax.text(x + w / 2, y + h / 2, label, ha="center", va="center", fontsize=8)
        return (x + w, y + h / 2)

    def arrow(p, q):
        ax.add_patch(FancyArrowPatch(p, q, arrowstyle="->", mutation_scale=10))

    inputs = [
        ("BEDMAP2\n1x11x11", 4.9),
        ("REMA\n1x110x110", 3.5),
        ("MEaSUREs\n2x22x22", 2.1),
        ("Accumulation\n1x11x11", 0.7),
    ]
    concat_in = []
    for label, y in inputs:
        p = box(0.3, y, 1.3, 0.8, label, "#cfe8ff")
        p = box(1.9, y, 1.2, 0.8, "Conv k3/k30/k6\n-> 32ch", "#ffe0b2")
        concat_in.append(box(3.4, y, 1.1, 0.8, "Conv 3x3\n32ch", "#ffe0b2"))
    cat = box(5.0, 2.6, 1.1, 1.0, "Concat\n128ch", "#e1bee7")
    for p in concat_in:
        arrow(p, (5.0, 3.1))
    pre = box(6.4, 2.6, 1.1, 1.0, "Conv 3x3\n64ch", "#ffe0b2")
    arrow(cat, (6.4, 3.1))
    trunk = box(
        7.8,
        2.45,
        1.9,
        1.3,
        f"RRDB trunk\n{num_residual_blocks} blocks\n(scale {residual_scaling})",
        "#c8e6c9",
    )
    arrow(pre, (7.8, 3.1))
    post = box(10.0, 2.6, 1.0, 1.0, "Conv 3x3\n64ch\n(+skip)", "#ffe0b2")
    arrow(trunk, (10.0, 3.1))
    up = box(11.3, 2.6, 0.9, 1.0, "2x NN-up\n+Conv x2", "#b2dfdb")
    arrow(post, (11.3, 3.1))
    d1 = box(12.5, 2.6, 0.7, 1.0, "Deform\nConv 64", "#ffcdd2")
    arrow(up, (12.5, 3.1))
    box(13.4, 2.6, 0.55, 1.0, "Deform\nConv 1", "#ffcdd2")
    arrow(d1, (13.4, 3.1))
    ax.set_title(
        "DeepBedMap generator (ESRGAN-style, deformable output) — "
        "8,907,749 parameters"
    )
    return fig

"""The paper's figure set from a synthetic DEM family (reference
paper_figures.py driven end to end).

The port's copy of ``examples/figure_set.py``, as functions. It builds the
same seeded synthetic DEM family (``np.random.RandomState(42)``) standing in
for DeepBedMap / BEDMAP2 / BedMachine / groundtruth over a Pine-Island-sized
region (real rasters need downloads), then writes every figure type the paper
uses, under the example's names:

  fig1    per-input thumbnails (with the prediction)
  fig2    DEM overview map (+ study regions, training tiles, grounding line)
  fig3    2x2 grid of 3-D perspective views
  fig4    annotated hillshaded closeups
  fig5    elevation + roughness grid maps with transect points
  fig6    1-D elevation/roughness transect profiles
  arch    generator architecture diagram (TikZ replacement)

``main(outdir, device=...)`` draws them (matplotlib needed);
``figure_arrays(device=...)`` computes what they compute on the device (the
hillshades, roughness grids and transect profiles) without matplotlib. The
CLI's ``figures`` runs ``main``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np

from deepbedmap_tpu_torch.data.geojson import load_polygons
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.viz.analysis import hillshade
from deepbedmap_tpu_torch.viz.paper import (
    REGION_PINE_ISLAND,
    closeup_window,
    roughness,
    transect_profiles,
)

RES = 250.0
N_TRACK = 400  # points on the diagonal transect of figs 5-6
FIGURES = (
    "fig2_deepbedmap_dem.png",
    "fig3_qualitative_bed_comparison.png",
    "fig4_deepbedmap_closeups.png",
    "fig5_elevation_roughness_grids.png",
    "fig6_elevation_roughness_transect.png",
    "architecture.png",
    "fig1_input_thumbnails.png",
)


def synthetic_dems(region=REGION_PINE_ISLAND) -> Dict[str, Raster]:
    """The example's DEM family at 250 m over ``region`` (left, bottom,
    right, top): DeepBedMap, Groundtruth, BEDMAP2 (smooth), BedMachine, and
    DeepBedMap - BEDMAP2, drawn from ``RandomState(42)`` in the example's
    order."""
    rs = np.random.RandomState(42)
    left, bottom, right, top = region
    h = int((top - bottom) / RES)
    w = int((right - left) / RES)
    yy, xx = np.mgrid[0:h, 0:w]

    def bed(phase, rough):
        return (
            -900.0
            + 350.0 * np.sin(xx / 90.0 + phase)
            + 250.0 * np.cos(yy / 70.0)
            + rough * rs.randn(h, w)
        ).astype(np.float32)

    dems = {
        "DeepBedMap": Raster(bed(0.0, 30.0), left=left, top=top, res=RES),
        "Groundtruth": Raster(bed(0.0, 35.0), left=left, top=top, res=RES),
        "BEDMAP2": Raster(bed(0.05, 2.0), left=left, top=top, res=RES),  # smooth
        "BedMachine": Raster(bed(0.02, 12.0), left=left, top=top, res=RES),
    }
    dems["DeepBedMap - BEDMAP2"] = Raster(
        dems["DeepBedMap"].data - dems["BEDMAP2"].data, left=left, top=top, res=RES)
    return dems


def closeups(region=REGION_PINE_ISLAND) -> List[dict]:
    """fig4's two panels, as ``closeup_fig`` keywords."""
    left, bottom, right, top = region
    return [
        dict(letter="a", name="Central trough", midx=(left + right) / 2,
             midy=(bottom + top) / 2,
             annotations=[((left + right) / 2, (bottom + top) / 2, "trough")],
             size=20_000.0),
        dict(letter="b", name="Upstream ridges", midx=left + 30_000.0, midy=top - 40_000.0,
             annotations=[], size=20_000.0),
    ]


def transect_xy(region=REGION_PINE_ISLAND):
    """figs 5-6's transect: a diagonal survey track of ``N_TRACK`` points."""
    left, bottom, right, top = region
    return (np.linspace(left + 10 * RES, right - 10 * RES, N_TRACK),
            np.linspace(bottom + 10 * RES, top - 10 * RES, N_TRACK))


def _profile_grids(dems: Dict[str, Raster]) -> Dict[str, Raster]:
    return {k: dems[k] for k in ("DeepBedMap", "Groundtruth", "BedMachine")}


def figure_arrays(region=REGION_PINE_ISLAND, device="cuda") -> Dict[str, np.ndarray]:
    """The arrays the figure set computes on ``device``, by the functions its
    figures call, without matplotlib: fig1's thumbnail hillshades (BEDMAP2,
    DeepBedMap), fig4's closeup hillshades, fig5's roughness grids and fig6's
    elevation and roughness profiles."""
    dems = synthetic_dems(region)
    out = {}
    for name in ("BEDMAP2", "DeepBedMap"):
        out[f"fig1 {name} hillshade"] = hillshade(
            np.nan_to_num(dems[name].masked()), device=device).cpu().numpy()
    dem = dems["DeepBedMap"]
    for c in closeups(region):
        window, _ = closeup_window(dem, c["midx"], c["midy"], c["size"])
        out[f"fig4 {c['letter']}) hillshade"] = hillshade(
            np.nan_to_num(window), dem.res, device=device).cpu().numpy()
    grids = _profile_grids(dems)
    for name, raster in grids.items():
        out[f"fig5 {name} roughness"] = roughness(raster, device=device).cpu().numpy()
    txs, tys = transect_xy(region)
    for name, (z, r) in transect_profiles(grids, txs, tys, device=device).items():
        out[f"fig6 {name} elevation"] = z
        out[f"fig6 {name} roughness"] = r
    return out


def main(outdir: str, device="cuda", region=REGION_PINE_ISLAND) -> List[str]:
    """Write the seven figures under ``outdir`` (made if missing), computing
    on ``device``; logs go to stderr. Returns the paths written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from deepbedmap_tpu_torch.viz.paper import (
        closeup_fig,
        fig_3d_comparison,
        fig_architecture,
        fig_dem_overview,
        fig_input_thumbnails,
        fig_roughness_grids,
        fig_transect,
    )

    t0 = time.time()
    os.makedirs(outdir, exist_ok=True)
    written = []

    def log(msg):
        print(f"[{time.time() - t0:5.1f}s] {msg}", file=sys.stderr, flush=True)

    def save(fig, name, dpi):
        path = os.path.join(outdir, name)
        fig.savefig(path, dpi=dpi)
        plt.close(fig)
        written.append(path)
        log(name)

    left, bottom, right, top = region
    dems = synthetic_dems(region)
    deepbedmap = dems["DeepBedMap"]
    log(f"built synthetic DEM family {deepbedmap.data.shape}")

    # ---- fig0/fig2: overview map ----
    ring = [
        [left + 30 * RES, bottom + 30 * RES],
        [right - 30 * RES, bottom + 60 * RES],
        [right - 60 * RES, top - 40 * RES],
        [left + 80 * RES, top - 30 * RES],
        [left + 30 * RES, bottom + 30 * RES],
    ]
    gl = load_polygons({
        "type": "FeatureCollection",
        "features": [{"type": "Feature", "properties": {},
                      "geometry": {"type": "Polygon", "coordinates": [ring]}}],
    })
    tiles = np.asarray([
        [left + 40 * RES, bottom + 50 * RES, left + 76 * RES, bottom + 86 * RES],
        [left + 150 * RES, top - 120 * RES, left + 186 * RES, top - 84 * RES],
    ])
    save(fig_dem_overview(deepbedmap, grounding_line=gl,
                          study_regions={"Pine Island Glacier": REGION_PINE_ISLAND},
                          training_tiles=tiles),
         FIGURES[0], 120)

    # ---- fig3: 3-D qualitative comparison ----
    save(fig_3d_comparison(
        {k: dems[k] for k in ("DeepBedMap", "BEDMAP2", "DeepBedMap - BEDMAP2", "BedMachine")},
        zmins={"DeepBedMap - BEDMAP2": -400.0},
        cmaps={"DeepBedMap - BEDMAP2": "RdBu"},
    ), FIGURES[1], 100)

    # ---- fig4: closeups ----
    fig, axes = plt.subplots(1, 2, figsize=(16, 8))
    for ax, c in zip(axes, closeups(region)):
        closeup_fig(deepbedmap, ax=ax, device=device, **c)
    save(fig, FIGURES[2], 120)

    # ---- figs 5-6 on a diagonal survey track ----
    txs, tys = transect_xy(region)
    grids = _profile_grids(dems)
    save(fig_roughness_grids(grids, transect_xy=(txs, tys), device=device), FIGURES[3], 100)
    save(fig_transect(grids, txs, tys, device=device), FIGURES[4], 120)

    # ---- architecture diagram ----
    save(fig_architecture(), FIGURES[5], 120)

    # ---- fig1 thumbnails: one panel per model input + the prediction ----
    save(fig_input_thumbnails({
        "BEDMAP2": dems["BEDMAP2"],
        "MEaSUREs": (deepbedmap, dems["BEDMAP2"]),  # (vx, vy) stand-ins
        "DeepBedMap": deepbedmap,
    }, device=device), FIGURES[6], 120)

    log(f"figure set written to {outdir}")
    return written

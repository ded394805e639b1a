"""Continent inference: whole passes of `DeepBedMap.predict_continent`.

Reads a traffic mix of this shape (`traffic/continent_band3.json`):
`bands` row bands of `tiles_per_band` output tiles of `tile_out` px at
250 m, west-south corner `origin`, `halo_lr`, `tiles_per_dispatch` and
`prefetch` as the program takes them, `check_tiles` tiles compared per run,
and `host_memory`: `pinned` holds the rasters in page-locked host memory (on
a card; the DMA from there does not wait on a busy host's copies), `pageable`
in ordinary memory.

Set-up draws the weights and the four conditioning rasters (NCHW float32 in
host memory, no product file) from the seed, loads the program and warms
its shapes on the first band alone. The window runs whole passes until
`--seconds` have gone by and reports the tiles of all passes over all their
time. Each pass keeps `check_tiles` tiles of its canvas, drawn from the seed
(a corner, the far corner, interior ones); the check runs the plain
reference on each from the host rasters, with the reference's edge padding
and clip of the conditioning, and compares every kept tile.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import tracing
from portbench.fields import continent_inputs
from portbench.reference import generator as reference
from portbench.weights import generator_weights

RATIOS = {"X": 1, "W1": 10, "W2": 2, "W3": 1}
RES = 250.0  # output cell size in metres
SCALE = 4
STAGES = ("head", "trunk", "upsample", "tail")


class Run:
    # the readings a limit is set from: one pass keeps every checked tile
    READINGS_WINDOW_S = 0.0

    def __init__(self, cell):
        self.cell = cell
        tr = cell.traffic
        self.dev = torch.device(cell.device)
        self.tile = tr["tile_out"]
        self.tile_lr = self.tile // SCALE
        self.pad_lr = tr["halo_lr"] + 1
        self.bands, self.per_band = tr["bands"], tr["tiles_per_band"]
        self.kw = dict(tile_out=self.tile, halo_lr=tr["halo_lr"],
                       tiles_per_dispatch=tr["tiles_per_dispatch"], prefetch=tr["prefetch"])
        self.pinned = {"pinned": True, "pageable": False}[tr["host_memory"]]
        self.saved: List[Tuple[Tuple[int, int], np.ndarray]] = []

    def setup(self) -> None:
        from deepbedmap_tpu_torch import DeepBedMap
        from deepbedmap_tpu_torch.config import GeneratorConfig
        from deepbedmap_tpu_torch.device import disable_tf32

        disable_tf32()
        cfg, seed = self.cell.config, self.cell.seed
        self.blocks = cfg["generator"]["num_residual_blocks"]
        self.weights = generator_weights(cfg["weights"], self.blocks, seed, self.dev)
        x0, y0 = self.cell.traffic["origin"]
        width, height = self.per_band * self.tile * RES, self.bands * self.tile * RES
        self.bounds = (x0, y0, x0 + width, y0 + height)
        self.inputs = continent_inputs(self.bounds, self.bands * self.tile_lr,
                                       self.per_band * self.tile_lr, seed, self.dev,
                                       pinned=self.pinned and self.dev.type == "cuda")
        rng = np.random.default_rng(seed)
        interior = [(int(rng.integers(1, max(self.bands - 1, 2))),
                     int(rng.integers(1, max(self.per_band - 1, 2))))
                    for _ in range(self.cell.traffic["check_tiles"] - 2)]
        tiles = [(0, 0), (self.bands - 1, self.per_band - 1)] + interior
        self.tiles = [tiles[i] for i in rng.permutation(len(tiles))]
        self.dbm = DeepBedMap(self.weights, device=self.dev,
                              cfg=GeneratorConfig(**cfg["generator"], **cfg["program"]))
        # every band's inputs have the same shapes: one band warms them all
        band = {k: v[:, :, : RATIOS[k] * self.tile_lr] for k, v in self.inputs.items()}
        top = self.bounds[3]
        self.dbm.predict_continent(band, (x0, top - self.tile * RES, x0 + width, top),
                                   **self.kw)

    def _pass(self):
        return self.dbm.predict_continent(self.inputs, self.bounds, **self.kw)

    def window(self, seconds: float) -> Dict:
        t = self.tile
        passes = 0
        t0 = time.perf_counter()
        while True:
            dem = self._pass()
            passes += 1
            self.saved += [((ty, tx), dem.data[ty * t:(ty + 1) * t, tx * t:(tx + 1) * t].copy())
                           for ty, tx in self.tiles]
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        tiles = passes * self.bands * self.per_band
        return {"metrics": {"continent_tiles_per_s": tiles / elapsed}, "attempted": tiles,
                "failed": 0, "passes": passes, "seconds": elapsed}

    def trace(self) -> Dict:
        """One pass with CUDA events around the generator's four stages, then
        one pass under the profiler."""
        spans = tracing.StageSpans()
        spans.wrap(self.dbm.model, STAGES)
        try:
            self._pass()
        finally:
            spans.unwrap(self.dbm.model, STAGES)
        return {"trace": tracing.profile(self._pass), "stages_ms": spans.ms(),
                "tiles_per_pass": self.bands * self.per_band,
                "batch": self.kw["tiles_per_dispatch"],
                "crop_lr": self.tile_lr + 2 * self.pad_lr}

    def release(self) -> None:
        del self.dbm
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def crop(self, ty: int, tx: int) -> List[torch.Tensor]:
        """Tile (ty, tx)'s NCHW input crops from the host rasters, edge-padded
        at the region's borders, the conditioning clipped at 0."""
        crop = self.tile_lr + 2 * self.pad_lr
        out = []
        for key, ratio in RATIOS.items():
            a = self.inputs[key]
            rows = np.clip(np.arange((ty * self.tile_lr - self.pad_lr) * ratio,
                                     (ty * self.tile_lr - self.pad_lr + crop) * ratio),
                           0, a.shape[2] - 1)
            cols = np.clip(np.arange((tx * self.tile_lr - self.pad_lr) * ratio,
                                     (tx * self.tile_lr - self.pad_lr + crop) * ratio),
                           0, a.shape[3] - 1)
            t = torch.from_numpy(np.ascontiguousarray(a[:, :, rows][:, :, :, cols]))
            out.append(t.to(self.dev) if key == "X" else t.to(self.dev).clamp_min(0.0))
        return out

    def reference_tile(self, ty: int, tx: int, lower: bool = False) -> torch.Tensor:
        """The plain reference's (tile, tile) output for tile (ty, tx), at the
        configuration's precisions, or one step below each with ``lower``."""
        prec = self.cell.config["precision"]
        other, trunk = prec["other"], prec["trunk"]
        if lower:
            other, trunk = reference.LOWER[other], reference.LOWER[trunk]
        with torch.no_grad(), reference.strict_fp32():
            out = reference.generator(self.weights, *self.crop(ty, tx), blocks=self.blocks,
                                      precision=other, trunk_precision=trunk)
        d = (self.cell.traffic["halo_lr"]) * SCALE
        return out[0, 0, d:out.shape[2] - d, d:out.shape[3] - d]

    def check(self, control: bool = False) -> Dict[str, float]:
        """``tile_gap_share``: over every kept tile, the widest gap of the
        program's tile from the reference's, as a share of the widest gap of
        the reference computed one precision step lower on the same tile
        (`reference.LOWER`). With ``control`` also the raw widest gaps:
        ``tile_gap`` (the program's, the largest) and ``control_tile_gap``
        (the lower precision's, the smallest)."""
        refs, lower = {}, {}
        for pos, _ in self.saved:
            if pos not in refs:
                refs[pos] = self.reference_tile(*pos)
                lower[pos] = reference.widest_gap(self.reference_tile(*pos, lower=True),
                                                  refs[pos])
        gaps = [(reference.widest_gap(torch.from_numpy(got).to(self.dev), refs[pos]), pos)
                for pos, got in self.saved]
        out = {"tile_gap_share": max(g / lower[pos] for g, pos in gaps)}
        if control:
            out.update(tile_gap=max(g for g, _ in gaps), control_tile_gap=min(lower.values()))
        return out

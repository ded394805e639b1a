"""Single regions: one client predicting windows one after another
(`DeepBedMap.predict`), a closed loop.

Reads a traffic mix of this shape (`traffic/region_closed.json`): a square
domain (`origin`, `domain_km`) covered by the five source rasters
(`sources`: resolution, grid offset, field base and amplitude, voids or not)
with `margin_m` to spare, `voids` NaN discs in each source that has them,
and window sides from `sides_km` in steps of `side_step_km`. Every run
sends the same sizes: each cycle of requests is a seeded permutation of
all of them, at seeded positions. Set-up makes the rasters from the seed
on the device, copies them to host memory, loads the program and sends one
request of every size. The window sends requests until `--seconds` have
gone by, each timed to its host result; the check runs the plain reference
on `check_requests` requests drawn from the seed among the first
`check_within`, and the first of the largest size.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import tracing
from portbench.fields import smooth_field
from portbench.reference import generator as reference
from portbench.reference.inputs import model_inputs
from portbench.weights import generator_weights, seeded_generator

RASTERS_STREAM = 3
CYCLES = 40  # sizes cycles drawn up front, more than a window reaches


class Run:
    # the readings a limit is set from: a window long enough to reach every
    # request the check keeps
    READINGS_WINDOW_S = 12.0

    def __init__(self, cell):
        self.cell = cell
        self.dev = torch.device(cell.device)
        tr = cell.traffic
        lo, hi = tr["sides_km"]
        self.sides = [1000.0 * s for s in range(lo, hi + 1, tr["side_step_km"])]
        self.pad = tr["padding_m"]
        self.kept: Dict[int, np.ndarray] = {}
        self.latencies: List[float] = []

    def _rasters(self):
        from deepbedmap_tpu_torch.data.raster import Raster

        tr = self.cell.traffic
        g = seeded_generator(self.cell.seed, self.dev, RASTERS_STREAM)
        x0, y0 = tr["origin"]
        span = 1000.0 * tr["domain_km"]
        reach = tr["margin_m"]
        count, r_lo, r_hi = tr["voids"]
        out = {}
        for name, (res, offset, base, amp, voids) in tr["sources"].items():
            left, top = x0 - reach - offset, y0 + span + reach + offset
            n = int(math.ceil((span + 2 * (reach + offset)) / res))
            cells = torch.arange(n, device=self.dev, dtype=torch.float64) + 0.5
            xc, yc = left + res * cells, top - res * cells
            data = smooth_field(g, xc, yc, base, amp)
            if voids:
                u = torch.rand((count, 3), generator=g, device=self.dev, dtype=torch.float64)
                for cx, cy, r in zip(x0 + span * u[:, 0], y0 + span * u[:, 1],
                                     r_lo + (r_hi - r_lo) * u[:, 2]):
                    disc = ((yc - cy) ** 2)[:, None] + ((xc - cx) ** 2)[None, :] < r * r
                    data[disc] = float("nan")
            out[name] = Raster(data.cpu().numpy(), left=left, top=top, res=res)
        return out

    def _windows(self, rng, cycles: int):
        x0, y0 = self.cell.traffic["origin"]
        span = 1000.0 * self.cell.traffic["domain_km"]
        out = []
        for _ in range(cycles):
            for k in rng.permutation(len(self.sides)):
                side = self.sides[k]
                room = span - side - 2 * self.pad
                xmin = round(x0 + self.pad + room * rng.random())
                ymin = round(y0 + self.pad + room * rng.random())
                out.append((float(xmin), float(ymin), xmin + side, ymin + side))
        return out

    def setup(self) -> None:
        from deepbedmap_tpu_torch import DeepBedMap
        from deepbedmap_tpu_torch.config import GeneratorConfig
        from deepbedmap_tpu_torch.device import disable_tf32

        disable_tf32()
        cfg, seed = self.cell.config, self.cell.seed
        self.blocks = cfg["generator"]["num_residual_blocks"]
        self.weights = generator_weights(cfg["weights"], self.blocks, seed, self.dev)
        self.rasters = self._rasters()
        rng = np.random.default_rng(seed)
        self.requests = self._windows(rng, CYCLES)
        tr = self.cell.traffic
        within = min(tr["check_within"], len(self.requests))
        largest = next(i for i, w in enumerate(self.requests)
                       if w[2] - w[0] == self.sides[-1])
        self.check_ids = sorted({largest, *rng.choice(within, tr["check_requests"],
                                                      replace=False).tolist()})
        self.dbm = DeepBedMap(self.weights, cfg=GeneratorConfig(**cfg["generator"],
                                                                **cfg["program"]),
                              device=self.dev)
        for w in self._windows(np.random.default_rng(seed + 1), 1):
            self.dbm.predict(w, self.rasters)

    def window(self, seconds: float) -> Dict:
        t_end = time.perf_counter() + seconds
        t0 = time.perf_counter()
        for i, w in enumerate(self.requests):
            start = time.perf_counter()
            dem = self.dbm.predict(w, self.rasters)
            self.latencies.append(1e3 * (time.perf_counter() - start))
            if i in self.check_ids:
                self.kept[i] = dem.data
            if time.perf_counter() >= t_end:
                break
        else:
            raise RuntimeError("the window outran the requests drawn; draw more cycles")
        lat = np.asarray(self.latencies)
        return {"metrics": {"region_p95_ms": float(np.percentile(lat, 95)),
                            "region_p50_ms": float(np.percentile(lat, 50))},
                "attempted": len(lat), "failed": 0, "seconds": time.perf_counter() - t0}

    def trace(self) -> Dict:
        slice_ = self.requests[: self.cell.traffic["trace_requests"]]

        def requests():
            for w in slice_:
                self.dbm.predict(w, self.rasters)

        return {"trace": tracing.profile(requests)}

    def release(self) -> None:
        del self.dbm
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_dem(self, bounds, lower: bool = False) -> torch.Tensor:
        srcs = {k: (r.data, r.left, r.top, r.res) for k, r in self.rasters.items()}
        xs = [torch.from_numpy(a).to(self.dev)
              for a in model_inputs(bounds, srcs, self.pad).values()]
        prec = self.cell.config["precision"]
        other, trunk = prec["other"], prec["trunk"]
        if lower:
            other, trunk = reference.LOWER[other], reference.LOWER[trunk]
        with torch.no_grad(), reference.strict_fp32():
            out = reference.generator(self.weights, *xs, blocks=self.blocks,
                                      precision=other, trunk_precision=trunk)
        return out[0, 0]

    def check(self, control: bool = False) -> Dict[str, float]:
        """``dem_gap_share``: over every kept answer, the widest gap of the
        program's DEM from the reference's, as a share of the widest gap of
        the reference computed one precision step lower on the same window
        (`reference.LOWER`). With ``control`` also the raw widest gaps
        ``dem_gap`` (the largest) and ``control_dem_gap`` (the smallest)."""
        gaps, lower = [], []
        for i in self.check_ids:
            if i not in self.kept:
                continue  # not reached in the window
            want = self.reference_dem(self.requests[i])
            gaps.append(reference.widest_gap(torch.from_numpy(self.kept[i]).to(self.dev),
                                             want))
            lower.append(reference.widest_gap(self.reference_dem(self.requests[i], True),
                                              want))
        if not gaps:
            return {"dem_gap_share": float("inf")}
        out = {"dem_gap_share": max(g / lo for g, lo in zip(gaps, lower))}
        if control:
            out.update(dem_gap=max(gaps), control_dem_gap=min(lower))
        return out

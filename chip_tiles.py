#!/usr/bin/env python3
"""Warm wall time per tile of the port's ``DeepBedMap.predict_continent`` on
one CUDA card, repeated, so that two versions can be compared beyond the
run-to-run spread of a single warm run (``chip_smoke.py`` times one), and
the device time of each stage of one forward.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_tiles.py [--config NAME] [--reps 10]

``NAME`` is a key of ``chip_smoke.CONFIGS`` (default, kernel, banded, sweep
and the options bf16, phase, hcw, plain, plain16). It uses
``chip_smoke.py``'s main-path geometry (a 2 x 2-tile region of 1000-px
tiles, 18-px halo, 2 tiles per forward) and seeded weights, runs
``predict_continent`` once cold and ``--reps`` times warm, then
``chip_smoke.forward_breakdown`` over ``--reps`` forwards at batch 2 x 288
px, and prints the card's name and power limit, each warm run's ms per
tile, each stage's mean device ms and, as its last line, a JSON object with
the runs, their median and the stages. It refuses to run without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (  # noqa: E402
    CONFIGS,
    HALO_LR,
    TILE_OUT,
    TILES_PER_DISPATCH,
    _crop_inputs,
    card,
    forward_breakdown,
)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="default")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_tiles.py: no CUDA device; it does not run on the CPU")
    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.inference import TilePlan

    card_name = card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = 2 * TILE_OUT
    lh = out // 4
    rng = np.random.default_rng(2)
    inputs = {
        "X": rng.random((1, 1, lh, lh), dtype=np.float32),
        "W1": rng.random((1, 1, 10 * lh, 10 * lh), dtype=np.float32),
        "W2": rng.random((1, 2, 2 * lh, 2 * lh), dtype=np.float32),
        "W3": rng.random((1, 1, lh, lh), dtype=np.float32),
    }
    bounds = (0.0, 0.0, out * 250.0, out * 250.0)
    dbm = DeepBedMap(cfg=GeneratorConfig(**CONFIGS[args.config]), device="cuda")
    kw = dict(tile_out=TILE_OUT, halo_lr=HALO_LR, tiles_per_dispatch=TILES_PER_DISPATCH)
    tiles = (out // TILE_OUT) ** 2

    dbm.predict_continent(inputs, bounds, **kw)  # cold: build, allocator, caches
    torch.cuda.synchronize()
    runs = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        dbm.predict_continent(inputs, bounds, **kw)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / tiles)
    crop_lr = TilePlan(out_h=out, out_w=out, tile_out=TILE_OUT, halo_lr=HALO_LR).crop_lr
    xs = [torch.from_numpy(a).cuda() for a in _crop_inputs(crop_lr, TILES_PER_DISPATCH, 3)]
    stages = forward_breakdown(dbm.model, xs, reps=args.reps)
    print(card_name)
    print(f"{args.config}: warm ms/tile " + " ".join(f"{r:.1f}" for r in runs))
    for name, ms in stages.items():
        print(f"{args.config}: forward at batch {TILES_PER_DISPATCH} x {crop_lr} px, {name}: "
              f"{ms:.2f} ms")
    print(json.dumps({"config": args.config, "tiles": tiles, "ms_per_tile": runs,
                      "median": statistics.median(runs), "stages_ms": stages,
                      "card": card_name}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

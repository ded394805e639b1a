#!/usr/bin/env python3
"""What sets the pace of K6 and K5 (``csrc/rdb_tile.cuh``, the tile-local
dense block on the tensor cores): the shipped kernels timed beside variants
of the tile's source on one CUDA card, at the main-path shape
(2, 286, 286, 64).

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_tile_variants.py [--rounds 2]

Each variant is ``csrc`` with one edit of ``rdb_tile.cuh``, built into its
own directory under ``build/variants/`` (``chip_tail_variants.build``):

- ``shipped``: no edit;
- ``divergent``: the warpgroup index taken from the thread index without a
  shuffle and the copies branched instead of predicated, so that ptxas takes
  the branches around the wgmma instructions for divergent;
- ``one_pass``: hi.hi only, a single TF32 pass (its output is wrong; timed
  only);
- ``no_wgmma``: no products at all: the staging, the A loads and splits, the
  barriers and the epilogues alone (output wrong; timed only).

K6 is timed for every variant, K5 for ``shipped`` and ``divergent``, in
turns, ``--rounds`` times. It prints the card's name and power limit,
ptxas's register, spill and performance lines for K6's kernel, each time,
and as its last line a JSON object of the times. It refuses to run without
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from chip_tail_variants import build  # noqa: E402

_PRODUCTS = (
    "          wgmma_k8(part, al[kx], weight_desc(bh), kx > 0);               // lo . hi\n",
    "          wgmma_k8(part, ah[kx], weight_desc(bh + kCK * kCout), 1);      // hi . lo\n",
    "          wgmma_k8(part, ah[kx], weight_desc(bh), 1);                    // hi . hi\n",
)
VARIANTS = {
    "shipped": [],
    "divergent": [
        ("const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), row",
         "const int wg = tid >> 7, row"),
        ("cp_async16_pred(dst + 4 * i, ws + 4 * i, 16, i < n4);",
         "if (i < n4) cp_async16(dst + 4 * i, ws + 4 * i, true);"),
        ("cp_async16_pred(xs + kCK * p + 4 * half, s, inside ? 16 : 0, i < 2 * win_pix(0));",
         "if (i < 2 * win_pix(0)) cp_async16(xs + kCK * p + 4 * half, s, inside);"),
    ],
    "one_pass": [(line, "") for line in _PRODUCTS[:2]],
    "no_wgmma": [(line, "") for line in _PRODUCTS],
}
K5_VARIANTS = ("shipped", "divergent")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_tile_variants.py: no CUDA device; it does not run on the CPU")
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops.rdb import (
        pack_rdb_weights_tc,
        pack_rrdb_weights_tc,
        rdb_banded,
        rrdb_sweep,
    )

    torch.backends.cudnn.allow_tf32 = False
    card_name = cs.card()
    print(card_name)
    libs = {name: build(_kernels, name, edits, "rdb_tile.cuh", "rdb_banded_kernel")
            for name, edits in VARIANTS.items()}
    gen = torch.Generator().manual_seed(6)
    f, g = 64, 32
    cins, couts = [f + g * j for j in range(5)], [g, g, g, g, f]
    blocks = [([cs._randn((co, ci, 3, 3), gen, 0.05) for ci, co in zip(cins, couts)],
               [cs._randn((co,), gen, 0.1) for co in couts]) for _ in range(3)]
    x = cs._randn(cs.MAIN_RDB, gen)
    k1, b1 = blocks[0]
    packed1 = pack_rdb_weights_tc(k1, b1)
    ks, bs = [k for k, _ in blocks], [b for _, b in blocks]
    packed3 = pack_rrdb_weights_tc(ks, bs)
    times: dict = {}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            _kernels._lib = lib
            ms = cs.time_ms(lambda: rdb_banded(x, k1, b1, 0.1, packed1), 10)
            times.setdefault(f"K6/{name}", []).append(ms)
            print(f"  K6 {name}: {ms:.3f} ms  [{card_name}]", flush=True)
            if name in K5_VARIANTS:
                ms = cs.time_ms(lambda: rrdb_sweep(x, ks, bs, 0.1, packed3), 5)
                times.setdefault(f"K5/{name}", []).append(ms)
                print(f"  K5 {name}: {ms:.3f} ms  [{card_name}]", flush=True)
    print(json.dumps({"card": card_name, "shape": list(cs.MAIN_RDB), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

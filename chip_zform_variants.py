#!/usr/bin/env python3
"""What sets the pace of K9 (``csrc/deform_zform.cu``, the deformable conv
with the tap projection inside the kernel): the shipped kernels timed beside
variants of their source on one CUDA card, at the tail's two shapes
(2, 1144, 1144, 64) -> 64 and -> 1.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_zform_variants.py [--rounds 2]

Each variant is ``csrc`` with one edit of ``deform_zform.cu``, built into its
own directory under ``build/variants/`` (``chip_tail_variants.build``):

- ``shipped``: no edit;
- ``one_pass``: hi.hi only, a single TF32 pass in the projection of the
  64 -> 64 kernel (its output is wrong; timed only);
- ``no_wgmma``: no products at all in the 64 -> 64 kernel: the staging, the
  A loads and splits, the z_t stores, the barriers and the sampling alone
  (output wrong; timed only);
- ``no_sampling``: the 64 -> 64 kernel without its sampling (output wrong;
  timed only);
- ``no_projection``: the 64 -> 1 kernel without its projection arithmetic:
  the staging, the field stores and the sampling alone (output wrong; timed
  only);
- ``no_x_staging``: the 64 -> 1 kernel without its copies of x (the ring
  keeps what it held): the weights, the projection's arithmetic, the
  offsets and the sampling alone (output wrong; timed only);
- ``tile_16x32``, ``tile_8x32``: the 64 -> 1 kernel on other tiles than
  the shipped 32 x 32 (512 threads, a 39 x 39 window: 1.49x the tile's
  pixels, one block per SM): 512 threads and 1.75x, 256 threads and 2.28x,
  each with two blocks per SM.

Both shapes are timed for every variant, in turns, ``--rounds`` times. It
prints the card's name and power limit, ptxas's register and spill lines
for the 64 -> 64 kernel, each time, and as its last line a JSON object of
the times. It refuses to run without a CUDA device.
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

_PRODUCTS = ("        wgmma_k8(part, al[e], weight_desc(bh), e > 0);  // lo . hi\n",
             "        wgmma_k8(part, ah[e], weight_desc(bl), 1);      // hi . lo\n",
             "        wgmma_k8(part, ah[e], weight_desc(bh), 1);      // hi . hi\n")
VARIANTS = {
    "shipped": [],
    "one_pass": [(line, "") for line in _PRODUCTS[:2]],
    "no_wgmma": [(line, "") for line in _PRODUCTS],
    "no_sampling": [("      if (!inside[k]) continue;\n      const float dy",
                     "      continue;\n      const float dy")],
    "no_projection": [("          if (k == k1PPT - 1 && tid + k * k1Threads >= k1XPix) continue;",
                       "          continue;")],
    "tile_16x32": [("constexpr int k1TH = 32, k1TW = 32;", "constexpr int k1TH = 16, k1TW = 32;"),
                   ("__launch_bounds__(k1Threads, 1)", "__launch_bounds__(k1Threads, 2)")],
    "tile_8x32": [("constexpr int k1TH = 32, k1TW = 32;", "constexpr int k1TH = 8, k1TW = 32;"),
                  ("__launch_bounds__(k1Threads, 1)", "__launch_bounds__(k1Threads, 2)")],
    "no_x_staging": [("      cp_async16(dst + ((i & 1) * k1XPix + p) * 4, src, valid);\n", "")],
}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_zform_variants.py: no CUDA device; it does not run on the CPU")
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d_zform

    card_name = cs.card()
    print(card_name)
    libs = {name: build(_kernels, name, edits, "deform_zform.cu",
                        "deform_zform_tc_kernelILi64")
            for name, edits in VARIANTS.items()}
    gen = torch.Generator().manual_seed(15)
    cases = {f"{s[3]}->{s[4]}": cs._zform_case(s, gen) for s in cs.MAIN_ZFORM}
    times: dict = {}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            _kernels._lib = lib
            for label, case in cases.items():
                ms = cs.time_ms(lambda: deform_conv2d_zform(*case, 1, 2), 10)
                times.setdefault(f"{name}/{label}", []).append(ms)
                print(f"  K9 {name}, {label}: {ms:.3f} ms  [{card_name}]", flush=True)
    print(json.dumps({"card": card_name, "shapes": cs.MAIN_ZFORM, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

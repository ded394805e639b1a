#!/usr/bin/env python3
"""What sets the pace of K2 (``csrc/deform_tail.cu``): the shipped kernel
timed beside variants of its source on one CUDA card, at the main-path shape
(2, 1144, 1144, 64).

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_tail_variants.py [--rounds 2]

Each variant is ``csrc`` with one edit of ``deform_tail.cu``, built into its
own directory under ``build/variants/``:

- ``shipped``: no edit;
- ``one_pass``: hi.hi only, a single TF32 pass (its output is wrong; timed
  only);
- ``no_wgmma``: no products at all, the sampling, staging and epilogue alone
  (output wrong; timed only);
- ``four_steps``: four k8 steps per wgmma group instead of two.

The variants are timed in turns, ``--rounds`` times, with the test's random
offsets and with offsets of 0.3 everywhere (every lane's corners then lie on
consecutive pixels: no bank conflicts). It prints the card's name and power
limit, ptxas's register and spill lines for K2, each time, and as its last
line a JSON object of the times. It refuses to run without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_PRODUCTS = ("        wgmma_k8(part, al[k], weight_desc(bh), k > 0);  // lo . hi\n",
             "        wgmma_k8(part, ah[k], weight_desc(bl), 1);      // hi . lo\n",
             "        wgmma_k8(part, ah[k], weight_desc(bh), 1);      // hi . hi\n")
VARIANTS = {
    "shipped": [],
    "one_pass": [(line, "") for line in _PRODUCTS[:2]],
    "no_wgmma": [(line, "") for line in _PRODUCTS],
    "four_steps": [("constexpr int kGroupSteps = 2;", "constexpr int kGroupSteps = 4;")],
}


def build(kernels, name: str, edits, source: str = "deform_tail.cu",
          marker: str = "deform64_tc_kernelILb1") -> object:
    """The kernel library built from ``csrc`` with ``edits`` applied to
    ``source``; prints ptxas's lines for the kernel whose name has
    ``marker``."""
    src = Path(kernels._CSRC)
    base = ROOT / "build" / "variants" / name
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(src, base / "csrc")
    cu = base / "csrc" / source
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: {old.strip()!r} not in {source}")
        text = text.replace(old, new)
    cu.write_text(text)
    kernels._CSRC, kernels._lib = base / "csrc", None
    os.environ["DEEPBEDMAP_TORCH_BUILD_DIR"] = str(base / "lib")
    lib = kernels.library()
    lines = kernels.build_log.splitlines()
    for i, line in enumerate(lines):
        if marker in line and "Function properties" in line:
            print(f"  {name}: ptxas {lines[i + 1].strip()}; {lines[i + 2].strip()}")
        elif marker in line and "Potential Performance Loss" in line:
            print(f"  {name}: ptxas {line.split(' in the function')[0].strip()}")
    kernels._CSRC = src
    return lib


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_tail_variants.py: no CUDA device; it does not run on the CPU")
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops.tail import deform64_lrelu

    card_name = cs.card()
    print(card_name)
    libs = {name: build(_kernels, name, edits) for name, edits in VARIANTS.items()}
    gen = torch.Generator().manual_seed(3)
    n, h, w, c = cs.MAIN_TAIL
    x = cs._randn((n, h, w, c), gen)
    offsets = {"random": cs._offsets((n, h, w, 18), gen),
               "uniform": torch.full((n, h, w, 18), 0.3, device="cuda")}
    w1, b1 = cs._randn((c, c, 3, 3), gen, 0.05), cs._randn((c,), gen, 0.1)
    times: dict = {}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            _kernels._lib = lib
            for kind, off in offsets.items():
                ms = cs.time_ms(lambda: deform64_lrelu(x, off, w1, b1, 2), 10)
                times.setdefault(f"{name}/{kind}", []).append(ms)
                print(f"  K2 {name}, {kind} offsets: {ms:.3f} ms  [{card_name}]", flush=True)
    print(json.dumps({"card": card_name, "shape": list(cs.MAIN_TAIL), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What sets the pace of K6 and K5 (``csrc/rdb_tile.cuh``, the tile-local
dense block on the tensor cores), on each of its routes: the shipped kernels
timed beside variants of the tile's source on one CUDA card, at the
main-path shape (2, 286, 286, 64).

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_tile_variants.py [--rounds 2]

Each variant is ``csrc`` with one edit of ``rdb_tile.cuh``, built (only
``rdb_banded.cu`` and ``rrdb_sweep.cu``) into its own directory under
``build/variants/``. The 3xTF32 route:

- ``shipped``: no edit (both routes as shipped);
- ``divergent``: the warpgroup index taken from the thread index without a
  shuffle and the copies branched instead of predicated, so that ptxas takes
  the branches around the wgmma instructions for divergent;
- ``one_pass``: hi.hi only, a single TF32 pass (its output is wrong; timed
  only);
- ``no_wgmma``: no products at all: the staging, the A loads and splits, the
  barriers and the epilogues alone (output wrong; timed only).

The bf16 route (``stage_bf16``, K6 and K5 with bf16 multiplicands):

- ``partial``: a fresh partial sum per nine taps (one k16 step), added to
  the stage's sum in fp32, in place of one chain per stage;
- ``unit16``: weight units of 16 channels (one k16 step: 40 barriers a
  tile, a 3-slot ring two units ahead) in place of 32;
- ``no_products``: no ``wgmma`` (the copies, x's rounding, the barriers,
  the fragment loads, which the operand fences keep, and the epilogues);
  output wrong, timed only;
- ``no_copies``: nothing copied after each tile's first unit (the products
  run on stale shared memory); output wrong, timed only.

The bf16 variants that compute the function are held, K6 and K5 at the
ragged (3, 37, 9, 64) and the main-path shapes, to the plain version on
bf16-rounded operands by ``chip_smoke.py``'s phase-28 rule (the largest and
the mean of |route - plain| over the range against ``TOL_MXU_MAX`` and
``TOL_MXU_MEAN``; a variant outside them is reported, not raised). Every
variant is timed in turns, ``--rounds`` times: K6 on its route, K5 on its
route for ``shipped``, ``divergent`` and the bf16 variants. It prints the
card's name and power limit, ptxas's register, spill and performance lines
for K6's kernels, each error and time, and as its last line a JSON object
of the errors and times. It refuses to run without a CUDA device.
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
from chip_conv_variants import errors  # noqa: E402

_PRODUCTS = (
    "          wgmma_k8(part, al[kx], weight_desc(bh), kx > 0);               // lo . hi\n",
    "          wgmma_k8(part, ah[kx], weight_desc(bh + kCK * kCout), 1);      // hi . lo\n",
    "          wgmma_k8(part, ah[kx], weight_desc(bh), 1);                    // hi . hi\n",
)
_BF16_PRODUCT = "wgmma_bf16(acc[m], a[tap], weight_desc(bn + tap * 16 * kCout), 1);"
# (edits, route): route "tf32" times the 3xTF32 kernels, "bf16" the bf16 ones
VARIANTS = {
    "shipped": ([], "both"),
    "divergent": ([
        ("const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), row",
         "const int wg = tid >> 7, row"),
        ("cp_async16_pred(dst + 4 * i, ws + 4 * i, 16, i < n4);",
         "if (i < n4) cp_async16(dst + 4 * i, ws + 4 * i, true);"),
        ("cp_async16_pred(xs + kCK * p + 4 * half, s, inside ? 16 : 0, i < 2 * win_pix(0));",
         "if (i < 2 * win_pix(0)) cp_async16(xs + kCK * p + 4 * half, s, inside);"),
    ], "tf32"),
    "one_pass": ([(line, "") for line in _PRODUCTS[:2]], "tf32"),
    "no_wgmma": ([(line, "") for line in _PRODUCTS], "tf32"),
    "partial": ([
        (_BF16_PRODUCT,
         "wgmma_bf16(part, a[tap], weight_desc(bn + tap * 16 * kCout), tap > 0);"),
        ('        asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");\n#pragma unroll\n'
         "        for (int tap = 0; tap < 9; ++tap)\n",
         '        float part[16];\n        asm volatile("wgmma.fence.sync.aligned;\\n" ::: '
         '"memory");\n#pragma unroll\n        for (int tap = 0; tap < 9; ++tap)\n'),
        ("        fence_operands(acc[m]);\n",
         "        fence_operands(part);\n"
         "        for (int i = 0; i < 16; ++i) acc[m][i] += part[i];\n"),
    ], "bf16"),
    "unit16": ([("constexpr int kBfSteps = 2;", "constexpr int kBfSteps = 1;")], "bf16"),
    "no_products": ([(_BF16_PRODUCT, ";")], "bf16"),
    "no_copies": ([("    issue(u + kBfAhead);\n", "    cp_async_commit();\n")], "bf16"),
}
TIMED_ONLY = ("one_pass", "no_wgmma", "no_products", "no_copies")  # wrong by design
K5_TF32 = ("shipped", "divergent")
SOURCES = ("rdb_banded.cu", "rrdb_sweep.cu")


def build(kernels, name: str, edits):
    """``rdb_banded.cu`` and ``rrdb_sweep.cu`` built from ``csrc`` with
    ``edits`` applied to ``rdb_tile.cuh``; prints ptxas's lines for K6's
    kernels."""
    src = Path(kernels._CSRC)
    base = ROOT / "build" / "variants" / name
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(src, base / "csrc")
    header = base / "csrc" / "rdb_tile.cuh"
    text = header.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: {old.strip()!r} not in rdb_tile.cuh")
        text = text.replace(old, new)
    header.write_text(text)
    saved = kernels._CSRC, kernels._SOURCES, kernels._SIGNATURES
    kernels._CSRC, kernels._lib = base / "csrc", None
    kernels._SOURCES = SOURCES
    kernels._SIGNATURES = {k: v for k, v in saved[2].items()
                           if k in ("rdb_banded_forward", "rrdb_sweep_forward")}
    os.environ["DEEPBEDMAP_TORCH_BUILD_DIR"] = str(base / "lib")
    try:
        lib = kernels.library()
    finally:
        kernels._CSRC, kernels._SOURCES, kernels._SIGNATURES = saved
    lines = kernels.build_log.splitlines()
    for i, line in enumerate(lines):
        for route, marker in (("3xTF32", "rdb_banded_kernelILb0"),
                              ("bf16", "rdb_banded_kernelILb1")):
            if marker in line and "Function properties" in line:
                print(f"  {name}: ptxas, K6 {route}: {lines[i + 1].strip()}; "
                      f"{lines[i + 2].strip()}")
            elif marker in line and "Potential Performance Loss" in line:
                print(f"  {name}: ptxas, K6 {route}: "
                      f"{line.split(' in the function')[0].strip()}")
    return lib


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_tile_variants.py: no CUDA device; it does not run on the CPU")
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops.rdb import (
        rdb_banded,
        rdb_reference,
        rrdb_reference,
        rrdb_sweep,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card_name = cs.card()
    print(card_name, flush=True)
    libs = {name: build(_kernels, name, edits) for name, (edits, _) in VARIANTS.items()}
    gen = torch.Generator().manual_seed(6)
    f, g = 64, 32
    cins, couts = [f + g * j for j in range(5)], [g, g, g, g, f]
    blocks = [([cs._randn((co, ci, 3, 3), gen, cs.MXU_WEIGHT_SCALE)
                for ci, co in zip(cins, couts)],
               [cs._randn((co,), gen, 0.1) for co in couts]) for _ in range(3)]
    k1, b1 = blocks[0]
    ks, bs = [k for k, _ in blocks], [b for _, b in blocks]
    s = cs.MXU_SCALING
    k6 = lambda x, m: rdb_banded(x, k1, b1, s, m)  # noqa: E731
    k5 = lambda x, m: rrdb_sweep(x, ks, bs, s, m)  # noqa: E731

    report: dict = {"card": card_name, "shape": list(cs.MAIN_RDB), "errors": {}, "ms": {}}
    xs = {shape: cs._randn(shape, gen) for shape in (cs.RAGGED_RDB, cs.MAIN_RDB)}
    for shape, x in xs.items():
        want = {"K6": rdb_reference(x, k1, b1, s, mxu_bf16=True),
                "K5": rrdb_reference(x, ks, bs, s, mxu_bf16=True)}
        for name, (_, route) in VARIANTS.items():
            if route == "tf32" or name in TIMED_ONLY:
                continue
            _kernels._lib = libs[name]
            for kname, fn in (("K6", k6), ("K5", k5)):
                e = errors(fn(x, True), want[kname])
                report["errors"][f"{name}/{kname} bf16 {shape}"] = e
                print(f"  {name} {kname} bf16 {shape}: max {e['max']:.3e}, mean "
                      f"{e['mean']:.3e} of the range; within {e['within']}", flush=True)
        del want
    torch.cuda.empty_cache()

    x = xs[cs.MAIN_RDB]
    for _ in range(args.rounds):
        for name, (_, route) in VARIANTS.items():
            _kernels._lib = libs[name]
            timed = []
            if route in ("tf32", "both"):
                timed.append(("K6 3xTF32", lambda: k6(x, False), 10))
                if name in K5_TF32:
                    timed.append(("K5 3xTF32", lambda: k5(x, False), 5))
            if route in ("bf16", "both"):
                timed += [("K6 bf16", lambda: k6(x, True), 10),
                          ("K5 bf16", lambda: k5(x, True), 5)]
            for label, fn, reps in timed:
                ms = cs.time_ms(fn, reps)
                report["ms"].setdefault(f"{label}/{name}", []).append(ms)
                print(f"  {label} {name}: {ms:.3f} ms  [{card_name}]", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

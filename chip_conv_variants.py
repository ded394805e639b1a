#!/usr/bin/env python3
"""The bf16 route of the tensor-core conv (``csrc/conv3x3_tc.cuh``,
``conv3x3_tc_stage_bf16``: K1, K4 and K10 with bf16 multiplicands) at each
chunk depth and chain length, on one CUDA card: each variant held to the
plain version on bf16-rounded operands at the ragged and main-path shapes by
``chip_smoke.py``'s phase-28 rule, and timed in turns beside the 3xTF32
kernels at the main-path shapes.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_conv_variants.py [--rounds 2]

Each variant is ``csrc`` with one edit of ``conv3x3_tc.cuh``, built (only
``rdb.cu`` and ``conv3x3.cu``) into its own directory under
``build/variants/``:

- ``shipped``: no edit (32 channels a chunk, every product of a stage in
  one chain on one accumulator);
- ``chunk16``: 16 channels a chunk (one k16 step, twice the barriers);
- ``partial``: a fresh partial sum per chain of nine taps, added to the
  running sum in fp32;
- ``chunk16_partial``: both;
- ``no_products``: no ``wgmma`` at all, everything else as shipped (the
  copies, the rounding, the barriers, the fragment loads, which the operand
  fences keep, the epilogue); output wrong, timed only;
- ``no_copies``: no copies after the first two steps (the products run on
  stale shared memory); output wrong, timed only.

It prints the card's name and power limit, ptxas's register, spill and
performance lines for the bf16 kernels, each variant's errors (the largest
and the mean of |route - plain| over the range, against ``TOL_MXU_MAX`` and
``TOL_MXU_MEAN``; a variant outside them is reported, not raised), each
time, and as its last line a JSON object of the errors and times. It refuses
to run without a CUDA device.
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

_CHUNK = ("constexpr int kBfChunk = 32;", "constexpr int kBfChunk = 16;")
_PRODUCTS = ("        wgmma_bf16(acc, a[tap], weight_desc(ws + (k * 9 + tap) * 16 * kCout), 1);\n")
_PARTIAL = [
    ("  float acc[kAcc];\n  stage_w(0);", "  float acc[kAcc], part[kAcc];\n  stage_w(0);"),
    (_PRODUCTS, _PRODUCTS.replace("(acc,", "(part,").replace(", 1);", ", tap > 0);")),
    ("      fence_operands(acc);\n",
     "      fence_operands(part);\n      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];\n"),
]
VARIANTS = {
    "shipped": [],
    "chunk16": [_CHUNK],
    "partial": _PARTIAL,
    "chunk16_partial": [_CHUNK, *_PARTIAL],
    "no_products": [(_PRODUCTS, "")],
    "no_copies": [("    if (s + 1 < steps) stage_w(s + 1);\n    if (s + 2 < steps) land(s + 2);\n",
                   "")],
}
TIMED_ONLY = ("no_products", "no_copies")  # their outputs are wrong by design
SOURCES = ("rdb.cu", "conv3x3.cu")


def build(kernels, name: str, edits):
    """``rdb.cu`` and ``conv3x3.cu`` built from ``csrc`` with ``edits`` applied
    to ``conv3x3_tc.cuh``; prints ptxas's lines for the bf16 kernels."""
    src = Path(kernels._CSRC)
    base = ROOT / "build" / "variants" / name
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(src, base / "csrc")
    header = base / "csrc" / "conv3x3_tc.cuh"
    text = header.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in conv3x3_tc.cuh")
        text = text.replace(old, new)
    header.write_text(text)
    saved = kernels._CSRC, kernels._SOURCES, kernels._SIGNATURES
    kernels._CSRC, kernels._lib = base / "csrc", None
    kernels._SOURCES = SOURCES
    kernels._SIGNATURES = {k: v for k, v in saved[2].items()
                           if k in ("rdb_forward", "rrdb_forward", "conv3x3_forward")}
    os.environ["DEEPBEDMAP_TORCH_BUILD_DIR"] = str(base / "lib")
    try:
        lib = kernels.library()
    finally:
        kernels._CSRC, kernels._SOURCES, kernels._SIGNATURES = saved
    lines = kernels.build_log.splitlines()
    for i, line in enumerate(lines):
        if "conv3x3_tc_stage_bf16" in line and "Function properties" in line:
            print(f"  {name}: ptxas {line.split('for')[-1].strip()} "
                  f"{lines[i + 1].strip()}; {lines[i + 2].strip()}")
        elif "Potential Performance Loss" in line:
            print(f"  {name}: ptxas {line.strip()}")
    return lib


def errors(got, want) -> dict:
    scale = float(want.abs().max())
    d = (got.double() - want.double()).abs()
    return {"max": float(d.max()) / scale, "mean": float(d.mean()) / scale,
            "within": bool(float(d.max()) <= cs.TOL_MXU_MAX * scale
                           and float(d.mean()) <= cs.TOL_MXU_MEAN * scale)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_conv_variants.py: no CUDA device; it does not run on the CPU")
    from deepbedmap_tpu_torch.ops import _kernels, rdb
    from deepbedmap_tpu_torch.ops.conv3x3 import conv3x3_fused, conv3x3_reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card_name = cs.card()
    print(card_name, flush=True)
    libs = {name: build(_kernels, name, edits) for name, edits in VARIANTS.items()}

    gen = torch.Generator().manual_seed(17)
    f, g = 64, 32
    cins, couts = [f + g * j for j in range(5)], [g, g, g, g, f]
    blocks = [([cs._randn((co, ci, 3, 3), gen, cs.MXU_WEIGHT_SCALE)
                for ci, co in zip(cins, couts)],
               [cs._randn((co,), gen, 0.1) for co in couts]) for _ in range(3)]
    k1, b1 = blocks[0]
    ks, bs = [k for k, _ in blocks], [b for _, b in blocks]
    s = cs.MXU_SCALING
    convs = []
    for n, h, w, cin, leaky, residual in cs.MAIN_CONVS:
        wt, b = cs._randn((64, cin, 3, 3), gen, 0.05), cs._randn((64,), gen, 0.1)
        convs.append(((n, h, w, cin), wt, b, leaky, residual))

    def k10(x, c, mode):
        _, wt, b, leaky, residual = c
        return conv3x3_fused(x, wt, b, leaky, x[..., :64] if residual else None, mode)

    # the checks: K1 and K4 at the ragged and main-path shapes, K10 at its four
    xs = {shape: cs._randn(shape, gen) for shape in (cs.RAGGED_RDB, cs.MAIN_RDB)}
    xc = [cs._randn(c[0], gen) for c in convs]
    want = {}
    for shape, x in xs.items():
        want["K1", shape] = rdb.rdb_reference(x, k1, b1, s, mxu_bf16=True)
        want["K4", shape] = rdb.rrdb_reference(x, ks, bs, s, mxu_bf16=True)
    for c, x in zip(convs, xc):
        _, wt, b, leaky, residual = c
        want["K10", c[0]] = conv3x3_reference(x, wt, b, leaky,
                                              x[..., :64] if residual else None, True)
    report: dict = {"card": card_name, "errors": {}, "ms": {}}
    for name, lib in libs.items():
        if name in TIMED_ONLY:
            continue
        _kernels._lib = lib
        for shape, x in xs.items():
            for kname, got in (("K1", rdb.rdb_fused(x, k1, b1, s, True)),
                               ("K4", rdb.rrdb_fused(x, ks, bs, s, True))):
                e = errors(got, want[kname, shape])
                report["errors"][f"{name}/{kname} {shape}"] = e
                print(f"  {name} {kname} {shape}: max {e['max']:.3e}, mean {e['mean']:.3e} "
                      f"of the range; within {e['within']}", flush=True)
        for c, x in zip(convs, xc):
            e = errors(k10(x, c, True), want["K10", c[0]])
            report["errors"][f"{name}/K10 {c[0]}"] = e
            print(f"  {name} K10 {c[0]}: max {e['max']:.3e}, mean {e['mean']:.3e} of the "
                  f"range; within {e['within']}", flush=True)
    del want
    torch.cuda.empty_cache()

    x = xs[cs.MAIN_RDB]
    timed = {
        "K1": lambda m: rdb.rdb_fused(x, k1, b1, s, m),
        "K4": lambda m: rdb.rrdb_fused(x, ks, bs, s, m),
        "K10": lambda m: [k10(xi, c, m) for c, xi in zip(convs, xc)],
    }
    for _ in range(args.rounds):
        for name, lib in [("tf32x3", libs["shipped"])] + list(libs.items()):
            _kernels._lib = lib
            for kname, fn in timed.items():
                ms = cs.time_ms(lambda: fn(name != "tf32x3"), 10)
                report["ms"].setdefault(f"{kname}/{name}", []).append(ms)
                print(f"  {kname} {name}: {ms:.3f} ms  [{card_name}]", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

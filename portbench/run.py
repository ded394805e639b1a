"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. It loads the cell's configuration and traffic
mix, sets up the program (`deepbedmap_tpu_torch`) with weights and inputs
drawn from the seed, warms up the cell's shapes, measures for `--seconds`,
with `--trace 1` reads the per-layer metrics from a traced slice after the
window, checks what the timed path produced against the plain reference,
and prints one JSON line last on standard output. Without a card (or with
fewer than the cell asks for), or with JAX or the JAX package loaded, it
exits with a code other than 0 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's kernel build and any Triton cache at fixed paths inside the
# checkout, so that only a checkout's first run builds
os.environ["DEEPBEDMAP_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# one host thread for PyTorch's and OpenMP's pools: the paths measured drive
# the card from one Python thread, and idle pool threads spinning on a host
# shared with other machines only add noise
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != Path(__file__).resolve().parent]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    args = parse(argv)
    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    cell.seed = args.seed
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    harness.import_program(ROOT)
    run = harness.load_driver(cell).Run(cell)
    run.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    window = run.window(args.seconds)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "power_limit_w": harness.power_limit_w()}
    if args.trace:
        ctx = run.trace()
        ctx.update(window=window, cell=cell)
        metrics = harness.read_layer_metrics(cell, ctx)
        device.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
        breakdown = {k: ctx["trace"][k] for k in ("device_ops", "idle_gaps")}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    run.release()

    checks = harness.judge(cell, run.check())
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {', '.join(found)}", 4)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}"
              f"{'' if c['ok'] else '  FAILED'}", file=sys.stderr, flush=True)
    result = {"correct": all(c["ok"] for c in checks), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""Readings that a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload NAME --seeds 12 [--first 1000]

For each seed: the cell's set-up, a short window of its timed path (as long
as its driver's `READINGS_WINDOW_S`; none for training), and its check,
with the control (the plain reference one precision step below each that
the configuration states, in the program's place) and, where the cell can
have them, faults planted in the reference. Prints one JSON line a seed
({"seed", "readings"}) and, last, the largest reading of the program and
the smallest of each control and fault: the lower and the upper readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != Path(__file__).resolve().parent]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=1000)
    args = ap.parse_args(argv)
    import os

    os.environ["DEEPBEDMAP_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    harness.import_program(ROOT)
    lower, upper = {}, {}
    for seed in range(args.first, args.first + args.seeds):
        cell = harness.load_cell(ROOT, args.workload)
        cell.seed = seed
        run = harness.load_driver(cell).Run(cell)
        t0 = time.perf_counter()
        run.setup()
        t1 = time.perf_counter()
        if run.READINGS_WINDOW_S is not None:
            run.window(run.READINGS_WINDOW_S)
        t2 = time.perf_counter()
        run.release()
        got = run.check(control=True)
        t3 = time.perf_counter()
        controls = {k: v for k, v in got.items() if k.startswith(("control", "fault"))}
        for k, v in got.items():
            if k in controls:
                upper[k] = min(upper.get(k, v), v)
            else:
                lower[k] = max(lower.get(k, v), v)
        print(json.dumps({"seed": seed, "readings": got, "setup_s": t1 - t0,
                          "pass_s": t2 - t1, "check_s": t3 - t2}), flush=True)
        del run
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "card": torch.cuda.get_device_name(0),
                      "power_limit_w": harness.power_limit_w()}), flush=True)


if __name__ == "__main__":
    main()

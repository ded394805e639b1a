"""What the program's telemetry costs, in one process on the card:

    python3 portbench/telemetry_cost.py --workload CELL --seed N --rounds 3

from the root of a checkout. It sets up the cell as `run.py` does, then
runs the slice its `--trace 1` run traces (one continent pass, the first
`trace_requests` region requests, `trace_steps` train steps) in rounds of
three modes, the order turning each round: `off` (no switch, no profiler),
`on` (the registry's switch alone) and `profiled` (under
`tracing.profile`, which the benchmark's readers read). It prints one JSON
line: each mode's wall seconds per round; per span the host `total_ms` (or
`device_ms`) per unit of the slice in the `on` and `profiled` modes (units:
the registry's tiles, requests or steps) and their ratio, the profiler's
inflation; the profiled slice's longest idle gaps; and the new per-layer
metrics as the profiled slice reads them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["DEEPBEDMAP_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != Path(__file__).resolve().parent]

UNITS = {"continent": "continent.tiles", "region": "predict.requests", "train": "train.steps"}
METRICS = {"continent": ("band_slice_ms_per_tile.continent", "band_upload_ms_per_tile.continent",
                         "fetch_wait_ms_per_tile.continent", "pageable_upload_share.continent",
                         "tail_offset_convs_ms.continent"),
           "region": ("inputs_ms.region",),
           "train": ("g_update_ms.train", "d_update_ms.train")}


def the_slice(kind: str, run):
    """The slice the driver's `trace()` profiles, as a function."""
    if kind == "continent":
        return run._pass
    if kind == "region":
        requests = run.requests[: run.cell.traffic["trace_requests"]]
        return lambda: [run.dbm.predict(w, run.rasters) for w in requests]
    from deepbedmap_tpu_torch.train.loop import make_epoch_fns

    train_fn, _ = make_epoch_fns(run.dataset, run.t_cfg)
    return lambda: train_fn(run.state, run.trace_rows)


def per_unit(snap, unit: str):
    units = snap["counters"][unit]
    return {name: a.get("total_ms", a.get("device_ms")) / units
            for name, a in snap["spans"].items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness, tracing

    torch.set_num_threads(1)
    cell = harness.load_cell(ROOT, args.workload)
    cell.seed = args.seed
    harness.import_program(ROOT)
    from deepbedmap_tpu_torch.utils import profiling

    kind = cell.traffic["driver"]
    run = harness.load_driver(cell).Run(cell)
    run.setup()
    fn = the_slice(kind, run)
    torch.cuda.synchronize()
    walls = {"off": [], "on": [], "profiled": []}
    spans = {"on": [], "profiled": []}
    gaps = metrics = None
    for r in range(args.rounds):
        order = ["off", "on", "profiled"]
        for mode in order[r % 3:] + order[: r % 3]:
            profiling.reset()
            if mode == "on":
                profiling.enable()
            t = time.perf_counter()
            if mode == "profiled":
                summary = tracing.profile(fn)
            else:
                fn()
                torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t)
            profiling.disable()
            if mode != "off":
                spans[mode].append(per_unit(profiling.snapshot(), UNITS[kind]))
            if mode == "profiled" and gaps is None:
                gaps = summary["idle_gaps"][:5]
                metrics = {}
                for name in METRICS[kind]:
                    reader = harness._load_module(harness.HERE / "metrics" / f"{name}.py",
                                                  "portbench_metric_" + name.replace(".", "_"))
                    metrics[name] = reader.read({})
    med = {mode: {name: statistics.median(s[name] for s in runs) for name in runs[0]}
           for mode, runs in spans.items()}
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0),
           "power_limit_w": harness.power_limit_w(), "wall_s": walls,
           "per_unit_ms": {name: {"on": med["on"][name], "profiled": med["profiled"].get(name),
                                  "inflation": (med["profiled"].get(name) or 0.0)
                                  / med["on"][name] if med["on"][name] else None}
                           for name in sorted(med["on"])},
           "idle_gaps": gaps, "metrics": metrics}
    run.release()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

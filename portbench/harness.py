"""Finding a cell's parts by name, and the shape of a run's result.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by the names in `BENCHMARK.json`:

- configuration `<name>`: the `file` its entry names (`configs/<name>.json`);
- traffic mix `<name>`: `traffic/<name>.json`, whose `driver` names the
  general generator `drivers/<driver>.py` that reads it;
- per-layer metric `<name>`: the reader `metrics/<name>.py`, whose
  `read(ctx)` returns the value or None where it finds nothing to read;
- a cell's limits on the numbers its check compares: `limits/<cell>.json`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
# top-level module names a run may not hold: JAX and the JAX package, whose
# name the port's begins with, so names are compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "deepbedmap_tpu")
PROGRAM = "deepbedmap_tpu_torch"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int = 0
    device: str = "cuda"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json, with its configuration,
    traffic mix, limits and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    limits_path = bench_dir / "limits" / f"{workload}.json"
    return Cell(name=workload, chips=int(w["chips"]),
                config=_json(root / configs[w["config"]]["file"]),
                traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_json(limits_path) if limits_path.is_file() else {},
                end_to_end=e2e, per_layer=layer)


def load_driver(cell: Cell, bench_dir: Path = HERE) -> ModuleType:
    kind = cell.traffic["driver"]
    return _load_module(bench_dir / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def read_layer_metrics(cell: Cell, ctx: dict, bench_dir: Path = HERE) -> Dict[str, dict]:
    """Each per-layer metric's reader on ``ctx``; a reader that returns None
    found nothing to read, and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = _load_module(bench_dir / "metrics" / f"{m['name']}.py",
                              "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def import_program(root: Path) -> ModuleType:
    """The port's package, which has to come from ``root``."""
    import importlib

    module = importlib.import_module(PROGRAM)
    where = Path(module.__file__).resolve()
    if root.resolve() not in where.parents:
        raise ImportError(f"{PROGRAM} loaded from {where}, outside {root}")
    return module


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def judge(cell: Cell, readings: Dict[str, float]) -> List[dict]:
    """Each compared number beside its limit, in ``limits/<cell>.json``;
    a number without a limit fails."""
    out = []
    for name, value in readings.items():
        limit = cell.limits.get(name, {}).get("limit")
        ok = limit is not None and value == value and value <= limit
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return out

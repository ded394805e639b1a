"""What a traced run reads: device time from a `torch.profiler` trace, and
CUDA-event spans around the calls into each layer of the generator.

`summarize` is the arithmetic of the program's on-card checks
(`chip_smoke.py:trace_summary`): the union of the device events' intervals
over the window from the first device event to the last gives the busy time
and the idle share. Each idle gap is named by the outermost host operator
that spans it, which says what the host was doing while the card waited.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
TOP = 10


def _host_during(host: List[tuple], start: float, end: float) -> str:
    """The outermost host event spanning [start, end]: the earliest to begin
    (the longest among those); else the one that overlaps it most."""
    spanning = [h for h in host if h[0] <= start and h[1] >= end]
    if spanning:
        return min(spanning, key=lambda h: (h[0], -h[1]))[2]
    overlap = [(min(h[1], end) - max(h[0], start), h[2]) for h in host
               if h[0] < end and h[1] > start]
    return max(overlap)[1] if overlap else "no host operator"


def summarize(events: List[dict]) -> Dict:
    """A Chrome trace's events (``traceEvents``) -> busy and window seconds,
    the idle share, the top device operations by total seconds, the longest
    idle gaps named by host operator, and the seconds of host-to-device
    copies. Raises when the trace holds no device event."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    if not dev:
        raise RuntimeError("the trace holds no device event")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in dev)
    merged = []
    for s, e, _ in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    start, end = merged[0][0], merged[-1][1]
    busy = sum(e - s for s, e in merged)
    totals: Dict[str, float] = {}
    for s, e, name in spans:
        totals[name] = totals.get(name, 0.0) + (e - s)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:TOP]
    return {
        "busy_s": busy / 1e6,
        "window_s": (end - start) / 1e6,
        "idle_share": 1.0 - busy / (end - start),
        "device_ops": [[n, t / 1e6] for n, t in
                       sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[_host_during(host, a, b), g / 1e6] for g, a, b in gaps],
        "htod_s": sum(e - s for s, e, n in spans if "HtoD" in n) / 1e6,
    }


def profile(fn) -> Dict:
    """Run ``fn()`` under ``torch.profiler`` (host and CUDA activities),
    synchronise, and summarize the trace, written under ``TMPDIR`` and
    removed once read."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events)


class StageSpans:
    """CUDA events around calls of an object's methods: ``wrap(obj, names)``
    replaces each bound method on the instance; ``ms()`` synchronises and
    returns each method's device milliseconds summed over its calls, and
    the number of calls of each."""

    def __init__(self):
        self.marks: Dict[str, list] = {}

    def wrap(self, obj, names):
        for name in names:
            inner = getattr(obj, name)
            marks = self.marks.setdefault(name, [])

            def timed(*args, _inner=inner, _marks=marks, **kw):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _inner(*args, **kw)
                stop.record()
                _marks.append((start, stop))
                return out

            setattr(obj, name, timed)

    @staticmethod
    def unwrap(obj, names):
        for name in names:
            with contextlib.suppress(AttributeError):
                delattr(obj, name)

    def ms(self) -> Dict[str, tuple]:
        torch.cuda.synchronize()
        return {n: (sum(a.elapsed_time(b) for a, b in m), len(m))
                for n, m in self.marks.items()}

"""Tracing and timing of the port: the telemetry registry (spans, device spans
and counters at the program's layer boundaries), a ``torch.profiler`` trace
around a block, and a wall-clock timer.

Counterpart of ``deepbedmap_tpu/utils/profiling.py``: ``trace`` takes the
place of ``jax.profiler.start_trace`` / ``stop_trace``. It writes a Chrome
trace (``*.pt.trace.json``) through
``torch.profiler.tensorboard_trace_handler``, which needs no package beyond
PyTorch; open it in Perfetto, ``chrome://tracing`` or TensorBoard's profiler
plugin. On a CUDA device the trace holds the card's kernels and copies
(CUPTI) beside the host's operators.

The registry records while ``recording()`` is true: while the operator's
switch is on (``enable()``, or ``DEEPBEDMAP_TORCH_TELEMETRY=1`` in the
environment when the module is imported) or while a ``torch.profiler``
session is active. Otherwise a span is one flag check and a shared no-op
context: no clock reading, no lock, no ``record_function``.

- ``span(name, range=True, **amounts)``: host start and end
  (``time.perf_counter_ns``), the enclosing span, and the id of the
  outermost one (a continent pass, a region request, a train step), kept on
  a ``contextvars`` stack so that threads keep their requests apart;
  ``amounts`` are summed per name. Under a profiler a span opened with
  ``range=True`` is also a ``record_function`` range of the same name. The
  spans that enclose others (a pass, a request, a step, a region's inputs)
  are opened with ``range=False``: a profiler names an idle gap of the card
  by the outermost range around it, and a range around a whole pass would
  name every gap after itself.
- ``device_span(name, device)``: CUDA events on the current stream around
  work inside one forward, resolved at ``snapshot()``; on the CPU, where the
  work runs as it is called, the host clock. Never a profiler range.
- ``count(name, n=1)``: a counter.
- ``snapshot()``: per name ``calls``, host ``total_ms`` and ``self_ms`` (the
  duration less what child spans cover), ``device_ms`` of device spans and
  the summed amounts; the counters; ``dropped``.
- ``reset()`` clears everything; ``export(path)`` writes the records as a
  Chrome trace that Perfetto opens.

Records are kept up to ``MAX_RECORDS``; past it only the aggregates grow and
``dropped`` counts the records lost. ``ops._kernels.launches`` stays apart:
it is an exact count that is always on.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from deepbedmap_tpu_torch.device import resolve_device

MAX_RECORDS = 100_000
# unresolved device spans kept before the finished ones are resolved early
MAX_PENDING = 4096

_enabled = os.environ.get("DEEPBEDMAP_TORCH_TELEMETRY", "") not in ("", "0")

if hasattr(torch.autograd.profiler, "_is_profiler_enabled"):
    _PROFILER = torch.autograd.profiler  # its flag is rebound by every session

    def _profiling() -> bool:
        return _PROFILER._is_profiler_enabled
else:  # pragma: no cover - older PyTorch
    _profiling = torch._C._autograd._profiler_enabled

_clock = time.perf_counter_ns
_open: contextvars.ContextVar = contextvars.ContextVar("deepbedmap_torch_span", default=None)
_ids = itertools.count(1)
_NOOP = contextlib.nullcontext()


def enable() -> None:
    """Turn the operator's switch on: record until ``disable()``."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def recording() -> bool:
    """Whether spans and counters record now: the switch is on or a
    ``torch.profiler`` session is active."""
    return _enabled or _profiling()


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self._clear()

    def _clear(self) -> None:
        self.records: List[tuple] = []
        self.pending: List["_DeviceSpan"] = []
        self.spans: Dict[str, dict] = {}
        self.counters: Dict[str, float] = {}
        self.dropped = 0

    def _agg(self, name: str) -> dict:
        a = self.spans.get(name)
        if a is None:
            a = self.spans[name] = {"calls": 0}
        return a

    def _keep(self, record: tuple) -> None:
        if len(self.records) < MAX_RECORDS:
            self.records.append(record)
        else:
            self.dropped += 1

    def add_span(self, s: "_Span", t1: int) -> None:
        dur = t1 - s.t0
        parent = s.parent
        with self.lock:
            a = self._agg(s.name)
            a["calls"] += 1
            a["total_ns"] = a.get("total_ns", 0) + dur
            a["self_ns"] = a.get("self_ns", 0) + dur - s.child_ns
            for k, v in s.amounts.items():
                a[k] = a.get(k, 0) + v
            self._keep(("span", s.name, s.t0, t1, threading.get_ident(), s.id,
                        parent.id if parent is not None else None, s.root, s.amounts))

    def add_device(self, d: "_DeviceSpan", ms: Optional[float] = None) -> None:
        with self.lock:
            if ms is not None:
                self._settle(d, ms)
                return
            if len(self.pending) >= MAX_PENDING:
                self._resolve(block=False)
                if len(self.pending) >= MAX_PENDING:
                    self.pending.pop(0)
                    self.dropped += 1
            self.pending.append(d)

    def _settle(self, d: "_DeviceSpan", ms: float) -> None:
        a = self._agg(d.name)
        a["calls"] += 1
        a["device_ms"] = a.get("device_ms", 0.0) + ms
        self._keep(("device", d.name, d.t0, d.t0 + int(ms * 1e6), 0, None, d.parent,
                    d.root, {}))

    def _resolve(self, block: bool) -> None:
        left = []
        for d in self.pending:
            if block:
                d.stop.synchronize()
            elif not d.stop.query():
                left.append(d)
                continue
            self._settle(d, d.start.elapsed_time(d.stop))
        self.pending = left

    def add_count(self, name: str, n) -> None:
        t = _clock()
        with self.lock:
            value = self.counters[name] = self.counters.get(name, 0) + n
            self._keep(("count", name, t, t, threading.get_ident(), None, None, None,
                        {name: value}))


_registry = _Registry()


class _Span:
    __slots__ = ("name", "range", "amounts", "parent", "id", "root", "child_ns", "t0", "_rf")

    def __init__(self, name: str, range_: bool, amounts: dict):
        self.name, self.range, self.amounts = name, range_, amounts

    def __enter__(self) -> "_Span":
        parent = _open.get()
        self.parent = parent
        self.id = next(_ids)
        self.root = self.id if parent is None else parent.root
        self.child_ns = 0
        self._rf = None
        _open.set(self)
        if self.range and _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _clock()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _open.set(self.parent)
        if self.parent is not None:
            self.parent.child_ns += t1 - self.t0
        _registry.add_span(self, t1)
        return False


def span(name: str, range: bool = True, **amounts):
    """Context manager recording the block as the span ``name`` (module
    docstring). ``range=False`` for a span that encloses other spans: it is
    never a profiler range."""
    if not (_enabled or _profiling()):
        return _NOOP
    return _Span(name, range, amounts)


class _DeviceSpan:
    __slots__ = ("name", "cuda", "start", "stop", "t0", "parent", "root")

    def __init__(self, name: str, device):
        self.name = name
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self) -> "_DeviceSpan":
        parent = _open.get()
        self.parent = None if parent is None else parent.id
        self.root = None if parent is None else parent.root
        self.t0 = _clock()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.stop = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.cuda:
            self.stop.record()
            _registry.add_device(self)
        else:
            _registry.add_device(self, (_clock() - self.t0) / 1e6)
        return False


def device_span(name: str, device="cuda"):
    """Context manager timing the block's device work on ``device`` as the
    device span ``name`` (module docstring)."""
    if not (_enabled or _profiling()):
        return _NOOP
    return _DeviceSpan(name, device)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if _enabled or _profiling():
        _registry.add_count(name, n)


def snapshot() -> Dict:
    """The aggregates: ``{"spans": {name: {calls, total_ms, self_ms,
    device_ms, amounts...}}, "counters": {name: n}, "dropped": n}``. Waits
    for the device spans still on the card."""
    with _registry.lock:
        _registry._resolve(block=True)
        spans = {}
        for name, a in _registry.spans.items():
            out = {k: v for k, v in a.items() if k not in ("total_ns", "self_ns")}
            if "total_ns" in a:
                out["total_ms"] = a["total_ns"] / 1e6
                out["self_ms"] = a["self_ns"] / 1e6
            spans[name] = out
        return {"spans": spans, "counters": dict(_registry.counters),
                "dropped": _registry.dropped}


def reset() -> None:
    """Clear every record, aggregate and counter (device spans still on the
    card are dropped unread)."""
    with _registry.lock:
        _registry._clear()


def export(path: str) -> None:
    """Write the records as a Chrome trace (``traceEvents``; open it in
    Perfetto): host spans on their threads, counters as counter tracks, and
    device spans on a track of their own, each placed at the host time it
    was enqueued with its device duration."""
    snapshot()  # resolve the device spans
    with _registry.lock:
        records = list(_registry.records)
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "device spans (at their enqueue)"}}]
    for kind, name, t0, t1, tid, sid, parent, root, amounts in records:
        ts = t0 / 1e3
        if kind == "count":
            events.append({"ph": "C", "name": name, "pid": pid, "ts": ts, "args": amounts})
            continue
        args = {"parent": parent, "root": root, **amounts}
        if sid is not None:
            args["id"] = sid
        events.append({"ph": "X", "cat": kind, "name": name, "pid": pid,
                       "tid": 0 if kind == "device" else tid, "ts": ts,
                       "dur": (t1 - t0) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace of the block, written under ``log_dir`` when
    the block ends. Activities: the CPU, plus CUDA when ``device`` is a card
    (without one a CUDA ``device`` raises, as every entry point of the port
    does). The block's device work is synchronised before the trace closes,
    so kernels still queued are in it. Yields the profiler, whose
    ``key_averages()`` sums the trace by operator."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(label: str, sink=print) -> Iterator[None]:
    """Wall-clock timer context. PyTorch returns before the card finishes:
    call ``torch.cuda.synchronize()`` as the block's last statement, or the
    time is that of the enqueue."""
    start = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {time.perf_counter() - start:.3f}s")

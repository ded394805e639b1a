"""Tracing and timing helpers: a ``torch.profiler`` trace around a block, and
a wall-clock timer.

Counterpart of ``deepbedmap_tpu/utils/profiling.py``: ``trace`` takes the
place of ``jax.profiler.start_trace`` / ``stop_trace``. It writes a Chrome
trace (``*.pt.trace.json``) through
``torch.profiler.tensorboard_trace_handler``, which needs no package beyond
PyTorch; open it in Perfetto, ``chrome://tracing`` or TensorBoard's profiler
plugin. On a CUDA device the trace holds the card's kernels and copies
(CUPTI) beside the host's operators.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch

from deepbedmap_tpu_torch.device import resolve_device


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

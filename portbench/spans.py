"""What the readers of the program's own spans and counters share: the
telemetry registry's `snapshot()` (`deepbedmap_tpu_torch.utils.profiling`),
which holds exactly the driver's traced slice, since the registry records
while a profiler runs. A program without the registry, or a registry
without the span or the counter, gives None."""

from __future__ import annotations

from typing import Optional


def snapshot() -> Optional[dict]:
    try:
        from deepbedmap_tpu_torch.utils import profiling
    except ImportError:
        return None
    take = getattr(profiling, "snapshot", None)
    return None if take is None else take()


def per_unit(span: str, field: str, counter: Optional[str] = None,
             calls_of: Optional[str] = None) -> Optional[float]:
    """``field`` (``total_ms``, ``self_ms``, ``device_ms``) of ``span``
    summed over the slice, over the registry's ``counter`` or over the
    ``calls`` of the span ``calls_of``."""
    snap = snapshot()
    if snap is None:
        return None
    value = snap["spans"].get(span, {}).get(field)
    if counter is not None:
        units = snap["counters"].get(counter)
    else:
        units = snap["spans"].get(calls_of, {}).get("calls")
    return None if value is None or not units else value / units

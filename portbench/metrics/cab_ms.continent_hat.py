"""Device ms per forward of the HABs' channel-attention branches (`hat.cab`:
conv, GELU, conv, the channel attention with its global pool, the conv
scale; CUDA events), in the traced pass: the span's ms over its calls per
forward (one a HAB)."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    if snap is None:
        return None
    s = snap["spans"].get("hat.cab", {})
    if not s.get("device_ms") or not s.get("calls"):
        return None
    blocks = sum(ctx["cell"].config["generator"]["depths"])
    return s["device_ms"] * blocks / s["calls"]

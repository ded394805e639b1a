"""Device ms per forward of the Swin layers' MLPs (`swin.mlp`: LayerNorm 2,
fc1, GELU, fc2; CUDA events), in the traced pass: the span's ms over its
calls per forward (one a Swin layer)."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    if snap is None:
        return None
    s = snap["spans"].get("swin.mlp", {})
    if not s.get("device_ms") or not s.get("calls"):
        return None
    layers = sum(ctx["cell"].config["generator"]["depths"])
    return s["device_ms"] * layers / s["calls"]

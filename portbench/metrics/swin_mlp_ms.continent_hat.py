"""Device ms per forward of the HABs' and OCABs' MLPs (`swin.mlp`: LayerNorm
2, fc1, GELU, fc2; CUDA events), in the traced pass: the span's ms over its
calls per forward (one a HAB and one an OCAB, so the groups' depths plus one
a group)."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    if snap is None:
        return None
    s = snap["spans"].get("swin.mlp", {})
    if not s.get("device_ms") or not s.get("calls"):
        return None
    depths = ctx["cell"].config["generator"]["depths"]
    return s["device_ms"] * (sum(depths) + len(depths)) / s["calls"]

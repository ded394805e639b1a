"""Device ms per forward of the HABs' window attention kernel alone
(`swin.attn`, CUDA events around its launch), in the traced pass: the span's
ms over its calls per forward (one a HAB; the OCABs' cross-attention is
`hat.oca_attn`, not read here)."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    if snap is None:
        return None
    s = snap["spans"].get("swin.attn", {})
    if not s.get("device_ms") or not s.get("calls"):
        return None
    blocks = sum(ctx["cell"].config["generator"]["depths"])
    return s["device_ms"] * blocks / s["calls"]

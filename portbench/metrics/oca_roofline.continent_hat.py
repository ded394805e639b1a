"""The OCABs' cross-attention layer (`hat.oca`: qkv, the tiled window
kernel's cross-attention of 16 x 16 queries onto 24 x 24 keys, proj) against
its bound, in %: `counts.hat.oca_layer` at the traced forwards' shapes
(batch, the crop's latent padded to the window) times the span's calls,
over the span's device ms (CUDA events) in the traced pass. Read over the
whole layer, so that a kernel fusing qkv or proj cannot read over 100%."""

from portbench.counts.hat import oca_layer, padded_side
from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    if snap is None:
        return None
    s = snap["spans"].get("hat.oca", {})
    if not s.get("device_ms") or not s.get("calls"):
        return None
    g = ctx["cell"].config["generator"]
    b = oca_layer(ctx["batch"], padded_side(g, ctx["crop_lr"]), g)
    return 100.0 * 1e3 * b["s"] * s["calls"] / s["device_ms"]

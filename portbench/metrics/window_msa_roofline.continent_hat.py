"""The HABs' window attention layer (`swin.msa`: qkv, the tiled window
kernel's self-attention at window 16, proj) against its bound, in %:
`counts.hat.msa_layer` at the traced forwards' shapes (batch, the crop's
latent padded to the window) times the span's calls, over the span's device
ms (CUDA events) in the traced pass. Read over the whole layer, so that a
kernel fusing qkv or proj cannot read over 100%."""

from portbench.counts.hat import msa_layer, padded_side
from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    if snap is None:
        return None
    s = snap["spans"].get("swin.msa", {})
    if not s.get("device_ms") or not s.get("calls"):
        return None
    g = ctx["cell"].config["generator"]
    b = msa_layer(ctx["batch"], padded_side(g, ctx["crop_lr"]), g)
    return 100.0 * 1e3 * b["s"] * s["calls"] / s["device_ms"]

"""Operation counts and layer bounds of the HAT generator.

`hat_tile_flops` is copied from the program's `utils/flops.py`, so that the
yardstick stays put while the program changes; its conventions are
`counts/model.py`'s and `counts/swinir.py`'s, whose SwinIR count it extends.
`msa_layer` bounds one call of a HAB's window attention as the program times
it (`swin.msa` at window 16: the qkv linear, the window attention, proj) and
`oca_layer` one call of an OCAB's (`hat.oca`: the qkv linear, the
cross-attention onto the overlap windows, proj), by `counts/layers.py`'s
rule.
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench.counts import swinir
from portbench.counts.layers import bound

HAT_DEFAULTS = dict(embed_dim=180, depths=(6, 6, 6, 6, 6, 6), num_heads=(6, 6, 6, 6, 6, 6),
                    window_size=16, compress_ratio=3, squeeze_factor=30, conv_scale=0.01,
                    overlap_ratio=0.5)


def settings(cfg: Optional[dict] = None) -> dict:
    """HAT x4's settings with the keys of ``cfg`` that name one."""
    return {**HAT_DEFAULTS, **{k: v for k, v in (cfg or {}).items() if k in HAT_DEFAULTS}}


def overlap_window(s: dict) -> int:
    return int(s["window_size"] * s["overlap_ratio"]) + s["window_size"]


def padded_side(cfg: Optional[dict], lr: int) -> int:
    """The side the model runs at on an ``lr`` crop: the latent, lr - 2,
    padded to a multiple of the window."""
    return swinir.padded_side(settings(cfg), lr)


def hat_tile_flops(cfg: Optional[dict] = None, lr: int = 288) -> Dict[str, float]:
    """Minimal FLOPs of one HAT forward on an ``lr`` x ``lr`` low-res crop
    (the program's `utils/flops.py:hat_tile_flops`)."""
    s = settings(cfg)
    out = swinir.swinir_tile_flops(s, lr)
    del out["total"]
    out["rhag_convs"] = out.pop("rstb_convs")
    c, ws, ow = s["embed_dim"], s["window_size"], overlap_window(s)
    side = -(-(lr - 2) // ws) * ws
    tokens = float(side) ** 2
    habs, groups = sum(s["depths"]), len(s["depths"])
    stages = {
        "cab_convs": habs * tokens * 9 * 2 * c * (c // s["compress_ratio"]),
        "channel_attention": habs * 2.0 * c * (c // s["squeeze_factor"]),
        "oca_linears": groups * tokens * 4 * c * c,
        "overlap_attention": groups * tokens * 2 * ow * ow * c,
        "oca_mlp": groups * tokens * 2 * c * swinir.MLP_RATIO * c,
    }
    out.update({name: 2.0 * macs for name, macs in stages.items()})
    out["total"] = sum(out.values())
    return out


def msa_layer(batch: int, side: int, cfg: Optional[dict] = None) -> Dict[str, float]:
    """One `swin.msa` call of a HAB: `counts.swinir.msa_layer` at HAT's
    window."""
    return swinir.msa_layer(batch, side, settings(cfg))


def oca_layer(batch: int, side: int, cfg: Optional[dict] = None) -> Dict[str, float]:
    """One `hat.oca` call on a (batch, side, side, C) float32 LayerNorm
    output: the qkv and proj linears (4 C^2 MACs a token) and the
    cross-attention (2 ow^2 C, the zero-padded keys included) at the TF32
    route of fp32 products; bytes are the LayerNorm output read once, proj's
    output written once and the layer's weights (qkv, proj, their biases,
    the widest bias table) in fp32."""
    s = settings(cfg)
    c, ws, ow = s["embed_dim"], s["window_size"], overlap_window(s)
    tokens = batch * side * side
    flops = 2.0 * tokens * (4 * c * c + 2 * ow * ow * c)
    weights = 4 * c * c + 4 * c + (ws + ow - 1) ** 2 * max(s["num_heads"])
    return bound(flops, 4.0 * (2 * tokens * c + weights), "fp32")

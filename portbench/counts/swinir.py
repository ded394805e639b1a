"""Operation counts and a layer bound of the SwinIR generator.

`swinir_tile_flops` is copied from the program's `utils/flops.py`, so that the
yardstick stays put while the program changes; its conventions are
`counts/model.py`'s. `msa_layer` bounds one call of the Swin layer's
attention as the program times it (`swin.msa`: the qkv linear, the window
attention, proj), by `counts/layers.py`'s rule.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

from portbench.counts.layers import bound

SWINIR_DEFAULTS = dict(embed_dim=180, depths=(6, 6, 6, 6, 6, 6),
                       num_heads=(6, 6, 6, 6, 6, 6), window_size=8)
# the widths no configuration varies: upscale, MLP ratio, conv_before_upsample's
# width, the output channels, the input block's channels a branch
UPSCALE, MLP_RATIO, NUM_FEAT, OUT_CHANNELS, INBLOCK_CHANNELS = 4, 2, 64, 1, 32


def _cfg(cfg: Optional[dict]) -> SimpleNamespace:
    return SimpleNamespace(**{**SWINIR_DEFAULTS, **{k: v for k, v in (cfg or {}).items()
                                                    if k in SWINIR_DEFAULTS}})


def padded_side(cfg: Optional[dict], lr: int) -> int:
    """The side the model runs at on an ``lr`` crop: the latent, lr - 2,
    padded to a multiple of the window."""
    ws = _cfg(cfg).window_size
    return -(-(lr - 2) // ws) * ws


def swinir_tile_flops(cfg: Optional[dict] = None, lr: int = 288) -> Dict[str, float]:
    """Minimal FLOPs of one SwinIR forward on an ``lr`` x ``lr`` low-res crop
    (the program's `utils/flops.py:swinir_tile_flops`)."""
    cfg = _cfg(cfg)
    c, f, ws = cfg.embed_dim, NUM_FEAT, cfg.window_size
    lat = lr - 2
    side = -(-lat // ws) * ws
    layers = sum(cfg.depths)
    tokens = float(side) ** 2

    def conv(px_side: int, c_in: int, c_out: int) -> float:
        return float(px_side) ** 2 * 9 * c_in * c_out

    ib = INBLOCK_CHANNELS
    stages = {
        "input_block": float(lat) ** 2 * (9 + 900 + 36 * 2 + 9) * ib,
        "conv_first": conv(side, 4 * ib, c),
        "msa_linears": layers * tokens * 4 * c * c,
        "window_attention": layers * tokens * 2 * ws * ws * c,
        "mlp": layers * tokens * 2 * c * MLP_RATIO * c,
        "rstb_convs": len(cfg.depths) * conv(side, c, c),
        "conv_after_body": conv(side, c, c),
        "conv_before_upsample": conv(side, c, f),
        "upsample_convs": sum(conv(side * 2**i, f, 4 * f)
                              for i in range(UPSCALE.bit_length() - 1)),
        "conv_last": conv(side * UPSCALE, f, OUT_CHANNELS),
    }
    out = {name: 2.0 * macs for name, macs in stages.items()}
    out["total"] = 2.0 * sum(stages.values())
    return out


def msa_layer(batch: int, side: int, cfg: Optional[dict] = None) -> Dict[str, float]:
    """One `swin.msa` call on a (batch, side, side, C) float32 LayerNorm
    output: the qkv and proj linears (4 C^2 MACs a token) and the window
    attention (2 w^2 C) at the TF32 route of fp32 products; bytes are the
    LayerNorm output read once, proj's output written once and the layer's
    weights (qkv, proj, their biases, the widest bias table) in fp32."""
    cfg = _cfg(cfg)
    c, ws = cfg.embed_dim, cfg.window_size
    tokens = batch * side * side
    flops = 2.0 * tokens * (4 * c * c + 2 * ws * ws * c)
    weights = 4 * c * c + 4 * c + (2 * ws - 1) ** 2 * max(cfg.num_heads)
    return bound(flops, 4.0 * (2 * tokens * c + weights), "fp32")

"""Analytic operation counts of the generator and the GAN train step.

Copied from the program's ``utils/flops.py`` (``generator_tile_flops``,
``discriminator_tile_flops``, ``train_step_flops``), so that the yardstick
stays put while the program changes. The count is minimal: the
multiply-accumulates the published model requires at the given size, two
FLOPs each, independent of how any kernel schedules them; bias adds,
LeakyReLU and nearest upsampling are left out (<0.1%); a deformable
layer's bilinear sampling counts 4 MACs per tap, channel and pixel.
Configurations are plain dicts of the generator's fields.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

GENERATOR_DEFAULTS = dict(num_residual_blocks=12, out_channels=1, base_channels=64,
                          growth_channels=32, inblock_channels=32,
                          upsample_phase_conv=False)
DISCRIMINATOR_DEFAULTS = dict(channels=(64, 64, 128, 128, 128, 256, 256, 512, 512, 512),
                              kernels=(3, 4, 3, 4, 3, 4, 3, 4, 3, 4),
                              strides=(1, 2, 1, 2, 1, 2, 1, 2, 1, 2), fc_units=100)


def _cfg(cfg, defaults):
    return SimpleNamespace(**{**defaults, **{k: v for k, v in (cfg or {}).items()
                                             if k in defaults}})


def generator_tile_flops(
    cfg: Optional[dict] = None, lr: int = 288
) -> Dict[str, float]:
    """Minimal FLOPs of one generator forward on an ``lr`` x ``lr`` low-res
    tile (continent tiles: lr=288 incl. halo -> 1144 px raw output,
    deepbedmap.py:691-736). Returns a per-stage breakdown plus 'total'."""
    cfg = _cfg(cfg, GENERATOR_DEFAULTS)
    ib = cfg.inblock_channels
    cc = 4 * ib
    bc = cfg.base_channels
    g = cfg.growth_channels
    lat = lr - 2  # valid input block shaves one lr px per side
    up1 = 2 * lat
    up2 = 4 * lat
    k = 9  # 3x3 taps

    def conv(px_side: int, taps: int, c_in: int, c_out: int) -> float:
        return float(px_side) ** 2 * taps * c_in * c_out

    stages: Dict[str, float] = {}
    # input block: 4 valid-conv branches to a common (lat, lat) grid
    # (srgan_train.py:201-266 — X k3s1, W1 k30s10, W2 k6s2, W3 k3s1)
    stages["input_block"] = (
        conv(lat, 9, 1, ib)
        + conv(lat, 900, 1, ib)
        + conv(lat, 36, 2, ib)
        + conv(lat, 9, 1, ib)
    )
    stages["pre_residual"] = conv(lat, k, cc, bc)
    # one RDB: 5 dense convs 64->32, 96->32, 128->32, 160->32, 192->64
    rdb = sum(
        conv(lat, k, bc + i * g, g if i < 4 else bc) for i in range(5)
    )
    stages["trunk"] = cfg.num_residual_blocks * 3 * rdb
    stages["post_residual"] = conv(lat, k, bc, bc)
    # upsample_phase_conv computes the SAME function with 2x2 phase kernels
    # at source resolution: 16 MACs per source px vs the literal 9 per
    # hi-res px (= 36 per source px). MFU counts the work actually required
    # by the executed algorithm, so the minimal count drops with the flag.
    if cfg.upsample_phase_conv:
        stages["upsample_convs"] = conv(lat, 16, bc, bc) + conv(up1, 16, bc, bc)
    else:
        stages["upsample_convs"] = conv(up1, k, bc, bc) + conv(up2, k, bc, bc)
    # deform layer 1: offset conv (64->18) + bilinear sampling (4 MACs per
    # tap/channel/px) + 3x3 kernel contraction (64->64)
    stages["deform64"] = (
        conv(up2, k, bc, 18) + float(up2) ** 2 * k * bc * 4 + conv(up2, k, bc, bc)
    )
    stages["deform1"] = (
        conv(up2, k, bc, 18)
        + float(up2) ** 2 * k * bc * 4
        + conv(up2, k, bc, cfg.out_channels)
    )
    total_macs = sum(stages.values())
    out = {name: 2.0 * macs for name, macs in stages.items()}
    out["total"] = 2.0 * total_macs
    return out


def discriminator_tile_flops(d_cfg=None, hr: int = 36) -> float:
    """Minimal FLOPs of one discriminator forward on an ``hr`` x ``hr`` tile
    (reference DiscriminatorModel, srgan_train.py:591-699): the 10-conv
    VGG stack with Chainer's pad-1 geometry, plus the two dense layers.
    BatchNorm/LeakyReLU are O(pixels) and excluded, as in
    ``generator_tile_flops``."""
    d_cfg = _cfg(d_cfg, DISCRIMINATOR_DEFAULTS)
    size = hr
    c_in = 1
    macs = 0.0
    for feat, k, s in zip(d_cfg.channels, d_cfg.kernels, d_cfg.strides):
        out = (size + 2 - k) // s + 1
        macs += float(out) ** 2 * k * k * c_in * feat
        size, c_in = out, feat
    macs += float(size) ** 2 * c_in * d_cfg.fc_units  # flatten -> 100
    macs += d_cfg.fc_units * 1  # -> 1 logit
    return 2.0 * macs


def train_step_flops(
    g_cfg: Optional[dict] = None,
    d_cfg=None,
    differentiable_adversarial: bool = False,
    batch: int = 128,
    lr: int = 11,
    hr: int = 36,
    g_params: int = 8_907_749,
    d_params: int = 10_370_761,
) -> Dict[str, float]:
    """Minimal FLOPs of ONE D+G training step (train/steps.py):

      D update:  G fwd (stop-gradient)        = 1x G_fwd
                 D(real), D(fake) fwd + bwd   = 2 x 3 x D_fwd
      G update:  G fwd + bwd                  = 3 x G_fwd
                 D(fake), D(real) fwd         = 2 x D_fwd
                 (+ 2 x D input-backward when the adversarial term is
                 differentiable — ``differentiable_adversarial``;
                 the reference-parity default detaches it,
                 srgan_train.py:1229-1233)
      optimizer: ~12 FLOPs/param (two Adam moments + update, both nets).

    Backward = 2x forward (input grads + weight grads), the standard
    convention; for the frozen-D pass in the G update only the input-grad
    half is charged. Conventions otherwise as ``generator_tile_flops``."""
    g_fwd = generator_tile_flops(g_cfg, lr)["total"]
    d_fwd = discriminator_tile_flops(d_cfg, hr)
    g_side_d = 2.0 + (2.0 if differentiable_adversarial else 0.0)
    per_tile = 4.0 * g_fwd + (6.0 + g_side_d) * d_fwd
    opt = 12.0 * (g_params + d_params)
    total = batch * per_tile + opt
    return {
        "g_fwd": g_fwd,
        "d_fwd": d_fwd,
        "per_tile": per_tile,
        "optimizer": opt,
        "total": total,
    }

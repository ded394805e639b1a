"""Analytic FLOP accounting for the generator forward and the GAN train step,
and the card's published peaks.

Counterpart of ``deepbedmap_tpu/utils/flops.py``: the counts are copied, the
peaks are the H100's. The count is analytic and *minimal*: the
mathematically required multiply-accumulates of the reference computation
(srgan_train.py:421-576) at the given input size, independent of how any
backend schedules it, so a kernel's redundant halo work is not credited.

Conventions (stated so the number is auditable):
- FLOPs = 2 x MACs (one multiply + one add); bias adds, LeakyReLU and
  nearest-neighbour upsampling are O(pixels) and excluded (<0.1%).
- Deformable sampling is counted as 4 MACs per tap/channel/pixel (the
  bilinear blend of 4 source pixels) plus the ordinary 3x3 kernel
  contraction; offset convs are counted as the convs they are.
- Halo/padding redundancy of any tiled implementation is NOT counted —
  MFU measures useful work per second vs peak.

Peaks: NVIDIA's data sheet for the H100 SXM 80GB, dense rates (no
sparsity), at its full 700 W power limit; a card set to a lower limit
(``nvidia-smi --query-gpu=power.limit``) runs slower under load. The port's
fp32 kernels run their products on the tensor cores as 3xTF32 (three TF32
passes, ``chip_smoke.py:bound``), so their work at fp32 accuracy takes at
least 3 x flops / ``H100_TF32_TC_PEAK_FLOPS``.
"""

from __future__ import annotations

from typing import Dict, Optional

from deepbedmap_tpu_torch.config import DiscriminatorConfig, GeneratorConfig, LossConfig

# NVIDIA H100 SXM 80GB (HBM3), data sheet, dense, 700 W
H100_BF16_TC_PEAK_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
H100_TF32_TC_PEAK_FLOPS = 495e12  # TF32 on the tensor cores
H100_FP32_PEAK_FLOPS = 67e12  # fp32 outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12  # HBM3


def generator_tile_flops(
    cfg: Optional[GeneratorConfig] = None, lr: int = 288
) -> Dict[str, float]:
    """Minimal FLOPs of one generator forward on an ``lr`` x ``lr`` low-res
    tile (continent tiles: lr=288 incl. halo -> 1144 px raw output,
    deepbedmap.py:691-736). Returns a per-stage breakdown plus 'total'."""
    cfg = cfg or GeneratorConfig()
    ib = cfg.inblock_channels
    cc = cfg.concat_channels
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


def generator_mfu(
    seconds_per_tile: float,
    cfg: Optional[GeneratorConfig] = None,
    lr: int = 288,
    peak_flops: float = H100_BF16_TC_PEAK_FLOPS,
) -> Dict[str, float]:
    """Achieved TFLOP/s and model FLOPs utilisation for one tile forward.
    The default denominator is the card's bf16 tensor-core peak, the JAX
    package's convention (its MFU is against the chip's bf16 peak); pass
    ``H100_TF32_TC_PEAK_FLOPS`` for a share of the TF32 peak."""
    flops = generator_tile_flops(cfg, lr)["total"]
    achieved = flops / max(seconds_per_tile, 1e-12)
    return {
        "tile_tflops": flops / 1e12,
        "achieved_tflops": achieved / 1e12,
        "mfu": achieved / peak_flops,
    }


def discriminator_tile_flops(d_cfg=None, hr: int = 36) -> float:
    """Minimal FLOPs of one discriminator forward on an ``hr`` x ``hr`` tile
    (reference DiscriminatorModel, srgan_train.py:591-699): the 10-conv
    VGG stack with Chainer's pad-1 geometry, plus the two dense layers.
    BatchNorm/LeakyReLU are O(pixels) and excluded, as in
    ``generator_tile_flops``."""
    d_cfg = d_cfg or DiscriminatorConfig()
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
    g_cfg: Optional[GeneratorConfig] = None,
    d_cfg=None,
    loss_cfg=None,
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
                 differentiable — LossConfig.differentiable_adversarial;
                 the reference-parity default detaches it,
                 srgan_train.py:1229-1233)
      optimizer: ~12 FLOPs/param (two Adam moments + update, both nets).

    Backward = 2x forward (input grads + weight grads), the standard
    convention; for the frozen-D pass in the G update only the input-grad
    half is charged. Conventions otherwise as ``generator_tile_flops``."""
    loss_cfg = loss_cfg or LossConfig()
    g_fwd = generator_tile_flops(g_cfg, lr)["total"]
    d_fwd = discriminator_tile_flops(d_cfg, hr)
    g_side_d = 2.0 + (2.0 if loss_cfg.differentiable_adversarial else 0.0)
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


def train_step_mfu(
    seconds_per_step: float,
    batch: int = 128,
    peak_flops: float = H100_BF16_TC_PEAK_FLOPS,
    **kw,
) -> Dict[str, float]:
    """Achieved TFLOP/s and MFU for one D+G step, against the card's bf16
    tensor-core peak by default (``generator_mfu``'s convention)."""
    flops = train_step_flops(batch=batch, **kw)["total"]
    achieved = flops / max(seconds_per_step, 1e-12)
    return {
        "step_tflops": flops / 1e12,
        "achieved_tflops": achieved / 1e12,
        "mfu": achieved / peak_flops,
    }

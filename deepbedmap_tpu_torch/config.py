"""Typed configuration for the PyTorch port.

Counterpart of ``deepbedmap_tpu/config.py``: ``GeneratorConfig``,
``DiscriminatorConfig``, ``LossConfig``, ``TrainConfig``,
``InferenceConfig`` and ``TilingConfig`` are copied field for field with the
same defaults, so a configuration written for the JAX package means the
same model and the same training run here. They are copied rather than
imported because importing anything from ``deepbedmap_tpu`` loads JAX, which
the port never needs.

Several generator fields select JAX code paths that the port does not have yet
(the plain XLA dense block ``fused_rdb='never'``, bf16 compute, the
channels-before-width tail layout, the phase convs). ``check_supported``
rejects them when a ``Generator`` is built instead of silently taking another
path.

Kernel dispatch flags (``fused_rdb``, ``rdb_resident``, ``rrdb_fused``,
``rrdb_sweep``, ``fused_conv``): in the port ``'auto'`` and ``'always'`` (or
True) both mean "the hand-written kernel on a CUDA tensor, its plain PyTorch
version on a CPU tensor". The JAX package's rule that takes a Pallas kernel
only on a TPU and only for images of at least 256^2 does not carry over: on
the card every image size goes through the kernel. The trunk follows the JAX
precedence (``models/generator.py``, ``models/blocks.py``):

- the trunk is resident unless ``rdb_resident='never'``;
- a resident trunk runs each RRDB as K5 (``rrdb_sweep``), else as K4
  (``rrdb_fused``), else as three K1 dense blocks; the sweep wins over
  ``rrdb_fused``;
- a non-resident trunk ignores ``rrdb_sweep`` and ``rrdb_fused`` and runs
  each dense block as K6, so ``rdb_resident='never', rrdb_fused=True`` is
  36 K6 launches, not 12 K4.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """ESRGAN-style generator (reference srgan_train.py:421-576)."""

    num_residual_blocks: int = 12
    residual_scaling: float = 0.1
    out_channels: int = 1
    base_channels: int = 64  # trunk width
    growth_channels: int = 32  # dense-block growth
    inblock_channels: int = 32  # per-branch channels in the input block (4x32=128)
    scale: int = 4  # super-resolution factor (two nearest x2 upsamples)
    # He-normal init std multiplier (Chainer HeNormal(scale=0.1))
    init_scale: float = 0.1
    # only 'float32' is ported
    compute_dtype: str = "float32"
    # rematerialise each RRDB in the backward pass (torch.utils.checkpoint,
    # as JAX's nn.remat): training memory O(1) in depth, one more trunk
    # forward per step
    remat: bool = False
    # dense-block dispatch: 'auto'/'always' take the hand-written kernel on
    # CUDA tensors and the plain version on CPU tensors; 'never' is not ported
    fused_rdb: str = "auto"
    # bf16 multiplicands inside the TPU dense-block kernel; inert here
    rdb_mxu_bf16: bool = True
    # resident trunk: 'auto'/'always' run the dense blocks as K1 (or whole
    # RRDBs as K4 / K5); 'never' runs each dense block as K6
    # (csrc/rdb_banded.cu) and ignores rrdb_fused / rrdb_sweep
    rdb_resident: str = "auto"
    # one launch per RRDB of a resident trunk (kernel K4, csrc/rdb.cu
    # rrdb_forward) instead of three dense-block launches
    rrdb_fused: bool = False
    # one single-sweep launch per RRDB of a resident trunk (kernel K5,
    # csrc/rrdb_sweep.cu); takes precedence over rrdb_fused
    rrdb_sweep: bool = False
    # the four 64-channel 3x3 convs: 'auto'/'always' take the hand-written
    # kernel K10 (csrc/conv3x3.cu) as fused_rdb does; 'never' keeps cuDNN
    fused_conv: str = "never"
    # bf16 multiplicands inside the TPU conv kernel; inert here
    conv_mxu_bf16: bool = False
    # deformable-conv offset clamp in px
    deform_clamp: int = 2
    # channels-before-width tail layout: not ported
    tail_hcw: bool = False
    # both deformable output layers as one fused tail (K2 + K3); False runs
    # them as two deformable convs (K7, then the projection + K8)
    tail_fused: bool = True
    # tap-packed body of the TPU deform kernel; the CUDA kernel has one body
    tail_pack_taps: bool = True
    # upsample + conv as a phase conv at source resolution: not ported
    upsample_phase_conv: bool = False

    @property
    def concat_channels(self) -> int:
        return 4 * self.inblock_channels


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """VGG-style discriminator (reference srgan_train.py:591-699).

    conv0 keeps its bias; convs 1-9 are bias-free and are followed by
    BatchNorm(eps=1e-5) + LeakyReLU(0.2). Head: flatten -> 100 -> 1, no
    sigmoid. ``bn_momentum`` is flax's (and Chainer's decay): the running
    statistics keep ``bn_momentum`` of their old value."""

    channels: Tuple[int, ...] = (64, 64, 128, 128, 128, 256, 256, 512, 512, 512)
    kernels: Tuple[int, ...] = (3, 4, 3, 4, 3, 4, 3, 4, 3, 4)
    strides: Tuple[int, ...] = (1, 2, 1, 2, 1, 2, 1, 2, 1, 2)
    fc_units: int = 100
    bn_eps: float = 1e-5
    bn_momentum: float = 0.9
    init_scale: float = 0.1


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Perceptual-loss weighting (reference srgan_train.py:849-852).

    The defaults are the reference's, including its generator adversarial
    term computed from detached discriminator logits (no gradient);
    ``recommended()`` is the JAX package's live-adversarial recipe (weight
    0.5, 100 m instance noise). Instance noise is drawn from a
    ``torch.Generator`` seeded from (``instance_noise_seed``, step): the
    same sigma and half-life decay as JAX, other random numbers."""

    content_weight: float = 1e-2
    adversarial_weight: float = 2e-2
    topographic_weight: float = 2e-3
    structural_weight: float = 5.25
    ssim_window: int = 9
    differentiable_adversarial: bool = False
    d_instance_noise: float = 0.0
    instance_noise_seed: int = 0
    instance_noise_half_life_steps: float = 0.0

    @classmethod
    def recommended(cls, **overrides) -> "LossConfig":
        """Live adversarial gradient, weight 0.5, 100 m instance noise."""
        base = dict(
            differentiable_adversarial=True,
            adversarial_weight=0.5,
            d_instance_noise=100.0,
        )
        base.update(overrides)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Adam and the run's schedule (reference srgan_train.py:1014-1055).
    Only ``compute_dtype='float32'`` is ported (``check_train_supported``);
    ``data_axis`` names a mesh axis in the JAX package and is unused here."""

    learning_rate: float = 1.7e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    batch_size: int = 128
    epochs: int = 140
    train_fraction: float = 0.95
    split_seed: int = 42
    seed: int = 42
    compute_dtype: str = "float32"
    data_axis: str = "data"
    # 'constant', or 'cosine': linear warmup then cosine decay to
    # learning_rate * lr_final_scale over lr_total_steps
    lr_schedule: str = "constant"
    lr_total_steps: int = 0
    lr_warmup_steps: int = 0
    lr_final_scale: float = 0.0
    # exponential moving average of the generator's weights (0 = off)
    ema_decay: float = 0.0
    # the discriminator's Adam runs at learning_rate * d_lr_scale
    d_lr_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Halo'd tile-predict-stitch (reference deepbedmap.py:689-736)."""

    tile_out: int = 1000  # output pixels per tile side
    halo_lr: int = 18  # extra low-res input pixels at borders ("xtrapad")
    scale: int = 4
    tile_axis: str = "data"  # mesh axis name in the JAX package; unused here


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    """Training-tile proposal (reference data_prep.py:501-572)."""

    tile_px: int = 36  # 36 px * 250 m = 9 km square tiles
    step_px: int = 3  # slide by 3 px = 750 m
    resolution: float = 250.0
    padding: float = 1000.0  # metres of context added to conditioning tiles
    gapfill_bed: float = -5000.0
    gapfill_vel: float = 0.0
    gapfill_accum: float = 0.0


DEFAULT_TILING = TilingConfig()


def check_supported(cfg: GeneratorConfig) -> None:
    """Raise ``NotImplementedError`` for every flag that selects unported code."""
    unported = {
        "upsample_phase_conv": cfg.upsample_phase_conv,
        "tail_hcw": cfg.tail_hcw,
        "compute_dtype != 'float32'": cfg.compute_dtype != "float32",
        "fused_rdb='never'": cfg.fused_rdb == "never",
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            "GeneratorConfig selects code the PyTorch port does not have: "
            + ", ".join(bad)
        )
    if cfg.out_channels != 1:
        raise NotImplementedError("the generator tail needs out_channels=1")


# the widths the hand-written kernels are built for: the dense-block kernels
# K1, K4, K5 and K6 take F = 64 trunk channels and G = 32 growth channels
# (ops/rdb.py FEATURES, GROWTH), the deformable tail K2/K3 and K7/K8 64 input
# channels (ops/deform_conv.py), K10 64 outputs from 64 or 128 inputs
# (ops/conv3x3.py C_INS)
CARD_BASE_CHANNELS = 64
CARD_GROWTH_CHANNELS = 32
CARD_CONV_C_INS = (64, 128)


def check_card_supported(cfg: GeneratorConfig) -> None:
    """Raise ``NotImplementedError`` for a generator whose widths or offset
    clamp the kernels of its configuration do not take, so that a generator
    built on a CUDA device fails at construction instead of at its first
    launch. The CPU runs any width and clamp through the plain versions and
    does not call this."""
    from deepbedmap_tpu_torch.ops.deform_conv import WINDOW_MAX_CLAMP, check_window_clamp

    bad = []
    if cfg.base_channels != CARD_BASE_CHANNELS:
        bad.append(f"base_channels={cfg.base_channels}")
    if cfg.growth_channels != CARD_GROWTH_CHANNELS:
        bad.append(f"growth_channels={cfg.growth_channels}")
    if cfg.fused_conv != "never" and cfg.concat_channels not in CARD_CONV_C_INS:
        bad.append(f"inblock_channels={cfg.inblock_channels} with fused_conv="
                   f"{cfg.fused_conv!r}")
    try:  # both tails run through kernels with windows (K2/K3 or K7/K8)
        check_window_clamp(cfg.deform_clamp)
    except ValueError:
        bad.append(f"deform_clamp={cfg.deform_clamp!r}")
    if bad:
        raise NotImplementedError(
            f"GeneratorConfig({', '.join(bad)}) has no kernels on the card: the "
            f"{trunk_kernel(cfg)} trunk's dense-block kernel takes base_channels="
            f"{CARD_BASE_CHANNELS} and growth_channels={CARD_GROWTH_CHANNELS}, the "
            f"deformable tail {CARD_BASE_CHANNELS} input channels and an integer "
            f"deform_clamp in [0, {WINDOW_MAX_CLAMP}], and K10 (fused_conv) "
            f"{CARD_BASE_CHANNELS} outputs from {CARD_CONV_C_INS} inputs "
            "(4 x inblock_channels); other widths and clamps run only on the CPU"
        )


def check_train_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for a training setting that selects
    unported code (bf16 compute)."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "TrainConfig selects code the PyTorch port does not have: "
            f"compute_dtype={cfg.compute_dtype!r} (only 'float32')"
        )


def trunk_kernel(cfg: GeneratorConfig) -> str:
    """Which kernel runs the trunk, by the JAX precedence: ``'rrdb_sweep'``
    (K5), ``'rrdb_fused'`` (K4) or ``'rdb'`` (K1) on a resident trunk,
    ``'rdb_banded'`` (K6) on a non-resident one."""
    if cfg.rdb_resident == "never":
        return "rdb_banded"
    if cfg.rrdb_sweep:
        return "rrdb_sweep"
    return "rrdb_fused" if cfg.rrdb_fused else "rdb"

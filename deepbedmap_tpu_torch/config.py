"""Typed configuration for the PyTorch port.

Counterpart of ``deepbedmap_tpu/config.py``: ``GeneratorConfig``,
``DiscriminatorConfig``, ``LossConfig``, ``TrainConfig``,
``InferenceConfig`` and ``TilingConfig`` are copied field for field with the
same defaults, so a configuration written for the JAX package means the
same model and the same training run here. They are copied rather than
imported because importing anything from ``deepbedmap_tpu`` loads JAX, which
the port never needs.

Every generator field the JAX package reads is ported. ``check_supported``
raises where JAX asserts: ``upsample_phase_conv`` with ``tail_hcw``,
``tail_fused`` with ``tail_hcw`` (so ``tail_hcw=True`` needs
``tail_fused=False``), and ``tail_fused`` with ``out_channels != 1``.

Kernel dispatch follows the JAX precedence (``models/generator.py:148-152``,
``models/blocks.py:171-175, 322-324``) without its TPU size rule
(``should_fuse``): where JAX would take a Pallas kernel on a TPU image of
at least 256^2, the port takes the hand-written kernel on a CUDA tensor (its
plain PyTorch version on a CPU tensor), at every image size.
``trunk_kernel`` and ``conv_kernel`` hold the rule:

- the trunk is resident when ``rdb_resident='always'``, or when
  ``rdb_resident='auto'``, the compute dtype is float32 and ``fused_rdb``
  is ``'always'``, or ``'auto'`` at the widths the kernels take
  (``CARD_BASE_CHANNELS``, ``CARD_GROWTH_CHANNELS``);
- a resident trunk runs each RRDB as K5 (``rrdb_sweep``), else as K4
  (``rrdb_fused``), else as three K1 dense blocks, each kernel fed the
  activation in float32;
- a non-resident trunk ignores ``rrdb_sweep`` and ``rrdb_fused``: each dense
  block is K6 when ``fused_rdb='always'``, or ``'auto'`` at float32 and the
  kernels' widths, and otherwise the plain composition at the compute dtype
  (``'plain'``). So ``fused_rdb='never', rdb_resident='always'`` is K1,
  ``rdb_resident='never', fused_rdb='never'`` is plain, and bfloat16 at the
  defaults is plain;
- the four 64-channel 3x3 convs take K10 when ``fused_conv='always'`` (fed
  float32 at any compute dtype) or ``'auto'`` at float32 and K10's widths
  (``CARD_CONV_C_INS``), else the plain conv at the compute dtype;
- the fused tail (``tail_fused``, JAX's ``method='auto'``) runs K2 + K3 at 64
  input channels and a clamp their windows cover, else its plain composition
  (``tail_kernel``); the unfused tail's layers choose by shape and clamp
  (``ops.deform_conv.choose_method``). The phase convs (``upsample_phase_conv``) and
  the channels-before-width conv (``tail_hcw``) replace the upsample stages'
  convs and ignore ``fused_conv``, as in JAX.

So ``'auto'`` never refuses a width: what the kernels do not take runs the
plain composition on either device, decided from the config before any
launch, as JAX's ``'auto'`` sends what it does not fuse to XLA. ``'always'``
(``fused_rdb``, ``rdb_resident``, ``fused_conv``) forces a kernel, and
``check_card_supported`` refuses a width it does not take, naming it.

bf16 multiplicands (the TPU kernels' ``mxu_bf16``): ``trunk_mxu_bf16`` and
``conv_mxu_bf16`` say where the port honours ``rdb_mxu_bf16`` and
``conv_mxu_bf16`` (their docstrings); elsewhere the kernels compute in fp32
(3xTF32).

JAX's ``nn.scan`` over the trunk refuses a carry whose dtype changes, so JAX
runs a kernel trunk under bfloat16 only when the pre-residual conv hands it
float32 (``fused_conv='always'``); the port's trunk is a loop and runs every
combination, with JAX's casts.
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
    # conv compute dtype, 'float32', 'bfloat16' or 'float16': the plain convs
    # take their input, kernel and bias in it (parameters stay float32); every
    # kernel and both deformable samplers compute in float32
    compute_dtype: str = "float32"
    # rematerialise each RRDB in the backward pass (torch.utils.checkpoint,
    # as JAX's nn.remat): training memory O(1) in depth, one more trunk
    # forward per step
    remat: bool = False
    # dense-block dispatch (trunk_kernel): 'always' forces a kernel, 'auto'
    # takes one at float32, 'never' the plain composition unless the trunk
    # is resident ('always')
    fused_rdb: str = "auto"
    # bf16 multiplicands, fp32 accumulation, in the dense-block kernels (K1,
    # K4, K5, K6: their bf16 route) where the trunk kernel is forced
    # (fused_rdb='always' or rdb_resident='always'), as JAX honours it off the
    # TPU; under 'auto' the trunk stays fp32 (trunk_mxu_bf16)
    rdb_mxu_bf16: bool = True
    # resident trunk (trunk_kernel): the dense blocks as K1, or whole RRDBs
    # as K4 / K5; a non-resident one runs each dense block as K6
    # (csrc/rdb_banded.cu) or plain and ignores rrdb_fused / rrdb_sweep
    rdb_resident: str = "auto"
    # one launch per RRDB of a resident trunk (kernel K4, csrc/rdb.cu
    # rrdb_forward) instead of three dense-block launches
    rrdb_fused: bool = False
    # one single-sweep launch per RRDB of a resident trunk (kernel K5,
    # csrc/rrdb_sweep.cu); takes precedence over rrdb_fused
    rrdb_sweep: bool = False
    # the four 64-channel 3x3 convs (conv_kernel): 'always' takes the
    # hand-written kernel K10 (csrc/conv3x3.cu), 'auto' takes it at float32,
    # 'never' keeps cuDNN
    fused_conv: str = "never"
    # bf16 multiplicands, fp32 accumulation, wherever K10 runs (its bf16
    # route; conv_kernel)
    conv_mxu_bf16: bool = False
    # deformable-conv offset clamp in px
    deform_clamp: int = 2
    # channels-before-width (N, H, C, W) tail: the second upsample conv
    # emits it and both deformable layers take it (needs tail_fused=False);
    # in PyTorch the layout is a permuted view of NHWC memory
    tail_hcw: bool = False
    # both deformable output layers as one fused tail (K2 + K3); False runs
    # them as two deformable convs (K7, then the projection + K8)
    tail_fused: bool = True
    # tap-packed body of the TPU deform kernel; the CUDA kernel has one body
    tail_pack_taps: bool = True
    # each nearest x2 upsample + 3x3 conv as one 2x2 conv over four phase
    # kernels at the source resolution (ops/phase_conv.py, cuDNN)
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
    ``compute_dtype`` is inert, as in the JAX package, which never reads it:
    bf16 training is selected by ``GeneratorConfig.compute_dtype`` (the
    parameters and both Adams' state stay float32). ``data_axis`` names a
    mesh axis in the JAX package and is unused here."""

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


DEFAULT_GENERATOR = GeneratorConfig()
DEFAULT_DISCRIMINATOR = DiscriminatorConfig()
DEFAULT_LOSS = LossConfig()
DEFAULT_TRAIN = TrainConfig()
DEFAULT_INFERENCE = InferenceConfig()
DEFAULT_TILING = TilingConfig()


def replace(cfg, **kwargs):
    """Functional update helper for any config dataclass."""
    return dataclasses.replace(cfg, **kwargs)


COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


def check_supported(cfg: GeneratorConfig) -> None:
    """Raise ``ValueError`` for the combinations the JAX generator asserts
    against and for a compute dtype other than ``COMPUTE_DTYPES``."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got "
                         f"{cfg.compute_dtype!r}")
    if cfg.tail_hcw and cfg.upsample_phase_conv:
        raise ValueError("upsample_phase_conv and tail_hcw are exclusive")
    if cfg.tail_hcw and cfg.tail_fused:
        raise ValueError("tail_fused and tail_hcw are exclusive")
    if cfg.tail_fused and cfg.out_channels != 1:
        raise ValueError("the fused tail requires a single output channel "
                         "(out_channels != 1 needs tail_fused=False)")


# the widths the hand-written kernels are built for: the dense-block kernels
# K1, K4, K5 and K6 take F = 64 trunk channels and G = 32 growth channels
# (ops/rdb.py FEATURES, GROWTH), the deformable tail K2/K3 and K7/K8 64 input
# channels (ops/deform_conv.py), K10 64 outputs from 64 or 128 inputs
# (ops/conv3x3.py C_INS)
CARD_BASE_CHANNELS = 64
CARD_GROWTH_CHANNELS = 32
CARD_CONV_C_INS = (64, 128)


def trunk_widths(cfg: GeneratorConfig) -> bool:
    """Whether the dense-block kernels K1, K4, K5 and K6 take the trunk's
    widths."""
    return (cfg.base_channels, cfg.growth_channels) == (CARD_BASE_CHANNELS,
                                                        CARD_GROWTH_CHANNELS)


def conv_widths(cfg: GeneratorConfig) -> bool:
    """Whether K10 takes the four 3x3 convs: 64 outputs from 64 or 128
    inputs."""
    return (cfg.base_channels == CARD_BASE_CHANNELS
            and cfg.concat_channels in CARD_CONV_C_INS)


def check_card_supported(cfg: GeneratorConfig) -> None:
    """Raise ``NotImplementedError`` for a generator that forces a kernel
    (``'always'``) whose widths that kernel does not take, naming that
    kernel, so that a generator built on a CUDA device fails at construction
    instead of at its first launch: the trunk's widths when ``trunk_kernel``
    is not ``'plain'``, K10's when ``conv_kernel`` holds. Under ``'auto'``
    the resolution already sent such widths to the plain path
    (``trunk_kernel``, ``conv_kernel``, ``tail_kernel``), and the unfused
    tail's layers to the plain samplers (``ops.deform_conv.choose_method``),
    so nothing else is refused. The CPU runs every width through the plain
    versions and does not call this."""
    bad = []
    trunk = trunk_kernel(cfg)
    if trunk != "plain" and not trunk_widths(cfg):
        bad.append(f"the {trunk} trunk's dense-block kernel takes base_channels="
                   f"{CARD_BASE_CHANNELS} and growth_channels={CARD_GROWTH_CHANNELS}, got "
                   f"{cfg.base_channels} and {cfg.growth_channels} (fused_rdb='auto' or "
                   "'never' with rdb_resident other than 'always' runs the plain trunk at "
                   "any width)")
    if conv_kernel(cfg) and not conv_widths(cfg):
        bad.append(f"K10 (fused_conv={cfg.fused_conv!r}) takes {CARD_BASE_CHANNELS} "
                   f"outputs from {CARD_CONV_C_INS} inputs, got base_channels="
                   f"{cfg.base_channels} and inblock_channels={cfg.inblock_channels} "
                   "(4 x inblock_channels inputs)")
    if bad:
        raise NotImplementedError(
            "GeneratorConfig has no kernels on the card: " + "; ".join(bad)
            + "; other widths run only on the CPU"
        )


def trunk_kernel(cfg: GeneratorConfig) -> str:
    """What runs the trunk, by the JAX precedence (module docstring):
    ``'rrdb_sweep'`` (K5), ``'rrdb_fused'`` (K4) or ``'rdb'`` (K1) on a
    resident trunk; ``'rdb_banded'`` (K6) or ``'plain'`` (the plain dense
    block at the compute dtype) on a non-resident one. ``'auto'`` takes a
    kernel only at the widths the kernels take (``trunk_widths``)."""
    fp32 = cfg.compute_dtype == "float32"
    auto = cfg.fused_rdb == "auto" and fp32 and trunk_widths(cfg)
    resident = cfg.rdb_resident == "always" or (
        cfg.rdb_resident == "auto" and fp32 and (cfg.fused_rdb == "always" or auto))
    if resident:
        if cfg.rrdb_sweep:
            return "rrdb_sweep"
        return "rrdb_fused" if cfg.rrdb_fused else "rdb"
    if cfg.fused_rdb == "always" or auto:
        return "rdb_banded"
    return "plain"


def trunk_mxu_bf16(cfg: GeneratorConfig) -> bool:
    """Whether the trunk's kernel takes its bf16-multiplicand route:
    ``rdb_mxu_bf16`` where the trunk kernel is forced (``fused_rdb='always'``
    or ``rdb_resident='always'``), which is where JAX's own CPU run honours
    it (its interpreted kernel casts; its ``'auto'`` is XLA in fp32). Under
    ``'auto'`` the kernels stay fp32 (3xTF32), so the default path computes
    what JAX's CPU default computes."""
    forced = cfg.fused_rdb == "always" or cfg.rdb_resident == "always"
    return cfg.rdb_mxu_bf16 and forced and trunk_kernel(cfg) != "plain"


def conv_kernel(cfg: GeneratorConfig) -> bool:
    """Whether the 64-channel 3x3 convs run K10: ``fused_conv='always'``, or
    ``'auto'`` at float32 (JAX ``models/blocks.py:322-324``) and K10's widths
    (``conv_widths``)."""
    return cfg.fused_conv == "always" or (
        cfg.fused_conv == "auto" and cfg.compute_dtype == "float32" and conv_widths(cfg))


def conv_mxu_bf16(cfg: GeneratorConfig) -> bool:
    """Whether K10 takes its bf16-multiplicand route: ``conv_mxu_bf16``
    wherever K10 runs (``conv_kernel``)."""
    return cfg.conv_mxu_bf16 and conv_kernel(cfg)


def tail_kernel(cfg: GeneratorConfig) -> bool:
    """Whether the fused tail runs K2 + K3: ``tail_fused`` at 64 input
    channels and an integer ``deform_clamp`` in [0, 2], which their
    shared-memory windows cover; otherwise the fused tail is its plain
    composition (``ops.tail.tail_reference``) on either device, as JAX's
    ``fused_deform_tail(method='auto')`` off the TPU."""
    from deepbedmap_tpu_torch.ops.deform_conv import window_covers

    return (cfg.tail_fused and cfg.base_channels == CARD_BASE_CHANNELS
            and window_covers(cfg.deform_clamp))

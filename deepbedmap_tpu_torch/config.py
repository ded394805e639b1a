"""Typed configuration for the PyTorch port.

Counterpart of ``deepbedmap_tpu/config.py``: ``GeneratorConfig`` and
``InferenceConfig`` are copied field for field with the same defaults, so a
configuration written for the JAX package means the same model here. They are
copied rather than imported because importing anything from ``deepbedmap_tpu``
loads JAX, which the port never needs.

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
    # training-only in the JAX package (rematerialisation); inert here
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
class InferenceConfig:
    """Halo'd tile-predict-stitch (reference deepbedmap.py:689-736)."""

    tile_out: int = 1000  # output pixels per tile side
    halo_lr: int = 18  # extra low-res input pixels at borders ("xtrapad")
    scale: int = 4
    tile_axis: str = "data"  # mesh axis name in the JAX package; unused here


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


def trunk_kernel(cfg: GeneratorConfig) -> str:
    """Which kernel runs the trunk, by the JAX precedence: ``'rrdb_sweep'``
    (K5), ``'rrdb_fused'`` (K4) or ``'rdb'`` (K1) on a resident trunk,
    ``'rdb_banded'`` (K6) on a non-resident one."""
    if cfg.rdb_resident == "never":
        return "rdb_banded"
    if cfg.rrdb_sweep:
        return "rrdb_sweep"
    return "rrdb_fused" if cfg.rrdb_fused else "rdb"

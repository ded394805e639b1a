"""Typed configuration for the PyTorch port.

Counterpart of ``deepbedmap_tpu/config.py``: ``GeneratorConfig`` and
``InferenceConfig`` are copied field for field with the same defaults, so a
configuration written for the JAX package means the same model here. They are
copied rather than imported because importing anything from ``deepbedmap_tpu``
loads JAX, which the port never needs.

Several generator fields select JAX code paths that the port does not have yet
(Pallas schedule variants, bf16 compute, the unfused tail). ``check_supported``
rejects them when a ``Generator`` is built instead of silently taking another
path.
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
    # resident trunk layout: 'auto'/'always' as fused_rdb; 'never' not ported
    rdb_resident: str = "auto"
    # whole-RRDB launches (TPU kernels K4/K5): not ported
    rrdb_fused: bool = False
    rrdb_sweep: bool = False
    # fused 3x3-conv kernel (TPU kernel K10): only 'never' is ported
    fused_conv: str = "never"
    conv_mxu_bf16: bool = False
    # deformable-conv offset clamp in px
    deform_clamp: int = 2
    # channels-before-width tail layout: not ported
    tail_hcw: bool = False
    # both deformable output layers as one fused tail: only True is ported
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
        "rrdb_fused": cfg.rrdb_fused,
        "rrdb_sweep": cfg.rrdb_sweep,
        "fused_conv != 'never'": cfg.fused_conv != "never",
        "compute_dtype != 'float32'": cfg.compute_dtype != "float32",
        "tail_fused=False": not cfg.tail_fused,
        "fused_rdb='never'": cfg.fused_rdb == "never",
        "rdb_resident='never'": cfg.rdb_resident == "never",
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            "GeneratorConfig selects code the PyTorch port does not have: "
            + ", ".join(bad)
        )
    if cfg.out_channels != 1:
        raise NotImplementedError("the fused tail needs out_channels=1")


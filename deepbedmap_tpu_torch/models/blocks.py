"""Generator building blocks (NHWC activations, OIHW weights).

Counterpart of ``deepbedmap_tpu/models/blocks.py``:

- Chainer He-normal initialisation, std = scale * sqrt(2 / fan_in);
- the input block, kept as space-to-depth + 3x3 VALID conv so the JAX HWIO
  kernels map onto these by a plain HWIO -> OIHW transpose;
- the dense blocks and the residual-in-residual block, whose forward
  runs what ``config.trunk_kernel`` names: the K1 / K6 (dense block) or K4 /
  K5 (whole RRDB) kernels (CUDA) or their plain versions (CPU) through
  ``ops.rdb``, fed float32, with bf16 multiplicands where
  ``config.trunk_mxu_bf16`` says so, or the plain dense block at the
  compute dtype (``'plain'``, PyTorch's convs on either device, JAX's XLA
  path);
- ``FusedConv3x3``: K10 (``ops.conv3x3``; its plain version on a CPU tensor)
  where ``config.conv_kernel`` says so, with bf16 multiplicands where
  ``config.conv_mxu_bf16`` says so, otherwise a cuDNN conv at the compute
  dtype and its bias / residual / LeakyReLU epilogue in PyTorch;
- ``ConvHCW``, the 3x3 conv of the channels-before-width tail;
- the deformable conv layer, applied as one layer (``ops.deform_conv``, K7 /
  K8 on the card; its offset conv at the compute dtype, its sampler in
  float32, NHWC or channels-before-width in and out) or, with its partner,
  by the fused tail (``ops.tail``).

``dtype`` is the compute dtype as JAX's blocks take it: None for float32, or
a torch dtype (``ops.conv.torch_dtype``) in which the plain convs take their
input, kernel and bias, rounding where flax rounds (``ops.conv.conv_nhwc``).
Parameters stay float32. Parameter names follow the JAX tree (``bridge.py``
maps one onto the other) under every configuration.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from deepbedmap_tpu_torch.ops.conv import conv_nhwc, leaky_relu, scaled
from deepbedmap_tpu_torch.ops.conv3x3 import conv3x3_fused
from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d
from deepbedmap_tpu_torch.ops.rdb import (
    rdb_banded,
    rdb_fused,
    rdb_reference,
    rrdb_fused,
    rrdb_sweep,
)
from deepbedmap_tpu_torch.ops.resize import space_to_depth


def he_normal_chainer_(
    weight: torch.Tensor, scale: float, generator: torch.Generator
) -> torch.Tensor:
    """Chainer HeNormal(scale, fan_option='fan_in') on an OIHW weight, in place."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = scale * math.sqrt(2.0 / fan_in)
    with torch.no_grad():
        return weight.normal_(0.0, std, generator=generator)


class Conv3x3(nn.Module):
    """A 3x3 conv's parameters: ``weight`` OIHW and ``bias``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, init_scale: float, generator: torch.Generator) -> None:
        he_normal_chainer_(self.weight, init_scale, generator)
        with torch.no_grad():
            self.bias.zero_()


class StridedInputConv(Conv3x3):
    """VALID conv with kernel 3b x 3b and stride b, computed as
    space_to_depth(b) + 3x3 VALID conv (reference srgan_train.py:223-254)."""

    def __init__(self, in_channels: int, out_channels: int, block: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(block * block * in_channels, out_channels)
        self.block = block
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.block > 1:
            x = space_to_depth(x, self.block)
        return conv_nhwc(x, self.weight, self.bias, 0, self.dtype)


class InputBlock(nn.Module):
    """Four-branch input block -> concat (reference srgan_train.py:201-266).
    x (N,h,w,1), w1 (N,10h,10w,1), w2 (N,2h,2w,2), w3 (N,h,w,1)
    -> (N, h-2, w-2, 4 * out_channels)."""

    def __init__(self, out_channels: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_on_X = StridedInputConv(1, out_channels, 1, dtype)
        self.conv_on_W1 = StridedInputConv(1, out_channels, 10, dtype)
        self.conv_on_W2 = StridedInputConv(2, out_channels, 2, dtype)
        self.conv_on_W3 = StridedInputConv(1, out_channels, 1, dtype)

    def forward(self, x, w1, w2, w3) -> torch.Tensor:
        return torch.cat(
            [self.conv_on_X(x), self.conv_on_W1(w1), self.conv_on_W2(w2),
             self.conv_on_W3(w3)],
            dim=-1,
        )


class FusedConv3x3(Conv3x3):
    """3x3 SAME conv with optional residual-add and LeakyReLU epilogues
    (reference layers srgan_train.py:470-505). ``kernel`` is
    ``config.conv_kernel``: True runs ``conv3x3_fused`` (K10 on a CUDA
    tensor, its plain version on a CPU tensor) on the input and residual in
    float32, at any compute dtype, as JAX's ``fused='always'``, on bf16
    multiplicands with ``mxu_bf16``; False the cuDNN conv at ``dtype``, then
    the bias, residual and LeakyReLU."""

    def __init__(
        self, in_channels: int, out_channels: int, leaky: bool = False,
        kernel: bool = False, dtype: Optional[torch.dtype] = None,
        mxu_bf16: bool = False,
    ):
        super().__init__(in_channels, out_channels)
        self.leaky = leaky
        self.kernel = kernel
        self.dtype = dtype
        self.mxu_bf16 = mxu_bf16

    def forward(
        self, x: torch.Tensor, residual: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if self.kernel:
            return conv3x3_fused(
                x.float().contiguous(), self.weight, self.bias, self.leaky,
                None if residual is None else residual.float().contiguous(),
                self.mxu_bf16,
            )
        z = conv_nhwc(x, self.weight, self.bias, 1, self.dtype)
        if residual is not None:
            z = z + residual
        return leaky_relu(z) if self.leaky else z


class ConvHCW(Conv3x3):
    """3x3 SAME conv of an NHWC input whose output is laid out
    channels-before-width (N, H, C, W), the JAX ``ConvHCW``
    (``models/blocks.py:347-381``) as the generator uses it. In PyTorch the
    layout is a view: ``conv_nhwc(...).permute(0, 1, 3, 2)``, no copy. At
    ``dtype`` as ``conv_nhwc``. The parameters are ``Conv3x3``'s."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.weight, self.bias, 1, self.dtype).permute(0, 1, 3, 2)


TRUNK_KERNELS = ("rdb", "rdb_banded", "rrdb_fused", "rrdb_sweep", "plain")


class ResidualDenseBlock(nn.Module):
    """5-conv dense block with residual scaling (reference
    srgan_train.py:275-360). ``kernel``: 'rdb' one K1 launch on the card,
    'rdb_banded' one K6 launch (both fed the input in float32, JAX's
    ``x.astype(float32)``; on bf16 multiplicands with ``mxu_bf16``), 'plain'
    ``ops.rdb.rdb_reference`` at ``dtype`` on either device."""

    def __init__(self, features: int = 64, growth: int = 32, residual_scaling: float = 0.1,
                 kernel: str = "rdb", dtype: Optional[torch.dtype] = None,
                 mxu_bf16: bool = False):
        super().__init__()
        f, g = features, growth
        c_ins = (f, f + g, f + 2 * g, f + 3 * g, f + 4 * g)
        c_outs = (g, g, g, g, f)
        for i, (ci, co) in enumerate(zip(c_ins, c_outs), start=1):
            setattr(self, f"conv_layer{i}", Conv3x3(ci, co))
        self.residual_scaling = residual_scaling
        self.kernel = kernel
        self.dtype = dtype
        self.mxu_bf16 = mxu_bf16

    def convs(self) -> Tuple[Conv3x3, ...]:
        return tuple(getattr(self, f"conv_layer{i}") for i in range(1, 6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernels = [c.weight for c in self.convs()]
        biases = [c.bias for c in self.convs()]
        if self.kernel == "plain":
            return rdb_reference(x, kernels, biases, self.residual_scaling, self.dtype)
        block = rdb_banded if self.kernel == "rdb_banded" else rdb_fused
        return block(x.float(), kernels, biases, self.residual_scaling, self.mxu_bf16)


class ResInResDenseBlock(nn.Module):
    """3 chained dense blocks + scaled outer skip (reference srgan_train.py:364-404).
    ``kernel`` (``config.trunk_kernel``) picks what runs it: 'rrdb_sweep' one
    K5 launch, 'rrdb_fused' one K4 launch (both fed float32), 'rdb' three K1
    launches and 'rdb_banded' three K6 launches (the skip in PyTorch),
    'plain' three plain dense blocks at ``dtype``. The skip adds the input
    as it came, so a bfloat16 input and a float32 kernel output give float32,
    as JAX's promotion does. ``mxu_bf16``: the kernels' bf16-multiplicand
    route."""

    def __init__(
        self, features: int = 64, growth: int = 32, residual_scaling: float = 0.1,
        kernel: str = "rdb", dtype: Optional[torch.dtype] = None, mxu_bf16: bool = False,
    ):
        super().__init__()
        if kernel not in TRUNK_KERNELS:
            raise ValueError(f"unknown trunk kernel {kernel!r}")
        block = "rdb" if kernel in ("rrdb_fused", "rrdb_sweep") else kernel
        self.residual_dense_block1 = ResidualDenseBlock(features, growth, residual_scaling,
                                                        block, dtype, mxu_bf16)
        self.residual_dense_block2 = ResidualDenseBlock(features, growth, residual_scaling,
                                                        block, dtype, mxu_bf16)
        self.residual_dense_block3 = ResidualDenseBlock(features, growth, residual_scaling,
                                                        block, dtype, mxu_bf16)
        self.residual_scaling = residual_scaling
        self.kernel = kernel
        self.mxu_bf16 = mxu_bf16

    def blocks(self) -> Tuple[ResidualDenseBlock, ...]:
        return (self.residual_dense_block1, self.residual_dense_block2,
                self.residual_dense_block3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        whole = {"rrdb_fused": rrdb_fused, "rrdb_sweep": rrdb_sweep}.get(self.kernel)
        if whole is not None:
            kernels = [[c.weight for c in b.convs()] for b in self.blocks()]
            biases = [[c.bias for c in b.convs()] for b in self.blocks()]
            return whole(x.float(), kernels, biases, self.residual_scaling, self.mxu_bf16)
        a = x
        for block in self.blocks():
            a = block(a)
        return x + scaled(self.residual_scaling, a)


class DeformableConv(nn.Module):
    """One deformable conv layer (reference srgan_train.py:506-523):
    ``offset_conv`` (18 offsets), ``weight`` OIHW and ``bias``. Its forward is
    the JAX ``models.blocks.DeformableConv``: the offset conv (cuDNN) at
    ``dtype``, then ``ops.deform_conv.deform_conv2d`` (K7 or K8 on the card)
    on the input and offsets in float32, whatever the compute dtype (JAX
    ``models/blocks.py:429-434``). ``in_hcw`` / ``out_hcw``: the input /
    output is channels-before-width (N, H, C, W), the offsets follow the
    input. The fused tail (``ops.tail.fused_deform_tail``) applies two of
    them at once instead."""

    def __init__(self, in_channels: int, features: int, clamp: int = 2,
                 dtype: Optional[torch.dtype] = None, in_hcw: bool = False,
                 out_hcw: bool = False):
        super().__init__()
        self.offset_conv = Conv3x3(in_channels, 18)
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.clamp = clamp
        self.dtype = dtype
        self.in_hcw = in_hcw
        self.out_hcw = out_hcw

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_nhwc = x.permute(0, 1, 3, 2) if self.in_hcw else x
        offsets = conv_nhwc(x_nhwc, self.offset_conv.weight, self.offset_conv.bias, 1,
                            self.dtype)
        return deform_conv2d(x_nhwc.float().contiguous(), offsets.float().contiguous(),
                             self.weight, self.bias, 1, self.clamp, out_hcw=self.out_hcw)

    def reset_parameters(self, init_scale: float, generator: torch.Generator) -> None:
        """Own weight and bias; ``offset_conv`` is a ``Conv3x3`` of its own."""
        he_normal_chainer_(self.weight, init_scale, generator)
        with torch.no_grad():
            self.bias.zero_()

    def tensors(self):
        return (self.offset_conv.weight, self.offset_conv.bias, self.weight, self.bias)

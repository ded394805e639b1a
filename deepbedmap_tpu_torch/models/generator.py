"""ESRGAN-style generator (reference GeneratorModel, srgan_train.py:421-576).

Counterpart of ``deepbedmap_tpu/models/generator.py:Generator``, NHWC at its
forward. For an (n, n) low-res crop the output is ((n-2)*4, (n-2)*4).

On CUDA tensors the forward runs the hand-written kernels that
``config.trunk_kernel`` and ``config.conv_kernel`` name; launches per
forward at 12 RRDBs:

- the defaults: K1 36 (one per dense block), K2 1 and K3 1 (the fused
  tail); the input block, the 3x3 convs, the nearest upsamples, the offset
  convs and the tap projection are plain PyTorch;
- ``rrdb_fused=True, fused_conv='always', tail_fused=False``: K4 12, K10 4,
  and the two deformable layers one at a time, K7 1 (then the LeakyReLU in
  PyTorch, where JAX has it) and K8 1;
- ``rdb_resident='never'``: K6 36 with the fused tail; ``rrdb_sweep=True``:
  K5 12 with the fused tail;
- ``upsample_phase_conv=True``: the defaults' K1 36, K2 1, K3 1; each
  upsample stage is one 2x2 conv over four phase kernels at the source
  resolution (``ops.phase_conv``, cuDNN), which ignores ``fused_conv``, so
  with ``fused_conv='always'`` K10 runs 2 times, not 4;
- ``tail_hcw=True, tail_fused=False``: K1 36, K7 1, K8 1; the second
  upsample conv (``ConvHCW``, cuDNN) emits channels-before-width, and both
  deformable layers take it (the last one emits NHWC), as permuted views;
- ``fused_rdb='never'``: the plain trunk (PyTorch's convs), K2 1, K3 1, at
  any trunk width;
- ``compute_dtype='bfloat16'`` (or ``'float16'``): every plain conv, the
  plain trunk included, at that dtype, from the input block to the tail's
  offset convs, rounding where flax rounds; K2 1 and K3 1 on float32
  inputs; the output is float32;
- a forced trunk (``fused_rdb='always'`` or ``rdb_resident='always'``) with
  ``rdb_mxu_bf16`` (on by default) runs its kernels' bf16-multiplicand
  route, and ``conv_mxu_bf16`` K10's (``config.trunk_mxu_bf16``,
  ``conv_mxu_bf16``), counted under the kernel's name with ``_bf16``;
- widths the kernels do not take run the plain trunk under ``'auto'``, and
  the fused tail at other than 64 channels or an uncovered clamp its plain
  composition (``config.tail_kernel``); ``out_channels != 1`` needs
  ``tail_fused=False``, whose last deformable layer then runs the plain
  samplers.

The parameters are the same under every config. On CPU tensors the
kernels' plain versions run instead.

Gradients flow through every kernel: each wrapper's backward is autograd of
its plain version (``ops._autograd``). With ``GeneratorConfig(remat=True)``
each RRDB runs under ``torch.utils.checkpoint`` whenever gradients are on
(JAX's ``nn.remat`` of the scanned block,
``deepbedmap_tpu/models/generator.py:156``): its
activations are recomputed in the backward pass, which launches the trunk's
kernels once more.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepbedmap_tpu_torch.config import (
    GeneratorConfig,
    check_supported,
    conv_kernel,
    conv_mxu_bf16,
    tail_kernel,
    trunk_kernel,
    trunk_mxu_bf16,
)
from deepbedmap_tpu_torch.models.blocks import (
    Conv3x3,
    ConvHCW,
    DeformableConv,
    FusedConv3x3,
    InputBlock,
    ResInResDenseBlock,
)
from deepbedmap_tpu_torch.ops.conv import leaky_relu, torch_dtype
from deepbedmap_tpu_torch.ops.phase_conv import upsample2_conv3x3
from deepbedmap_tpu_torch.ops.resize import nearest_upsample
from deepbedmap_tpu_torch.ops.tail import fused_deform_tail, tail_reference


class Generator(nn.Module):
    def __init__(self, cfg: GeneratorConfig = GeneratorConfig()):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        c = cfg.base_channels
        dt = self.dtype = torch_dtype(cfg.compute_dtype)
        conv = dict(kernel=conv_kernel(cfg), dtype=dt, mxu_bf16=conv_mxu_bf16(cfg))
        hcw = cfg.tail_hcw
        self.input_block = InputBlock(cfg.inblock_channels, dt)
        self.pre_residual_conv_layer = FusedConv3x3(cfg.concat_channels, c, leaky=True,
                                                    **conv)
        self.residual_network = nn.ModuleList(
            ResInResDenseBlock(c, cfg.growth_channels, cfg.residual_scaling,
                               kernel=trunk_kernel(cfg), dtype=dt,
                               mxu_bf16=trunk_mxu_bf16(cfg))
            for _ in range(cfg.num_residual_blocks)
        )
        self.post_residual_conv_layer = FusedConv3x3(c, c, **conv)
        self.post_upsample_conv_layer_1 = FusedConv3x3(c, c, leaky=True, **conv)
        self.post_upsample_conv_layer_2 = (
            ConvHCW(c, c, dt) if hcw else FusedConv3x3(c, c, leaky=True, **conv))
        self.final_conv_layer1 = DeformableConv(c, c, cfg.deform_clamp, dt, hcw, hcw)
        self.final_conv_layer2 = DeformableConv(c, cfg.out_channels, cfg.deform_clamp, dt,
                                                hcw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded Chainer He-normal init of every layer, zero biases."""
        for m in self.modules():
            if isinstance(m, (Conv3x3, DeformableConv)):
                m.reset_parameters(self.cfg.init_scale, generator)

    # the forward's four stages, which chip_smoke.py times one by one

    def head(self, x, w1, w2, w3) -> torch.Tensor:
        """The input block and the pre-residual conv -> a1."""
        return self.pre_residual_conv_layer(self.input_block(x, w1, w2, w3))

    def trunk(self, a1: torch.Tensor) -> torch.Tensor:
        # enter the trunk kernels' layout (contiguous NHWC) once; every dense
        # block and every RRDB skip keeps it, so the trunk leaves it without
        # a copy
        t = a1.contiguous()
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.residual_network:
            t = checkpoint(block, t, use_reentrant=False) if remat else block(t)
        return t

    def upsample(self, t: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
        """The post-residual conv and long skip, then the two upsample
        stages -> a4 (channels-before-width under ``tail_hcw``)."""
        a3 = self.post_residual_conv_layer(t, residual=a1)
        up1, up2 = self.post_upsample_conv_layer_1, self.post_upsample_conv_layer_2
        if self.cfg.upsample_phase_conv:
            # JAX casts the source, kernel and bias to the compute dtype
            # before the phase kernels' taps are summed
            for layer in (up1, up2):
                w, b = layer.weight, layer.bias
                if self.dtype is not None:
                    a3, w, b = a3.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
                a3 = upsample2_conv3x3(a3, w, b, leaky=True)
            return a3
        a4 = nearest_upsample(up1(nearest_upsample(a3, 2)), 2)
        return leaky_relu(up2(a4)) if self.cfg.tail_hcw else up2(a4)

    def tail(self, a4: torch.Tensor) -> torch.Tensor:
        """Both deformable output layers -> (N, H, W, out_channels) float32."""
        l1, l2 = self.final_conv_layer1, self.final_conv_layer2
        if not self.cfg.tail_fused:
            return l2(leaky_relu(l1(a4)))
        if not tail_kernel(self.cfg):
            return tail_reference(a4, *l1.tensors(), *l2.tensors(),
                                  clamp=self.cfg.deform_clamp,
                                  compute_dtype=self.cfg.compute_dtype)
        return fused_deform_tail(a4, *l1.tensors(), *l2.tensors(), clamp=self.cfg.deform_clamp,
                                 compute_dtype=self.cfg.compute_dtype)

    def forward(self, x, w1, w2, w3) -> torch.Tensor:
        """NHWC inputs: x (N,h,w,1) bed, w1 (N,10h,10w,1) surface,
        w2 (N,2h,2w,2) velocity, w3 (N,h,w,1) accumulation -> (N,4(h-2),4(w-2),1)."""
        a1 = self.head(x, w1, w2, w3)
        return self.tail(self.upsample(self.trunk(a1), a1))

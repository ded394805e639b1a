"""ESRGAN-style generator (reference GeneratorModel, srgan_train.py:421-576).

Counterpart of ``deepbedmap_tpu/models/generator.py:Generator``, NHWC at its
forward. For an (n, n) low-res crop the output is ((n-2)*4, (n-2)*4).

On CUDA tensors the forward runs the hand-written kernels. With the default
config: K1 for each of the 3 x ``num_residual_blocks`` dense blocks and K2/K3
in the fused tail; the input block, the 3x3 convs, the nearest upsamples, the
offset convs and the tap projection are plain PyTorch. With
``GeneratorConfig(rrdb_fused=True, fused_conv='always', tail_fused=False)``:
K4 for each RRDB, K10 for the four 64-channel 3x3 convs, and the two
deformable layers one at a time, K7 (then the LeakyReLU in PyTorch, where JAX
has it) and K8. ``rdb_resident='never'`` runs each dense block as K6 instead
of K1, and ``rrdb_sweep=True`` each RRDB as K5 (``config.trunk_kernel`` has
the precedence). The parameters are the same under every config. On CPU
tensors the kernels' plain versions run instead.

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

from deepbedmap_tpu_torch.config import GeneratorConfig, check_supported, trunk_kernel
from deepbedmap_tpu_torch.models.blocks import (
    Conv3x3,
    DeformableConv,
    FusedConv3x3,
    InputBlock,
    ResInResDenseBlock,
)
from deepbedmap_tpu_torch.ops.conv import leaky_relu
from deepbedmap_tpu_torch.ops.resize import nearest_upsample
from deepbedmap_tpu_torch.ops.tail import fused_deform_tail


class Generator(nn.Module):
    def __init__(self, cfg: GeneratorConfig = GeneratorConfig()):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        c = cfg.base_channels
        fc = cfg.fused_conv
        self.input_block = InputBlock(cfg.inblock_channels)
        self.pre_residual_conv_layer = FusedConv3x3(
            cfg.concat_channels, c, leaky=True, fused=fc)
        self.residual_network = nn.ModuleList(
            ResInResDenseBlock(c, cfg.growth_channels, cfg.residual_scaling,
                               kernel=trunk_kernel(cfg))
            for _ in range(cfg.num_residual_blocks)
        )
        self.post_residual_conv_layer = FusedConv3x3(c, c, fused=fc)
        self.post_upsample_conv_layer_1 = FusedConv3x3(c, c, leaky=True, fused=fc)
        self.post_upsample_conv_layer_2 = FusedConv3x3(c, c, leaky=True, fused=fc)
        self.final_conv_layer1 = DeformableConv(c, c, cfg.deform_clamp)
        self.final_conv_layer2 = DeformableConv(c, cfg.out_channels, cfg.deform_clamp)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded Chainer He-normal init of every layer, zero biases."""
        for m in self.modules():
            if isinstance(m, (Conv3x3, DeformableConv)):
                m.reset_parameters(self.cfg.init_scale, generator)

    def forward(self, x, w1, w2, w3) -> torch.Tensor:
        """NHWC inputs: x (N,h,w,1) bed, w1 (N,10h,10w,1) surface,
        w2 (N,2h,2w,2) velocity, w3 (N,h,w,1) accumulation -> (N,4(h-2),4(w-2),1)."""
        a0 = self.input_block(x, w1, w2, w3)
        a1 = self.pre_residual_conv_layer(a0)
        # enter the trunk kernels' layout (contiguous NHWC fp32) once; every
        # dense block and every RRDB skip keeps it, so the trunk leaves it
        # without a copy
        t = a1.contiguous()
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.residual_network:
            t = checkpoint(block, t, use_reentrant=False) if remat else block(t)
        a3 = self.post_residual_conv_layer(t, residual=a1)
        a4 = self.post_upsample_conv_layer_1(nearest_upsample(a3, 2))
        a4 = self.post_upsample_conv_layer_2(nearest_upsample(a4, 2))
        l1, l2 = self.final_conv_layer1, self.final_conv_layer2
        if not self.cfg.tail_fused:
            return l2(leaky_relu(l1(a4)))
        return fused_deform_tail(
            a4, *l1.tensors(), *l2.tensors(), clamp=self.cfg.deform_clamp,
            w1_packed=l1.packed_weight() if a4.is_cuda else None,
        )

"""VGG-style discriminator (reference DiscriminatorModel, srgan_train.py:591-699).

Counterpart of ``deepbedmap_tpu/models/discriminator.py``: ten convs with
padding 1 (only conv0 has a bias), BatchNorm(eps=1e-5) after convs 1-9 and
LeakyReLU(0.2) after each, then flatten -> 100 -> LeakyReLU -> 1, no sigmoid
(it is folded into the loss). At a 36^2 input the five stride-2 convs leave
1 x 1 x 512 before the head: 10,370,761 parameters.

NHWC in, (N, 1) logits out; the convs run on NCHW in between, and the map is
flattened in (H, W, C) order as in JAX, so ``linear_1``'s weight is the
transpose of the flax kernel with no reordering of its rows. The input size
fixes ``linear_1``'s width (``in_px``), as flax's lazy init does.

``FlaxBatchNorm`` is flax's ``nn.BatchNorm``, not ``nn.BatchNorm2d``: in
train mode it normalises with the batch's biased variance, E[x^2] - E[x]^2
clipped at 0, and updates the running statistics with that same biased
variance as ``momentum * old + (1 - momentum) * new`` (flax's momentum 0.9
is PyTorch's 0.1; ``nn.BatchNorm2d`` would store the unbiased variance, off
by n/(n-1)). Its parameters are ``scale`` and ``bias``, its statistics the
buffers ``mean`` and ``var``, under flax's names.

``forward(x, group)`` with a process group (data-parallel training) takes
the batch's mean and mean square over the global batch, with gradient
(``ops.collectives.global_mean``), before the one-pass variance: GSPMD's
cross-device BatchNorm in JAX's sharded step. The running statistics then
update identically on every rank.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from deepbedmap_tpu_torch.config import DiscriminatorConfig
from deepbedmap_tpu_torch.ops.collectives import global_mean
from deepbedmap_tpu_torch.ops.conv import leaky_relu


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of an NCHW tensor."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        if self.training:
            mean = x.mean((0, 2, 3))
            mean_sq = (x * x).mean((0, 2, 3))
            if group is not None:
                mean, mean_sq = global_mean(torch.cat([mean, mean_sq]), group).chunk(2)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = x - mean[:, None, None]
        return y * mul[:, None, None] + self.bias[:, None, None]


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(), in_px: int = 36):
        super().__init__()
        self.cfg = cfg
        self.in_px = in_px
        c_in, px = 1, in_px
        for i, (feat, k, s) in enumerate(zip(cfg.channels, cfg.kernels, cfg.strides)):
            self.add_module(f"conv_layer{i}", nn.Conv2d(c_in, feat, k, s, 1, bias=i == 0))
            if i > 0:
                self.add_module(f"batch_norm{i}",
                                FlaxBatchNorm(feat, cfg.bn_eps, cfg.bn_momentum))
            c_in, px = feat, (px + 2 - k) // s + 1
        if px < 1:
            raise ValueError(f"a {in_px}-px input leaves no pixels before the head")
        self.linear_1 = nn.Linear(px * px * c_in, cfg.fc_units)
        self.linear_2 = nn.Linear(cfg.fc_units, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded Chainer He-normal init (std = init_scale * sqrt(2 / fan_in))
        of the conv and dense weights; zero biases; BatchNorm scale 1, bias
        0, statistics mean 0 and var 1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    std = self.cfg.init_scale * math.sqrt(2.0 / fan_in)
                    m.weight.normal_(0.0, std, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, FlaxBatchNorm):
                    m.scale.fill_(1.0)
                    m.bias.zero_()
                    m.mean.zero_()
                    m.var.fill_(1.0)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """x (N, H, W, 1) NHWC -> (N, 1) logits. ``train()`` mode normalises
        with the batch's statistics (the global batch's over ``group``) and
        updates the running ones; ``eval()`` mode uses the running ones."""
        a = x.permute(0, 3, 1, 2)
        for i in range(len(self.cfg.channels)):
            a = getattr(self, f"conv_layer{i}")(a)
            if i > 0:
                a = getattr(self, f"batch_norm{i}")(a, group)
            a = leaky_relu(a)
        a = a.permute(0, 2, 3, 1).reshape(a.shape[0], -1)  # flax's (H, W, C) order
        return self.linear_2(leaky_relu(self.linear_1(a)))

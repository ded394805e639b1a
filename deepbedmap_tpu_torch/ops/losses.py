"""Adversarial and perceptual losses (reference srgan_train.py:841-1009).

Counterpart of ``deepbedmap_tpu/ops/losses.py``. Image batches are NHWC,
logits (N, 1). Golden values: ragan_loss 1.56670504 (srgan_train.py:985-991)
and generator_loss 4.35108415 (srgan_train.py:859-868).

``group`` (data-parallel training): RaGAN's relativistic means and the
accuracy become global-batch means (``ops.collectives.global_mean``); the
other means stay over the rank's rows, whose average over equal shards is
the global one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepbedmap_tpu_torch.config import LossConfig
from deepbedmap_tpu_torch.ops.collectives import global_mean
from deepbedmap_tpu_torch.ops.resize import avg_pool
from deepbedmap_tpu_torch.ops.ssim import ssim


def sigmoid_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy in Chainer's stable form
    -(x * (t - [x >= 0]) - log1p(exp(-|x|))) (srgan_train.py:976-980)."""
    logits = logits.float()
    targets = targets.float()
    per_elem = -(
        logits * (targets - (logits >= 0.0).float())
        - torch.log1p(torch.exp(-torch.abs(logits)))
    )
    return torch.mean(per_elem)


def ragan_loss(
    real_logits: torch.Tensor,
    fake_logits: torch.Tensor,
    real_target: float = 1.0,
    fake_target: float = 0.0,
    group=None,
) -> torch.Tensor:
    """Relativistic-average GAN loss: real logits relative to the mean fake
    logit classified as ``real_target``, and fake relative to the mean real
    as ``fake_target``. The generator's adversarial term swaps the targets
    (srgan_train.py:874-879)."""
    real_vs_fake = sigmoid_cross_entropy(
        real_logits - global_mean(torch.mean(fake_logits), group),
        torch.full_like(real_logits, real_target),
    )
    fake_vs_real = sigmoid_cross_entropy(
        fake_logits - global_mean(torch.mean(real_logits), group),
        torch.full_like(fake_logits, fake_target),
    )
    return real_vs_fake + fake_vs_real


def binary_accuracy(logits: torch.Tensor, labels: torch.Tensor, group=None) -> torch.Tensor:
    """Share of logits whose sign (threshold 0) matches the 0/1 label."""
    predictions = (logits >= 0.0).float()
    return global_mean(torch.mean((predictions == labels.float()).float()), group)


class GeneratorLossTerms(NamedTuple):
    total: torch.Tensor
    content: torch.Tensor
    adversarial: torch.Tensor
    topographic: torch.Tensor
    structural: torch.Tensor


def generator_loss(
    y_pred: torch.Tensor,  # NHWC predicted tiles
    y_true: torch.Tensor,  # NHWC groundtruth tiles
    fake_logits: torch.Tensor,  # (N, 1) discriminator logits on fakes
    real_logits: torch.Tensor,  # (N, 1) on reals, or literal ones
    x_topo: torch.Tensor,  # NHWC low-res tile cropped of its one-pixel ring
    cfg: LossConfig = LossConfig(),
    scale: int = 4,
    group=None,
) -> GeneratorLossTerms:
    """Weighted perceptual loss (srgan_train.py:841-902): content L1,
    RaGAN with swapped targets, topographic L1 of the ``scale`` x ``scale``
    average-pooled prediction against ``x_topo``, and 1 - SSIM. For the
    reference's behaviour the caller passes detached ``fake_logits`` and
    ones as ``real_logits`` (``train.steps``)."""
    content = torch.mean(torch.abs(y_pred - y_true))
    adversarial = ragan_loss(
        real_logits=real_logits,
        fake_logits=fake_logits,
        real_target=0.0,
        fake_target=1.0,
        group=group,
    )
    topographic = torch.mean(torch.abs(avg_pool(y_pred, scale) - x_topo))
    structural = 1.0 - ssim(y_pred, y_true, window_size=cfg.ssim_window)

    total = (
        cfg.content_weight * content
        + cfg.adversarial_weight * adversarial
        + cfg.topographic_weight * topographic
        + cfg.structural_weight * structural
    )
    return GeneratorLossTerms(total, content, adversarial, topographic, structural)

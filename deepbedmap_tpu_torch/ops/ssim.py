"""Structural similarity (SSIM), differentiable.

Counterpart of ``deepbedmap_tpu/ops/ssim.py`` (the reference's ssim-chainer
dependency, srgan_train.py:932-956): a uniform window through average
pooling, VALID windows, C1 = 0.01^2 and C2 = 0.03^2. Golden value:
ssim(ones(2,9,9,1), 2 * ones(2,9,9,1)) == 0.800004 (srgan_train.py:944-948).
"""

from __future__ import annotations

import torch

from deepbedmap_tpu_torch.ops.resize import avg_pool

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def ssim(
    y_pred: torch.Tensor,
    y_true: torch.Tensor,
    window_size: int = 9,
    stride: int = 1,
) -> torch.Tensor:
    """Mean SSIM between two NHWC batches over every window position and
    batch entry: the quantity the structural loss takes as 1 - SSIM
    (srgan_train.py:887)."""
    if y_pred.shape != y_true.shape:
        raise ValueError(
            f"Input images must have the same dimensions, "
            f"got {tuple(y_pred.shape)} vs {tuple(y_true.shape)}"
        )

    mu_x = avg_pool(y_pred, window_size, stride)
    mu_y = avg_pool(y_true, window_size, stride)
    mu_xx = avg_pool(y_pred * y_pred, window_size, stride)
    mu_yy = avg_pool(y_true * y_true, window_size, stride)
    mu_xy = avg_pool(y_pred * y_true, window_size, stride)

    var_x = mu_xx - mu_x * mu_x
    var_y = mu_yy - mu_y * mu_y
    cov_xy = mu_xy - mu_x * mu_y

    numerator = (2.0 * mu_x * mu_y + _C1) * (2.0 * cov_xy + _C2)
    denominator = (mu_x * mu_x + mu_y * mu_y + _C1) * (var_x + var_y + _C2)
    return torch.mean(numerator / denominator)

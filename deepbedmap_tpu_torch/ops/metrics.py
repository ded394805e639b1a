"""Quality metrics (reference srgan_train.py:906-928, deepbedmap.py:570-573).

Counterpart of ``deepbedmap_tpu/ops/metrics.py`` on tensors.
"""

from __future__ import annotations

import torch

from deepbedmap_tpu_torch.ops.collectives import global_mean


def psnr(y_pred: torch.Tensor, y_true: torch.Tensor, data_range: float = 2.0 ** 32,
         group=None) -> torch.Tensor:
    """Batch Peak Signal-to-Noise Ratio; over ``group``, of the global
    batch's MSE (taken before the log, not a mean of the ranks' PSNRs).

    Keeps the reference's unusual ``data_range=2**32`` default
    (srgan_train.py:907) so logged numbers are directly comparable;
    golden value: psnr(ones, 2*ones) == 192.65919722494797.
    """
    mse = global_mean(torch.mean(torch.square(y_pred - y_true)), group)
    return 20.0 * torch.log10(data_range / torch.sqrt(mse))


def rmse(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error, NaN-aware: pairs whose difference is NaN (a
    NaN in either, such as a point outside the grid) are left out, and the
    count is floored at 1."""
    err = y_pred - y_true
    valid = ~torch.isnan(err)
    err = torch.where(valid, err, 0.0)
    count = valid.sum().clamp(min=1)
    return torch.sqrt(torch.sum(err * err) / count)

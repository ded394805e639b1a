"""The plain NHWC 3x3 conv and the LeakyReLU shared by the port's layers."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias, padding: int = 1) -> torch.Tensor:
    """Conv of an NHWC tensor with an OIHW weight. A contiguous NHWC tensor
    permuted to NCHW is already channels_last, so no copy is made on the way
    in, and cuDNN returns channels_last, so none on the way out."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=padding).permute(
        0, 2, 3, 1
    )


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)

"""Resampling / layout ops on NHWC tensors.

Counterpart of ``deepbedmap_tpu/ops/resize.py`` (``nearest_upsample``,
``space_to_depth``, ``avg_pool``), with the same ``(bh, bw, c)`` channel order, so that
conv(x, k=3b, s=b) == conv(space_to_depth(x, b), k=3, s=1) and the JAX
input-block kernels map onto the port's by a plain HWIO -> OIHW transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor by an integer factor."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """Rearrange NHWC (N, H, W, C) -> (N, H/b, W/b, b*b*C), channels (bh, bw, c)."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth: {(h, w)} not divisible by {block}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # N, H/b, W/b, bh, bw, C
    return x.reshape(n, h // block, w // block, block * block * c)


def avg_pool(x: torch.Tensor, window: int, stride: int | None = None) -> torch.Tensor:
    """Average pooling over the spatial axes of an NHWC tensor, VALID windows
    (the topographic loss pools 36^2 predictions 4x4 -> 9^2). As in JAX, the
    window's sum divided by window^2."""
    stride = window if stride is None else stride
    summed = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, divisor_override=1)
    return summed.permute(0, 2, 3, 1) / float(window * window)

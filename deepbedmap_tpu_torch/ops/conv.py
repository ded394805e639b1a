"""The plain NHWC 3x3 conv and the LeakyReLU shared by the port's layers."""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A compute dtype's name (``GeneratorConfig.compute_dtype``) as the
    layers take it: None for None or 'float32' (no casts, as JAX's
    ``dtype=None``), else the torch dtype."""
    return None if name in (None, "float32") else getattr(torch, name)


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias, padding: int = 1,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Conv of an NHWC tensor with an OIHW weight. A contiguous NHWC tensor
    permuted to NCHW is already channels_last, so no copy is made on the way
    in, and cuDNN returns channels_last, so none on the way out.

    With a ``dtype`` (flax's ``nn.Conv(dtype=...)``) the input, weight and
    bias are cast to it, and the bias is added to the conv's output after
    it is rounded to ``dtype``, so each result is rounded where flax rounds
    it: once after the conv, once after the bias."""
    if dtype is None:
        return F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=padding).permute(
            0, 2, 3, 1
        )
    z = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype), padding=padding)
    return z.permute(0, 2, 3, 1) + bias.to(dtype)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even, as XLA's
    ``astype``) and returned in its own dtype: a bf16 multiplicand of the
    TPU kernels' ``mxu_bf16`` mode, as the plain versions compute it."""
    return t.to(torch.bfloat16).to(t.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(s: float, dtype: torch.dtype) -> float:
    return torch.tensor(s, dtype=dtype).item()


def scaled(s: float, t: torch.Tensor) -> torch.Tensor:
    """``s * t`` with the Python number ``s`` taken in ``t``'s dtype first,
    as JAX takes a weakly typed scalar: JAX multiplies a bfloat16 tensor by
    bfloat16(0.2), where PyTorch would multiply by 0.2 in float32 and round
    once. For float32 and float64 tensors this is PyTorch's own product."""
    return _rounded(s, t.dtype) * t


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, scaled(slope, x))

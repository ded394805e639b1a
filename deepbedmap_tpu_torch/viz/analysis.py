"""Terrain analysis on a device.

Counterpart of ``deepbedmap_tpu/viz/analysis.py``:

- ``standard_deviation_2d``: rolling-window std-dev roughness grid
  (reference paper_figures.py:847-865, xarray.rolling(5,5).std());
- ``hillshade``: Lambertian shaded relief for map figures (the reference gets
  this from GMT grdimage -I).

Both take a 2-D grid: a tensor is computed on its own device; anything else
(a numpy array) is copied as float32 to ``device``, the card unless the
caller asks for the CPU. They return float32 tensors. JAX computes both in
plain XLA, so they are plain PyTorch here (box sums by ``avg_pool2d``,
``torch.gradient``), with JAX's formulas.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.ops.interp import as_f32


def as_grid(grid, device) -> torch.Tensor:
    """A float32 tensor of ``grid``: a tensor on its own device, anything
    else copied to ``device``."""
    if isinstance(grid, torch.Tensor):
        return grid.to(torch.float32)
    return as_f32(grid, resolve_device(device))


def standard_deviation_2d(grid, window: int = 5, device="cuda") -> torch.Tensor:
    """Rolling std-dev over a centered (window x window) neighbourhood.

    Matches xarray ``rolling(y=5, x=5, center=True).std()`` semantics: the
    border where the window is incomplete is NaN; NaNs propagate. JAX's
    one-pass formula, kept so the answer is JAX's, cancellation included:
    in float32, var = max(s2 / n - mean^2, 0) from the window's box sums s1
    and s2 = sum of x^2, then ddof=1 as var * n / max(n - 1, 1). The box
    sums are ``avg_pool2d`` with ``divisor_override=1`` (never TF32, as a
    cuDNN convolution might be) over float64 and round once to float32:
    XLA's float32 sums are a few ulps from that, and at a DEM's magnitudes
    the cancellation turns each ulp of s2 into ~1e-7 of max(x^2) in the
    variance."""
    half = window // 2
    x = as_grid(grid, device)

    def box(a):
        return F.avg_pool2d(a.double()[None, None], window, stride=1,
                            divisor_override=1)[0, 0].float()

    # JAX's box of ones, exact in float32; a tensor, since CUDA divides by a
    # Python number as a product with its reciprocal, an ulp off the quotient
    n = torch.tensor(float(window * window), device=x.device)
    s1 = box(x)
    s2 = box(x * x)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    std = torch.sqrt(var * n / torch.clamp(n - 1.0, min=1.0))  # ddof=1 like xarray
    return F.pad(std, (half, half, half, half), value=math.nan)


def hillshade(
    grid,
    res: float = 250.0,
    azimuth_deg: float = 315.0,
    altitude_deg: float = 45.0,
    vert_exag: float = 1.0,
    device="cuda",
) -> torch.Tensor:
    """Lambertian hillshade in [0, 1]. ``torch.gradient`` gives (dy, dx) as
    ``jnp.gradient`` does: central differences inside, one-sided first-order
    differences at the edges."""
    z = as_grid(grid, device) * vert_exag
    dy, dx = torch.gradient(z, spacing=res)
    slope = math.pi / 2.0 - torch.arctan(torch.hypot(dx, dy))
    aspect = torch.atan2(-dx, dy)
    az = torch.deg2rad(torch.tensor(360.0 - azimuth_deg + 90.0, device=z.device))
    alt = torch.deg2rad(torch.tensor(altitude_deg, device=z.device))
    shaded = torch.sin(alt) * torch.sin(slope) + torch.cos(alt) * torch.cos(slope) * torch.cos(
        az - aspect
    )
    return torch.clamp(shaded, 0.0, 1.0)

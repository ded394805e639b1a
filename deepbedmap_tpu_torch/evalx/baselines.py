"""Comparison baselines (reference deepbedmap.py:323-366,
paper_figures.py:593-620): classical interpolation upsamples of the low-res
bed to compare against the neural super-resolution — bicubic 4x BEDMAP2
('cubicbedmap'), bilinear downsample of synthetic high-res.

Counterpart of ``deepbedmap_tpu/evalx/baselines.py``, which resizes with
``jax.image.resize``. That function is reproduced here, not replaced by
``F.interpolate`` (whose bicubic uses Keys a = -0.75 and other edge weights,
0.2 apart on unit-variance data): per resized axis a dense (in, out) weight
matrix built as JAX builds it (Keys cubic a = -0.5 or the triangle, half-pixel
centres, the kernel's support widened by 1/factor when downsampling, which
is ``antialias=True``, each output's weights renormalised to sum to 1, zero
for samples outside the input), applied as one product per axis. An axis
whose size does not change is left as it is, as JAX skips it. Because the
matrices are dense, a single NaN in the input makes the whole output NaN,
as it does in JAX (NaN x 0 is NaN). The weights are float32 as JAX's; the
products run in float64 and round once to float32, so TF32 settings of the
card do not touch them.
"""

from __future__ import annotations

import numpy as np
import torch

from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.ops.interp import as_f32

_EPS32 = float(np.finfo(np.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_weights(n_in: int, n_out: int, method: str, device) -> torch.Tensor:
    """The (n_in, n_out) float32 weight matrix of ``jax.image.resize`` along
    one axis (``jax._src.image.scale.compute_weight_mat`` with translation
    0 and ``antialias=True``)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    f32 = dict(dtype=torch.float32, device=device)
    # a tensor: CUDA divides by a Python number as a product with its
    # reciprocal (0.4 for x1/2.5), an ulp off JAX's quotient
    kernel_scale = torch.tensor(max(float(inv_scale), 1.0), **f32)
    sample_f = (torch.arange(n_out, **f32) + 0.5) * float(inv_scale) - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, **f32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize(data: torch.Tensor, out_shape, method: str) -> torch.Tensor:
    """``jax.image.resize(data, out_shape, method)`` of a 2-D float32 tensor,
    on its device: one float64 product per axis whose size changes, the
    cheaper order first (as JAX's einsum chooses it)."""
    (h, w), (oh, ow) = data.shape, out_shape
    dev = data.device

    def rows(z):
        return resize_weights(h, oh, method, dev).double().T @ z if oh != h else z

    def cols(z):
        return z @ resize_weights(w, ow, method, dev).double() if ow != w else z

    z = data.double()
    if oh * h * w + oh * w * ow <= h * w * ow + oh * h * ow:
        return cols(rows(z)).float()
    return rows(cols(z)).float()


def _resample(raster: Raster, factor: float, method: str, device) -> Raster:
    data = as_f32(raster.masked(), resolve_device(device))
    out_shape = (int(round(data.shape[0] * factor)), int(round(data.shape[1] * factor)))
    return Raster(
        resize(data, out_shape, method).cpu().numpy(),
        left=raster.left,
        top=raster.top,
        res=raster.res / factor,
        crs=raster.crs,
    )


def bicubic_upsample(raster: Raster, factor: int = 4, device="cuda") -> Raster:
    """skimage.transform.rescale(order=3) equivalent — the 'cubicbedmap'
    baseline (deepbedmap.py:327-339), computed on ``device``."""
    return _resample(raster, factor, "cubic", device)


def bilinear_resample(raster: Raster, factor: float, device="cuda") -> Raster:
    """Bilinear up/down-sample — the 'synthetic HRES' baseline
    (deepbedmap.py:344-356 uses 1/2.5), computed on ``device``."""
    return _resample(raster, factor, "linear", device)

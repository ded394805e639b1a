"""Continuous-curvature tension-spline gridding (GMT ``surface`` equivalent),
on a device.

Counterpart of ``deepbedmap_tpu/ops/spline.py``. The reference grids survey
xyz points with GMT's surface program, minimum-curvature interpolation under
tension T (data_prep.py:382-441; T=0.35, spacing 250 m). The same
variational problem

    minimize (1-T) * integral (laplacian z)^2 + T * integral |grad z|^2
    subject to z(data cells) = data

is solved here by damped Jacobi relaxation of the Euler-Lagrange equation
(1-T) * biharmonic(z) - T * laplacian(z) = 0 with the data nodes pinned,
coarse to fine: the same stencils, padding, damping, restriction pyramid,
start and prolongation as JAX, in float32, with the sums taken in JAX's
order. JAX sweeps inside ``lax.scan``; here each sweep is a few PyTorch
operations launched from a Python loop. The result is an approximation of
GMT surface (the exact converged system is ``ops.gmt_surface``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deepbedmap_tpu_torch.device import resolve_device

# Damped Jacobi: the biharmonic stencil is not diagonally dominant
# (|off-diag| sums to 44 vs center 20), so plain Jacobi diverges; the
# iteration matrix spectrum demands omega < ~0.62 at T=0.35.
_OMEGA = 0.6


def _pad_odd(a: torch.Tensor) -> torch.Tensor:
    """Free-boundary padding by two cells of odd reflection (linear
    extrapolation): planes then satisfy the stencil exactly up to the edge,
    unlike edge-replicate padding which imposes zero normal slope."""
    top = 2.0 * a[:1] - a[1:3].flip(0)
    bot = 2.0 * a[-1:] - a[-3:-1].flip(0)
    a = torch.cat([top, a, bot], dim=0)
    left = 2.0 * a[:, :1] - a[:, 1:3].flip(1)
    right = 2.0 * a[:, -1:] - a[:, -3:-1].flip(1)
    return torch.cat([left, a, right], dim=1)


def _coefficients(tension: float, device) -> tuple:
    """(1 - T), T and the stencil's center (1 - T) * 20 + T * 4, computed in
    float32 as JAX computes them from its float32 ``tension``; the center is
    a tensor, so the division by it is a true division on every device."""
    t = np.float32(tension)
    one_minus = np.float32(1.0) - t
    center = one_minus * np.float32(20.0) + t * np.float32(4.0)
    return float(one_minus), float(t), torch.tensor(center, device=device)


def _relax_step(z, data, has_data, coefficients):
    """One Jacobi sweep of (1-T)*bih(z) - T*lap(z) = 0, data nodes pinned.

    Stencils (unit spacing): laplacian 5-point (center -4), biharmonic
    13-point (center 20, cross-1 -8, diag 2, cross-2 1).
    """
    one_minus, t, center = coefficients
    zp = _pad_odd(z)
    h, w = zp.shape

    def sh(dy, dx):
        return zp[2 + dy: h - 2 + dy, 2 + dx: w - 2 + dx]

    # biharmonic neighbours (coefficient * value), center coeff 20
    bih_neigh = (
        -8.0 * (sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1))
        + 2.0 * (sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1))
        + 1.0 * (sh(-2, 0) + sh(2, 0) + sh(0, -2) + sh(0, 2))
    )
    # laplacian neighbours, center coeff -4
    lap_neigh = sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1)

    rhs = -(one_minus * bih_neigh) + t * lap_neigh
    z_new = rhs / center
    z_new = z + _OMEGA * (z_new - z)
    return torch.where(has_data, data, z_new)


def _upsample2(z: torch.Tensor, dim: int) -> torch.Tensor:
    """x2 linear upsampling along ``dim`` with half-pixel centres, in XLA's
    CPU arithmetic for ``jax.image.resize``: output 2k mixes inputs k-1 and
    k with weights 0.25 and 0.75, output 2k+1 inputs k and k+1 with 0.75 and
    0.25, and the two edge outputs copy the edge inputs (the weights are
    renormalised over the inputs in range). Each output is one fused
    multiply-add on the lower input's rounded product, round(round(w_lo *
    x_lo) + w_hi * x_hi), computed exactly in float64 and rounded once."""
    z = torch.movedim(z, dim, 0)
    lo, hi = z[:-1].double(), z[1:].double()
    even = ((0.25 * lo).float().double() + 0.75 * hi).float()  # outputs 2, 4, ...
    odd = ((0.75 * lo).float().double() + 0.25 * hi).float()  # outputs 1, 3, ...
    out = torch.empty((2 * z.shape[0],) + tuple(z.shape[1:]), dtype=z.dtype, device=z.device)
    out[0], out[-1] = z[0], z[-1]
    out[2::2], out[1:-1:2] = even, odd
    return torch.movedim(out, 0, dim)


def prolong(z: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear x2 upsampling with half-pixel centres, cropped to ``shape``:
    JAX's ``jax.image.resize(z, (2h, 2w), "linear")[:H, :W]``, one einsum
    whose cheaper contraction order takes the columns first when w > h and
    the rows first otherwise, each pass in ``_upsample2``'s arithmetic (XLA
    on the CPU rounds some small second passes' products separately, so
    this is within an ulp of it there). Its values are those of
    ``F.interpolate(..., "bilinear", align_corners=False)``, edges included,
    up to that rounding."""
    first = 1 if z.shape[1] > z.shape[0] else 0
    return _upsample2(_upsample2(z, first), 1 - first)[: shape[0], : shape[1]]


def solve_tension_spline(
    data,  # (H, W) data values at constrained nodes (0 elsewhere)
    has_data,  # (H, W) bool mask of constrained nodes
    tension: float = 0.35,
    iterations: int = 300,
    device="cuda",
) -> torch.Tensor:
    """Solve for the full (H, W) float32 surface on ``device`` via recursive
    coarse-to-fine relaxation (GMT surface's multigrid schedule in spirit):
    constraints are box-averaged down to a ~4-node grid, each level is
    Jacobi-relaxed ``iterations`` times and bilinearly prolonged as the next
    level's initialisation. Jacobi kills high-frequency error fast; the
    coarse levels supply the low-frequency shape it cannot reach.

    ``data`` and ``has_data`` are numpy arrays; the result is a tensor on
    ``device``."""
    dev = resolve_device(device)
    data = torch.tensor(np.asarray(data), dtype=torch.float32, device=dev)
    has_data = torch.tensor(np.asarray(has_data), dtype=torch.bool, device=dev)
    coefficients = _coefficients(tension, dev)

    # restrict constraints level by level (box average of data nodes)
    levels = [(data, has_data)]
    while min(levels[-1][0].shape) >= 8:
        d, m = levels[-1]
        hh, ww = d.shape
        hc, wc = (hh + 1) // 2, (ww + 1) // 2
        pad = (0, 2 * wc - ww, 0, 2 * hc - hh)
        dp = F.pad(torch.where(m, d, 0.0), pad)
        mp = F.pad(m.to(torch.float32), pad)
        d4 = dp.reshape(hc, 2, wc, 2).sum(dim=(1, 3))
        m4 = mp.reshape(hc, 2, wc, 2).sum(dim=(1, 3))
        levels.append((torch.where(m4 > 0, d4 / torch.clamp(m4, min=1.0), 0.0), m4 > 0))

    total = torch.where(has_data, data, 0.0).sum()
    count = torch.clamp(has_data.sum(), min=1)
    z = (total / count).expand(levels[-1][0].shape)

    for d, m in reversed(levels):
        if z.shape != d.shape:
            z = prolong(z, d.shape)
        for _ in range(iterations):
            z = _relax_step(z, d, m, coefficients)
    return z


def distance_mask(has_data: np.ndarray, radius: int) -> np.ndarray:
    """Cells farther than ``radius`` cells (Chebyshev) from any data cell —
    GMT surface's -M{n}c masking (data_prep.py:418). On the host with scipy,
    as JAX computes it."""
    from scipy import ndimage

    if radius <= 0:
        return ~has_data
    structure = np.ones((3, 3), bool)
    grown = ndimage.binary_dilation(has_data, structure, iterations=radius)
    return ~grown


def gridline_to_pixel(z: torch.Tensor) -> torch.Tensor:
    """Gridline -> pixel registration: average the 4 surrounding nodes
    (GMT grdsample -T, data_prep.py:427-437). (H, W) -> (H-1, W-1)."""
    return 0.25 * (z[:-1, :-1] + z[:-1, 1:] + z[1:, :-1] + z[1:, 1:])

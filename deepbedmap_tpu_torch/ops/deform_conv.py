"""Deformable convolution v1 by masked shifts: the plain versions of K2 and K3.

Counterpart of ``deepbedmap_tpu/ops/deform_conv.py:_deform_conv_shifts`` and
``_deform_conv_shifts_zproj``. Offsets are clamped to [-clamp, clamp] and the
bilinear sample decomposes over the (2*clamp+2)^2 integer shifts as sliced
reads weighted by per-position masks:

    y_t(p) = sum_{sy,sx} wy[sy](p) * wx[sx](p) * x(p + tap_t + (sy, sx))
    wy[s]  = (1-fy) * [floor(dy) == s] + fy * [floor(dy) == s-1]

Offset layout as in the JAX package: ``offsets[..., :K]`` are row (y)
displacements and ``offsets[..., K:]`` column (x) displacements, taps
row-major over the kernel grid. Zero padding outside the image. Weights are
OIHW ``(C_out, C_in, kh, kw)``; activations NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _shift_weights(off_y: torch.Tensor, off_x: torch.Tensor, clamp: int):
    """Per-shift mask weights {s: wy[s]}, {s: wx[s]} for one tap."""
    shifts = range(-clamp, clamp + 2)
    dy = off_y.clamp(-clamp, clamp)
    dx = off_x.clamp(-clamp, clamp)
    iy, ix = torch.floor(dy), torch.floor(dx)
    fy, fx = dy - iy, dx - ix
    wy = {s: (1.0 - fy) * (iy == s) + fy * (iy == s - 1) for s in shifts}
    wx = {s: (1.0 - fx) * (ix == s) + fx * (ix == s - 1) for s in shifts}
    return wy, wx


def _pad_hw(a: torch.Tensor, big: int) -> torch.Tensor:
    """Zero-pad the H and W axes of (..., H, W, C) by ``big`` each side."""
    return F.pad(a, (0, 0, big, big, big, big))


def deform_conv_shifts(
    x: torch.Tensor,  # (N, H, W, C_in)
    offsets: torch.Tensor,  # (N, H, W, 2K)
    weight: torch.Tensor,  # (C_out, C_in, kh, kw)
    bias: Optional[torch.Tensor],
    padding: int = 1,
    clamp: int = 2,
) -> torch.Tensor:
    """Deformable conv: sample each tap by masked shifts, then contract it."""
    n, h, w, c_in = x.shape
    c_out, _, kh, kw = weight.shape
    k = kh * kw
    big = padding + clamp + 1  # tap shift + max integer shift + corner
    x_big = _pad_hw(x.float(), big)
    rhs = weight.permute(2, 3, 1, 0).reshape(k, c_in, c_out)
    acc = x.new_zeros((n * h * w, c_out), dtype=torch.float32)
    shifts = range(-clamp, clamp + 2)
    for t in range(k):
        u, v = divmod(t, kw)
        wy, wx = _shift_weights(offsets[..., t].float(), offsets[..., k + t].float(), clamp)
        y_t = x.new_zeros((n, h, w, c_in), dtype=torch.float32)
        for sy in shifts:
            row0 = big + u - padding + sy
            for sx in shifts:
                col0 = big + v - padding + sx
                patch = x_big[:, row0 : row0 + h, col0 : col0 + w, :]
                y_t = y_t + (wy[sy] * wx[sx])[..., None] * patch
        acc = acc + y_t.reshape(n * h * w, c_in) @ rhs[t]
    out = acc.reshape(n, h, w, c_out)
    return out if bias is None else out + bias


def sample_tap_fields(
    z: torch.Tensor,  # (N, H, W, K, C) tap fields
    offsets: torch.Tensor,  # (N, H, W, 2K)
    bias: Optional[torch.Tensor],
    padding: int = 1,
    clamp: int = 2,
    kw: int = 3,
) -> torch.Tensor:
    """sum_t of tap field t's masked-shift sample at tap t's position, + bias.
    The plain version of K3 (``deform_zproj1``) when C == 1."""
    n, h, w, k, c = z.shape
    big = padding + clamp + 1
    z_big = _pad_hw(z.permute(3, 0, 1, 2, 4).float(), big)  # (K, N, H', W', C)
    acc = z.new_zeros((n, h, w, c), dtype=torch.float32)
    shifts = range(-clamp, clamp + 2)
    for t in range(k):
        u, v = divmod(t, kw)
        wy, wx = _shift_weights(offsets[..., t].float(), offsets[..., k + t].float(), clamp)
        for sy in shifts:
            row0 = big + u - padding + sy
            for sx in shifts:
                col0 = big + v - padding + sx
                patch = z_big[t, :, row0 : row0 + h, col0 : col0 + w, :]
                acc = acc + (wy[sy] * wx[sx])[..., None] * patch
    return acc if bias is None else acc + bias


def deform_conv_shifts_zproj(
    x: torch.Tensor,  # (N, H, W, C_in)
    offsets: torch.Tensor,  # (N, H, W, 2K)
    weight: torch.Tensor,  # (C_out, C_in, kh, kw)
    bias: Optional[torch.Tensor],
    padding: int = 1,
    clamp: int = 2,
) -> torch.Tensor:
    """The same deformable conv, projection first: z_t = x @ W_t, then the
    masked-shift samples of the (N, H, W, C_out) projections are summed."""
    c_out, c_in, kh, kw = weight.shape
    rhs = weight.permute(2, 3, 1, 0).reshape(kh * kw, c_in, c_out)
    z = torch.einsum("nhwc,kcd->nhwkd", x.float(), rhs)
    return sample_tap_fields(z, offsets, bias, padding, clamp, kw)

"""Nearest-upsample(2) then 3x3 SAME conv, computed at the source resolution.

Counterpart of ``deepbedmap_tpu/ops/phase_conv.py``. Because the upsample is
nearest, hi-res pixel (2i+py, 2j+px) reads source pixel (i, j), and every
3x3 window over the upsampled image touches at most a 2x2 source
neighbourhood. Summing the taps that land on the same source pixel, per
output phase (py, px), gives four 2x2 kernels:

- along each axis, phase 0's three taps (k0, k1, k2) hit source offsets
  (-1, 0, 0): the two-tap kernel (k0, k1+k2) at offsets (-1, 0);
- phase 1's hit (0, 0, +1): (k0+k1, k2) at offsets (0, +1).

One 2x2 VALID conv with 4F outputs over the source padded by one pixel then
computes all four phases (16 C F multiply-adds per source pixel instead of
the literal 36 C F), and their crops interleave into the upsampled output.
The result is the conv of the upsampled image up to the order of the sums.
Weights are OIHW, activations NHWC; the conv is ``F.conv2d`` (cuDNN on the
card), as JAX computes it in XLA outside any Pallas kernel. The parameters
are the literal 3x3 layer's, so the generator's parameter tree is the same
with or without ``GeneratorConfig.upsample_phase_conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepbedmap_tpu_torch.ops.conv import leaky_relu


def phase_kernels_2x(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (F, C, 3, 3) -> (4F, C, 2, 2), phase-major as JAX's: output
    channels [F (2 py + px), F (2 py + px + 1)) hold the (py, px) phase. The
    taps are summed in ``weight``'s dtype, in JAX's order (rows, then
    columns), so a bfloat16 weight gives JAX's bfloat16 sums."""
    k0, k1, k2 = weight[:, :, 0], weight[:, :, 1], weight[:, :, 2]  # rows, (F, C, 3)
    ry0 = torch.stack([k0, k1 + k2], dim=2)  # (F, C, 2, 3): py=0 taps at dy (-1, 0)
    ry1 = torch.stack([k0 + k1, k2], dim=2)  # py=1 taps at dy (0, +1)

    def cols(r):
        c0 = torch.stack([r[..., 0], r[..., 1] + r[..., 2]], dim=-1)  # px=0: dx (-1, 0)
        c1 = torch.stack([r[..., 0] + r[..., 1], r[..., 2]], dim=-1)  # px=1: dx (0, +1)
        return c0, c1  # each (F, C, 2, 2)

    k00, k01 = cols(ry0)
    k10, k11 = cols(ry1)
    return torch.cat([k00, k01, k10, k11], dim=0)


def upsample2_conv3x3(
    x: torch.Tensor,  # (N, H, W, C)
    weight: torch.Tensor,  # (F, C, 3, 3) OIHW
    bias: torch.Tensor,  # (F,)
    leaky: bool = False,
    slope: float = 0.2,
) -> torch.Tensor:
    """conv3x3_SAME(nearest_upsample(x, 2)) + bias [then LeakyReLU] ->
    (N, 2H, 2W, F), computed in the dtype of its arguments: the conv's
    output is rounded to it, then the bias added, as in JAX. The caller
    casts (the generator casts all three to its compute dtype)."""
    n, h, w, _ = x.shape
    f = weight.shape[0]
    pk = phase_kernels_2x(weight)
    # one VALID 2x2 conv over the zero-padded source: output position m
    # covers source rows (m-1, m), so phase 0 reads [0:H] and phase 1 [1:H+1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    z = F.conv2d(xp.permute(0, 3, 1, 2), pk).permute(0, 2, 3, 1)  # (N, H+1, W+1, 4F)
    z = z + bias.repeat(4)
    if leaky:
        z = leaky_relu(z, slope)
    z00 = z[:, 0:h, 0:w, 0 * f:1 * f]
    z01 = z[:, 0:h, 1:w + 1, 1 * f:2 * f]
    z10 = z[:, 1:h + 1, 0:w, 2 * f:3 * f]
    z11 = z[:, 1:h + 1, 1:w + 1, 3 * f:4 * f]
    # interleave the phases: out[2i+py, 2j+px] = z{py px}[i, j]
    out = torch.stack([torch.stack([z00, z01], dim=3), torch.stack([z10, z11], dim=3)],
                      dim=2)  # (N, H, 2, W, 2, F)
    return out.reshape(n, 2 * h, 2 * w, f)

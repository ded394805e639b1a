"""Residual dense block: the plain version and the K1 kernel wrapper.

Counterpart of ``deepbedmap_tpu/ops/pallas_rdb.py``. ``rdb_reference`` is the
port of its ``rdb_reference`` (the plain composition of five 3x3 SAME convs);
``rdb_fused`` takes the hand-written CUDA kernel ``csrc/rdb.cu`` for a CUDA
tensor and the plain version for a CPU tensor. There is no size rule and no
fallback: any N, H, W >= 1 go through the kernel on the card.

Layout: NHWC at both functions. Conv weights are OIHW, as everywhere in the
port; ``pack_rdb_weights`` repacks them once for the kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from deepbedmap_tpu_torch.ops import _kernels
from deepbedmap_tpu_torch.ops.conv import leaky_relu

FEATURES = 64
GROWTH = 32


def rdb_reference(
    x: torch.Tensor,  # (N, H, W, F)
    kernels: Sequence[torch.Tensor],  # five OIHW (C_out_j, C_in_j, 3, 3)
    biases: Sequence[torch.Tensor],  # five (C_out_j,)
    scaling: float,
) -> torch.Tensor:
    """out = x + scaling * conv5(dense(x)), LeakyReLU(0.2) after conv1-4."""
    xc = x.permute(0, 3, 1, 2)
    acts = [xc]
    for j in range(5):
        z = F.conv2d(torch.cat(acts, 1), kernels[j], biases[j], padding=1)
        if j < 4:
            acts.append(leaky_relu(z))
    return (xc + scaling * z).permute(0, 2, 3, 1)


def pack_rdb_weights(
    kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weight layout: each stage as [C_out/32][C_in][9][32],
    the five stages back to back, and the five biases concatenated."""
    blocks = []
    for k in kernels:
        co, ci = k.shape[:2]
        blocks.append(
            k.detach().reshape(co // 32, 32, ci, 9).permute(0, 2, 3, 1).reshape(-1)
        )
    w = torch.cat(blocks).contiguous()
    b = torch.cat([b_.detach() for b_ in biases]).contiguous()
    return w, b


def rdb_fused(
    x: torch.Tensor,  # (N, H, W, 64) float32
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    scaling: float,
    packed: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One dense block: K1 (``csrc/rdb.cu``) on a CUDA tensor, the plain
    ``rdb_reference`` on a CPU tensor. ``packed`` is ``pack_rdb_weights``'s
    result, cached by the caller so the repack happens once per load."""
    if x.device.type == "cpu":
        return rdb_reference(x, kernels, biases, scaling)
    if x.device.type != "cuda":
        raise ValueError(f"rdb_fused: unsupported device {x.device}")
    n, h, w, _ = x.shape
    _kernels.check_tensor(x, "x", (n, h, w, FEATURES))
    _kernels.check_image_shape(n, h, w, FEATURES + 4 * GROWTH)
    w_packed, b_packed = packed if packed is not None else pack_rdb_weights(
        kernels, biases
    )
    n_w = sum(9 * (FEATURES + GROWTH * j) * (GROWTH if j < 4 else FEATURES)
              for j in range(5))
    _kernels.check_tensor(w_packed, "packed weights", (n_w,))
    _kernels.check_tensor(b_packed, "packed biases", (4 * GROWTH + FEATURES,))
    ws = torch.empty((n, h, w, FEATURES + 4 * GROWTH), device=x.device)
    out = torch.empty_like(x)
    _kernels.launch_rdb_forward(x, ws, out, w_packed, b_packed, n, h, w, scaling)
    return out

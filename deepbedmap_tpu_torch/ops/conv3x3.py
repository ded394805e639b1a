"""The fused 3x3 conv: the plain version and the K10 kernel wrapper.

Counterpart of ``deepbedmap_tpu/ops/pallas_conv.py``. ``conv3x3_reference`` is
the port of its ``conv3x3_reference``: a 3x3 SAME conv, then + bias, then
[+ residual], then [LeakyReLU 0.2], in that order. ``conv3x3_fused`` takes the
hand-written CUDA kernel ``csrc/conv3x3.cu`` for a CUDA tensor and the plain
version for a CPU tensor; it computes the same function as the JAX
``conv3x3_pallas``. There is no size rule and no fallback.

Gradients: on a CUDA tensor ``conv3x3_fused`` goes through
``_autograd.kernel_with_plain_grad``, its backward autograd of
``conv3x3_reference`` (of x, the weight, the bias and the residual)
recomputed on the saved inputs, as JAX's ``pallas_conv.py:214-261``.

bf16 multiplicands (``mxu_bf16=True``, the JAX kernel's ``mxu_bf16``,
``pallas_conv.py:77, 131-132``): the conv's input and weight are rounded to
bf16 (to nearest even), the sum, bias, residual and LeakyReLU stay float32.
``conv3x3_reference(mxu_bf16=True)`` is the plain version, K10's bf16 route
(``csrc/conv3x3_tc.cuh``: bf16 ``wgmma`` k16 on weights that
``pack_conv_weight(mxu_bf16=True)`` packs in bf16) the kernel; the gradient
in either mode is that of the float32 plain version, as JAX's custom VJP
(``pallas_conv.py:224-230``).

Layout: NHWC activations, OIHW weights. ``pack_conv_weight`` is the packed
layout of the tensor-core conv (``csrc/conv3x3_tc.cuh``) that K10 and the
dense-block kernels K1 and K4 (``ops.rdb``) share.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from deepbedmap_tpu_torch.ops import _kernels
from deepbedmap_tpu_torch.ops._autograd import kernel_with_plain_grad
from deepbedmap_tpu_torch.ops._packed import packed
from deepbedmap_tpu_torch.ops.conv import leaky_relu, round_bf16

C_OUT = 64
C_INS = (64, 128)


def conv3x3_reference(
    x: torch.Tensor,  # (N, H, W, C_in)
    weight: torch.Tensor,  # (C_out, C_in, 3, 3) OIHW
    bias: torch.Tensor,  # (C_out,)
    leaky: bool = False,
    residual: Optional[torch.Tensor] = None,  # (N, H, W, C_out)
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """[lrelu]((conv3x3_same(x) + bias) [+ residual]); ``mxu_bf16`` rounds x
    and the weight to bf16 first."""
    if mxu_bf16:
        x, weight = round_bf16(x), round_bf16(weight)
    z = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1) + bias
    if residual is not None:
        z = z + residual
    return leaky_relu(z) if leaky else z


# k slot s of a bf16 k16 step -> its channel among the step's 16: a lane's
# four A values (slots 2t, 2t + 1, 2t + 8, 2t + 9) are channels 4t..4t + 3
BF16_SLOT_CHANNELS = tuple(4 * (s % 8 // 2) + 2 * (s // 8) + s % 2 for s in range(16))


def pack_conv_weight(weight: torch.Tensor, mxu_bf16: bool = False) -> torch.Tensor:
    """OIHW (C_out, C_in, 3, 3) -> flat [C_out/32][C_in][9][32] float32, the
    layout the 3xTF32 conv stages each 8-channel chunk's weights from. With
    ``mxu_bf16`` the bf16 route's: the weight rounded to bf16 (to nearest
    even) as a ``torch.bfloat16`` tensor [C_in/16][9][C_out/8][2][8][8], per
    16 input channels and tap the K-major core matrices [n/8][k/8][n%8][k%8]
    that its wgmma B descriptor reads, slot k holding channel
    ``BF16_SLOT_CHANNELS[k]`` of the 16 (C_in a multiple of 16)."""
    co, ci = weight.shape[:2]
    weight = weight.detach()
    if not mxu_bf16:
        return weight.reshape(co // 32, 32, ci, 9).permute(0, 2, 3, 1).reshape(-1)
    w = weight.to(torch.bfloat16).reshape(co // 8, 8, ci // 16, 16, 9)
    w = w[:, :, :, list(BF16_SLOT_CHANNELS)].reshape(co // 8, 8, ci // 16, 2, 8, 9)
    return w.permute(2, 5, 0, 3, 1, 4).reshape(-1)  # (c16, tap, n8, k8, n%8, k%8)


def conv3x3_fused(
    x: torch.Tensor,  # (N, H, W, C_in) float32, C_in in {64, 128}
    weight: torch.Tensor,  # (64, C_in, 3, 3)
    bias: torch.Tensor,  # (64,)
    leaky: bool = False,
    residual: Optional[torch.Tensor] = None,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """K10 (``csrc/conv3x3.cu``) on a CUDA tensor, the plain
    ``conv3x3_reference`` on a CPU tensor. Shapes the kernel does not take
    (C_in not in {64, 128}, C_out != 64) raise ``ValueError`` on either
    device. The kernel reads ``pack_conv_weight(weight, mxu_bf16)``, packed
    once per version of the weight. ``mxu_bf16``: bf16 multiplicands
    (module docstring)."""
    n, h, w, c_in = x.shape
    if c_in not in C_INS or tuple(weight.shape) != (C_OUT, c_in, 3, 3):
        raise ValueError(
            f"conv3x3_fused takes C_in in {C_INS} and a ({C_OUT}, C_in, 3, 3) "
            f"weight, got x {tuple(x.shape)} and weight {tuple(weight.shape)}"
        )

    def plain(x, weight, bias, residual, mxu_bf16=False):
        return conv3x3_reference(x, weight, bias, leaky, residual, mxu_bf16)

    if x.device.type == "cpu":
        if not mxu_bf16:
            return plain(x, weight, bias, residual)
        # the rounded plain version, differentiated as the float32 one
        return kernel_with_plain_grad(functools.partial(plain, mxu_bf16=True), plain,
                                      x, weight, bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused: unsupported device {x.device}")
    _kernels.check_tensor(x, "x", (n, h, w, c_in))
    _kernels.check_image_shape(n, h, w, max(c_in, C_OUT))
    w_packed = packed(pack_conv_weight, [weight], mxu_bf16)
    _kernels.check_tensor(w_packed, "packed weight", (C_OUT * c_in * 9,),
                          torch.bfloat16 if mxu_bf16 else torch.float32)
    _kernels.check_tensor(bias, "bias", (C_OUT,))
    if residual is not None:
        _kernels.check_tensor(residual, "residual", (n, h, w, C_OUT))

    def launch(x, weight, bias, residual):
        out = torch.empty((n, h, w, C_OUT), device=x.device)
        _kernels.launch_conv3x3_forward(x, w_packed, bias, residual, out, n, h, w, c_in,
                                        leaky, mxu_bf16)
        return out

    return kernel_with_plain_grad(launch, plain, x, weight, bias, residual)

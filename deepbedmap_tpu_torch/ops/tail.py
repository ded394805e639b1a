"""The generator tail: both deformable output layers, and the K2/K3 wrappers.

Counterpart of ``deepbedmap_tpu/ops/pallas_tail.py``. ``tail_reference`` is
the port of ``_tail_reference`` (offset conv -> masked-shift sampler ->
LeakyReLU -> offset conv -> projection-first sampler), the numerical oracle.
``fused_deform_tail`` is the port of ``fused_deform_tail``: on a CUDA tensor
it runs

1. offset conv 1 (``F.conv2d``);
2. K2 ``deform64_lrelu`` (``csrc/deform_tail.cu``): 64 -> 64 deformable conv,
   bias and LeakyReLU in one kernel;
3. offset conv 2 (``F.conv2d``);
4. the tap projection z_t = a5 . W2_t (a matmul, as JAX computes it outside
   Pallas);
5. K3 ``deform_zproj1`` (``csrc/deform_tail.cu``): the clamped bilinear
   samples of the nine tap fields, summed, plus the bias.

The TPU version tiles the image into halo'd lane frames and masks the emitted
halo by hand; here each kernel reads the whole NHWC image, so zero padding
outside the image needs no extra step. On a CPU tensor the K2/K3 wrappers use
their plain versions, so the same sequence runs on both devices. On a CUDA
tensor K2's and K3's backward is a kernel each (``ops.deform_conv.deform64``
/ ``deform_tap_fields``, in the device span ``tail.backward``) that computes
the gradient autograd of those plain versions gives, which is what JAX's
``pallas_tail.py:310-333`` differentiates (``_tail_reference``).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepbedmap_tpu_torch.ops.conv import conv_nhwc, leaky_relu, torch_dtype
from deepbedmap_tpu_torch.ops.deform_conv import (
    deform64,
    deform_conv_shifts,
    deform_conv_shifts_zproj,
    deform_tap_fields,
    sample_tap_fields,
    tap_projection,
)
from deepbedmap_tpu_torch.utils.profiling import device_span


def tail_reference(x, o1k, o1b, w1, b1, o2k, o2b, w2, b2, padding=1, clamp=2,
                   compute_dtype: Optional[str] = None):
    """Plain composition of the two deformable layers (OIHW weights, NHWC x).
    ``compute_dtype`` ('bfloat16') runs the two offset convs at that
    precision, their offsets returned in float32; x is cast to float32 for
    the samplers, which compute in float32 (JAX ``pallas_tail.py:100-148``)."""
    dt = torch_dtype(compute_dtype)
    off1 = conv_nhwc(x, o1k, o1b, 1, dt).float()
    a5 = leaky_relu(deform_conv_shifts(x.float(), off1, w1, b1, padding, clamp))
    off2 = conv_nhwc(a5, o2k, o2b, 1, dt).float()
    return deform_conv_shifts_zproj(a5, off2, w2, b2, padding, clamp)


def deform64_lrelu(
    x: torch.Tensor,  # (N, H, W, 64)
    offsets: torch.Tensor,  # (N, H, W, 18), [:9] dy, [9:] dx
    w1: torch.Tensor,  # (64, 64, 3, 3) OIHW
    b1: torch.Tensor,  # (64,)
    clamp: int = 2,
    w_packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """lrelu(deform_conv(x, offsets, w1) + b1): K2 on a CUDA tensor, the plain
    masked-shift version on a CPU tensor. ``w_packed`` is
    ``ops.deform_conv.pack_deform64_weight_tc(w1)``, cached by the caller."""
    if x.device.type == "cpu":
        return leaky_relu(deform_conv_shifts(x, offsets, w1, b1, 1, clamp))
    if x.device.type != "cuda":
        raise ValueError(f"deform64_lrelu: unsupported device {x.device}")
    return deform64(x, offsets, w1, b1, clamp, True, w_packed)


def deform_zproj1(
    z: torch.Tensor,  # (N, H, W, 9) tap fields
    offsets: torch.Tensor,  # (N, H, W, 18)
    b2: torch.Tensor,  # (1,)
    clamp: int = 2,
) -> torch.Tensor:
    """sum_t bilinear(z_t, p + tap_t + clamp(offset_t)) + b2 -> (N, H, W, 1):
    K3 on a CUDA tensor, the plain ``sample_tap_fields`` on a CPU tensor."""
    if z.device.type == "cpu":
        return sample_tap_fields(z[..., None], offsets, b2, 1, clamp)
    if z.device.type != "cuda":
        raise ValueError(f"deform_zproj1: unsupported device {z.device}")
    return deform_tap_fields(z, offsets, b2, clamp, "deform_zproj1")


def fused_deform_tail(
    x: torch.Tensor,  # (N, H, W, 64), the last upsample conv's activation
    o1k: torch.Tensor,  # (18, 64, 3, 3) first offset conv
    o1b: torch.Tensor,  # (18,)
    w1: torch.Tensor,  # (64, 64, 3, 3) deform64 kernel
    b1: torch.Tensor,  # (64,)
    o2k: torch.Tensor,  # (18, 64, 3, 3) second offset conv
    o2b: torch.Tensor,  # (18,)
    w2: torch.Tensor,  # (1, 64, 3, 3) final deform kernel
    b2: torch.Tensor,  # (1,)
    clamp: int = 2,
    w1_packed: Optional[torch.Tensor] = None,
    compute_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Both deformable output layers (module docstring) -> (N, H, W, 1).
    ``compute_dtype`` ('bfloat16') runs the two offset convs at that
    precision and returns their offsets in float32, as ``tail_reference``;
    x is cast to float32 before K2, and K2, the projection and K3 compute
    in float32. Device spans (``utils.profiling``): ``tail.offset_convs``
    (both offset convs and their float32 copies, twice a call),
    ``tail.deform64`` (K2, once a call), ``tail.projection``, ``tail.zproj``
    (K3)."""
    if w2.shape[0] != 1:
        raise ValueError("the fused tail needs a single output channel")
    dt = torch_dtype(compute_dtype)
    dev = x.device
    with device_span("tail.offset_convs", dev):
        off1 = conv_nhwc(x, o1k, o1b, 1, dt).float().contiguous()
        x32 = x.float().contiguous()
    with device_span("tail.deform64", dev):
        a5 = deform64_lrelu(x32, off1, w1, b1, clamp, w1_packed)
    with device_span("tail.offset_convs", dev):
        off2 = conv_nhwc(a5, o2k, o2b, 1, dt).float().contiguous()
    with device_span("tail.projection", dev):
        z = tap_projection(a5, w2)
    with device_span("tail.zproj", dev):
        return deform_zproj1(z, off2, b2, clamp)

"""Deformable convolution v1: the masked-shift plain versions of K2, K3, K7
and K8, the exact gather sampler, and the layer-level ``deform_conv2d`` with
JAX's ``method`` names and the K7 / K8 wrappers.

Counterpart of ``deepbedmap_tpu/ops/deform_conv.py`` (``_deform_conv_shifts``,
``_deform_conv_shifts_zproj``, ``_deform_conv_gather``, ``deform_conv2d``).
``deform_conv_gather`` samples without a clamp, a corner outside the padded
input counting as zero. The masked-shift samplers clamp offsets to
[-clamp, clamp] and the bilinear sample decomposes over the (2*clamp+2)^2
integer shifts as sliced reads weighted by per-position masks:

    y_t(p) = sum_{sy,sx} wy[sy](p) * wx[sx](p) * x(p + tap_t + (sy, sx))
    wy[s]  = (1-fy) * [floor(dy) == s] + fy * [floor(dy) == s-1]

Offset layout as in the JAX package: ``offsets[..., :K]`` are row (y)
displacements and ``offsets[..., K:]`` column (x) displacements, taps
row-major over the kernel grid. Zero padding outside the image. Weights are
OIHW ``(C_out, C_in, kh, kw)``; activations NHWC.

The CUDA kernels (``csrc/deform_tail.cu``) take the 64-channel deformable
conv (K2 with its LeakyReLU, K7 without; a 3xTF32 implicit GEMM on the tensor
cores, its weights split by ``pack_deform64_weight_tc``) and the
nine-tap-field sampler (K3, and K8 behind a projection); ``deform64`` and
``deform_tap_fields`` here are their launchers for CUDA tensors, shared by
``deform_conv2d`` and the fused tail (``ops.tail``). Both kernels stage a
window sized for a clamp of at most ``WINDOW_MAX_CLAMP`` px, and their
launchers refuse any other (``check_window_clamp``); the plain versions take
any clamp. ``deform_conv2d_zform`` is the port of the JAX
``deform_conv2d_pallas_zform``: the same deformable conv with the tap
projection inside the kernel (K9, ``csrc/deform_zform.cu``: for C_out 64
and 16 the projection on the tensor cores with K2's split weights, for
C_out 1 on the fp32 units). No model path takes it, as in JAX; it is a
public function of its own.

Gradients: on a CUDA tensor ``deform64`` (K2, K7) and ``deform_tap_fields``
(K3, K8) are ``torch.autograd.Function``s whose backward is a kernel of
``csrc/deform_tail.cu`` (``deform64_backward``, ``tap_fields_backward``;
launches counted as ``deform64_bwd`` / ``deform_conv_bwd`` and
``deform_zproj1_bwd`` / ``deform_conv_zproj1_bwd``, each inside the device
span ``tail.backward``). They compute exactly the gradient that autograd of
``deform_conv_shifts`` [+ LeakyReLU] / ``sample_tap_fields`` gives, which is
what JAX's ``deform_conv.py:_pallas_bwd`` and ``pallas_tail.py:_fused_bwd``
differentiate: the offsets' gradient passes where -clamp <= d <= clamp, the
bilinear fraction's derivative is 1 (so at an integer offset the sample's
derivative is x(iy + 1) - x(iy)), zero padding takes no gradient, and K2's
LeakyReLU passes 1 where its saved output is >= 0, else 0.2.
``deform64_backward_plain`` and ``tap_fields_backward_plain`` write the
kernels' closed form (the samples' corners gathered, dx and dz gathered over
the masked shifts read backwards) in PyTorch. ``deform_conv2d_zform`` (K9)
has no VJP in JAX and raises ``ValueError`` here when a gradient is asked
of it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deepbedmap_tpu_torch.ops import _kernels
from deepbedmap_tpu_torch.ops._autograd import needs_grad, refuse_grad
from deepbedmap_tpu_torch.utils.profiling import device_span

_TAPS = 9
_C = 64
WINDOW_MAX_CLAMP = 2  # the reach K2's, K3's and K9's shared-memory windows cover


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
    """Deformable conv: sample each tap by masked shifts, then contract it.
    Computes in float32, or in float64 for a float64 ``x``."""
    n, h, w, c_in = x.shape
    c_out, _, kh, kw = weight.shape
    k = kh * kw
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    big = padding + clamp + 1  # tap shift + max integer shift + corner
    x_big = _pad_hw(x.to(dt), big)
    rhs = weight.to(dt).permute(2, 3, 1, 0).reshape(k, c_in, c_out)
    acc = x.new_zeros((n * h * w, c_out), dtype=dt)
    shifts = range(-clamp, clamp + 2)
    for t in range(k):
        u, v = divmod(t, kw)
        wy, wx = _shift_weights(offsets[..., t].to(dt), offsets[..., k + t].to(dt), clamp)
        y_t = x.new_zeros((n, h, w, c_in), dtype=dt)
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
    The plain version of K3 (``deform_zproj1``) when C == 1. Computes in
    float32, or in float64 for a float64 ``z``."""
    n, h, w, k, c = z.shape
    dt = torch.float64 if z.dtype == torch.float64 else torch.float32
    big = padding + clamp + 1
    z_big = _pad_hw(z.permute(3, 0, 1, 2, 4).to(dt), big)  # (K, N, H', W', C)
    acc = z.new_zeros((n, h, w, c), dtype=dt)
    shifts = range(-clamp, clamp + 2)
    for t in range(k):
        u, v = divmod(t, kw)
        wy, wx = _shift_weights(offsets[..., t].to(dt), offsets[..., k + t].to(dt), clamp)
        for sy in shifts:
            row0 = big + u - padding + sy
            for sx in shifts:
                col0 = big + v - padding + sx
                patch = z_big[t, :, row0 : row0 + h, col0 : col0 + w, :]
                acc = acc + (wy[sy] * wx[sx])[..., None] * patch
    return acc if bias is None else acc + bias


def _tap_corners(a_big, offsets, t: int, clamp: int, big: int):
    """Tap t's bilinear samples of the zero-padded (N, H + 2 big, W + 2 big,
    ...) ``a_big`` (3x3 taps, padding 1): its four corners (the base corner
    floor(d) and its right, lower and lower-right neighbours, each
    (N, H, W, ...)), the fractions fy, fx and where the clamp passes the
    offsets' gradient (-clamp <= d <= clamp, ``torch.clamp``'s backward)."""
    n, h, w = offsets.shape[:3]
    u, v = divmod(t, 3)
    raw_y, raw_x = offsets[..., t].to(a_big.dtype), offsets[..., _TAPS + t].to(a_big.dtype)
    dy, dx = raw_y.clamp(-clamp, clamp), raw_x.clamp(-clamp, clamp)
    iy, ix = torch.floor(dy), torch.floor(dx)
    dev = offsets.device
    rows = torch.arange(h, device=dev)[None, :, None] + (big + u - 1) + iy.long()
    cols = torch.arange(w, device=dev)[None, None, :] + (big + v - 1) + ix.long()
    nn_ = torch.arange(n, device=dev)[:, None, None]
    corners = [a_big[nn_, rows + a, cols + b] for a in (0, 1) for b in (0, 1)]
    passes = ((raw_y >= -clamp) & (raw_y <= clamp), (raw_x >= -clamp) & (raw_x <= clamp))
    return corners, dy - iy, dx - ix, passes


def _shifted_gather(q, offsets, t: int, clamp: int):
    """sum over the integer shifts (sy, sx) of the masked-shift samplers, at
    each input pixel r, of wy[sy] wx[sx] q at the output pixel r - tap_t -
    (sy, sx): the samplers' masked shifts read backwards, which carries the
    gradient ``q`` (N, H, W, C) of tap t's samples to their input."""
    n, h, w = q.shape[:3]
    u, v = divmod(t, 3)
    big = clamp + 2
    wy, wx = _shift_weights(offsets[..., t].to(q.dtype), offsets[..., _TAPS + t].to(q.dtype),
                            clamp)
    out = torch.zeros_like(q)
    for sy in wy:
        for sx in wx:
            q_big = _pad_hw((wy[sy] * wx[sx])[..., None] * q, big)
            r0, c0 = big - (u - 1) - sy, big - (v - 1) - sx
            out = out + q_big[:, r0:r0 + h, c0:c0 + w]
    return out


def deform64_backward_plain(
    x: torch.Tensor,  # (N, H, W, C_in)
    offsets: torch.Tensor,  # (N, H, W, 18)
    weight: torch.Tensor,  # (C_out, C_in, 3, 3) OIHW
    out: torch.Tensor,  # (N, H, W, C_out): the forward's output
    grad: torch.Tensor,  # (N, H, W, C_out): its gradient
    clamp: int = 2,
    lrelu: bool = True,
):
    """The plain version of the backward kernel of K2 (``lrelu``) and K7:
    the gradient of ``[leaky_relu](deform_conv_shifts(x, offsets, weight,
    bias, 1, clamp))`` whose output is ``out``, with upstream ``grad``, in
    the kernel's closed form -> (dx, d_offsets, d_weight (OIHW), d_bias), in
    x's dtype (float32 or float64). The LeakyReLU passes ``grad`` where
    ``out >= 0`` and 0.2 of it elsewhere; per tap t, with S_t the samples and
    W_t the (C_out, C_in) weights: dS_t = g' W_t, dW_t = S_t^T g', the
    offsets' gradient dS_t against the corners' differences, dx the
    shifted gather of dS_t (``_shifted_gather``)."""
    n, h, w, c_in = x.shape
    c_out = weight.shape[0]
    dt = x.dtype
    g = grad.to(dt)
    if lrelu:
        g = torch.where(out >= 0, g, 0.2 * g)
    g2 = g.reshape(-1, c_out)
    big = clamp + 2
    x_big = _pad_hw(x, big)
    rhs = weight.to(dt).permute(2, 3, 1, 0).reshape(_TAPS, c_in, c_out)
    dx = torch.zeros_like(x)
    d_off = x.new_zeros((n, h, w, 2 * _TAPS))
    d_w = torch.zeros_like(rhs)
    for t in range(_TAPS):
        (c00, c01, c10, c11), fy, fx, (pass_y, pass_x) = _tap_corners(x_big, offsets, t,
                                                                      clamp, big)
        fy, fx = fy[..., None], fx[..., None]
        s_t = (1 - fy) * (1 - fx) * c00 + (1 - fy) * fx * c01 + fy * (1 - fx) * c10 \
            + fy * fx * c11
        ds_t = (g2 @ rhs[t].T).reshape(n, h, w, c_in)
        d_w[t] = s_t.reshape(-1, c_in).T @ g2
        d_y = (ds_t * ((1 - fx) * (c10 - c00) + fx * (c11 - c01))).sum(-1)
        d_x = (ds_t * ((1 - fy) * (c01 - c00) + fy * (c11 - c10))).sum(-1)
        d_off[..., t] = torch.where(pass_y, d_y, 0.0)
        d_off[..., _TAPS + t] = torch.where(pass_x, d_x, 0.0)
        dx = dx + _shifted_gather(ds_t, offsets, t, clamp)
    d_weight = d_w.reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    return dx, d_off, d_weight, g2.sum(0)


def tap_fields_backward_plain(
    z: torch.Tensor,  # (N, H, W, 9) tap fields
    offsets: torch.Tensor,  # (N, H, W, 18)
    grad: torch.Tensor,  # (N, H, W, 1): the gradient of K3's output
    clamp: int = 2,
):
    """The plain version of the backward kernel of K3 / K8: the gradient of
    ``sample_tap_fields(z[..., None], offsets, bias, 1, clamp)`` with
    upstream ``grad``, in the kernel's closed form -> (dz, d_offsets,
    d_bias (1,)), in z's dtype (float32 or float64)."""
    n, h, w, _ = z.shape
    dt = z.dtype
    g = grad.to(dt).reshape(n, h, w)
    big = clamp + 2
    z_big = _pad_hw(z, big)
    dz = torch.zeros_like(z)
    d_off = z.new_zeros((n, h, w, 2 * _TAPS))
    for t in range(_TAPS):
        (z00, z01, z10, z11), fy, fx, (pass_y, pass_x) = _tap_corners(z_big[..., t], offsets,
                                                                      t, clamp, big)
        d_off[..., t] = torch.where(pass_y, g * ((1 - fx) * (z10 - z00) + fx * (z11 - z01)), 0.0)
        d_off[..., _TAPS + t] = torch.where(
            pass_x, g * ((1 - fy) * (z01 - z00) + fy * (z11 - z10)), 0.0)
        dz[..., t] = _shifted_gather(g[..., None], offsets, t, clamp)[..., 0]
    return dz, d_off, g.sum().reshape(1)


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


def _bilinear_gather(
    x_pad: torch.Tensor,  # (N, HP, WP, C) zero-padded input
    rows: torch.Tensor,  # (N, H, W) fractional row coordinates into x_pad
    cols: torch.Tensor,  # (N, H, W) fractional column coordinates into x_pad
) -> torch.Tensor:
    """x_pad sampled bilinearly at (rows, cols) -> (N, H, W, C). A corner
    outside x_pad counts as zero: its validity is tested before its index is
    clipped, so an off-grid tap contributes exactly nothing."""
    n, hp, wp, c = x_pad.shape
    r0, c0 = torch.floor(rows), torch.floor(cols)
    fr, fc = rows - r0, cols - c0
    r0, c0 = r0.long(), c0.long()
    x_flat = x_pad.reshape(n, hp * wp, c)

    def corner(ri, ci):
        valid = (ri >= 0) & (ri < hp) & (ci >= 0) & (ci < wp)
        flat = ri.clamp(0, hp - 1) * wp + ci.clamp(0, wp - 1)
        idx = flat.reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(x_flat, 1, idx).reshape(ri.shape + (c,)) * valid[..., None]

    return (corner(r0, c0) * ((1.0 - fr) * (1.0 - fc))[..., None]
            + corner(r0, c0 + 1) * ((1.0 - fr) * fc)[..., None]
            + corner(r0 + 1, c0) * (fr * (1.0 - fc))[..., None]
            + corner(r0 + 1, c0 + 1) * (fr * fc)[..., None])


def deform_conv_gather(
    x: torch.Tensor,  # (N, H, W, C_in)
    offsets: torch.Tensor,  # (N, H, W, 2K)
    weight: torch.Tensor,  # (C_out, C_in, kh, kw)
    bias: Optional[torch.Tensor],
    padding: int = 1,
) -> torch.Tensor:
    """The exact deformable conv, offsets unclamped (Chainer's
    ``deformable_convolution_2d_sampler`` semantics; JAX's
    ``_deform_conv_gather``): each tap samples the zero-padded input at
    p + (u, v) + offset, then one matmul contracts it. Computes in float32,
    or in float64 for a float64 ``x``."""
    n, h, w, c_in = x.shape
    c_out, _, kh, kw = weight.shape
    k = kh * kw
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    x_pad = _pad_hw(x.to(dt), padding)
    ii = torch.arange(h, dtype=dt, device=x.device)[None, :, None]
    jj = torch.arange(w, dtype=dt, device=x.device)[None, None, :]
    rhs = weight.to(dt).permute(2, 3, 1, 0).reshape(k, c_in, c_out)
    acc = x.new_zeros((n * h * w, c_out), dtype=dt)
    for t in range(k):
        u, v = divmod(t, kw)
        rows = ii + u + offsets[..., t].to(dt)
        cols = jj + v + offsets[..., k + t].to(dt)
        acc = acc + _bilinear_gather(x_pad, rows, cols).reshape(n * h * w, c_in) @ rhs[t]
    out = acc.reshape(n, h, w, c_out)
    return out if bias is None else out + bias


def tf32_split(a: torch.Tensor):
    """(hi, lo) with a = hi + lo to 2^-22 of |a|, both TF32 (10 mantissa
    bits): hi is ``cvt.rna.tf32.f32`` of a (round to nearest, ties away from
    zero), lo the same of a - hi. float32 in, float32 out."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a.float())
    return hi, rna(a.float() - hi)


def pack_deform64_weight_tc(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (C_out, C_in, 3, 3), C_out a multiple of 8 -> the B operand of
    the tensor-core deformable convs, flat (9 * 2 * C16 * C_out,) with C16 =
    C_in rounded up to 16 (zero weights past C_in): per tap, hi then lo
    (``tf32_split``), each the C16 x C_out (channel, output) matrix as
    C16 / 8 k8 steps of wgmma's K-major core matrices,
    [step][n / 8][k / 4][n % 8][k % 4]. Step s = 2 b + e reads window block b
    (channels 16 b .. 16 b + 15); its slot k takes channel
    16 b + 4 (k % 4) + 2 e + k // 4, the order in which a lane reads its A
    values from the window. K2 and K7 (``csrc/deform_tail.cu``) read it at
    64 -> 64, K9 (``csrc/deform_zform.cu``) at C_out 64 and 16."""
    c_out, c_in = weight.shape[:2]
    c16 = -(-c_in // 16) * 16
    steps = c16 // 8
    rhs = weight.detach().float().permute(2, 3, 1, 0).reshape(_TAPS, c_in, c_out)
    rhs = F.pad(rhs, (0, 0, 0, c16 - c_in))
    s = torch.arange(steps, device=rhs.device)[:, None]
    k = torch.arange(8, device=rhs.device)[None, :]
    channel = 16 * (s // 2) + 4 * (k % 4) + 2 * (s % 2) + k // 4  # (step, slot)
    b = rhs[:, channel, :]  # (tap, step, slot, n)
    b = b.reshape(_TAPS, steps, 2, 4, c_out // 8, 8).permute(0, 1, 4, 2, 5, 3)
    return torch.stack(tf32_split(b), dim=1).reshape(-1).contiguous()


def window_covers(clamp) -> bool:
    """Whether the CUDA kernels' windows, which reach ``WINDOW_MAX_CLAMP``
    px, cover ``clamp``: an integer in [0, WINDOW_MAX_CLAMP]."""
    return not isinstance(clamp, bool) and int(clamp) == clamp \
        and 0 <= clamp <= WINDOW_MAX_CLAMP


def check_window_clamp(clamp) -> None:
    """Raise ``ValueError`` for a clamp the kernels' windows do not cover
    (``window_covers``)."""
    if not window_covers(clamp):
        raise ValueError(
            f"the deformable-conv kernels take an integer clamp in [0, "
            f"{WINDOW_MAX_CLAMP}], got {clamp!r}")


def _launch_deform64(x, offsets, w_packed, bias, clamp, lrelu) -> torch.Tensor:
    out = torch.empty_like(x)
    n, h, w, _ = x.shape
    _kernels.launch_deform64(x, offsets, w_packed, bias, out, n, h, w, clamp, lrelu)
    return out


def deform64_backward(x, offsets, weight, out, grad, clamp: int, lrelu: bool):
    """The backward kernel of K2 (``lrelu``) / K7 on the card: the gradient
    of ``deform64``'s output ``out`` with upstream ``grad`` -> (dx,
    d_offsets, d_weight (OIHW), d_bias), float32; its plain version is
    ``deform64_backward_plain``. ``csrc/deform_tail.cu`` splits dW's sum
    over pixels into one partial per block (``blocks`` a tap, two per SM
    over the nine taps) and adds them in order: no atomics."""
    check_window_clamp(clamp)
    n, h, w, _ = x.shape
    grad = grad.contiguous()
    weight = weight.detach().float().contiguous()
    for t, name, shape in ((x, "x", (n, h, w, _C)), (offsets, "offsets", (n, h, w, 2 * _TAPS)),
                           (out, "output", (n, h, w, _C)), (grad, "gradient", (n, h, w, _C)),
                           (weight, "weight", (_C, _C, 3, 3))):
        _kernels.check_tensor(t, name, shape)
    tiles = n * -(-h // 8) * -(-w // 8)  # the kernel's 8 x 8 tiles
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(tiles, 2 * sms // _TAPS))
    dx, d_off, d_w = torch.empty_like(x), torch.empty_like(offsets), torch.empty_like(weight)
    d_b = torch.empty(_C, device=x.device)
    ds = torch.empty((n, h, w, _TAPS, _C), device=x.device)  # dS_t for the dx gather
    part = torch.empty(blocks * (_TAPS * _C * _C + _C), device=x.device)
    _kernels.launch_deform64_bwd(x, offsets, weight, out, grad, dx, d_off, d_w, d_b, ds, part,
                                 n, h, w, clamp, lrelu, blocks)
    return dx, d_off, d_w, d_b


class _Deform64(torch.autograd.Function):
    """K2 / K7 forward, its backward kernel ``deform64_backward``."""

    @staticmethod
    def forward(ctx, x, offsets, weight, bias, w_packed, clamp, lrelu):
        out = _launch_deform64(x, offsets, w_packed, bias, clamp, lrelu)
        ctx.save_for_backward(x, offsets, weight, out)
        ctx.clamp, ctx.lrelu = clamp, lrelu
        return out

    @staticmethod
    def backward(ctx, grad):
        x, offsets, weight, out = ctx.saved_tensors
        with device_span("tail.backward", grad.device, range=True):
            dx, d_off, d_w, d_b = deform64_backward(x, offsets, weight, out, grad, ctx.clamp,
                                                    ctx.lrelu)
        return dx, d_off, d_w.to(weight.dtype), d_b, None, None, None


def deform64(
    x: torch.Tensor,  # (N, H, W, 64) on the card
    offsets: torch.Tensor,  # (N, H, W, 18)
    weight: torch.Tensor,  # (64, 64, 3, 3) OIHW
    bias: torch.Tensor,  # (64,)
    clamp: int,
    lrelu: bool,
    w_packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[lrelu](deform_conv(x) + bias) on the card: K2 with ``lrelu``, K7
    without. ``w_packed`` is ``pack_deform64_weight_tc(weight)``. When a
    gradient is needed the output's backward is ``deform64_backward``."""
    check_window_clamp(clamp)
    n, h, w, _ = x.shape
    _kernels.check_tensor(x, "x", (n, h, w, _C))
    _kernels.check_tensor(offsets, "offsets", (n, h, w, 2 * _TAPS))
    _kernels.check_image_shape(n, h, w, _C)
    if w_packed is None:
        with torch.no_grad():
            w_packed = pack_deform64_weight_tc(weight)
    _kernels.check_tensor(w_packed, "packed weight", (_TAPS * 2 * _C * _C,))
    _kernels.check_tensor(bias, "bias", (_C,))
    if needs_grad(x, offsets, weight, bias):
        return _Deform64.apply(x, offsets, weight, bias, w_packed, clamp, lrelu)
    return _launch_deform64(x, offsets, w_packed, bias, clamp, lrelu)


def _launch_tap_fields(z, offsets, bias, clamp, name) -> torch.Tensor:
    n, h, w, _ = z.shape
    out = torch.empty((n, h, w, 1), device=z.device)
    _kernels.launch_deform_zproj1(z, offsets, bias, out, n, h, w, clamp, name)
    return out


def tap_fields_backward(z, offsets, grad, clamp: int, name: str = "deform_zproj1"):
    """The backward kernel of K3 / K8 on the card, counted as ``name +
    '_bwd'``: the gradient of ``deform_tap_fields``' output with upstream
    ``grad`` -> (dz, d_offsets, d_bias (1,)), float32; its plain version is
    ``tap_fields_backward_plain``."""
    check_window_clamp(clamp)
    n, h, w, _ = z.shape
    grad = grad.contiguous()
    for t, label, shape in ((z, "z", (n, h, w, _TAPS)), (offsets, "offsets", (n, h, w, 2 * _TAPS)),
                            (grad, "gradient", (n, h, w, 1))):
        _kernels.check_tensor(t, label, shape)
    dz, d_off = torch.empty_like(z), torch.empty_like(offsets)
    d_b = torch.empty(1, device=z.device)
    part = torch.empty(-(-w // 32) * -(-h // 8) * n, device=z.device)  # a sum per 8 x 32 tile
    _kernels.launch_deform_zproj1_bwd(z, offsets, grad, dz, d_off, d_b, part, n, h, w, clamp,
                                      name)
    return dz, d_off, d_b


class _TapFields(torch.autograd.Function):
    """K3 / K8 forward, its backward kernel ``tap_fields_backward``."""

    @staticmethod
    def forward(ctx, z, offsets, bias, clamp, name):
        out = _launch_tap_fields(z, offsets, bias, clamp, name)
        ctx.save_for_backward(z, offsets)
        ctx.clamp, ctx.name = clamp, name
        return out

    @staticmethod
    def backward(ctx, grad):
        z, offsets = ctx.saved_tensors
        with device_span("tail.backward", grad.device, range=True):
            dz, d_off, d_b = tap_fields_backward(z, offsets, grad, ctx.clamp, ctx.name)
        return dz, d_off, d_b, None, None


def deform_tap_fields(
    z: torch.Tensor,  # (N, H, W, 9) tap fields on the card
    offsets: torch.Tensor,  # (N, H, W, 18)
    bias: torch.Tensor,  # (1,)
    clamp: int,
    name: str,
) -> torch.Tensor:
    """``sample_tap_fields`` of one-channel fields on the card (K3's kernel),
    its launches counted under ``name`` (K3 or K8) -> (N, H, W, 1). When a
    gradient is needed the output's backward is ``tap_fields_backward``."""
    check_window_clamp(clamp)
    n, h, w, _ = z.shape
    _kernels.check_tensor(z, "z", (n, h, w, _TAPS))
    _kernels.check_tensor(offsets, "offsets", (n, h, w, 2 * _TAPS))
    _kernels.check_image_shape(n, h, w, 2 * _TAPS)
    _kernels.check_tensor(bias, "bias", (1,))
    if needs_grad(z, offsets, bias):
        return _TapFields.apply(z, offsets, bias, clamp, name)
    return _launch_tap_fields(z, offsets, bias, clamp, name)


def tap_projection(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """z_t = x . W[0, :, t] for a one-output-channel OIHW weight -> the nine
    tap fields (N, H, W, 9), as JAX computes them outside Pallas."""
    return (x @ weight[0].reshape(weight.shape[1], _TAPS)).contiguous()


METHODS = ("auto", "pallas", "zproj", "shifts", "gather")  # JAX's names


def _kernel_shape(x_shape, weight_shape, padding: int) -> bool:
    """A 3x3 kernel, padding 1, 64 input channels and 1 or 64 outputs."""
    c_out, c_in, kh, kw = weight_shape
    return padding == 1 and (kh, kw) == (3, 3) and c_in == _C and x_shape[-1] == _C \
        and c_out in (1, _C)


def choose_method(device_type: str, x_shape, weight_shape, padding: int, clamp) -> str:
    """What ``deform_conv2d(method='auto')`` runs, by shape and clamp alone:
    on a CUDA tensor ``'pallas'`` (the kernels) for every layer K7 / K8 take
    (3x3, padding 1, 64 input channels, 1 or 64 outputs, a clamp their
    windows cover: ``window_covers``); every other layer takes JAX's rule
    off the TPU (``deepbedmap_tpu/ops/deform_conv.py``), ``'zproj'`` for an
    image of at least 256^2 px whose layer contracts channels (C_out * 4 <=
    C_in), else ``'shifts'``. So ``'auto'`` sends what the kernels do not
    take to a plain sampler, as JAX's ``'auto'`` does; ``'pallas'`` refuses
    it."""
    if device_type == "cuda" and _kernel_shape(x_shape, weight_shape, padding) \
            and window_covers(clamp):
        return "pallas"
    c_out, c_in = weight_shape[:2]
    large = x_shape[1] * x_shape[2] >= 256 * 256
    return "zproj" if large and c_out * 4 <= c_in else "shifts"


def deform_conv2d(
    x: torch.Tensor,  # (N, H, W, C_in), or (N, H, C_in, W) with in_hcw
    offsets: torch.Tensor,  # (N, H, W, 2K), [:K] dy, [K:] dx; (N, H, 2K, W) with in_hcw
    weight: torch.Tensor,  # (C_out, C_in, kh, kw) OIHW
    bias: Optional[torch.Tensor] = None,  # (C_out,) or None
    padding: int = 1,
    clamp: int = 2,
    w_packed: Optional[torch.Tensor] = None,
    method: str = "auto",
    in_hcw: bool = False,
    out_hcw: bool = False,
) -> torch.Tensor:
    """One deformable conv layer, the JAX ``deform_conv2d`` with its
    ``method`` names:

    - ``'pallas'``: the kernels. On a CUDA tensor K7 (``deform_conv``) for
      C_out = 64, and for C_out = 1 the tap projection (a matmul) followed by
      K8 (``deform_conv_zproj1``, K3's kernel); on a CPU tensor their plain
      versions ``deform_conv_shifts`` / ``deform_conv_shifts_zproj``. Shapes
      the kernels do not take raise ``ValueError`` on either device: padding
      != 1, a kernel that is not 3x3, C_in != 64, C_out not in {1, 64}; on a
      CUDA tensor so does a clamp the kernels' windows do not cover
      (``check_window_clamp``). ``w_packed`` is
      ``pack_deform64_weight_tc(weight)`` for C_out = 64, cached by the
      caller.
    - ``'shifts'``, ``'zproj'``: the plain masked-shift samplers
      ``deform_conv_shifts`` / ``deform_conv_shifts_zproj``, any shape.
    - ``'gather'``: ``deform_conv_gather``, the exact sampler without a
      clamp, any shape.
    - ``'auto'``: ``choose_method``, the kernels on a CUDA tensor whose
      layer and clamp they take, JAX's rule off the TPU everywhere else.

    ``in_hcw`` / ``out_hcw``: the channels-before-width layout (N, H, C, W)
    of ``x`` and ``offsets`` / of the output, for every method. The kernels
    take NHWC: ``x`` and ``offsets`` are permuted back and made contiguous,
    which copies only where their memory really is (N, H, C, W) (a permuted
    view of NHWC memory, as ``models.blocks.ConvHCW`` returns, costs
    nothing), and the output is returned as a permuted view.

    ``bias`` None adds nothing. Another method raises ``ValueError``."""
    if method not in METHODS:
        raise ValueError(f"unknown deform_conv2d method {method!r}")
    if in_hcw:
        x = x.permute(0, 1, 3, 2).contiguous()
        offsets = offsets.permute(0, 1, 3, 2).contiguous()
    out = _deform_conv2d_nhwc(x, offsets, weight, bias, padding, clamp, w_packed, method)
    return out.permute(0, 1, 3, 2) if out_hcw else out


def _deform_conv2d_nhwc(x, offsets, weight, bias, padding, clamp, w_packed,
                        method) -> torch.Tensor:
    """``deform_conv2d`` on NHWC tensors."""
    c_out = weight.shape[0]
    if method == "auto":
        method = choose_method(x.device.type, x.shape, weight.shape, padding, clamp)
    if method == "shifts":
        return deform_conv_shifts(x, offsets, weight, bias, padding, clamp)
    if method == "zproj":
        return deform_conv_shifts_zproj(x, offsets, weight, bias, padding, clamp)
    if method == "gather":
        return deform_conv_gather(x, offsets, weight, bias, padding)
    if not _kernel_shape(x.shape, weight.shape, padding):
        raise ValueError(
            "deform_conv2d(method='pallas') takes padding 1, a 3x3 kernel, 64 input "
            f"channels and 1 or 64 output channels; got padding {padding}, weight "
            f"{tuple(weight.shape)}, x {tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        plain = deform_conv_shifts_zproj if c_out == 1 else deform_conv_shifts
        return plain(x, offsets, weight, bias, padding, clamp)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d: unsupported device {x.device}")
    if bias is None:
        bias = torch.zeros(c_out, device=x.device)
    if c_out == 1:
        z = tap_projection(x, weight)
        return deform_tap_fields(z, offsets, bias, clamp, "deform_conv_zproj1")
    return deform64(x, offsets, weight, bias, clamp, False, w_packed)


ZFORM_C_OUTS = (1, 16, 64)  # output widths K9 is built for
ZFORM_MAX_C_IN = 64


def deform_conv2d_zform(
    x: torch.Tensor,  # (N, H, W, C_in)
    offsets: torch.Tensor,  # (N, H, W, 18), [:9] dy, [9:] dx
    weight: torch.Tensor,  # (C_out, C_in, 3, 3) OIHW
    bias: Optional[torch.Tensor],  # (C_out,) or None
    padding: int = 1,
    clamp: int = 2,
) -> torch.Tensor:
    """The deformable conv computed projection first inside one kernel (the
    JAX ``deform_conv2d_pallas_zform``): on a CUDA tensor K9
    (``csrc/deform_zform.cu``, its weights packed per call by
    ``pack_deform64_weight_tc`` for C_out 64 and 16, as the (C_in, 9) tap
    matrix for C_out 1), on a CPU tensor its plain version
    ``deform_conv_shifts_zproj``. Takes a 3x3 kernel, padding 1, C_in a
    multiple of 4 up to 64, C_out in {1, 16, 64} and an integer clamp in
    [0, 2]; anything else raises ``ValueError`` on either device, and so
    does a call that would need a gradient (JAX's kernel has no VJP)."""
    refuse_grad("deform_conv2d_zform", x, offsets, weight, bias)
    c_out, c_in, kh, kw = weight.shape
    n, h, w = x.shape[:3]
    if padding != 1 or (kh, kw) != (3, 3) or x.shape[-1] != c_in \
            or c_in % 4 or not 4 <= c_in <= ZFORM_MAX_C_IN or c_out not in ZFORM_C_OUTS \
            or int(clamp) != clamp or not 0 <= clamp <= WINDOW_MAX_CLAMP \
            or tuple(offsets.shape) != (n, h, w, 2 * _TAPS) \
            or (bias is not None and tuple(bias.shape) != (c_out,)):
        raise ValueError(
            "deform_conv2d_zform takes padding 1, a 3x3 kernel, C_in a multiple "
            f"of 4 up to {ZFORM_MAX_C_IN}, C_out in {ZFORM_C_OUTS}, an integer clamp in "
            f"[0, {WINDOW_MAX_CLAMP}] and (N, H, W, 18) offsets; got padding "
            f"{padding}, weight {tuple(weight.shape)}, x {tuple(x.shape)}, offsets "
            f"{tuple(offsets.shape)}, clamp {clamp}"
        )
    if x.device.type == "cpu":
        return deform_conv_shifts_zproj(x, offsets, weight, bias, padding, clamp)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d_zform: unsupported device {x.device}")
    _kernels.check_tensor(x, "x", (n, h, w, c_in))
    _kernels.check_tensor(offsets, "offsets", (n, h, w, 2 * _TAPS))
    _kernels.check_image_shape(n, h, w, max(c_in, 2 * _TAPS, c_out))
    if c_out == 1:
        w_packed = weight.detach()[0].reshape(c_in, _TAPS).contiguous()
        packed_shape = (c_in, _TAPS)
    else:
        w_packed = pack_deform64_weight_tc(weight)
        packed_shape = (_TAPS * 2 * (-(-c_in // 16) * 16) * c_out,)
    _kernels.check_tensor(w_packed, "packed weight", packed_shape)
    if bias is None:
        bias = torch.zeros(c_out, device=x.device)
    _kernels.check_tensor(bias, "bias", (c_out,))
    out = torch.empty((n, h, w, c_out), device=x.device)
    _kernels.launch_deform_zform(x, offsets, w_packed, bias, out, n, h, w, c_in,
                                 c_out, clamp)
    return out

"""PyTorch port: the deformable conv layer ``deform_conv2d`` (the plain
versions behind K7 and K8) against the JAX package's Pallas kernels
``deform_conv2d_pallas`` and ``deform_conv2d_pallas_zproj1`` (interpret mode)
and the JAX layer-level ``deform_conv2d``.

The CUDA kernels only run on the card (``chip_smoke.py``). K7 is K2's kernel
with its LeakyReLU switched off and K8 is K3's kernel behind the tap
projection; a numpy emulation of K7's clamped-corner algorithm is held against
the plain version here, as tests/test_torch_port_tail.py does for K2 and K3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from deepbedmap_tpu.ops.pallas_kernels import (
    deform_conv2d_pallas,
    deform_conv2d_pallas_zproj1,
)
from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d, pack_deform64_weight

C = 64


def _offsets(rs, shape):
    """std-1.5 offsets with some beyond the +/-2 clamp and some exact integers,
    so the clamp, every shift branch and floor() at an integer all run."""
    off = (rs.randn(*shape) * 1.5).astype(np.float32)
    flat = off.reshape(-1)
    idx = rs.choice(flat.size, size=flat.size // 10, replace=False)
    flat[idx] = rs.choice([-3.7, -2.0, -1.0, 0.0, 1.0, 2.0, 4.2], size=len(idx))
    return off


def _case(seed, shape, c_out):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    off = _offsets(rs, shape[:3] + (18,))
    w = (rs.randn(3, 3, C, c_out) * 0.05).astype(np.float32)  # HWIO
    b = (rs.randn(c_out) * 0.1).astype(np.float32)
    return x, off, w, b


def _port(x, off, w, b, clamp):
    return deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                         torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                         torch.from_numpy(b), 1, clamp).numpy()


@pytest.mark.parametrize("clamp", [1, 2])
@pytest.mark.parametrize("c_out", [64, 1])
@pytest.mark.parametrize("shape", [(1, 12, 20, C), (2, 9, 11, C)])
def test_deform_conv2d_matches_jax_pallas(shape, c_out, clamp):
    # fp32 on both sides, same masked-shift math in another summation order
    # -> rtol 1e-5, atol 1e-5, as tests/test_pallas.py holds the JAX kernels
    # to the shifts path; block_rows 8 gives the JAX kernels several row tiles
    x, off, w, b = _case(7 * c_out + clamp, shape, c_out)
    jargs = (jnp.asarray(x), jnp.asarray(off), jnp.asarray(w), jnp.asarray(b), 1, clamp)
    kernel = deform_conv2d_pallas_zproj1 if c_out == 1 else deform_conv2d_pallas
    jax_kernel = np.asarray(kernel(*jargs, block_rows=8, interpret=True))
    jax_layer = np.asarray(jax_deform_conv2d(*jargs[:5], method="shifts", clamp=clamp))
    ours = _port(x, off, w, b, clamp)
    assert ours.shape == shape[:3] + (c_out,)
    np.testing.assert_allclose(ours, jax_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, jax_layer, rtol=1e-5, atol=1e-5)


def test_k7_corner_algorithm_matches_plain_version():
    # float64 emulation of csrc/deform_tail.cu's deform64 kernel without the
    # LeakyReLU (K7) vs the fp32 plain version
    x, off, w, b = _case(3, (2, 6, 13, C), C)
    n, h, wd, _ = x.shape
    w_oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    w_packed = pack_deform64_weight(w_oihw).numpy().astype(np.float64)
    acc = np.zeros((n, h, wd, C))
    yy, xx = np.meshgrid(np.arange(h), np.arange(wd), indexing="ij")
    nn_ = np.broadcast_to(np.arange(n)[:, None, None], (n, h, wd))
    for t in range(9):
        dy, dx = np.clip(off[..., t], -2, 2), np.clip(off[..., 9 + t], -2, 2)
        iy, ix = np.floor(dy), np.floor(dx)
        sample = np.zeros((n, h, wd, C))
        for a, wy in ((0, 1 - (dy - iy)), (1, dy - iy)):
            for c, wx in ((0, 1 - (dx - ix)), (1, dx - ix)):
                r = yy + t // 3 - 1 + iy.astype(int) + a
                cc = xx + t % 3 - 1 + ix.astype(int) + c
                valid = (r >= 0) & (r < h) & (cc >= 0) & (cc < wd)
                corner = x[nn_, np.clip(r, 0, h - 1), np.clip(cc, 0, wd - 1)]
                sample += np.where(valid, wy * wx, 0.0)[..., None] * corner
        acc += sample @ w_packed[t * C : (t + 1) * C]
    np.testing.assert_allclose(acc + b, _port(x, off, w, b, 2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "x_shape,w_shape,padding",
    [
        ((1, 6, 6, 32), (64, 32, 3, 3), 1),  # C_in the kernels do not take
        ((1, 6, 6, 64), (64, 64, 5, 5), 1),  # not 3x3
        ((1, 6, 6, 64), (64, 64, 3, 3), 0),  # padding
        ((1, 6, 6, 64), (8, 64, 3, 3), 1),  # C_out neither 1 nor 64
    ],
)
def test_deform_conv2d_refuses_shapes_the_kernels_do_not_take(x_shape, w_shape, padding):
    k = w_shape[2] * w_shape[3]
    with pytest.raises(ValueError):
        deform_conv2d(torch.zeros(x_shape), torch.zeros(x_shape[:3] + (2 * k,)),
                      torch.zeros(w_shape), torch.zeros(w_shape[0]), padding)

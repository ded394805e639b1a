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
from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d

C = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    w_packed = w.reshape(9 * C, C).astype(np.float64)  # HWIO: row t * C + c_in
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
    # method 'pallas' names the kernels, which take only these shapes, on
    # either device; the plain methods take them (below)
    k = w_shape[2] * w_shape[3]
    with pytest.raises(ValueError):
        deform_conv2d(torch.zeros(x_shape), torch.zeros(x_shape[:3] + (2 * k,)),
                      torch.zeros(w_shape), torch.zeros(w_shape[0]), padding,
                      method="pallas")


def _any_case(seed, shape, c_out, spread):
    """(x, offsets, HWIO weight, bias) of any C_in -> C_out; offsets of std
    ``spread`` px."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    off = (rs.randn(*shape[:3], 18) * spread).astype(np.float32)
    w = (rs.randn(3, 3, shape[-1], c_out) * 0.05).astype(np.float32)
    b = (rs.randn(c_out) * 0.1).astype(np.float32)
    return x, off, w, b


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("method", ["shifts", "zproj", "gather"])
@pytest.mark.parametrize("shape,c_out", [((1, 9, 11, C), C), ((1, 9, 13, 8), 16)])
def test_deform_conv2d_methods_match_jax(shape, c_out, method, with_bias):
    # each plain method against the JAX method of the same name, on a shape
    # the kernels take and on one they do not; fp32 on both sides, the same
    # sampling in another summation order -> 1e-5. 'gather' gets offsets of
    # std 3 px, many beyond +/-2 and some past the padded image, which only
    # the unclamped sampler reaches
    spread = 3.0 if method == "gather" else 1.5
    x, off, w, b = _any_case(41, shape, c_out, spread)
    if method == "gather":
        assert np.abs(off).max() > 6.0
    jb = jnp.asarray(b) if with_bias else None
    want = np.asarray(jax_deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
                                        jb, 1, method=method, clamp=2))
    got = deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(b) if with_bias else None, 1, 2,
                        method=method).numpy()
    assert got.shape == shape[:3] + (c_out,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gather_is_the_unclamped_sampler():
    # with every offset inside +/-2 the exact sampler and the clamped one
    # agree; with offsets of 3.5 they do not, and 'gather' still matches JAX
    x, off, w, b = _any_case(43, (1, 10, 12, 8), 8, 0.6)
    off = np.clip(off, -1.9, 1.9)
    args = [torch.from_numpy(x), torch.from_numpy(off),
            torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b), 1, 2]
    np.testing.assert_allclose(deform_conv2d(*args, method="gather").numpy(),
                               deform_conv2d(*args, method="shifts").numpy(),
                               rtol=1e-5, atol=1e-5)
    args[1] = torch.full_like(args[1], 3.5)
    assert not torch.allclose(deform_conv2d(*args, method="gather"),
                              deform_conv2d(*args, method="shifts"), atol=1e-3)


@pytest.mark.parametrize(
    "hw,c_in,c_out,chosen",
    [
        ((256, 256), 8, 2, "zproj"),  # 256^2 px, contracting: zproj
        ((255, 256), 8, 2, "shifts"),  # one row short of 256^2: shifts
        ((256, 256), 8, 4, "shifts"),  # large, not contracting (4 * 4 > 8)
        ((16, 16), 64, 1, "shifts"),  # contracting but small
    ],
)
def test_auto_follows_jax_rule_on_the_cpu(monkeypatch, hw, c_in, c_out, chosen):
    # JAX's 'auto' off the TPU (deepbedmap_tpu/ops/deform_conv.py:341-350);
    # the plain functions are replaced by markers, so no conv runs
    from deepbedmap_tpu_torch.ops import deform_conv as dc

    monkeypatch.setattr(dc, "deform_conv_shifts", lambda *a: "shifts")
    monkeypatch.setattr(dc, "deform_conv_shifts_zproj", lambda *a: "zproj")
    x = torch.zeros((1,) + hw + (c_in,))
    got = dc.deform_conv2d(x, torch.zeros((1,) + hw + (18,)),
                           torch.zeros(c_out, c_in, 3, 3), None)
    assert got == chosen


def test_auto_on_the_cpu_matches_jax_auto():
    # the same choice end to end: a contracting layer on 256^2 px, 'zproj' in
    # both, against JAX's own 'auto'
    x, off, w, b = _any_case(47, (1, 256, 256, 4), 1, 1.5)
    want = np.asarray(jax_deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
                                        jnp.asarray(b), 1))
    got = deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_deform_conv2d_refuses_unknown_methods():
    x = torch.zeros((1, 6, 6, C))
    with pytest.raises(ValueError, match="method"):
        deform_conv2d(x, torch.zeros((1, 6, 6, 18)), torch.zeros(C, C, 3, 3), None,
                      method="bilinear")

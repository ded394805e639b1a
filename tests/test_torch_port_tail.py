"""PyTorch port: the deformable samplers and the fused generator tail (K2/K3
plain versions and wrappers) against the JAX package's Pallas tail
(interpret mode) and its oracle.

The CUDA kernels only run on the card (``chip_smoke.py``); here numpy
emulations of their algorithms — clamped bilinear corners read through the
packed weight layout — are held against the plain masked-shift versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.deform_conv import (
    _deform_conv_shifts,
    _deform_conv_shifts_zproj,
)
from deepbedmap_tpu.ops.pallas_tail import _tail_reference, fused_deform_tail as jax_tail
from deepbedmap_tpu_torch.ops.deform_conv import (
    deform_conv_shifts,
    deform_conv_shifts_zproj,
    sample_tap_fields,
)
from deepbedmap_tpu_torch.ops.tail import (
    deform64_lrelu,
    deform_zproj1,
    fused_deform_tail,
    tail_reference,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed, c, scale=0.2):
    """HWIO tail params: offset conv 1, deform64, offset conv 2, final deform."""
    rs = np.random.RandomState(seed)
    shapes = [(3, 3, c, 18), (18,), (3, 3, c, c), (c,),
              (3, 3, c, 18), (18,), (3, 3, c, 1), (1,)]
    return [(rs.randn(*s) * scale).astype(np.float32) for s in shapes]


def _oihw(a):
    return torch.from_numpy(a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a)


def _offsets(rs, shape):
    """std-1.5 offsets with some beyond the +/-2 clamp and some exact integers,
    so the clamp, every shift branch and floor() at an integer all run."""
    off = (rs.randn(*shape) * 1.5).astype(np.float32)
    flat = off.reshape(-1)
    idx = rs.choice(flat.size, size=flat.size // 10, replace=False)
    flat[idx[: len(idx) // 2]] = rs.choice([-3.7, -2.0, -1.0, 0.0, 1.0, 2.0, 4.2],
                                           size=len(idx) // 2)
    return off


@pytest.mark.parametrize(
    "n,h,w,c,bh,clamp",
    [
        (1, 32, 48, 16, 16, 2),
        (2, 40, 150, 8, 8, 2),
        (1, 20, 130, 16, 8, 1),
    ],
)
def test_fused_tail_matches_jax(n, h, w, c, bh, clamp):
    # atol 3e-4 as tests/test_pallas_tail.py holds the JAX kernel to its oracle
    rs = np.random.RandomState(1)
    x = rs.randn(n, h, w, c).astype(np.float32)
    p = _params(42, c)
    jp = [jnp.asarray(a) for a in p]
    jax_ref = np.asarray(_tail_reference(jnp.asarray(x), *jp, 1, clamp))
    jax_kernel = np.asarray(jax_tail(
        jnp.asarray(x), *jp, clamp=clamp, block_rows=bh, method="pallas",
        interpret=True, pack_taps=True,
    ))
    tp = [_oihw(a) for a in p]
    xt = torch.from_numpy(x)
    ours_fused = fused_deform_tail(xt, *tp, clamp=clamp).numpy()
    ours_ref = tail_reference(xt, *tp, 1, clamp).numpy()
    assert ours_fused.shape == (n, h, w, 1)
    for ours in (ours_fused, ours_ref):
        np.testing.assert_allclose(ours, jax_kernel, atol=3e-4)
        np.testing.assert_allclose(ours, jax_ref, atol=3e-4)


def test_fused_tail_large_offsets_clamped_like_jax():
    # scale-3 params drive offsets far past the clamp and activations to
    # O(100-700); tolerances as tests/test_pallas_tail.py sets for this case
    rs = np.random.RandomState(3)
    x = rs.randn(1, 24, 40, 8).astype(np.float32)
    p = _params(4, 8, scale=3.0)
    jp = [jnp.asarray(a) for a in p]
    jax_ref = np.asarray(_tail_reference(jnp.asarray(x), *jp, 1, 2))
    jax_kernel = np.asarray(jax_tail(
        jnp.asarray(x), *jp, block_rows=8, method="pallas", interpret=True,
        pack_taps=True,
    ))
    ours = fused_deform_tail(torch.from_numpy(x), *[_oihw(a) for a in p]).numpy()
    np.testing.assert_allclose(ours, jax_ref, rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(ours, jax_kernel, rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("clamp", [1, 2])
def test_deform_samplers_match_jax(clamp):
    # same masked-shift decomposition in fp32 on both sides -> 1e-5
    rs = np.random.RandomState(10 + clamp)
    x = rs.randn(2, 9, 11, 8).astype(np.float32)
    off = _offsets(rs, (2, 9, 11, 18))
    wk = (rs.randn(3, 3, 8, 5) * 0.3).astype(np.float32)
    b = (rs.randn(5) * 0.1).astype(np.float32)
    args_j = (jnp.asarray(x), jnp.asarray(off), jnp.asarray(wk), jnp.asarray(b), 1, clamp)
    args_t = (torch.from_numpy(x), torch.from_numpy(off), _oihw(wk), torch.from_numpy(b),
              1, clamp)
    np.testing.assert_allclose(
        deform_conv_shifts(*args_t).numpy(), np.asarray(_deform_conv_shifts(*args_j)),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        deform_conv_shifts_zproj(*args_t).numpy(),
        np.asarray(_deform_conv_shifts_zproj(*args_j)), rtol=1e-5, atol=1e-5,
    )


def _corners(off, t, clamp, h, w):
    """K2/K3's per-tap bilinear corners: (rows, cols, weights, valid) x 4."""
    n = off.shape[0]
    dy = np.clip(off[..., t], -clamp, clamp)
    dx = np.clip(off[..., 9 + t], -clamp, clamp)
    iy, ix = np.floor(dy), np.floor(dx)
    fy, fx = dy - iy, dx - ix
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    r0 = yy[None] + t // 3 - 1 + iy.astype(int)
    c0 = xx[None] + t % 3 - 1 + ix.astype(int)
    nn_ = np.broadcast_to(np.arange(n)[:, None, None], r0.shape)
    out = []
    for a, wy in ((0, 1 - fy), (1, fy)):
        for b, wx in ((0, 1 - fx), (1, fx)):
            r, c = r0 + a, c0 + b
            valid = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            out.append((nn_, np.clip(r, 0, h - 1), np.clip(c, 0, w - 1),
                        np.where(valid, wy * wx, 0.0)))
    return out


def test_k2_k3_corner_algorithm_matches_plain_versions():
    # float64 emulation of csrc/deform_tail.cu vs the fp32 plain versions
    rs = np.random.RandomState(7)
    n, h, w, c = 2, 6, 13, 64
    x = rs.randn(n, h, w, c).astype(np.float32)
    off = _offsets(rs, (n, h, w, 18))
    w1 = (rs.randn(c, c, 3, 3) * 0.05).astype(np.float32)
    b1 = (rs.randn(c) * 0.1).astype(np.float32)
    w_packed = w1.transpose(2, 3, 1, 0).reshape(9 * c, c)  # row t * c + c_in
    assert w_packed.shape == (9 * c, c)

    acc = np.zeros((n, h, w, c))
    for t in range(9):
        sample = sum(cw[..., None] * x[nn_, r, cc] for nn_, r, cc, cw in _corners(off, t, 2, h, w))
        acc += sample @ w_packed[t * c : (t + 1) * c]
    acc += b1
    k2 = np.where(acc >= 0, acc, 0.2 * acc)
    plain = deform64_lrelu(torch.from_numpy(x), torch.from_numpy(off),
                           torch.from_numpy(w1), torch.from_numpy(b1)).numpy()
    np.testing.assert_allclose(k2, plain, rtol=1e-5, atol=1e-5)

    z = rs.randn(n, h, w, 9).astype(np.float32)
    b2 = np.array([0.3], np.float32)
    k3 = np.full((n, h, w), 0.3)
    for t in range(9):
        k3 += sum(cw * z[nn_, r, cc, t] for nn_, r, cc, cw in _corners(off, t, 2, h, w))
    plain3 = deform_zproj1(torch.from_numpy(z), torch.from_numpy(off),
                           torch.from_numpy(b2)).numpy()
    assert plain3.shape == (n, h, w, 1)
    np.testing.assert_allclose(k3, plain3[..., 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        plain3, sample_tap_fields(torch.from_numpy(z)[..., None],
                                  torch.from_numpy(off), torch.from_numpy(b2)).numpy(),
        rtol=0, atol=0,
    )

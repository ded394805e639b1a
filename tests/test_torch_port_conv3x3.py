"""PyTorch port: the fused 3x3 conv (K10's plain version and wrapper) against
the JAX package's Pallas kernel ``conv3x3_pallas`` (interpret mode) and its
oracle.

The CUDA kernel only runs on the card (``chip_smoke.py``); here a numpy
emulation of the shared direct conv — the packed weight layout it stages and
its epilogue order — is held against the plain version too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_conv import conv3x3_pallas, conv3x3_reference as jax_ref
from deepbedmap_tpu_torch.ops.conv3x3 import (
    conv3x3_fused,
    conv3x3_reference,
    pack_conv_weight,
)


def _params(c_in, seed, scale=0.05):
    """HWIO kernel and bias, as tests/test_pallas_conv.py draws them."""
    rs = np.random.RandomState(seed)
    kernel = (rs.randn(3, 3, c_in, 64) * scale).astype(np.float32)
    bias = (rs.randn(64) * 0.1).astype(np.float32)
    return kernel, bias


def _oihw(k):
    return torch.from_numpy(k.transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("c_in", [64, 128])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("leaky", [False, True])
def test_conv3x3_matches_jax_pallas(c_in, residual, leaky):
    # fp32 on both sides, same math in another summation order -> 1e-5, as
    # tests/test_pallas_conv.py holds the JAX kernel to its oracle; batch 2,
    # odd W, H not a multiple of the band
    rs = np.random.RandomState(c_in + 2 * residual + leaky)
    kernel, bias = _params(c_in, seed=3)
    x = rs.randn(2, 7, 13, c_in).astype(np.float32)
    res = rs.randn(2, 7, 13, 64).astype(np.float32) if residual else None
    jres = None if res is None else jnp.asarray(res)
    args = (jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    jax_kernel = np.asarray(conv3x3_pallas(*args, leaky=leaky, residual=jres, band=4,
                                           interpret=True))
    jax_plain = np.asarray(jax_ref(*args, leaky=leaky, residual=jres))

    tres = None if res is None else torch.from_numpy(res)
    xt, wt, bt = torch.from_numpy(x), _oihw(kernel), torch.from_numpy(bias)
    ours_ref = conv3x3_reference(xt, wt, bt, leaky, tres).numpy()
    ours_wrapper = conv3x3_fused(xt, wt, bt, leaky, tres).numpy()
    assert ours_wrapper.shape == (2, 7, 13, 64)
    for ours in (ours_ref, ours_wrapper):
        np.testing.assert_allclose(ours, jax_kernel, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours, jax_plain, rtol=1e-5, atol=1e-5)


def _emulate_k10(x, w_packed, bias, leaky, res):
    """csrc/conv3x3.cuh in float64: the 32-channel output tiles read through
    the packed [C_out/32][C_in][9][32] weights over the zero-padded input,
    then (acc + b) [+ res] [lrelu]."""
    n, h, w, c_in = x.shape
    wmat = w_packed.reshape(2, c_in, 9, 32).transpose(1, 2, 0, 3).reshape(c_in, 9, 64)
    src = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((n, h, w, 64))
    for t in range(9):
        ky, kx = divmod(t, 3)
        acc += src[:, ky : ky + h, kx : kx + w] @ wmat[:, t]
    v = acc + bias
    if res is not None:
        v = v + res
    return np.where(v >= 0, v, 0.2 * v) if leaky else v


def test_k10_packed_layout_and_epilogue():
    # float64 emulation vs the fp32 plain version: fp32 round-off only
    rs = np.random.RandomState(9)
    kernel, bias = _params(128, seed=9)
    wt = _oihw(kernel)
    w_packed = pack_conv_weight(wt)
    assert w_packed.shape == (64 * 128 * 9,)
    x = rs.randn(1, 5, 9, 128).astype(np.float32)
    res = rs.randn(1, 5, 9, 64).astype(np.float32)
    emulated = _emulate_k10(x, w_packed.numpy(), bias, True, res)
    plain = conv3x3_reference(torch.from_numpy(x), wt, torch.from_numpy(bias), True,
                              torch.from_numpy(res)).numpy()
    np.testing.assert_allclose(emulated, plain, rtol=1e-5, atol=1e-5)


def test_conv3x3_fused_refuses_other_shapes_and_devices():
    kernel, bias = _params(64, seed=0)
    wt, bt = _oihw(kernel), torch.from_numpy(bias)
    with pytest.raises(ValueError):  # C_in the kernel does not take
        conv3x3_fused(torch.zeros(1, 4, 4, 32), wt[:, :32].contiguous(), bt)
    with pytest.raises(ValueError):  # weight that does not match x
        conv3x3_fused(torch.zeros(1, 4, 4, 128), wt, bt)
    with pytest.raises(ValueError):
        conv3x3_fused(torch.zeros(1, 4, 4, 64, device="meta"), wt, bt)

"""PyTorch port: the fused 3x3 conv (K10's plain version and wrapper) against
the JAX package's Pallas kernel ``conv3x3_pallas`` (interpret mode) and its
oracle.

The CUDA kernel only runs on the card (``chip_smoke.py``); here the numpy
emulation of the tensor-core conv it launches (``csrc/conv3x3_tc.cuh``,
``tests/torch_port_emulation.py:emulate_tc_stage``: 3xTF32 with the hi/lo
split, ``pack_conv_weight``'s layout, K10's epilogue modes in the plain
version's order) is held against the plain version and the JAX kernel too,
and one TF32 pass is shown to fail the card's precision check."""

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
from tests.torch_port_emulation import ADD, ADD_LRELU, LINEAR, LRELU, emulate_tc_stage

# chip_smoke.py's precision check (TOL_TF32X3): 1e-5 of the float64
# reference's largest magnitude
TOL_TF32X3 = 1e-5
# conv3x3_forward's epilogue mode for (leaky, residual)
MODES = {(True, False): LRELU, (False, False): LINEAR, (False, True): ADD,
         (True, True): ADD_LRELU}


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


def _emulate_k10(x, wt, bias, leaky, res, passes=3):
    """conv3x3_forward: one launch of the tensor-core conv at 64 outputs, x
    read at its own channel pitch, the mode of (leaky, residual)."""
    n, h, w, c_in = x.shape
    out = np.full(n * h * w * 64, np.nan, np.float32)
    emulate_tc_stage(x.reshape(-1), c_in, c_in, pack_conv_weight(wt).numpy(), bias, n, h, w,
                     64, MODES[(leaky, res is not None)], out, 64,
                     res=None if res is None else res.reshape(-1), res_pitch=64,
                     passes=passes)
    return out.reshape(n, h, w, 64)


def _k10_case(c_in, residual, seed):
    rs = np.random.RandomState(seed)
    kernel, bias = _params(c_in, seed=seed)
    x = rs.randn(2, 9, 19, c_in).astype(np.float32)
    res = rs.randn(2, 9, 19, 64).astype(np.float32) if residual else None
    return x, kernel, bias, res


def _plain64(x, kernel, bias, leaky, res):
    return conv3x3_reference(torch.from_numpy(x).double(), _oihw(kernel).double(),
                             torch.from_numpy(bias).double(), leaky,
                             None if res is None else torch.from_numpy(res).double()).numpy()


def _rel_err(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("c_in", [64, 128])
@pytest.mark.parametrize("leaky,residual", [(True, False), (False, False), (False, True),
                                            (True, True)])
def test_k10_tc_emulation_matches_plain_and_jax(c_in, leaky, residual):
    # K10's four epilogue modes on the emulated 3xTF32 conv (batch 2, H and W
    # not multiples of the 16 x 16 tile, W over one tile): against the plain
    # version in float64, 1e-6 of the range covers the split's residue and
    # the float32 output, while a wrong tap, layout or epilogue order is of
    # the order of the output; against the JAX kernel (interpret mode) and
    # its oracle in fp32, 1e-5 as test_conv3x3_matches_jax_pallas
    x, kernel, bias, res = _k10_case(c_in, residual, seed=c_in + 2 * residual + leaky)
    got = _emulate_k10(x, _oihw(kernel), bias, leaky, res)
    assert not np.isnan(got).any()
    assert _rel_err(got, _plain64(x, kernel, bias, leaky, res)) <= 1e-6
    jres = None if res is None else jnp.asarray(res)
    args = (jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    jax_kernel = np.asarray(conv3x3_pallas(*args, leaky=leaky, residual=jres, band=4,
                                           interpret=True))
    np.testing.assert_allclose(got, jax_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_ref(*args, leaky=leaky, residual=jres)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c_in,residual", [(64, True), (128, False)])
def test_k10_precision_check_separates_one_pass_from_three(c_in, residual):
    # chip_smoke.py's precision check for K10: three passes stay within
    # TOL_TF32X3 by ten times or more, a single TF32 pass (hi.hi only) misses it
    x, kernel, bias, res = _k10_case(c_in, residual, seed=70 + c_in)
    want = _plain64(x, kernel, bias, False, res)
    three = _rel_err(_emulate_k10(x, _oihw(kernel), bias, False, res, passes=3), want)
    one = _rel_err(_emulate_k10(x, _oihw(kernel), bias, False, res, passes=1), want)
    assert three <= TOL_TF32X3 / 10
    assert one > 3 * TOL_TF32X3


def test_conv3x3_fused_refuses_other_shapes_and_devices():
    kernel, bias = _params(64, seed=0)
    wt, bt = _oihw(kernel), torch.from_numpy(bias)
    with pytest.raises(ValueError):  # C_in the kernel does not take
        conv3x3_fused(torch.zeros(1, 4, 4, 32), wt[:, :32].contiguous(), bt)
    with pytest.raises(ValueError):  # weight that does not match x
        conv3x3_fused(torch.zeros(1, 4, 4, 128), wt, bt)
    with pytest.raises(ValueError):
        conv3x3_fused(torch.zeros(1, 4, 4, 64, device="meta"), wt, bt)

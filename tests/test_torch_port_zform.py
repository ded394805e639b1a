"""PyTorch port: ``deform_conv2d_zform`` (K9's plain version and wrapper), the
deformable conv computed projection first, against the JAX package's Pallas
kernel ``deform_conv2d_pallas_zform`` (interpret mode).

The CUDA kernel only runs on the card (``chip_smoke.py``); here a numpy
emulation of its tile algorithm (``tests/torch_port_emulation.py``: 8 x 16
output tiles, each tap's 13 x 21 projection window, four-corner sampling) is
held against the plain version too, and the shapes the kernel does not take
raise on the CPU as they do on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_kernels import deform_conv2d_pallas_zform
from deepbedmap_tpu_torch.ops.deform_conv import (
    deform_conv2d_zform,
    deform_conv_shifts_zproj,
    pack_deform64_weight,
)
from tests.torch_port_emulation import emulate_k9


def _offsets(rs, shape):
    """std-1.5 offsets with some beyond the +/-2 clamp and some exact integers,
    so the clamp, every shift branch and floor() at an integer all run."""
    off = (rs.randn(*shape) * 1.5).astype(np.float32)
    flat = off.reshape(-1)
    idx = rs.choice(flat.size, size=flat.size // 10, replace=False)
    flat[idx] = rs.choice([-3.7, -2.0, -1.0, 0.0, 1.0, 2.0, 4.2], size=len(idx))
    return off


def _case(seed, n, h, w, c_in, c_out):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, c_in).astype(np.float32)
    off = _offsets(rs, (n, h, w, 18))
    wt = (rs.randn(3, 3, c_in, c_out) * 0.2).astype(np.float32)  # HWIO
    b = (rs.randn(c_out) * 0.1).astype(np.float32)
    return x, off, wt, b


def _port_weight(wt):
    return torch.from_numpy(wt.transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("clamp", [1, 2])
@pytest.mark.parametrize("c_out", [16, 1])
def test_zform_matches_jax_zform_kernel(c_out, clamp):
    # tests/test_pallas.py's zform shape (1, 9, 13, 8 -> 16) and the tail's
    # one-channel output; fp32 on both sides, the same function summed in
    # another order -> rtol 1e-5, atol 1e-5, as that test holds the JAX kernel
    x, off, wt, b = _case(3 * c_out + clamp, 1, 9, 13, 8, c_out)
    want = np.asarray(deform_conv2d_pallas_zform(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), jnp.asarray(b),
        padding=1, clamp=clamp, block_rows=8, interpret=True,
    ))
    got = deform_conv2d_zform(torch.from_numpy(x), torch.from_numpy(off),
                              _port_weight(wt), torch.from_numpy(b), 1, clamp).numpy()
    assert got.shape == (1, 9, 13, c_out)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clamp", [1, 2])
@pytest.mark.parametrize("c_out", [64, 16, 1])
def test_k9_tile_algorithm_matches_plain_version(c_out, clamp):
    # float64 emulation vs the fp32 plain version: fp32 round-off only; two
    # images, ragged tiles in both directions, and 8 -> C_out so the
    # emulation stays quick
    x, off, wt, b = _case(5, 2, 11, 21, 8, c_out)
    wp = _port_weight(wt)
    emulated = emulate_k9(x, off, pack_deform64_weight(wp).numpy(), b, clamp)
    plain = deform_conv_shifts_zproj(torch.from_numpy(x), torch.from_numpy(off), wp,
                                     torch.from_numpy(b), 1, clamp).numpy()
    np.testing.assert_allclose(emulated, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "c_in,c_out,k,padding,clamp,off_channels",
    [
        (8, 16, 3, 0, 2, 18),  # padding other than 1
        (8, 16, 5, 1, 2, 50),  # a 5x5 kernel
        (8, 32, 3, 1, 2, 18),  # C_out not in {1, 16, 64}
        (6, 16, 3, 1, 2, 18),  # C_in not a multiple of 4
        (128, 16, 3, 1, 2, 18),  # C_in above 64
        (8, 16, 3, 1, 3, 18),  # a clamp beyond the kernel's 2-px window
        (8, 16, 3, 1, 1.5, 18),  # a clamp the masked shifts cannot take
        (8, 16, 3, 1, 2, 9),  # offsets of the wrong width
    ],
)
def test_zform_rejects_shapes_the_kernel_does_not_take(c_in, c_out, k, padding, clamp,
                                                       off_channels):
    x = torch.zeros(1, 5, 6, c_in)
    off = torch.zeros(1, 5, 6, off_channels)
    with pytest.raises(ValueError):
        deform_conv2d_zform(x, off, torch.zeros(c_out, c_in, k, k), torch.zeros(c_out),
                            padding, clamp)


def test_zform_refuses_other_devices():
    x = torch.zeros((1, 4, 4, 8), device="meta")
    off = torch.zeros((1, 4, 4, 18), device="meta")
    with pytest.raises(ValueError):
        deform_conv2d_zform(x, off, torch.zeros(16, 8, 3, 3, device="meta"),
                            torch.zeros(16, device="meta"))

"""PyTorch port: ``deform_conv2d_zform`` (K9's plain version and wrapper), the
deformable conv computed projection first, against the JAX package's Pallas
kernel ``deform_conv2d_pallas_zform`` (interpret mode).

The CUDA kernel only runs on the card (``chip_smoke.py``); here a numpy
emulation of its tile algorithm (``tests/torch_port_emulation.py``: for
C_out 64 and 16 the 7 x 16 tile's window, each tap's projection as a 3xTF32
GEMM over 256 padded M rows with C_in padded to 16, four-corner sampling of
z_t; for C_out 1 the 32 x 32 tile's window projected onto the nine tap
fields, then K3's sampling) is held against the plain version too, the
packed B operand is checked entry by entry, and the shapes the kernel does
not take raise on the CPU as they do on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_kernels import deform_conv2d_pallas_zform
from deepbedmap_tpu_torch.ops.deform_conv import (
    deform_conv2d_zform,
    deform_conv_shifts,
    deform_conv_shifts_zproj,
    pack_deform64_weight_tc,
)
from tests.torch_port_emulation import emulate_k9, split_tf32

# chip_smoke.py's precision check (TOL_TF32X3): 1e-5 of the float64
# reference's largest magnitude
TOL_TF32X3 = 1e-5


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


def _packed(wp):
    """The weights as deform2d_zform hands them to K9."""
    c_out, c_in = wp.shape[:2]
    if c_out == 1:
        return wp[0].reshape(c_in, 9).numpy()
    return pack_deform64_weight_tc(wp).numpy()


def _plain64(x, off, wp, b, clamp):
    """The deformable conv in float64 (in float64 the two associations agree
    to round-off far below the tolerances)."""
    return deform_conv_shifts(torch.from_numpy(x).double(), torch.from_numpy(off).double(),
                              wp.double(), torch.from_numpy(b).double(), 1, clamp).numpy()


def _rel_err(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


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
    # the emulated kernel vs the fp32 plain version: fp32 round-off only (and
    # 3xTF32's, below it); two images, ragged tiles in both directions (7 x
    # 16 and 32 x 32 tiles), and 8 -> C_out (C_in padded to a 16-channel
    # block) so the emulation stays quick
    x, off, wt, b = _case(5, 2, 19, 37, 8, c_out)
    wp = _port_weight(wt)
    emulated = emulate_k9(x, off, _packed(wp), b, clamp)
    plain = deform_conv_shifts_zproj(torch.from_numpy(x), torch.from_numpy(off), wp,
                                     torch.from_numpy(b), 1, clamp).numpy()
    np.testing.assert_allclose(emulated, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c_in,c_out", [(8, 16), (12, 16), (20, 64), (64, 64)])
def test_zform_packed_weight_layout(c_in, c_out):
    # exact: every (tap, step, slot, output) of K9's B lands where the
    # kernel's descriptor reads it, split into hi + lo, with zero weights in
    # the channels past C_in up to the next 16
    rs = np.random.RandomState(c_in + c_out)
    wk = rs.randn(c_out, c_in, 3, 3).astype(np.float32)
    c16 = -(-c_in // 16) * 16
    steps = c16 // 8
    packed = pack_deform64_weight_tc(torch.from_numpy(wk)).numpy()
    assert packed.shape == (9 * 2 * c16 * c_out,)
    p = packed.reshape(9, 2, steps, c_out // 8, 2, 8, 4)
    hi, lo = split_tf32(wk)
    seen = set()
    for t in range(9):
        for s in range(steps):
            for kk in range(8):
                ci = 16 * (s // 2) + 4 * (kk % 4) + 2 * (s % 2) + kk // 4
                seen.add(ci)
                for part, ref in ((0, hi), (1, lo)):
                    got = p[t, part, s, :, kk // 4, :, kk % 4].reshape(-1)  # (n/8, n%8)
                    want = ref[:, ci, t // 3, t % 3] if ci < c_in else np.zeros(c_out)
                    np.testing.assert_array_equal(got, want)
    assert seen == set(range(c16))


@pytest.mark.parametrize("c_out", [64, 16])
def test_k9_precision_check_separates_one_pass_from_three(c_out):
    # chip_smoke.py's precision check for K9: the emulated kernel against the
    # float64 deformable conv; three passes stay within TOL_TF32X3 by ten
    # times or more, a single TF32 pass (hi.hi only) misses it
    x, off, wt, b = _case(60 + c_out, 1, 9, 19, 64, c_out)
    wt *= 0.25  # 64 input channels: the scale the chip check draws at
    wp = _port_weight(wt)
    want = _plain64(x, off, wp, b, 2)
    three = _rel_err(emulate_k9(x, off, _packed(wp), b, 2, passes=3), want)
    one = _rel_err(emulate_k9(x, off, _packed(wp), b, 2, passes=1), want)
    assert three <= TOL_TF32X3 / 10
    assert one > 3 * TOL_TF32X3


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

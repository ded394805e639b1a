"""PyTorch port: the tail kernels' shared-memory windows. K2 / K7, the 64 -> 64
deformable conv as a 3xTF32 implicit GEMM, and K3, the nine-tap-field
sampler (``csrc/deform_tail.cu``), as numpy emulations held against the plain
versions and the JAX package.

The kernels themselves only run on the card (``chip_smoke.py``). Here
``tests/torch_port_emulation.py`` repeats their algorithms step for step: the
tile's window with zero fill, each tap's four clamped corners read from it,
and for K2 the TF32 split of the blended samples, the weights read through
``pack_deform64_weight_tc``'s layout and a partial sum per wgmma group.
Offsets include values of exactly +/-clamp, whose zero-weight far corner lies
on the window's last row or column."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.deform_conv import (
    _deform_conv_shifts,
    _deform_conv_shifts_zproj,
)
from deepbedmap_tpu.ops.pallas_tail import fused_deform_tail as jax_tail
from deepbedmap_tpu_torch.ops.conv import conv_nhwc
from deepbedmap_tpu_torch.ops.deform_conv import (
    check_window_clamp,
    deform_conv2d,
    deform_conv_shifts,
    pack_deform64_weight_tc,
    sample_tap_fields,
    tap_projection,
    tf32_split,
)
from tests.torch_port_emulation import emulate_k2_tc, emulate_k3_window, split_tf32

C = 64
# chip_smoke.py's precision check (TOL_TF32X3): 1e-5 of the float64
# reference's largest magnitude
TOL_TF32X3 = 1e-5
# smaller than K2's 16 x 16 and K3's 8 x 32 tile; H and W multiples of
# neither, batch > 1; W narrower than a tile
SHAPES = [(1, 5, 7, C), (2, 21, 37, C), (1, 18, 9, C)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _offsets(rs, shape, clamp):
    """std-1.5 offsets, some beyond the clamp, some exact integers, and a
    tenth set to exactly +clamp or -clamp."""
    off = (rs.randn(*shape) * 1.5).astype(np.float32)
    flat = off.reshape(-1)
    idx = rs.choice(flat.size, size=flat.size // 5, replace=False)
    half = len(idx) // 2
    flat[idx[:half]] = rs.choice([-3.7, -2.0, -1.0, 0.0, 1.0, 2.0, 4.2], size=half)
    flat[idx[half:]] = rs.choice([-float(clamp), float(clamp)], size=len(idx) - half)
    return off


def _k2_case(shape, clamp, seed):
    rs = np.random.RandomState(seed)
    n, h, w, _ = shape
    x = rs.randn(*shape).astype(np.float32)
    off = _offsets(rs, (n, h, w, 18), clamp)
    wk = (rs.randn(C, C, 3, 3) * 0.05).astype(np.float32)  # OIHW
    b = (rs.randn(C) * 0.1).astype(np.float32)
    w_tc = pack_deform64_weight_tc(torch.from_numpy(wk)).numpy()
    return x, off, wk, b, w_tc


def _plain64(x, off, wk, b, clamp, lrelu):
    y = deform_conv_shifts(torch.from_numpy(x).double(), torch.from_numpy(off).double(),
                           torch.from_numpy(wk).double(), torch.from_numpy(b).double(),
                           1, clamp).numpy()
    return np.where(y >= 0, y, 0.2 * y) if lrelu else y


def _rel_err(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def test_pack_deform64_weight_tc_layout():
    # exact: every (tap, step, slot, output) lands where the kernel's B
    # descriptor reads it, split into hi + lo
    rs = np.random.RandomState(1)
    wk = rs.randn(C, C, 3, 3).astype(np.float32)
    packed = pack_deform64_weight_tc(torch.from_numpy(wk)).numpy()
    assert packed.shape == (9 * 2 * 8 * 8 * C,)
    p = packed.reshape(9, 2, 8, 8, 2, 8, 4)
    hi, lo = split_tf32(wk)
    for t, s, kk, co in [(0, 0, 0, 0), (4, 3, 5, 17), (8, 7, 7, 63), (2, 6, 2, 40)]:
        ci = 16 * (s // 2) + 4 * (kk % 4) + 2 * (s % 2) + kk // 4
        for part, ref in ((0, hi), (1, lo)):
            got = p[t, part, s, co // 8, kk // 4, co % 8, kk % 4]
            assert got == ref[co, ci, t // 3, t % 3]
    # the slot order covers every channel once per pair of steps
    chans = {16 * (s // 2) + 4 * (k % 4) + 2 * (s % 2) + k // 4
             for s in range(8) for k in range(8)}
    assert chans == set(range(C))


def test_tf32_split_matches_emulation():
    # the packer's torch split is the emulation's cvt.rna split, bit for bit
    rs = np.random.RandomState(2)
    a = (rs.randn(4096) * np.exp(rs.uniform(-10, 10, 4096))).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(a))
    ehi, elo = split_tf32(a)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), ehi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), elo.view(np.uint32))


@pytest.mark.parametrize("clamp", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_tc_emulation_matches_plain_and_jax(shape, clamp):
    # against the plain masked-shift conv in float64: 1e-6 of the range covers
    # the split's residue (2^-22 per product) and float32 storage; a wrong
    # window index, slot order or zero fill is of the order of the output.
    # Against the JAX package's _deform_conv_shifts (fp32 on the CPU): 1e-5,
    # as test_torch_port_tail.py holds the plain samplers to it
    x, off, wk, b, w_tc = _k2_case(shape, clamp, seed=30 + clamp)
    got = emulate_k2_tc(x, off, w_tc, b, clamp, lrelu=True)
    assert _rel_err(got, _plain64(x, off, wk, b, clamp, True)) <= 1e-6
    conv = np.asarray(_deform_conv_shifts(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wk.transpose(2, 3, 1, 0)),
        jnp.asarray(b), 1, clamp))
    want = np.where(conv >= 0, conv, 0.2 * conv)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_k7_tc_emulation_matches_plain():
    # K7: the same kernel without the LeakyReLU
    x, off, wk, b, w_tc = _k2_case(SHAPES[1], 2, seed=40)
    got = emulate_k2_tc(x, off, w_tc, b, 2, lrelu=False)
    assert _rel_err(got, _plain64(x, off, wk, b, 2, False)) <= 1e-6


@pytest.mark.parametrize("lrelu", [True, False])
def test_precision_check_separates_one_pass_from_three(lrelu):
    # chip_smoke.py's precision check for K2 (lrelu) and K7: three passes stay
    # within TOL_TF32X3 by ten times or more, a single TF32 pass (hi.hi only)
    # misses it
    x, off, wk, b, w_tc = _k2_case(SHAPES[1], 2, seed=50)
    want = _plain64(x, off, wk, b, 2, lrelu)
    three = _rel_err(emulate_k2_tc(x, off, w_tc, b, 2, lrelu, passes=3), want)
    one = _rel_err(emulate_k2_tc(x, off, w_tc, b, 2, lrelu, passes=1), want)
    assert three <= TOL_TF32X3 / 10
    assert one > TOL_TF32X3


@pytest.mark.parametrize("clamp", [0, 1, 2])
@pytest.mark.parametrize("shape", [(1, 5, 7), (2, 21, 70), (1, 17, 9)])
def test_k3_window_emulation_matches_plain_and_jax(shape, clamp):
    # the window sampler against the plain sample_tap_fields (fp32) and, with
    # the tap projection in front, against the JAX package's projection-first
    # sampler (fp32): 1e-5, fp32 sums of 36 terms in another order
    rs = np.random.RandomState(60 + clamp)
    n, h, w = shape
    x = rs.randn(n, h, w, 8).astype(np.float32)
    off = _offsets(rs, (n, h, w, 18), clamp)
    w2 = (rs.randn(1, 8, 3, 3) * 0.3).astype(np.float32)  # OIHW
    b2 = np.array([0.25], np.float32)
    z = tap_projection(torch.from_numpy(x), torch.from_numpy(w2))
    got = emulate_k3_window(z.numpy(), off, b2, clamp)
    plain = sample_tap_fields(z[..., None], torch.from_numpy(off), torch.from_numpy(b2),
                              1, clamp).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    jax_out = np.asarray(_deform_conv_shifts_zproj(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(w2.transpose(2, 3, 1, 0)),
        jnp.asarray(b2), 1, clamp))
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-5)


def test_emulated_tail_matches_jax_fused_tail():
    # the whole fused tail with K2 and K3 replaced by their emulations:
    # offset conv, K2 (window, 3xTF32), offset conv, tap projection, K3
    # (window), against the JAX fused tail in interpret mode; atol 3e-4 as
    # test_torch_port_tail.py and tests/test_pallas_tail.py hold it
    rs = np.random.RandomState(70)
    n, h, w = 1, 20, 40
    x = rs.randn(n, h, w, C).astype(np.float32)
    shapes = [(3, 3, C, 18), (18,), (3, 3, C, C), (C,), (3, 3, C, 18), (18,),
              (3, 3, C, 1), (1,)]
    p = [(rs.randn(*s) * (0.05 if len(s) == 4 else 0.2)).astype(np.float32) for s in shapes]
    oihw = [torch.from_numpy(a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a) for a in p]
    xt = torch.from_numpy(x)
    off1 = conv_nhwc(xt, oihw[0], oihw[1]).numpy()
    w_tc = pack_deform64_weight_tc(oihw[2]).numpy()
    a5 = emulate_k2_tc(x, off1, w_tc, p[3], 2, lrelu=True)
    off2 = conv_nhwc(torch.from_numpy(a5), oihw[4], oihw[5]).numpy()
    z = tap_projection(torch.from_numpy(a5), oihw[6]).numpy()
    got = emulate_k3_window(z, off2, p[7], 2)
    want = np.asarray(jax_tail(jnp.asarray(x), *[jnp.asarray(a) for a in p], clamp=2,
                               block_rows=8, method="pallas", interpret=True,
                               pack_taps=True))
    np.testing.assert_allclose(got, want, atol=3e-4)


@pytest.mark.parametrize("clamp", [-1, 3, 2.5, True, 1e9])
def test_window_clamp_check_refuses(clamp):
    with pytest.raises(ValueError):
        check_window_clamp(clamp)


@pytest.mark.parametrize("clamp", [0, 1, 2, 2.0])
def test_window_clamp_check_accepts(clamp):
    check_window_clamp(clamp)


def test_plain_deform_conv_takes_any_clamp():
    # on a CPU tensor deform_conv2d runs its plain version, which takes a
    # clamp beyond the kernels' window: 3 px reaches corners clamp 2 cannot
    rs = np.random.RandomState(80)
    x = torch.from_numpy(rs.randn(1, 9, 11, C).astype(np.float32))
    off = torch.full((1, 9, 11, 18), 2.5)
    wt = torch.from_numpy((rs.randn(C, C, 3, 3) * 0.05).astype(np.float32))
    b = torch.zeros(C)
    three = deform_conv2d(x, off, wt, b, 1, 3)
    two = deform_conv2d(x, off, wt, b, 1, 2)
    assert three.shape == (1, 9, 11, C)
    assert not torch.allclose(three, two)

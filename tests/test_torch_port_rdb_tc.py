"""PyTorch port: the 3xTF32 tensor-core conv of K1 and K4
(``csrc/conv3x3_tc.cuh``, wired by ``csrc/rdb.cu``) as a numpy emulation,
held against the plain versions.

The kernel itself only runs on the card (``chip_smoke.py``). Here
``tests/torch_port_emulation.py`` repeats its algorithm step for step: TF32
rounding as ``cvt.rna.tf32.f32`` does it, the hi/lo split, the halo and weight
staging with zero fill and the workspace's channel pitch, the shared-memory
layouts the wgmma fragments are read from, the partial sum per kernel row and
the epilogues. The plain versions run in float64, so each error below is the
emulated algorithm's own."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F_

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_rdb import rdb_reference as jax_rdb_reference
from deepbedmap_tpu_torch.ops.rdb import (
    pack_rdb_weights,
    pack_rrdb_weights,
    rdb_reference,
    rrdb_reference,
)
from tests.torch_port_emulation import (
    LRELU,
    emulate_k1_tc,
    emulate_k4_tc,
    emulate_tc_stage,
    split_tf32,
    tf32_rna,
)

F, G = 64, 32
# chip_smoke.py's precision check (TOL_TF32X3): 1e-5 of the float64
# reference's largest magnitude, at scaling 1.0
TOL_TF32X3 = 1e-5
# two ragged shapes each: H and W not multiples of the 16 x 16 tile, W
# narrower than a tile, batch > 1
K1_SHAPES = [(1, 13, 14, F), (3, 37, 9, F)]
K4_SHAPES = [(1, 13, 14, F), (2, 18, 19, F)]


@pytest.mark.parametrize(
    "bits_in,bits_out",
    [
        (0x3F800000, 0x3F800000),  # 1.0: already TF32
        (0x3F801000, 0x3F802000),  # exact tie, even TF32 mantissa: away from zero
        (0xBF801000, 0xBF802000),  # the same, negative: away from zero
        (0x3F803000, 0x3F804000),  # exact tie, odd TF32 mantissa
        (0x3F800FFF, 0x3F800000),  # just below the tie: down
        (0x3F801001, 0x3F802000),  # just above the tie: up
        (0x3FFFF000, 0x40000000),  # all mantissa bits carry into the exponent: 2.0
        (0xBFFFF000, 0xC0000000),  # the same, negative: -2.0
        (0x00000000, 0x00000000),  # +0
        (0x80000000, 0x80000000),  # -0
    ],
)
def test_tf32_rna_bit_patterns(bits_in, bits_out):
    # exact: rounding is a bit operation, no tolerance
    x = np.array([bits_in], np.uint32).view(np.float32)
    assert int(tf32_rna(x).view(np.uint32)[0]) == bits_out


def test_split_tf32_is_exact_and_tf32():
    # hi + lo recovers x to 2^-22 of |x| (lo's own rounding), both halves keep
    # 10 mantissa bits (low 13 bits zero)
    rs = np.random.RandomState(3)
    x = (rs.randn(10000) * np.exp(rs.uniform(-20, 20, 10000))).astype(np.float32)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    err = np.abs(hi.astype(np.float64) + lo - x.astype(np.float64))
    assert np.all(err <= 2.0 ** -22 * np.abs(x))


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_tc_stage_zero_fill_and_pitch(shape):
    # one 3xTF32 stage (96 -> 32, LeakyReLU) reading the first 96 channels of
    # a 192-channel workspace and writing channels 96-127, against the plain
    # conv in float64: 1e-6 of the range covers the split's residue (2^-22
    # per product) and the float32 output; a wrong tap, halo or zero fill is
    # of the order of the output
    n, h, w, _ = shape
    rs = np.random.RandomState(11)
    ws = rs.randn(n, h, w, 192).astype(np.float32)
    kernel = (rs.randn(G, 96, 3, 3) * 0.05).astype(np.float32)
    bias = (rs.randn(G) * 0.1).astype(np.float32)
    w_packed, _ = pack_rdb_weights([torch.from_numpy(kernel)], [torch.from_numpy(bias)])
    flat = ws.reshape(-1).copy()
    emulate_tc_stage(flat, 192, 96, w_packed.numpy(), bias, n, h, w, G, LRELU, flat[96:],
                     192)
    got = flat.reshape(ws.shape)
    z = F_.conv2d(torch.from_numpy(ws[..., :96]).double().permute(0, 3, 1, 2),
                  torch.from_numpy(kernel).double(), torch.from_numpy(bias).double(),
                  padding=1).permute(0, 2, 3, 1).numpy()
    want = np.where(z >= 0, z, 0.2 * z)
    assert np.abs(got[..., 96:128] - want).max() <= 1e-6 * np.abs(want).max()
    # the channels the stage does not write are untouched
    np.testing.assert_array_equal(got[..., :96], ws[..., :96])
    np.testing.assert_array_equal(got[..., 128:], ws[..., 128:])


def _block_params(rs, scale=0.05):
    kernels, biases = [], []
    for ci, co in zip([F + G * j for j in range(5)], [G, G, G, G, F]):
        kernel = (rs.randn(co, ci, 3, 3) * scale).astype(np.float32)
        kernels.append(torch.from_numpy(kernel))
        biases.append(torch.from_numpy((rs.randn(co) * 0.1).astype(np.float32)))
    return kernels, biases


def _double(ts):
    return [_double(t) for t in ts] if isinstance(ts, (list, tuple)) else ts.double()


def _k1_case(shape, scaling):
    rs = np.random.RandomState(21)
    kernels, biases = _block_params(rs)
    x = rs.randn(*shape).astype(np.float32)
    w, b = pack_rdb_weights(kernels, biases)
    want = rdb_reference(torch.from_numpy(x).double(), _double(kernels), _double(biases),
                         scaling).numpy()
    return x, w.numpy(), b.numpy(), want


def _k4_case(shape, scaling):
    rs = np.random.RandomState(22)
    blocks = [_block_params(rs) for _ in range(3)]
    kernels, biases = [k for k, _ in blocks], [b for _, b in blocks]
    x = rs.randn(*shape).astype(np.float32)
    w, b = pack_rrdb_weights(kernels, biases)
    want = rrdb_reference(torch.from_numpy(x).double(), _double(kernels), _double(biases),
                          scaling).numpy()
    return x, w.numpy(), b.numpy(), want


def _rel_err(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_tc_emulation_matches_rdb_reference(shape):
    # K1's five stages from pack_rdb_weights at scaling 0.1, as the generator
    # runs them; 1e-6 of the range: the split's residue and float32 storage
    x, w, b, want = _k1_case(shape, 0.1)
    got = emulate_k1_tc(x, w, b, 0.1)
    assert _rel_err(got, want) <= 1e-6
    # and the JAX package's plain dense block (fp32 on the CPU, HWIO kernels):
    # its own fp32 round-off, 1e-5 as in test_torch_port_rdb.py
    rs = np.random.RandomState(21)
    kernels, biases = _block_params(rs)
    jax_out = np.asarray(jax_rdb_reference(
        jnp.asarray(x), [jnp.asarray(k.numpy().transpose(2, 3, 1, 0)) for k in kernels],
        [jnp.asarray(b_.numpy()) for b_ in biases], 0.1))
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", K4_SHAPES)
def test_k4_tc_emulation_matches_rrdb_reference(shape):
    # K4 (ping-pong workspaces, the outer skip in the last epilogue) from
    # pack_rrdb_weights at scaling 0.1; 1e-6 of the range, as K1
    x, w, b, want = _k4_case(shape, 0.1)
    assert _rel_err(emulate_k4_tc(x, w, b, 0.1), want) <= 1e-6


@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_precision_check_separates_one_pass_from_three(kernel):
    # chip_smoke.py's precision check at scaling 1.0: three passes stay within
    # TOL_TF32X3 by a wide margin, a single TF32 pass (hi.hi only) misses it
    case, emulate, shape = {"k1": (_k1_case, emulate_k1_tc, K1_SHAPES[0]),
                            "k4": (_k4_case, emulate_k4_tc, K4_SHAPES[0])}[kernel]
    x, w, b, want = case(shape, 1.0)
    three = _rel_err(emulate(x, w, b, 1.0, passes=3), want)
    one = _rel_err(emulate(x, w, b, 1.0, passes=1), want)
    assert three <= TOL_TF32X3 / 10
    assert one > 3 * TOL_TF32X3

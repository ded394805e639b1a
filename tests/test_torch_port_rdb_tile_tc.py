"""PyTorch port: the tile-local dense block of K6 and K5 on the tensor cores
(``csrc/rdb_tile.cuh``, 3xTF32 ``wgmma`` on an 8 x 16 tile) as a numpy
emulation, held against the plain versions and the JAX kernels.

The kernels only run on the card (``chip_smoke.py``). Here
``tests/torch_port_emulation.py`` repeats the tile body step for step: x
staged one 8-channel chunk at a time with zero outside the image, a1..a4
written and read through their swizzled shared-memory offsets with zero
outside the image, each stage's window padded to 64-row blocks, each lane's A
gathered in the permuted k order and split into TF32 hi/lo, B read back
through ``pack_rdb_weights_tc``'s core-matrix layout, a partial sum per chunk
and kernel row. Products are exact and sums float64, so each error below is
the algorithm's own."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_rdb import rdb_pallas
from deepbedmap_tpu_torch.ops.rdb import (
    pack_rdb_weights_tc,
    pack_rrdb_weights_tc,
    rdb_reference,
    rrdb_reference,
)
from tests.torch_port_emulation import (
    SLOT_CHANNELS,
    TH,
    TW,
    _stage_b_tc,
    _swizzled,
    dense_block_tile_tc,
    emulate_k5,
    emulate_k6,
    split_tf32,
)

F, G = 64, 32
# chip_smoke.py's precision check (TOL_TF32X3): 1e-5 of the float64
# reference's largest magnitude, at scaling 1.0
TOL_TF32X3 = 1e-5
# ragged (H and W multiples of neither 8 nor 16), W narrower than a tile and
# five bands, smaller than one tile, and two tile columns over a height that
# is not a multiple of the band
K6_SHAPES = [(1, 13, 14, F), (3, 37, 9, F), (1, 5, 7, F), (2, 20, 35, F)]


def _block(rs, scale=0.05):
    kernels, biases = [], []
    for ci, co in zip([F + G * j for j in range(5)], [G, G, G, G, F]):
        kernels.append(torch.from_numpy((rs.randn(co, ci, 3, 3) * scale).astype(np.float32)))
        biases.append(torch.from_numpy((rs.randn(co) * 0.1).astype(np.float32)))
    return kernels, biases


def _double(ts):
    return [_double(t) for t in ts] if isinstance(ts, (list, tuple)) else ts.double()


def _err(got, want):
    """Largest error as a fraction of the reference's largest magnitude."""
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("stage", range(5))
def test_pack_rdb_weights_tc_layout_and_split(stage):
    # every element where the kernel's B descriptor reads it: per chunk c,
    # kernel row ky, column kx, hi then lo, [n/8][k/4][n%8][k%4] with slot k
    # holding channel 8c + 2(k%4) + k//4; hi + lo recovers the weight to
    # 2^-22 of it, both TF32 (low 13 bits zero). Exact: a layout fault is off
    # by whole weights
    rs = np.random.RandomState(5)
    kernels, biases = _block(rs)
    w_packed, b_packed = pack_rdb_weights_tc(kernels, biases)
    assert w_packed.shape == (2 * sum(k.numel() for k in kernels),)
    np.testing.assert_array_equal(b_packed.numpy(), torch.cat(biases).numpy())
    sizes = [2 * k.numel() for k in kernels]
    off = sum(sizes[:stage])
    kern = kernels[stage].numpy()
    cout, cin = kern.shape[:2]
    core = w_packed.numpy()[off:off + sizes[stage]].reshape(
        cin // 8, 3, 3, 2, cout // 8, 2, 8, 4)
    c, ky, kx, n, k = np.meshgrid(np.arange(cin // 8), np.arange(3), np.arange(3),
                                  np.arange(cout), np.arange(8), indexing="ij")
    hi = core[c, ky, kx, 0, n // 8, k // 4, n % 8, k % 4]
    lo = core[c, ky, kx, 1, n // 8, k // 4, n % 8, k % 4]
    w = kern[n, 8 * c + SLOT_CHANNELS[k], ky, kx]
    want_hi, want_lo = split_tf32(w)
    np.testing.assert_array_equal(hi, want_hi)
    np.testing.assert_array_equal(lo, want_lo)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    assert np.all(np.abs(hi.astype(np.float64) + lo - w) <= 2.0 ** -22 * np.abs(w))


def test_pack_rrdb_weights_tc_is_three_blocks():
    rs = np.random.RandomState(6)
    blocks = [_block(rs) for _ in range(3)]
    w, b = pack_rrdb_weights_tc([k for k, _ in blocks], [b for _, b in blocks])
    parts = [pack_rdb_weights_tc(k, b_) for k, b_ in blocks]
    np.testing.assert_array_equal(w.numpy(), torch.cat([p[0] for p in parts]).numpy())
    np.testing.assert_array_equal(b.numpy(), torch.cat([p[1] for p in parts]).numpy())


def test_swizzled_storage_is_a_permutation_and_conflict_free():
    # a1..a4's [pixel][chunk ^ (pixel & 3)][8] storage: every float of a
    # window has one slot, and the four consecutive pixels of a half-warp's
    # 8-byte A load (lanes g = 0..3, t = 0..3) fall in 32 different banks
    npix = 384
    offsets = np.concatenate([_swizzled(np.arange(npix), c)[:, None] + np.arange(8)
                              for c in range(4)], axis=1)
    assert sorted(offsets.reshape(-1).tolist()) == list(range(npix * G))
    for q0 in range(0, npix - 4):
        for chunk in range(4):
            q = q0 + np.arange(4)[:, None]
            words = _swizzled(q, chunk) + 2 * np.arange(4)[None, :]  # (g, t), 2 words each
            banks = np.concatenate([words, words + 1]).reshape(-1) % 32
            assert len(set(banks.tolist())) == 32


def test_staging_reads_only_in_image_pixels():
    # a tile at the image's corner: its 18 x 26 window overhangs three edges;
    # the staging asks the loader only for in-image pixels (the rest is the
    # zero fill) and the tile's outputs outside the image are flagged
    rs = np.random.RandomState(8)
    kernels, biases = _block(rs)
    w_packed, b_packed = pack_rdb_weights_tc(kernels, biases)
    h, w = 6, 11
    x = rs.randn(h, w, F).astype(np.float32)

    def load(gy, gx):
        assert np.all((gy >= 0) & (gy < h) & (gx >= 0) & (gx < w))
        return x[gy, gx]

    v, inside = dense_block_tile_tc(load, _stage_b_tc(w_packed.numpy()), b_packed.numpy(),
                                    0, 0, h, w)
    assert v.shape == (TH, TW, F)
    assert inside.sum() == h * w and inside[:h, :w].all()


@pytest.mark.parametrize("shape", K6_SHAPES)
def test_emulated_k6_matches_float64_plain_version(shape):
    # scaling 1.0, so the conv's error is not damped under the residual:
    # 1e-6 of the range covers the split's residue (2^-22 per product) and
    # the float32 intermediates; a wrong tap, window, zero fill or layout is
    # of the order of the output
    rs = np.random.RandomState(12)
    kernels, biases = _block(rs)
    w_packed, b_packed = pack_rdb_weights_tc(kernels, biases)
    x = rs.randn(*shape).astype(np.float32)
    got = emulate_k6(x, w_packed.numpy(), b_packed.numpy(), 1.0)
    want = rdb_reference(torch.from_numpy(x).double(), _double(kernels), _double(biases),
                         1.0).numpy()
    assert got.shape == shape
    assert _err(got, want) <= 1e-6


@pytest.mark.parametrize(
    "shape,band",
    [
        ((3, 37, 14, F), 8),  # five bands, the last one short; W under a tile
        ((2, 13, 22, F), 4),  # two tile columns, the second short
        ((1, 5, 6, F), 4),  # smaller than one tile
    ],
)
def test_emulated_k6_matches_jax_rdb_pallas(shape, band):
    # fp32 on both sides, the same math in another summation order -> 1e-5,
    # as tests/test_pallas_rdb.py holds rdb_pallas to its XLA oracle (which
    # takes W + 2 a multiple of 8)
    rs = np.random.RandomState(14)
    kernels, biases = _block(rs)
    x = rs.randn(*shape).astype(np.float32)
    want = np.asarray(rdb_pallas(
        jnp.asarray(x), [jnp.asarray(k.numpy().transpose(2, 3, 1, 0)) for k in kernels],
        [jnp.asarray(b.numpy()) for b in biases], 0.2, band=band, interpret=True))
    w_packed, b_packed = pack_rdb_weights_tc(kernels, biases)
    got = emulate_k6(x, w_packed.numpy(), b_packed.numpy(), 0.2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 26, 20, F), (3, 37, 9, F)])
def test_emulated_k5_on_the_tc_tile_matches_float64_plain_version(shape):
    # the sweep over 8-row bands with 8 x 16 tiles: four bands over two tile
    # columns, and five bands (more than the rings' four slots) of a tile
    # narrower than 16; emulate_k5 asserts that no step reads a ring slot it
    # writes. Three chained blocks at scaling 1.0 against float64: 1e-6
    rs = np.random.RandomState(16)
    blocks = [_block(rs) for _ in range(3)]
    kernels, biases = [k for k, _ in blocks], [b for _, b in blocks]
    w_packed, b_packed = pack_rrdb_weights_tc(kernels, biases)
    x = rs.randn(*shape).astype(np.float32)
    got = emulate_k5(x, w_packed.numpy(), b_packed.numpy(), 1.0)
    want = rrdb_reference(torch.from_numpy(x).double(), _double(kernels), _double(biases),
                          1.0).numpy()
    assert _err(got, want) <= 1e-6


def test_one_tf32_pass_fails_the_precision_check_where_three_pass():
    # chip_smoke.py's precision check must tell 3xTF32 from one TF32 pass:
    # one pass lands well above TOL_TF32X3, three well below it
    rs = np.random.RandomState(18)
    kernels, biases = _block(rs)
    w_packed, b_packed = pack_rdb_weights_tc(kernels, biases)
    x = rs.randn(1, 13, 14, F).astype(np.float32)
    want = rdb_reference(torch.from_numpy(x).double(), _double(kernels), _double(biases),
                         1.0).numpy()
    one = _err(emulate_k6(x, w_packed.numpy(), b_packed.numpy(), 1.0, passes=1), want)
    three = _err(emulate_k6(x, w_packed.numpy(), b_packed.numpy(), 1.0), want)
    assert one > TOL_TF32X3 and three < TOL_TF32X3 / 10

"""PyTorch port: the bf16-multiplicand mode (``mxu_bf16``) of K1, K4, K5, K6
and K10 against the JAX package's Pallas kernels in the mode (interpret
mode, JAX's own test sizes: 13 x 14 px, band 4; K5 needs a band of at least
its margin, 8, on 22 x 14 px), and the bf16 routes of the CUDA kernels as
numpy emulations (``tests/torch_port_emulation.py``): K1's, K4's and K10's
(``csrc/conv3x3_tc.cuh``, bf16 ``wgmma`` k16 on bf16-packed weights, its
layouts checked one by one and the whole route held against JAX and the
rounded plain version), and K6's and K5's (``csrc/rdb_tile.cuh``'s bf16
route: bf16 ``wgmma`` k16 on bf16-packed weights with the tile's input and
intermediates resident in bf16, held against JAX and the rounded plain
version at a ragged shape too).

The mode rounds each dot's multiplicands to bf16 (to nearest even) and keeps
everything else float32. Products of bf16 values are exact in float32, so
the port's plain version and JAX's kernel differ only in their float32 sum
order; a later stage then rounds its float32 input to bf16, and where the
two sums straddle a rounding boundary the two sides round one value to
neighbouring bf16 numbers (a flip), which the next stages carry on. The
criterion, stated once (``_hold``; ``chip_smoke.py`` holds the kernels on
the card by the same): the mean difference within ``TOL_MEAN`` = 1e-6 of the
range and the largest, a few flips' tail, within ``TOL_MAX`` = 5e-5 (a flip
moves a few outputs by a few 1e-6 at these weights; a layout fault moves
them by the order of the range), while the port's float32 forward lies
beyond ``TOL_MEAN`` from JAX's mode on the mean (the rounding is live: 5e-6
of the range and more). The weights are drawn at 0.01 (the generator's
init scale 0.1 gives std ~0.006): at JAX's test scale 0.05 each conv of a
dense block amplifies, and a flip in the first block of an RRDB spreads over
most of the third's outputs.

Gradients in the mode are those of the float32 plain version, on both sides
(JAX's custom VJPs differentiate the float32 reference; the port's wrappers
go through ``ops._autograd.kernel_with_plain_grad`` on the CPU too): the
port's equal its float32 gradients bit for bit and JAX's within 1e-4, JAX's
own gradient tolerance (``tests/test_pallas_rdb.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.ops import pallas_rdb as jax_rdb
from deepbedmap_tpu.ops.pallas_conv import conv3x3_fused as jax_conv3x3_fused
from deepbedmap_tpu.ops.pallas_conv import conv3x3_res_fused as jax_conv3x3_res_fused
from deepbedmap_tpu_torch.ops.conv import round_bf16
from deepbedmap_tpu_torch.ops.conv3x3 import (
    BF16_SLOT_CHANNELS,
    conv3x3_fused,
    pack_conv_weight,
)
from deepbedmap_tpu_torch.ops.rdb import (
    pack_rdb_weights,
    pack_rdb_weights_tc,
    pack_rrdb_weights,
    pack_rrdb_weights_tc,
    rdb_banded,
    rdb_fused,
    rdb_reference,
    rrdb_fused,
    rrdb_reference,
    rrdb_sweep,
)
from tests.torch_port_emulation import (
    ADD,
    ADD_LRELU,
    LINEAR,
    LRELU,
    TC_HALO_H,
    TC_HALO_W,
    bf16_a_fragments,
    bf16_b_operand,
    bf16_bits,
    bf16_rn,
    emulate_k1_tc,
    emulate_k4_tc,
    emulate_k5,
    emulate_k6,
    emulate_tc_stage,
    emulate_tc_stage_bf16,
)

F, G = 64, 32
TOL_MAX, TOL_MEAN = 5e-5, 1e-6
TOL_GRAD = 1e-4
SCALING = 0.2  # JAX's tests' residual scaling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block(seed, scale=0.01):
    """One dense block's HWIO kernels and biases."""
    rs = np.random.RandomState(seed)
    ks, bs = [], []
    for ci, co in zip([F, F + G, F + 2 * G, F + 3 * G, F + 4 * G], [G, G, G, G, F]):
        ks.append(rs.randn(3, 3, ci, co).astype(np.float32) * scale)
        bs.append(rs.randn(co).astype(np.float32) * 0.1)
    return ks, bs


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _hold(label, got, want, fp32):
    """The module docstring's criterion; ``fp32`` is the port's float32
    result on the same inputs."""
    got, want, fp32 = (np.asarray(a, np.float64) for a in (got, want, fp32))
    scale = np.abs(want).max()
    d, d32 = np.abs(got - want), np.abs(fp32 - want)
    print(f"{label}: max {d.max() / scale:.3e}, mean {d.mean() / scale:.3e} of the range "
          f"{scale:.3e}; float32 port: max {d32.max() / scale:.3e}, mean "
          f"{d32.mean() / scale:.3e}")
    assert d.max() <= TOL_MAX * scale and d.mean() <= TOL_MEAN * scale, label
    assert d32.mean() > TOL_MEAN * scale, label


def _emulated_k10(x, wt, b, leaky, r, grid=3):
    """``conv3x3_tc.cuh``'s bf16 route for K10, emulated: (N, H, W, 64)."""
    n, h, w, c = x.shape
    out = np.empty(n * h * w * 64, np.float32)
    mode = (LRELU if leaky else LINEAR) if r is None else (ADD_LRELU if leaky else ADD)
    emulate_tc_stage_bf16(np.ascontiguousarray(x, np.float32).reshape(-1), c, c,
                          bf16_bits(pack_conv_weight(wt, True)), b, n, h, w, 64, mode, out, 64,
                          None if r is None else r.reshape(-1), 64, grid=grid)
    return out.reshape(n, h, w, 64)


def _close_grads(label, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=f"{label}: gradient {i}")


# (JAX entry, the port's wrapper, blocks, shape, band)
DENSE = {
    "K1": ("rdb_fused_flat", rdb_fused, 1, (1, 13, 14, F), 4),
    "K6": ("rdb_fused", rdb_banded, 1, (1, 13, 14, F), 4),
    "K4": ("rrdb_fused_flat", rrdb_fused, 3, (1, 13, 14, F), 4),
    "K5": ("rrdb_sweep_flat", rrdb_sweep, 3, (2, 22, 14, F), 8),
}
# each kernel's packer and the emulation of its bf16 route
ROUTES = {
    "K1": (pack_rdb_weights, emulate_k1_tc),
    "K4": (pack_rrdb_weights, emulate_k4_tc),
    "K6": (pack_rdb_weights_tc, emulate_k6),
    "K5": (pack_rrdb_weights_tc, emulate_k5),
}


@pytest.mark.parametrize("kernel", list(DENSE))
def test_dense_block_kernels_match_jax_in_the_mode(kernel):
    # JAX's custom-VJP entry of the kernel, interpreted with mxu_bf16=True:
    # one call gives the forward and, through its VJP, the gradients of
    # sum(out * g) in x, the kernels and the biases
    entry, wrapper, blocks, shape, band = DENSE[kernel]
    n, h, w, _ = shape
    sets = [_block(seed=40 + i) for i in range(blocks)]
    rs = np.random.RandomState(7)
    x = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    jk = [[jnp.asarray(k) for k in s[0]] for s in sets]
    jb = [[jnp.asarray(b) for b in s[1]] for s in sets]
    if blocks == 1:
        jk, jb = jk[0], jb[0]
    fn = getattr(jax_rdb, entry)

    def jax_out(x, ks, bs):
        if entry == "rdb_fused":
            return fn(x, ks, bs, SCALING, band, True)
        flat = fn(jax_rdb.flatten_rdb(x, band=band), ks, bs, SCALING, h, w, band, True)
        return jax_rdb.unflatten_rdb(flat, h, w, band=band, features=F)

    def loss(x, ks, bs):
        out = jax_out(x, ks, bs)
        return jnp.sum(out * g), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jk, jb)
    jgrads = [jgrads[0]] + jax.tree_util.tree_leaves(jgrads[1:])

    tk = [[_oihw(k).requires_grad_() for k in s[0]] for s in sets]
    tb = [[torch.from_numpy(b).requires_grad_() for b in s[1]] for s in sets]
    args = (tk[0], tb[0]) if blocks == 1 else (tk, tb)
    leaves = [t for b in tk for t in b] + [t for b in tb for t in b]
    grads = {}
    for mxu in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        out = wrapper(xt, *args, SCALING, mxu_bf16=mxu)
        grads[mxu] = torch.autograd.grad((out * torch.from_numpy(g)).sum(), [xt] + leaves)
        if mxu:
            got = out.detach().numpy()
        else:
            fp32 = out.detach().numpy()
    _hold(f"{kernel} ({entry}) {shape}", got, np.asarray(want), fp32)
    # the CUDA kernel's bf16 route (conv3x3_tc.cuh's for K1/K4, rdb_tile.cuh's
    # for K6/K5), emulated, against JAX's kernel in the mode
    pack, emulate = ROUTES[kernel]
    w16, b16 = pack(*args, True)
    _hold(f"emulated {kernel} bf16 route vs {entry}",
          emulate(x, w16, b16.numpy(), SCALING, bf16=True), np.asarray(want), fp32)
    # the mode's gradient is the float32 plain version's, on both sides
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
    # x, then the kernels block by block, then the biases, as JAX's leaves
    ours = [t.permute(2, 3, 1, 0) if t.dim() == 4 and i else t
            for i, t in enumerate(grads[True])]
    _close_grads(kernel, [t.numpy() for t in ours], jgrads)


@pytest.mark.parametrize("c_in,residual", [(64, True), (128, False)])
def test_k10_matches_jax_in_the_mode(c_in, residual):
    rs = np.random.RandomState(c_in)
    x = rs.randn(1, 13, 14, c_in).astype(np.float32)
    k = rs.randn(3, 3, c_in, 64).astype(np.float32) * 0.05
    b = rs.randn(64).astype(np.float32) * 0.1
    r = rs.randn(1, 13, 14, 64).astype(np.float32) if residual else None
    g = rs.randn(1, 13, 14, 64).astype(np.float32)

    def loss(*a):
        out = (jax_conv3x3_res_fused(*a, True, True) if residual
               else jax_conv3x3_fused(*a, True, True))
        return jnp.sum(out * g), out

    jargs = [jnp.asarray(a) for a in (x, k, b, r) if a is not None]
    (_, want), jgrads = jax.value_and_grad(loss, argnums=tuple(range(len(jargs))),
                                           has_aux=True)(*jargs)
    grads = {}
    for mxu in (True, False):
        ts = [torch.from_numpy(x).requires_grad_(), _oihw(k).requires_grad_(),
              torch.from_numpy(b).requires_grad_(),
              None if r is None else torch.from_numpy(r).requires_grad_()]
        out = conv3x3_fused(ts[0], ts[1], ts[2], True, ts[3], mxu_bf16=mxu)
        grads[mxu] = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                         [t for t in ts if t is not None])
        if mxu:
            got = out.detach().numpy()
        else:
            fp32 = out.detach().numpy()
    _hold(f"K10 C_in {c_in}, residual {residual}", got, np.asarray(want), fp32)
    _hold(f"emulated K10 bf16 route vs JAX, C_in {c_in}, residual {residual}",
          _emulated_k10(x, _oihw(k), b, True, r), np.asarray(want), fp32)
    for a, b_ in zip(grads[True], grads[False]):
        assert torch.equal(a, b_)
    ours = [t.numpy() for t in grads[True]]
    ours[1] = ours[1].transpose(2, 3, 1, 0)
    _close_grads("K10", ours, jgrads)


@pytest.mark.parametrize(
    "bits_in,rne,rna",
    [
        (0x3F808000, 0x3F800000, 0x3F810000),  # tie, even bf16 mantissa: RNE keeps it
        (0x3F818000, 0x3F820000, 0x3F820000),  # tie, odd mantissa: both go up
        (0xBF808000, 0xBF800000, 0xBF810000),  # the same, negative
        (0x3F807FFF, 0x3F800000, 0x3F800000),  # just below the tie
        (0x3F808001, 0x3F810000, 0x3F810000),  # just above the tie
        (0x3FFF8000, 0x40000000, 0x40000000),  # carries into the exponent: 2.0
    ],
)
def test_bf16_rounding_is_round_to_nearest_even(bits_in, rne, rna):
    # the kernels' cvt.rn.bf16x2.f32 (emulated by bf16_rn) and the plain
    # versions' .to(torch.bfloat16) round ties to even, as XLA's astype; the
    # TF32 split's ties-away rounding (cvt.rna) at bf16's width would land
    # an ulp off on ties
    a = np.array([bits_in], np.uint32).view(np.float32)
    assert bf16_rn(a).view(np.uint32)[0] == rne
    assert round_bf16(torch.from_numpy(a)).numpy().view(np.uint32)[0] == rne
    away = ((a.view(np.uint32) + np.uint32(0x8000)) & np.uint32(0xFFFF0000))
    assert away[0] == rna
    # random values: the emulation is torch's rounding bit for bit
    v = np.random.RandomState(bits_in % 1000).randn(4096).astype(np.float32) * 100
    np.testing.assert_array_equal(bf16_rn(v), round_bf16(torch.from_numpy(v)).numpy())


@pytest.mark.parametrize("kernel,shape", [
    pytest.param("K1", (2, 13, 19, F), id="K1"),
    pytest.param("K4", (2, 13, 19, F), id="K4"),
    pytest.param("K6", (2, 13, 19, F), id="K6"),
    pytest.param("K5", (2, 13, 19, F), id="K5"),
    # narrower than a tile and not a multiple of the 8-row band
    pytest.param("K6", (2, 13, 9, F), id="K6-ragged"),
    pytest.param("K5", (2, 13, 9, F), id="K5-ragged"),
])
def test_emulated_bf16_route_matches_the_rounded_plain_version(kernel, shape):
    # the CUDA kernels' bf16 routes step for step: conv3x3_tc.cuh's for
    # K1/K4/K10 (bf16 weights as packed, the halo rounded once per chunk,
    # bf16 k16 products), rdb_tile.cuh's for K6/K5 (bf16 weights as packed,
    # x rounded once per tile, a1..a4 stored in bf16, bf16 k16 products);
    # the same criterion against the rounded plain version as the port
    # against JAX (sums in float64 here, float32 there)
    blocks = 3 if kernel in ("K4", "K5") else 1
    sets = [_block(seed=61)] if blocks == 1 else [_block(seed=64 + i) for i in range(3)]
    tk = [[_oihw(k) for k in s_[0]] for s_ in sets]
    tb = [[torch.from_numpy(b) for b in s_[1]] for s_ in sets]
    if blocks == 1:
        tk, tb = tk[0], tb[0]
    x = np.random.RandomState(62).randn(*shape).astype(np.float32)
    pack, emulate = ROUTES[kernel]
    w, b = pack(tk, tb, mxu_bf16=True)
    got = emulate(x, w, b.numpy(), SCALING, bf16=True)
    fp32 = emulate(x, *[t.numpy() for t in pack(tk, tb)], SCALING)
    plain = rrdb_reference if blocks == 3 else rdb_reference
    want = plain(torch.from_numpy(x), tk, tb, SCALING, mxu_bf16=True).numpy()
    _hold(f"emulated {kernel} bf16 route {shape}", got, want, fp32)


def test_emulated_tile_bf16_route_with_16_channel_units():
    # rdb_tile.cuh's bf16 route with kBfSteps 1 (chip_tile_variants.py's
    # "unit16"): one k16 step a unit, a 3-slot ring two units ahead, one x
    # plane landed per unit; the same answer as the shipped 32-channel units,
    # bit for bit (products exact, sums float64)
    ks, bs = _block(seed=67)
    tk, tb = [_oihw(k) for k in ks], [torch.from_numpy(b) for b in bs]
    x = np.random.RandomState(68).randn(1, 13, 19, F).astype(np.float32)
    w, b = pack_rdb_weights_tc(tk, tb, mxu_bf16=True)
    got = emulate_k6(x, w, b.numpy(), SCALING, bf16=True, unit_steps=1)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, emulate_k6(x, w, b.numpy(), SCALING, bf16=True))


@pytest.mark.parametrize("blocks", [1, 3])
def test_tile_bf16_pack_is_the_b_descriptor_layout(blocks):
    # pack_rdb_weights_tc / pack_rrdb_weights_tc with mxu_bf16: bf16, the
    # bytes of K1's pack (pack_rdb_weights(mxu_bf16=True)), and read back as
    # rdb_tile.cuh's bf16 route reads it (per stage and k16 step a unit of
    # nine taps' descriptors; stage 5's two N halves 512 values apart) the
    # bf16-rounded weights, block after block
    sets = [_block(seed=69 + i, scale=1.0) for i in range(blocks)]
    tk = [[_oihw(k) for k in s_[0]] for s_ in sets]
    tb = [[torch.from_numpy(b) for b in s_[1]] for s_ in sets]
    if blocks == 1:
        w, b = pack_rdb_weights_tc(tk[0], tb[0], mxu_bf16=True)
        w1, b1 = pack_rdb_weights(tk[0], tb[0], mxu_bf16=True)
    else:
        w, b = pack_rrdb_weights_tc(tk, tb, mxu_bf16=True)
        w1, b1 = pack_rrdb_weights(tk, tb, mxu_bf16=True)
    per_block = sum(k.numel() for k in tk[0])
    assert w.dtype == torch.bfloat16 and w.shape == (blocks * per_block,)
    assert torch.equal(w.view(torch.int16), w1.view(torch.int16)) and torch.equal(b, b1)
    bits, off = bf16_bits(w), 0
    for ks in tk:
        for wt in ks:
            cout, cin = wt.shape[:2]
            rounded = round_bf16(wt).double().numpy()
            unit = 16 * 9 * cout
            for c16 in range(cin // 16):
                for tap in range(9):
                    for half in range(cout // 32):
                        got = bf16_b_operand(bits[off + c16 * unit:], 0, tap, cout, n=32,
                                             start=512 * half)
                        want = rounded[32 * half:32 * (half + 1),
                                       16 * c16 + np.asarray(BF16_SLOT_CHANNELS),
                                       tap // 3, tap % 3].T
                        np.testing.assert_array_equal(got, want)
            off += cin * unit // 16
    assert off == blocks * per_block


def test_emulated_k10_bf16_route_matches_the_rounded_plain_version():
    # both of K10's C_in, with LeakyReLU and with the residual, at a shape
    # that leaves both tile edges ragged
    rs = np.random.RandomState(63)
    for c, leaky, residual in ((128, True, False), (64, False, True)):
        x = rs.randn(2, 13, 19, c).astype(np.float32)
        k = rs.randn(3, 3, c, 64).astype(np.float32) * 0.05
        b = rs.randn(64).astype(np.float32) * 0.1
        r = rs.randn(2, 13, 19, 64).astype(np.float32) if residual else None
        wt = _oihw(k)
        n, h, w, _ = x.shape
        fp32 = np.empty(n * h * w * 64, np.float32)
        emulate_tc_stage(x.reshape(-1), c, c, pack_conv_weight(wt).numpy(), b, n, h, w, 64,
                         LRELU if leaky else ADD, fp32, 64,
                         None if r is None else r.reshape(-1), 64)
        want = conv3x3_fused(torch.from_numpy(x), wt, torch.from_numpy(b), leaky,
                             None if r is None else torch.from_numpy(r), mxu_bf16=True).numpy()
        _hold(f"emulated K10 bf16 route, C_in {c}", _emulated_k10(x, wt, b, leaky, r), want,
              fp32.reshape(n, h, w, 64))


@pytest.mark.parametrize("grid", [1, 4, 132])
def test_emulated_bf16_route_walks_every_tile_once(grid):
    # conv3x3_tc.cuh's persistent blocks at the ragged shape (3, 37, 9): 9
    # tiles walked by one block, by four (three tiles for the first, two for
    # the others) and by as many as the card has SMs (one each); the rings
    # start poisoned with NaN, so a slot read before its copy lands, or a
    # tile that no block stores, shows in the output
    ks, bs = _block(seed=65)
    tk, tb = [_oihw(k) for k in ks], [torch.from_numpy(b) for b in bs]
    x = np.random.RandomState(66).randn(3, 37, 9, F).astype(np.float32)
    n, h, w, _ = x.shape
    w16, b16 = pack_rdb_weights(tk, tb, mxu_bf16=True)
    bits, b16 = bf16_bits(w16), b16.numpy()
    ws = np.zeros((n * h * w, 192), np.float32)
    ws[:, :F] = x.reshape(-1, F)
    ws = ws.reshape(-1)
    out = np.full(n * h * w * G, np.nan, np.float32)
    # stage 1 of the dense block, as K1's first launch
    emulate_tc_stage_bf16(ws, 192, F, bits, b16, n, h, w, G, LRELU, out, G, grid=grid)
    assert not np.isnan(out).any()
    got = out.reshape(n, h, w, G)
    want = torch.nn.functional.leaky_relu(
        torch.nn.functional.conv2d(round_bf16(torch.from_numpy(x)).permute(0, 3, 1, 2),
                                   round_bf16(tk[0]), torch.from_numpy(bs[0]), padding=1),
        0.2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("c_out", [32, 64])
def test_bf16_weight_pack_is_the_b_descriptor_layout(c_out):
    # pack_conv_weight(mxu_bf16=True) read back through the wgmma B
    # descriptor (core matrices 128 B apart along K, 256 B along N) gives,
    # for every 16 input channels and tap, the bf16-rounded weight with k
    # slot s holding channel BF16_SLOT_CHANNELS[s]
    c_in = 96
    wt = torch.from_numpy(np.random.RandomState(c_out).randn(c_out, c_in, 3, 3)
                          .astype(np.float32))
    packed = pack_conv_weight(wt, True)
    assert packed.dtype == torch.bfloat16 and packed.numel() == wt.numel()
    bits, rounded = bf16_bits(packed), round_bf16(wt).double().numpy()
    chunk = 16 * 9 * c_out
    for c16 in range(c_in // 16):
        for tap in range(9):
            b = bf16_b_operand(bits[c16 * chunk:], 0, tap, c_out)  # (16 slots, C_out)
            want = rounded[:, 16 * c16 + np.asarray(BF16_SLOT_CHANNELS), tap // 3, tap % 3].T
            np.testing.assert_array_equal(b, want)
    # the slot order: a lane's four k slots 2t, 2t + 1, 2t + 8, 2t + 9 are
    # the adjacent channels 4t..4t + 3, every channel once
    assert sorted(BF16_SLOT_CHANNELS) == list(range(16))
    for t in range(4):
        assert [BF16_SLOT_CHANNELS[k] for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)] == [
            4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3]


def test_k16_a_fragments_read_the_tap_shifted_pixels_and_slot_channels():
    # the lanes' 8-byte loads of the rounded halo ([k16 step][pixel][16]),
    # put where the wgmma A fragment layout puts registers, give each warp
    # (tile row) the 16 pixels of its row shifted by the tap, with k slot s
    # holding channel BF16_SLOT_CHANNELS[s] of the step's 16: checked with a
    # halo that holds its halo row, its column, or its channel (all exact in
    # bf16)
    hpix = TC_HALO_W * TC_HALO_H
    p, ch = np.meshgrid(np.arange(2 * hpix) % hpix, np.arange(16), indexing="ij")
    step = np.repeat([0, 1], hpix)[:, None] + 0 * ch
    rows, pix = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    for name, value in (("halo row", p // TC_HALO_W), ("halo column", p % TC_HALO_W),
                        ("channel", ch + 16 * step)):
        halo = (bf16_rn(value.astype(np.float32)).view(np.uint32) >> 16).astype(np.uint16)
        for k in range(2):
            for tap in range(9):
                a = bf16_a_fragments(halo.reshape(-1), k, tap)
                want = {"halo row": (rows + tap // 3)[..., None] + 0 * a,
                        "halo column": (pix + tap % 3)[..., None] + 0 * a,
                        "channel": 16 * k + np.asarray(BF16_SLOT_CHANNELS) + 0 * a}[name]
                np.testing.assert_array_equal(a, want, err_msg=f"{name}, step {k}, tap {tap}")

"""PyTorch port: the bf16-multiplicand mode (``mxu_bf16``) of K1, K4, K5, K6
and K10 against the JAX package's Pallas kernels in the mode (interpret
mode, JAX's own test sizes: 13 x 14 px, band 4; K5 needs a band of at least
its margin, 8, on 22 x 14 px), and the bf16 route of the CUDA kernels as a
numpy emulation (``tests/torch_port_emulation.py``).

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
from deepbedmap_tpu_torch.ops.conv3x3 import conv3x3_fused, pack_conv_weight
from deepbedmap_tpu_torch.ops.rdb import (
    pack_rdb_weights,
    pack_rdb_weights_tc,
    rdb_banded,
    rdb_fused,
    rdb_reference,
    rrdb_fused,
    rrdb_sweep,
)
from tests.torch_port_emulation import (
    LRELU,
    bf16_rn,
    emulate_k1_tc,
    emulate_k6,
    emulate_tc_stage,
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


def _rounded_plain(x, tk, tb):
    return rdb_reference(torch.from_numpy(x), tk, tb, SCALING, mxu_bf16=True).numpy()


@pytest.mark.parametrize("kernel", ["K1", "K6"])
def test_emulated_bf16_route_matches_the_rounded_plain_version(kernel):
    # the CUDA kernels' bf16 route step for step (conv3x3_tc.cuh for K1/K4/
    # K10, rdb_tile.cuh for K6/K5): the packers' rounded weights, A rounded
    # at each dot, one pass; the same criterion against the rounded plain
    # version as the port against JAX (sums in float64 here, float32 there)
    ks, bs = _block(seed=61)
    tk, tb = [_oihw(k) for k in ks], [torch.from_numpy(b) for b in bs]
    x = np.random.RandomState(62).randn(2, 13, 19, F).astype(np.float32)
    if kernel == "K1":
        w, b = pack_rdb_weights(tk, tb, mxu_bf16=True)
        got = emulate_k1_tc(x, w.numpy(), b.numpy(), SCALING, bf16=True)
        fp32 = emulate_k1_tc(x, *[t.numpy() for t in pack_rdb_weights(tk, tb)], SCALING)
    else:
        w, b = pack_rdb_weights_tc(tk, tb, mxu_bf16=True)
        got = emulate_k6(x, w.numpy(), b.numpy(), SCALING, bf16=True)
        fp32 = emulate_k6(x, *[t.numpy() for t in pack_rdb_weights_tc(tk, tb)], SCALING)
    _hold(f"emulated {kernel} bf16 route", got, _rounded_plain(x, tk, tb), fp32)


def test_emulated_k10_bf16_route_matches_the_rounded_plain_version():
    rs = np.random.RandomState(63)
    x = rs.randn(2, 13, 19, 128).astype(np.float32)
    k = rs.randn(3, 3, 128, 64).astype(np.float32) * 0.05
    b = rs.randn(64).astype(np.float32) * 0.1
    wt = _oihw(k)
    n, h, w, c = x.shape
    outs = {}
    for mxu in (True, False):
        out = np.empty(n * h * w * 64, np.float32)
        emulate_tc_stage(x.reshape(-1), c, c, pack_conv_weight(wt, mxu).numpy(), b, n, h, w,
                         64, LRELU, out, 64, bf16=mxu)
        outs[mxu] = out.reshape(n, h, w, 64)
    want = conv3x3_fused(torch.from_numpy(x), wt, torch.from_numpy(b), True,
                         mxu_bf16=True).numpy()
    _hold("emulated K10 bf16 route", outs[True], want, outs[False])

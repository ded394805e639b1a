"""PyTorch port: the whole residual-in-residual dense block (K4's plain
version and wrapper) against the JAX package's Pallas kernel
``rrdb_pallas_flat`` (interpret mode) and its XLA composition.

The CUDA kernel only runs on the card (``chip_smoke.py``); here a numpy
emulation of its launch sequence — two workspaces in ping-pong, stage 5
writing the next block's input, the outer skip folded into the last
epilogue — is held against the plain version too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_rdb import (
    flatten_rdb,
    rdb_reference as jax_rdb_reference,
    rrdb_pallas_flat,
    unflatten_rdb,
)
from deepbedmap_tpu_torch.ops.rdb import pack_rrdb_weights, rrdb_fused, rrdb_reference

F, G = 64, 32


def _params(seed, scale=0.05):
    """Three blocks of HWIO kernels and biases, as tests/test_pallas_rdb.py
    draws them."""
    kernels, biases = [], []
    for p in range(3):
        rs = np.random.RandomState(seed + p)
        ks, bs = [], []
        for ci, co in zip([F, F + G, F + 2 * G, F + 3 * G, F + 4 * G], [G, G, G, G, F]):
            ks.append(rs.randn(3, 3, ci, co).astype(np.float32) * scale)
            bs.append(rs.randn(co).astype(np.float32) * 0.1)
        kernels.append(ks)
        biases.append(bs)
    return kernels, biases


def _to_port(kernels, biases):
    return (
        [[torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in ks] for ks in kernels],
        [[torch.from_numpy(b) for b in bs] for bs in biases],
    )


def test_rrdb_matches_jax_pallas_and_composition():
    # fp32 on both sides through 15 chained convs in another summation order;
    # rtol 1e-5, atol 2e-5, as tests/test_pallas_rdb.py holds the JAX kernel
    # to the XLA composition
    rs = np.random.RandomState(21)
    x = rs.randn(2, 13, 14, F).astype(np.float32)
    kernels, biases = _params(seed=30)
    jk = [[jnp.asarray(k) for k in ks] for ks in kernels]
    jb = [[jnp.asarray(b) for b in bs] for bs in biases]
    jax_flat = rrdb_pallas_flat(
        flatten_rdb(jnp.asarray(x), band=4), jk, jb, 0.2, h=13, w=14, band=4,
        interpret=True,
    )
    jax_kernel = np.asarray(unflatten_rdb(jax_flat, 13, 14, band=4, features=F))
    a = jnp.asarray(x)
    for ks, bs in zip(jk, jb):
        a = jax_rdb_reference(a, ks, bs, 0.2)
    jax_plain = np.asarray(jnp.asarray(x) + 0.2 * a)

    tk, tb = _to_port(kernels, biases)
    xt = torch.from_numpy(x)
    ours_ref = rrdb_reference(xt, tk, tb, 0.2).numpy()
    ours_wrapper = rrdb_fused(xt, tk, tb, 0.2).numpy()
    assert ours_wrapper.shape == x.shape
    for ours in (ours_ref, ours_wrapper):
        np.testing.assert_allclose(ours, jax_kernel, rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(ours, jax_plain, rtol=1e-5, atol=2e-5)


def _stage(ws, cin, cout, w_flat, bias):
    """One direct-conv launch: the first ``cin`` workspace channels -> cout."""
    n, h, w, _ = ws.shape
    wmat = w_flat.reshape(cout // 32, cin, 9, 32).transpose(1, 2, 0, 3).reshape(cin, 9, cout)
    src = np.pad(ws[..., :cin], ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((n, h, w, cout))
    for t in range(9):
        ky, kx = divmod(t, 3)
        acc += src[:, ky : ky + h, kx : kx + w] @ wmat[:, t]
    return acc + bias


def _emulate_k4(x, w_packed, b_packed, s):
    """csrc/rdb.cu rrdb_forward in float64: x into workspace A, stages 1-4 of
    each block write 32 channels after the block input, stage 5 of blocks 1
    and 2 writes a + s * v into channels 0-63 of the other workspace, stage 5
    of block 3 writes x + s * (a + s * v)."""
    n, h, w, _ = x.shape
    cur = np.zeros((n, h, w, F + 4 * G))
    nxt = np.zeros_like(cur)
    cur[..., :F] = x
    wo = bo = 0
    for p in range(3):
        for j in range(5):
            cin, cout = F + G * j, G if j < 4 else F
            v = _stage(cur, cin, cout, w_packed[wo : wo + 9 * cin * cout],
                       b_packed[bo : bo + cout])
            wo += 9 * cin * cout
            bo += cout
            if j < 4:
                cur[..., cin : cin + G] = np.where(v >= 0, v, 0.2 * v)
            elif p < 2:
                nxt[..., :F] = cur[..., :F] + s * v
                cur, nxt = nxt, cur
            else:
                return x + s * (cur[..., :F] + s * v)
    raise AssertionError("unreachable")


def test_k4_ping_pong_algorithm_matches_plain_version():
    # float64 emulation vs the fp32 plain version: fp32 round-off only
    rs = np.random.RandomState(6)
    kernels, biases = _params(seed=40)
    tk, tb = _to_port(kernels, biases)
    w_packed, b_packed = pack_rrdb_weights(tk, tb)
    block = sum(9 * (F + G * j) * (G if j < 4 else F) for j in range(5))
    assert w_packed.shape == (3 * block,) and b_packed.shape == (3 * (F + 4 * G),)
    x = rs.randn(2, 6, 9, F).astype(np.float32)
    emulated = _emulate_k4(x, w_packed.numpy(), b_packed.numpy(), 0.2)
    plain = rrdb_reference(torch.from_numpy(x), tk, tb, 0.2).numpy()
    np.testing.assert_allclose(emulated, plain, rtol=1e-5, atol=1e-5)


def test_rrdb_fused_refuses_other_devices():
    tk, tb = _to_port(*_params(seed=0))
    with pytest.raises(ValueError):
        rrdb_fused(torch.zeros((1, 4, 4, F), device="meta"), tk, tb, 0.2)

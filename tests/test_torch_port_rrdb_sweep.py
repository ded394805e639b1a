"""PyTorch port: the single-sweep RRDB ``rrdb_sweep`` (K5's plain version and
wrapper) against the JAX package's Pallas kernel ``rrdb_sweep_pallas_flat``
(interpret mode), the kernel the JAX generator runs with ``rrdb_sweep=True``.

The CUDA kernel only runs on the card (``chip_smoke.py``); here a numpy
emulation of its wavefront schedule (``tests/torch_port_emulation.py``: RDB2
and RDB3 two bands behind the block before them, the block outputs in 4-slot
band rings that start as NaN, rows outside the image read as zero) is held
against the plain version too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_rdb import (
    flatten_rdb,
    rrdb_sweep_pallas_flat,
    unflatten_rdb,
)
from deepbedmap_tpu_torch.ops.rdb import pack_rrdb_weights_tc, rrdb_reference, rrdb_sweep
from tests.torch_port_emulation import emulate_k5

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


def test_rrdb_sweep_matches_jax_sweep_kernel():
    # the shape of tests/test_pallas_rdb.py's sweep test: 22 rows in bands of
    # 8 (the last one short), batch 2; fp32 on both sides in another
    # summation order through three dense blocks -> 1e-5
    rs = np.random.RandomState(23)
    x = rs.randn(2, 22, 14, F).astype(np.float32)
    kernels, biases = _params(seed=50)
    jk = [[jnp.asarray(k) for k in ks] for ks in kernels]
    jb = [[jnp.asarray(b) for b in bs] for bs in biases]
    flat = rrdb_sweep_pallas_flat(flatten_rdb(jnp.asarray(x), 8), jk, jb, 0.2,
                                  h=22, w=14, band=8)
    want = np.asarray(unflatten_rdb(flat, 22, 14, band=8, features=F))
    tk, tb = _to_port(kernels, biases)
    got = rrdb_sweep(torch.from_numpy(x), tk, tb, 0.2).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 22, 14, F), (1, 5, 9, F), (1, 40, 8, F)])
def test_k5_sweep_schedule_matches_plain_version(shape):
    # float64 emulation vs the fp32 plain version: fp32 round-off only. One
    # band (the whole sweep is prologue and epilogue), three bands, and five
    # full bands, more than the rings have slots
    rs = np.random.RandomState(31)
    kernels, biases = _params(seed=60)
    tk, tb = _to_port(kernels, biases)
    w_packed, b_packed = pack_rrdb_weights_tc(tk, tb)
    x = rs.randn(*shape).astype(np.float32)
    emulated = emulate_k5(x, w_packed.numpy(), b_packed.numpy(), 0.2)
    plain = rrdb_reference(torch.from_numpy(x), tk, tb, 0.2).numpy()
    np.testing.assert_allclose(emulated, plain, rtol=1e-5, atol=1e-5)


def test_rrdb_sweep_refuses_other_devices():
    tk, tb = _to_port(*_params(seed=0))
    with pytest.raises(ValueError):
        rrdb_sweep(torch.zeros((1, 4, 4, F), device="meta"), tk, tb, 0.2)

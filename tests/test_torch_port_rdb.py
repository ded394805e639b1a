"""PyTorch port: the residual dense block (K1's plain version and wrapper)
against the JAX package's Pallas kernel (interpret mode) and its oracle.

The CUDA kernel itself only runs on the card (``chip_smoke.py``); here a
numpy emulation of its stage-by-stage algorithm — the dense workspace and the
packed weight layout it reads — is held against the plain version too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_rdb import (
    flatten_rdb,
    rdb_pallas_flat,
    rdb_reference as jax_rdb_reference,
    unflatten_rdb,
)
from deepbedmap_tpu_torch.ops.rdb import pack_rdb_weights, rdb_fused, rdb_reference

F, G = 64, 32


def _params(seed=0, scale=0.05):
    """HWIO kernels and biases, as tests/test_pallas_rdb.py draws them."""
    rs = np.random.RandomState(seed)
    kernels, biases = [], []
    for ci, co in zip([F, F + G, F + 2 * G, F + 3 * G, F + 4 * G], [G, G, G, G, F]):
        kernels.append(rs.randn(3, 3, ci, co).astype(np.float32) * scale)
        biases.append(rs.randn(co).astype(np.float32) * 0.1)
    return kernels, biases


def _to_port(kernels, biases):
    return (
        [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in kernels],
        [torch.from_numpy(b) for b in biases],
    )


@pytest.mark.parametrize(
    "shape,band",
    [
        ((1, 13, 14, F), 4),  # H not divisible by band, odd W
        ((2, 16, 6, F), 8),  # batch > 1, tiny W
    ],
)
def test_rdb_matches_jax_pallas_and_reference(shape, band):
    # fp32 on both sides, same math in another summation order -> 1e-5
    rs = np.random.RandomState(8)
    kernels, biases = _params(seed=8)
    x = rs.randn(*shape).astype(np.float32)
    n, h, w, _ = shape
    jk, jb = [jnp.asarray(k) for k in kernels], [jnp.asarray(b) for b in biases]
    jax_flat = rdb_pallas_flat(
        flatten_rdb(jnp.asarray(x), band=band), jk, jb, 0.2,
        h=h, w=w, band=band, interpret=True,
    )
    jax_kernel = np.asarray(unflatten_rdb(jax_flat, h, w, band=band, features=F))
    jax_ref = np.asarray(jax_rdb_reference(jnp.asarray(x), jk, jb, 0.2))

    tk, tb = _to_port(kernels, biases)
    xt = torch.from_numpy(x)
    ours_ref = rdb_reference(xt, tk, tb, 0.2).numpy()
    ours_wrapper = rdb_fused(xt, tk, tb, 0.2).numpy()
    assert ours_wrapper.shape == shape
    for ours in (ours_ref, ours_wrapper):
        np.testing.assert_allclose(ours, jax_kernel, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours, jax_ref, rtol=1e-5, atol=1e-5)


def _emulate_k1(x, w_packed, b_packed, scaling):
    """csrc/rdb.cu in numpy: x into workspace channels 0-63, stage j reads
    channels [0, 64+32j) of the zero-padded workspace with the packed
    [C_out/32][C_in][9][32] weights and writes 32 channels after them; stage
    5 writes out = x + s * (conv + b)."""
    n, h, w, _ = x.shape
    ws = np.zeros((n, h, w, F + 4 * G), np.float64)
    ws[..., :F] = x
    off = 0
    for j in range(5):
        cin, cout = F + G * j, G if j < 4 else F
        wp = w_packed[off : off + cin * 9 * cout].reshape(cout // 32, cin, 9, 32)
        off += cin * 9 * cout
        wmat = wp.transpose(1, 2, 0, 3).reshape(cin, 9, cout)  # [ci][t][co]
        src = np.pad(ws[..., :cin], ((0, 0), (1, 1), (1, 1), (0, 0)))
        acc = np.zeros((n, h, w, cout))
        for t in range(9):
            ky, kx = divmod(t, 3)
            acc += src[:, ky : ky + h, kx : kx + w] @ wmat[:, t]
        acc += b_packed[G * j : G * j + cout]
        if j < 4:
            ws[..., cin : cin + G] = np.where(acc >= 0, acc, 0.2 * acc)
        else:
            return x + scaling * acc
    raise AssertionError("unreachable")


def test_k1_packed_layout_and_workspace_algorithm():
    # float64 emulation vs the fp32 plain version: fp32 round-off only
    rs = np.random.RandomState(5)
    kernels, biases = _params(seed=5)
    tk, tb = _to_port(kernels, biases)
    w_packed, b_packed = pack_rdb_weights(tk, tb)
    assert w_packed.shape == (
        sum(9 * (F + G * j) * (G if j < 4 else F) for j in range(5)),
    )
    assert b_packed.shape == (4 * G + F,)
    x = rs.randn(2, 7, 9, F).astype(np.float32)
    emulated = _emulate_k1(x, w_packed.numpy(), b_packed.numpy(), 0.2)
    plain = rdb_reference(torch.from_numpy(x), tk, tb, 0.2).numpy()
    np.testing.assert_allclose(emulated, plain, rtol=1e-5, atol=1e-5)


def test_rdb_fused_refuses_other_devices():
    tk, tb = _to_port(*_params())
    x = torch.zeros((1, 4, 4, F), device="meta")
    with pytest.raises(ValueError):
        rdb_fused(x, tk, tb, 0.2)

"""PyTorch port: the non-resident trunk's dense block ``rdb_banded`` (K6's
plain version and wrapper) against the JAX package's Pallas kernel
``rdb_pallas`` (interpret mode), the kernel the JAX generator runs with
``rdb_resident="never"``.

The CUDA kernel only runs on the card (``chip_smoke.py``); here a numpy
emulation of its tile algorithm (``tests/torch_port_emulation.py``: 8 x 16
tiles, a 5-px input halo, the intermediates on shrinking windows and zero
outside the image, each stage a 3xTF32 product on the tensor cores) is held
against the plain version too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepbedmap_tpu.ops.pallas_rdb import rdb_pallas
from deepbedmap_tpu_torch.ops.rdb import pack_rdb_weights_tc, rdb_banded, rdb_reference
from tests.torch_port_emulation import emulate_k6

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
def test_rdb_banded_matches_jax_rdb_pallas(shape, band):
    # fp32 on both sides, same math in another summation order -> 1e-5, as
    # tests/test_pallas_rdb.py holds rdb_pallas to its XLA oracle
    rs = np.random.RandomState(9)
    kernels, biases = _params(seed=9)
    x = rs.randn(*shape).astype(np.float32)
    want = np.asarray(rdb_pallas(
        jnp.asarray(x), [jnp.asarray(k) for k in kernels],
        [jnp.asarray(b) for b in biases], 0.2, band=band, interpret=True,
    ))
    tk, tb = _to_port(kernels, biases)
    got = rdb_banded(torch.from_numpy(x), tk, tb, 0.2).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 13, 14, F), (2, 8, 19, F), (1, 3, 5, F)])
def test_k6_tile_algorithm_matches_plain_version(shape):
    # float64 emulation vs the fp32 plain version: fp32 round-off only. The
    # shapes cover ragged last tiles, exact 8-px tiles and an image smaller
    # than one tile, where every stage's window overhangs every edge
    rs = np.random.RandomState(11)
    kernels, biases = _params(seed=11)
    tk, tb = _to_port(kernels, biases)
    w_packed, b_packed = pack_rdb_weights_tc(tk, tb)
    x = rs.randn(*shape).astype(np.float32)
    emulated = emulate_k6(x, w_packed.numpy(), b_packed.numpy(), 0.2)
    plain = rdb_reference(torch.from_numpy(x), tk, tb, 0.2).numpy()
    np.testing.assert_allclose(emulated, plain, rtol=1e-5, atol=1e-5)


def test_rdb_banded_refuses_other_devices():
    tk, tb = _to_port(*_params())
    with pytest.raises(ValueError):
        rdb_banded(torch.zeros((1, 4, 4, F), device="meta"), tk, tb, 0.2)

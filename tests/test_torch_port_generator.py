"""PyTorch port: the whole generator on the CPU (the plain versions of its
kernels) with bridged weights against the JAX generator, in each ported
configuration, in float32 and, for the forced trunks, in the kernels'
bf16-multiplicand mode (``rdb_mxu_bf16`` at its default, on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.models.generator import Generator as JaxGenerator
from deepbedmap_tpu_torch.bridge import jax_params_to_state_dict
from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.models import Generator


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize(
    "flags,lr",
    [
        # JAX runs its K1 Pallas kernel (interpreted) on the resident trunk;
        # bf16 multiplicands off so both sides compute in fp32
        (dict(num_residual_blocks=2, rdb_resident="always", fused_rdb="always",
              rdb_mxu_bf16=False), 16),
        # the opt-in kernel configuration: JAX runs K4 (whole RRDB) and K10
        # (the four 3x3 convs) interpreted and the unfused deformable tail;
        # the port runs their plain versions and the two layers one at a time
        (dict(num_residual_blocks=2, rdb_resident="always", fused_rdb="always",
              rdb_mxu_bf16=False, rrdb_fused=True, fused_conv="always",
              tail_fused=False), 16),
        # the non-resident trunk: JAX runs K6 (rdb_pallas) interpreted for
        # each dense block; the port runs K6's plain version
        (dict(num_residual_blocks=2, rdb_resident="never", fused_rdb="always",
              rdb_mxu_bf16=False), 16),
        # one single-sweep launch per RRDB: JAX runs K5
        # (rrdb_sweep_pallas_flat) interpreted; the port K5's plain version
        (dict(num_residual_blocks=2, rrdb_sweep=True, rdb_resident="always",
              fused_rdb="always", rdb_mxu_bf16=False), 16),
        # the defaults: 12 RRDBs, the XLA trunk and tail on the CPU
        ({}, 11),
    ],
)
def test_generator_matches_jax(flags, lr):
    # weights drawn at init_scale=1.0 (init only; the forward is the same
    # config) so activations and offsets are O(1) and the tolerance bites:
    # at the default 0.1 the output is ~1e-6 and atol alone would pass it
    _, params = jax_build_generator(JaxGeneratorConfig(**flags, init_scale=1.0), lr=lr)
    rs = np.random.RandomState(42)
    xs = [rs.rand(1, lr, lr, 1), rs.rand(1, 10 * lr, 10 * lr, 1),
          rs.rand(1, 2 * lr, 2 * lr, 2), rs.rand(1, lr, lr, 1)]
    xs = [a.astype(np.float32) for a in xs]
    want = np.asarray(
        JaxGenerator(JaxGeneratorConfig(**flags)).apply(
            {"params": params}, *map(jnp.asarray, xs)
        )
    )
    model = Generator(GeneratorConfig(**flags))
    model.load_state_dict(
        jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    )
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, xs)).numpy()
    out = 4 * (lr - 2)
    assert got.shape == want.shape == (1, out, out, 1)
    scale = np.abs(want).max()
    assert scale > 0.5  # a meaningful scale for the tolerance
    # fp32 on both sides in another summation order through 2 or 12 RRDBs
    # and two deformable layers: rtol 1e-4 as tests/test_torch_parity.py:186,
    # atol 1e-5 of the output's range (outputs cancel to ~0 in places, and
    # the round-off there grows with depth: 3e-5 at 12 RRDBs on a range of 7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


# the forced trunks with rdb_mxu_bf16 at its default (on), as JAX's CPU run
# honours it: JAX runs each kernel interpreted with bf16 multiplicands, the
# port its rounded plain version (config.trunk_mxu_bf16); K10 with
# conv_mxu_bf16=True beside K4
MXU_FORCED = {
    "K1": dict(num_residual_blocks=2, rdb_resident="always", fused_rdb="always"),
    "K4+K10": dict(num_residual_blocks=2, rdb_resident="always", fused_rdb="always",
                   rrdb_fused=True, fused_conv="always", conv_mxu_bf16=True,
                   tail_fused=False),
    "K6": dict(num_residual_blocks=2, rdb_resident="never", fused_rdb="always"),
    "K5": dict(num_residual_blocks=2, rrdb_sweep=True, rdb_resident="always",
               fused_rdb="always"),
}
TOL_MXU = 2e-2  # JAX's own bf16 bound (tests/test_models.py:154-194)


@pytest.mark.parametrize("trunk", list(MXU_FORCED))
def test_forced_trunk_in_the_mode_matches_jax(trunk):
    # at init scale 1.0, 2 RRDBs, a 16-px crop: the mode moves JAX's output
    # by ~3e-4 of its range (1.6e-2 with K10's), and bf16 flips set off by
    # the two sides' float32 sum orders carry through 30 chained convs, so
    # the port is held as the bf16 options are (test_torch_port_options.py:
    # _hold_bf16): nearer JAX's mode than its own float32 forward lies to it,
    # and both within TOL_MXU of the range
    flags, lr = MXU_FORCED[trunk], 16
    _, params = jax_build_generator(JaxGeneratorConfig(**flags, init_scale=1.0), lr=lr)
    rs = np.random.RandomState(42)
    xs = [rs.rand(1, lr, lr, 1), rs.rand(1, 10 * lr, 10 * lr, 1),
          rs.rand(1, 2 * lr, 2 * lr, 2), rs.rand(1, lr, lr, 1)]
    xs = [a.astype(np.float32) for a in xs]
    want = np.asarray(JaxGenerator(JaxGeneratorConfig(**flags)).apply(
        {"params": params}, *map(jnp.asarray, xs)))
    sd = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    outs = {}
    for mode in (True, False):
        fp32 = {} if mode else dict(rdb_mxu_bf16=False, conv_mxu_bf16=False)
        model = Generator(GeneratorConfig(**{**flags, **fp32}))
        model.load_state_dict(sd)
        with torch.inference_mode():
            outs[mode] = model(*map(torch.from_numpy, xs)).numpy()
    scale = np.abs(want).max()
    d_port = np.abs(outs[True] - want).max()
    d_fp32 = np.abs(outs[False] - want).max()
    print(f"{trunk}: port vs JAX's mode {d_port / scale:.3e}, the port's float32 "
          f"forward {d_fp32 / scale:.3e} of the range {scale:.3e}")
    assert outs[True].shape == want.shape == (1, 4 * (lr - 2), 4 * (lr - 2), 1)
    assert d_port < d_fp32, (trunk, d_port, d_fp32)
    assert d_fp32 <= TOL_MXU * scale

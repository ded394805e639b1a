"""PyTorch port: tensor (channel) parallelism over ``torch.distributed`` on
the CPU, against JAX's ``parallel.tp`` and the single-process port.

Real Gloo groups of 2 and 4 ranks (``tests/torch_port_parallel_worker.py``,
one process and one thread per rank, a ``file://`` store) run
``make_tp_forward`` on ``(1, 2)`` and ``(2, 2)`` meshes with a 1-RRDB
generator at init scale 1.0, its gradients (a mean square of the output,
then ``reduce_tp_grads`` over ``"data"``), the placement rule on
``(1, 2)``, ``(1, 4)`` and ``(2, 2)``, and ``tp_state_shardings`` after one
step. JAX's side runs here on the 8 virtual CPU devices.

Tolerances (stated once): forwards against JAX rtol 1e-4, atol 1e-5 of the
range; against the port's single-device forward rtol 1e-6, atol 1e-6 of the
range (each output channel's sum is the same sum; only the tail's plain
sampler differs from the fused one); gradients 1e-4 of each tensor's largest
magnitude (``tests/test_torch_port_train.py``'s ``TOL_GRAD``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.models import Generator as JaxGenerator
from deepbedmap_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from deepbedmap_tpu.parallel import make_tp_forward as jax_make_tp_forward
from deepbedmap_tpu.parallel import shard_params_tp as jax_shard_params_tp
from deepbedmap_tpu.parallel import tp_param_shardings as jax_tp_param_shardings
from deepbedmap_tpu_torch.bridge import jax_params_to_state_dict, state_dict_to_jax_params
from tests import torch_port_parallel_worker as worker

RTOL_JAX, ATOL_JAX = 1e-4, 1e-5  # of the range
TOL_PORT = 1e-6  # of the range
TOL_GRAD = 1e-4  # of each tensor's largest magnitude
# mesh shape -> (world of the run, its ranks with "data" coordinate 0)
MESHES = {"1x2": (2, [0, 1]), "2x2": (4, [0, 1])}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    for w, d in dirs.items():  # one run after the other
        worker.finish(worker.launch("tp", w, d))
    return dirs


def _record(d, rank):
    with open(os.path.join(d, f"record_r{rank}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def model():
    return worker.infer_model().model


@pytest.fixture(scope="module")
def jax_params(model):
    return jax.tree_util.tree_map(jnp.asarray, state_dict_to_jax_params(model.state_dict()))


def _jax_sharded_names(jax_params, n_data, n_model):
    """JAX's rule on its own tree, mapped to the port's names by ``bridge``."""
    shardings = jax_tp_param_shardings(jax_make_mesh_2d(n_data, n_model), jax_params)
    flags = jax.tree_util.tree_map(
        lambda leaf, s: np.full(leaf.shape, float("model" in tuple(s.spec)), np.float32),
        jax_params, shardings)
    return sorted(k for k, v in jax_params_to_state_dict(flags).items() if bool(v.any()))


@pytest.mark.parametrize("shape,world", [("1x2", 2), ("1x4", 4), ("2x2", 4)])
def test_tp_param_shardings_match_jax(runs, jax_params, shape, world):
    want = _jax_sharded_names(jax_params, *map(int, shape.split("x")))
    for r in range(world):
        assert _record(runs[world], r)["tp_sharded"][shape] == want
    assert "final_conv_layer2.weight" not in want  # the 64 -> 1 head
    assert {"pre_residual_conv_layer.weight", "pre_residual_conv_layer.bias"} <= set(want)
    # 18 offsets shard over 2 ranks, not over 4
    assert ("final_conv_layer1.offset_conv.weight" in want) == shape.endswith("x2")


@pytest.mark.parametrize("shape", list(MESHES))
def test_tp_forward_matches_jax_and_one_device(runs, model, jax_params, shape):
    world, _ = MESHES[shape]
    n_data, n_model = map(int, shape.split("x"))
    args = worker.tp_args()
    mesh = jax_make_mesh_2d(n_data, n_model)
    sharded = jax_shard_params_tp(mesh, jax_params)
    jax_model = JaxGenerator(JaxGeneratorConfig(num_residual_blocks=1))
    want_jax = np.asarray(jax_make_tp_forward(mesh, jax_model, sharded)(
        sharded, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        want = model(*(torch.from_numpy(a) for a in args)).numpy()
    scale = np.abs(want).max()
    assert scale > 0.5
    for r in range(world):
        got = np.load(os.path.join(runs[world], f"tp_{shape}_r{r}.npz"))["out"]
        assert got.shape == want.shape == (4, 36, 36, 1)
        np.testing.assert_allclose(got, want_jax, rtol=RTOL_JAX, atol=ATOL_JAX * scale)
        np.testing.assert_allclose(got, want, rtol=TOL_PORT, atol=TOL_PORT * scale)


@pytest.mark.parametrize("shape", list(MESHES))
def test_tp_gradients_compose_with_dp(runs, model, shape):
    world, ranks = MESHES[shape]
    args = [torch.from_numpy(a) for a in worker.tp_args()]
    model.zero_grad()
    model(*args).square().mean().backward()
    saved = [np.load(os.path.join(runs[world], f"tp_{shape}_r{r}.npz")) for r in range(world)]
    for k, p in model.named_parameters():
        want = p.grad.numpy()
        parts = [saved[r][f"grad/{k}"] for r in ranks]
        got = parts[0] if parts[0].shape == want.shape else np.concatenate(parts)
        err = np.abs(got - want).max()
        assert err <= TOL_GRAD * np.abs(want).max(), (k, err)
        for r in range(world):  # the data ranks agree after the reduction
            m = ranks.index(r % len(ranks))
            np.testing.assert_array_equal(saved[r][f"grad/{k}"], parts[m])


def test_tp_state_shardings(runs, model):
    names = set(_record(runs[4], 0)["tp_state_sharded"])
    assert "step" not in names
    for k in model.state_dict():  # Adam's moments follow their parameters
        for moment in ("exp_avg", "exp_avg_sq"):
            assert (f"g_opt.{k}.{moment}" in names) == (f"g.{k}" in names), k
        assert f"g_opt.{k}.step" not in names
    assert "g.final_conv_layer2.weight" not in names and "g.pre_residual_conv_layer.weight" in names
    assert "d.batch_norm1.mean" in names and "d.linear_2.weight" not in names

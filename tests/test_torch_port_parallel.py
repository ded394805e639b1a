"""PyTorch port: data-parallel training and tile-sharded inference over
``torch.distributed`` on the CPU, against the single-process port and JAX.

Real multi-process groups: ``tests/torch_port_parallel_worker.py`` runs 2
and 4 Gloo ranks (one process each, one thread each, a ``file://`` store),
and saves what they computed; JAX's side runs here on the 8 virtual CPU
devices of ``tests/conftest.py``. The step: one ``make_sharded_train_step``
at worlds 2 and 4 (global batch 8, a 1-RRDB generator) against the port's
single-device step on the whole batch and JAX's ``make_sharded_train_step``;
the state on ranks other than the first is perturbed before the first call,
which must broadcast the first rank's. Inference: ``sharded_predict_tiles``
(3 tiles over 2 ranks, 1 and 2 tiles per forward), ``predict_continent``
with a mesh, buffered and streamed, and the CLI's ``--mesh-devices``.

Tolerances (stated once):
- against the port's single-device step, ``tests/test_parallel.py``'s
  contract: metrics rtol 1e-5, parameters and BatchNorm statistics rtol
  1e-4 / atol 1e-6; gradients (Adam's first moments) 1e-4 of each tensor's
  largest magnitude. A GAN step is not well-conditioned everywhere in fp32
  (``tests/test_torch_port_train.py``): a sum taken in another order moves a
  gradient that is round-off-sized (D's ``linear_2`` bias is 0 but for
  round-off), and Adam's first step turns any gradient into about lr x its
  sign. So each result is held to the larger of its tolerance and
  ``NOISE_K`` x the change the single-device step itself shows from weights
  perturbed by ``PERTURB``, and parameters only where that change is under
  |g| / ``NOISE_K`` and |g| > 1e-3 of the tensor's largest (the rest's
  share is printed);
- against JAX's sharded step: ``tests/test_torch_port_train.py``'s, or
  ``NOISE_K`` x the port's single-device step's own difference from JAX's
  if larger (``test_dp_step_matches_jax``);
- inference against JAX: rtol 1e-4, atol 1e-5 of the range; against the
  port on one process: rtol 1e-6, atol 1e-6 of the range (another batch
  composition of the same crops); products within 1 m on at most 1e-3 of
  their pixels (int16 rounding of outputs that differ by round-off).
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu import DeepBedMap as JaxDeepBedMap
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.config import TrainConfig as JaxTrainConfig
from deepbedmap_tpu.inference import TilePlan as JaxTilePlan
from deepbedmap_tpu.inference.continent import (
    predict_continent_sharded as jax_predict_continent_sharded,
)
from deepbedmap_tpu.models import Discriminator as JaxDiscriminator
from deepbedmap_tpu.models import Generator as JaxGenerator
from deepbedmap_tpu.parallel import batch_sharding as jax_batch_sharding
from deepbedmap_tpu.parallel import make_mesh as jax_make_mesh
from deepbedmap_tpu.parallel import make_sharded_train_step as jax_make_sharded_train_step
from deepbedmap_tpu.parallel import sharded_predict_tiles as jax_sharded_predict_tiles
from deepbedmap_tpu_torch.bridge import (
    jax_d_vars_to_state_dict,
    jax_params_to_state_dict,
    state_dict_to_jax_params,
)
from deepbedmap_tpu_torch.cli import main
from deepbedmap_tpu_torch.config import LossConfig, TrainConfig
from deepbedmap_tpu_torch.data.geotiff import read_geotiff
from deepbedmap_tpu_torch.inference import TilePlan, predict_continent
from deepbedmap_tpu_torch.parallel import distributed, make_mesh, replicated, sharded_predict_tiles
from deepbedmap_tpu_torch.train.steps import make_train_step
from tests import torch_port_parallel_worker as worker
from tests.test_torch_port_train import TOL_GRAD as TOL_GRAD_JAX
from tests.test_torch_port_train import TOL_PARAM as TOL_PARAM_JAX
from tests.test_torch_port_train import TOL_STATS as TOL_STATS_JAX
from tests.test_torch_port_train import METRICS, _jax_state, _perturbed, _tol

RTOL_METRICS, RTOL_STATE, ATOL_STATE, TOL_GRAD = 1e-5, 1e-4, 1e-6, 1e-4
PERTURB, NOISE_K = 1e-5, 3
RTOL_JAX, ATOL_JAX = 1e-4, 1e-5  # of the range
TOL_PORT = 1e-6  # of the range
PRODUCT_SHARE = 1e-3  # pixels that may differ by 1 m
B1 = TrainConfig().adam_beta1


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
    """world -> the directory of its ranks' outputs (one run after the
    other, to keep the suite's other workers' cores)."""
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    worker.finish(worker.launch("cli_mesh,dp,tiles", 2, dirs[2]))
    worker.finish(worker.launch("dp", 4, dirs[4]))
    return dirs


def _record(d, rank):
    with open(os.path.join(d, f"record_r{rank}.json")) as f:
        return json.load(f)


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in worker.train_batch().items()}


def _load(d, name, rank):
    """The rank's saved step as a GANState (weights, statistics, Adam)."""
    saved = torch.load(os.path.join(d, f"{name}_r{rank}.pt"), weights_only=True)
    state = worker.train_state()
    state.g.load_state_dict(saved["g"])
    state.d.load_state_dict(saved["d"])
    state.g_opt.load_state_dict(saved["g_opt"])
    state.d_opt.load_state_dict(saved["d_opt"])
    state.step = saved["step"]
    return state, saved["metrics"]


def _single_step(l_kw, perturb=False):
    state = worker.train_state()
    if perturb:
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in list(state.g.parameters()) + list(state.d.parameters()):
                p.mul_(1 + PERTURB * torch.randn(p.shape, generator=gen))
    return make_train_step(TrainConfig(**worker.T_TRAIN), LossConfig(**l_kw))(
        state, _torch_batch())


def _grads(state):
    return {f"{m}.{k}": (opt.state[p]["exp_avg"] / (1 - B1)).numpy().astype(np.float64)
            for m, model, opt in (("g", state.g, state.g_opt), ("d", state.d, state.d_opt))
            for k, p in model.named_parameters()}


def _params(state):
    return {f"{m}.{k}": v.numpy().astype(np.float64)
            for m, model in (("g", state.g), ("d", state.d))
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("world,case", [(2, "default"), (4, "default"), (2, "noise")])
def test_dp_step_matches_single_device(runs, world, case):
    l_kw = worker.LOSS_CASES[case]
    want, want_m = _single_step(l_kw)
    other, other_m = _single_step(l_kw, perturb=True)
    got, got_m = _load(runs[world], f"dp_{case}", 0)
    for r in range(1, world):  # the broadcast undid the perturbation; one result
        peer, peer_m = _load(runs[world], f"dp_{case}", r)
        assert peer_m == got_m
        for a, b in zip(_params(got).values(), _params(peer).values()):
            np.testing.assert_array_equal(a, b)
    assert got.step == 1
    for name in METRICS:
        w, o = float(getattr(want_m, name)), float(getattr(other_m, name))
        assert abs(got_m[name] - w) <= max(RTOL_METRICS * abs(w), NOISE_K * abs(o - w)), name
    g_want, g_other, g_got = _grads(want), _grads(other), _grads(got)
    p_want, p_got = _params(want), _params(got)
    for k, gw in g_want.items():
        err = np.abs(g_got[k] - gw).max()
        assert err <= _tol(gw, g_other[k], TOL_GRAD), (k, err, np.abs(gw).max())
        ok = (np.abs(gw) > 1e-3 * np.abs(gw).max()) & \
            (NOISE_K * np.abs(g_other[k] - gw) < np.abs(gw))
        print(f"{k}: {100 * (1 - ok.mean()):.2f}% of elements left out")
        np.testing.assert_allclose(p_got[k][ok], p_want[k][ok], rtol=RTOL_STATE,
                                   atol=ATOL_STATE, err_msg=k)
    for k, v in p_want.items():
        if k.startswith("d.") and k.endswith((".mean", ".var")):  # BatchNorm statistics
            np.testing.assert_allclose(p_got[k], v, rtol=RTOL_STATE, atol=ATOL_STATE,
                                       err_msg=k)


@pytest.fixture(scope="module")
def jax_dp_step():
    """JAX's sharded step on the 8-device mesh, from the seeded state: its
    result and its result from perturbed weights (``_perturbed``)."""
    jt_cfg = JaxTrainConfig(**worker.T_TRAIN)
    step = jax_make_sharded_train_step(
        jax_make_mesh(8), JaxGenerator(JaxGeneratorConfig(**{
            k: v for k, v in worker.G_TRAIN.items() if k != "init_scale"})),
        JaxDiscriminator(), jt_cfg)
    data = jax_batch_sharding(jax_make_mesh(8))
    batch = {k: jax.device_put(jnp.asarray(v), data) for k, v in worker.train_batch().items()}
    state = _jax_state(worker.train_state(), jt_cfg)
    other_state = jax.tree_util.tree_map(jnp.copy, _perturbed(state))
    new, metrics = step(state, batch)
    other, other_metrics = step(other_state, batch)
    return new, metrics, other, other_metrics


def _jax_flat(state, b1):
    """(gradients, parameters, BatchNorm statistics) of JAX's state after one
    step, by the port's names (``bridge``)."""
    g = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.g_opt[0].mu))
    d = jax_d_vars_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                                   state.d_opt[0].mu),
                                  "batch_stats": state.d_batch_stats})
    grads = {f"g.{k}": v.numpy().astype(np.float64) / (1 - b1) for k, v in g.items()}
    grads.update({f"d.{k}": v.numpy().astype(np.float64) / (1 - b1) for k, v in d.items()
                  if not k.endswith((".mean", ".var"))})
    params = {f"g.{k}": v.numpy().astype(np.float64)
              for k, v in jax_params_to_state_dict(state.g_params).items()}
    params.update({f"d.{k}": v.numpy().astype(np.float64) for k, v in jax_d_vars_to_state_dict(
        {"params": state.d_params, "batch_stats": state.d_batch_stats}).items()})
    return grads, params


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax(runs, jax_dp_step, world):
    """tests/test_torch_port_train.py's tolerances, or ``NOISE_K`` x the
    port's single-device step's own difference from JAX's sharded step,
    whichever is larger: the data-parallel step may not add to it. At this
    batch the single-device step already exceeds those tolerances in places
    (D's ``batch_norm5.bias`` gradient by 3.1e-5 against 5.7e-6, a parameter
    by 2.4e-3 x lr where |g| is a few of Adam's eps)."""
    jax_new, jax_metrics, jax_other, other_metrics = jax_dp_step
    port, metrics = _load(runs[world], "dp_default", 0)
    single, single_m = _single_step({})
    t_cfg = TrainConfig(**worker.T_TRAIN)

    def allowed(tol, want, single_value):
        return np.maximum(tol, NOISE_K * np.abs(single_value - want))

    for name in METRICS:
        want = float(getattr(jax_metrics, name))
        tol = _tol(np.array([want]), np.array([float(getattr(other_metrics, name))]),
                   RTOL_METRICS)
        assert abs(metrics[name] - want) <= allowed(
            tol, want, float(getattr(single_m, name))), (name, metrics[name], want)
    g_jax, p_jax = _jax_flat(jax_new, B1)
    g_other, p_other = _jax_flat(jax_other, B1)
    g_port, p_port = _grads(port), _params(port)
    g_single, p_single = _grads(single), _params(single)
    assert sorted(g_port) == sorted(g_jax) and sorted(p_port) == sorted(p_jax)
    for k, gj in g_jax.items():
        tol = _tol(gj, g_other[k], TOL_GRAD_JAX)
        if k == "d.linear_2.bias":  # RaGAN does not see it: 0 up to round-off
            tol = max(tol, 1e-6)
        err = np.abs(g_port[k] - gj).max()
        assert err <= allowed(tol, gj, g_single[k]).max(), (k, err, tol)
        ok = (np.abs(gj) > 1e-3 * np.abs(gj).max()) & \
            (NOISE_K * np.abs(g_other[k] - gj) < np.abs(gj))
        lr = t_cfg.learning_rate * (t_cfg.d_lr_scale if k.startswith("d.") else 1.0)
        near = np.abs(p_port[k] - p_jax[k]) <= allowed(TOL_PARAM_JAX * lr, p_jax[k],
                                                        p_single[k])
        assert near[ok].all(), k
    for k, w in p_jax.items():
        if k.endswith((".mean", ".var")):
            err = np.abs(p_port[k] - w).max()
            assert err <= allowed(_tol(w, p_other[k], TOL_STATS_JAX), w,
                                  p_single[k]).max(), (k, err)


def test_dp_step_refuses_uneven_rows(runs):
    # rank 0 holds 4 rows and rank 1 three: both ranks refuse, naming counts
    for r in range(2):
        assert "[4, 3]" in _record(runs[2], r)["dp_uneven"]


def _jax_forward(dbm):
    return JaxDeepBedMap(jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_jax_params(dbm.model.state_dict())),
        JaxGeneratorConfig(num_residual_blocks=worker.G_INFER["num_residual_blocks"])
    ).forward_fn()


@pytest.fixture(scope="module")
def jax_fwd():
    return _jax_forward(worker.infer_model())


def _close(got, want, rtol, atol):
    scale = np.abs(want).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("tiles_per_dispatch", [1, 2])
def test_sharded_predict_tiles_matches_jax(runs, jax_fwd, tiles_per_dispatch):
    plan = JaxTilePlan(out_h=32, out_w=96, **worker.TILING)  # 3 tiles over 2 ranks
    inputs = {k: jnp.asarray(v[:, : 8 * r]) for (k, v), r in
              zip(worker.host_inputs(1).items(), (1, 10, 2, 1))}
    want = np.asarray(jax_sharded_predict_tiles(
        jax_fwd, inputs, plan, jax_make_mesh(2), tiles_per_dispatch=tiles_per_dispatch))
    for r in range(2):
        got = np.load(os.path.join(runs[2], f"tiles_r{r}.npz"))
        assert got[f"tiles_b{tiles_per_dispatch}"].shape == want.shape == (3, 32, 32)
        _close(got[f"tiles_b{tiles_per_dispatch}"], want, RTOL_JAX, ATOL_JAX)
        np.testing.assert_array_equal(got["stitched"], np.concatenate(list(got["tiles_b2"]), 1))


def test_predict_continent_sharded_matches_jax(runs, jax_fwd):
    plan = TilePlan(out_h=96, out_w=96, **worker.TILING)
    want = jax_predict_continent_sharded(jax_fwd, worker.host_inputs(),
                                         JaxTilePlan(out_h=96, out_w=96, **worker.TILING),
                                         jax_make_mesh(2))
    single = predict_continent(worker.infer_model().forward_fn(), worker.host_inputs(), plan,
                               tiles_per_dispatch=1, device="cpu")
    for r in range(2):
        got = np.load(os.path.join(runs[2], f"tiles_r{r}.npz"))["canvas"]
        _close(got, want, RTOL_JAX, ATOL_JAX)
        _close(got, single, TOL_PORT, TOL_PORT)


def _product_close(got_path, want_path):
    got, _ = read_geotiff(got_path)
    want, _ = read_geotiff(want_path)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and diff.max() <= 1
    assert (diff > 0).mean() <= PRODUCT_SHARE


def test_mesh_product_written_by_first_rank(runs, tmp_path):
    # every rank computes; rank 0 writes and returns the path, rank 1 None
    assert [_record(runs[2], r)["mesh_stream_returned"] for r in range(2)] == [None, None]
    single = str(tmp_path / "single")
    worker.infer_model().predict_continent(worker.inputs_nchw(), worker.BOUNDS,
                                           outfilepath=single, stream_product=True,
                                           **worker.TILING)
    _product_close(os.path.join(runs[2], "mesh_product.tif"), single + ".tif")


def test_cli_mesh_devices(runs, tmp_path, capsys):
    lines = [_record(runs[2], r)["cli_mesh"] for r in range(2)]
    assert [x["rc"] for x in lines] == [0, 0] and lines[1]["last_line"] == ""
    res = json.loads(lines[0]["last_line"])
    assert res["sharded"] is True and res["streamed"] is True and res["processes"] == 2
    d = tmp_path / "inputs"
    d.mkdir()
    for k, v in worker.inputs_nchw().items():
        np.save(d / f"{k}.npy", v)
    out = str(tmp_path / "single")
    assert main(["continent", "--inputs", str(d), "--bounds", ",".join(map(str, worker.BOUNDS)),
                 "-o", out, "--blocks", "1", "--device", "cpu", "--stream",
                 "--tile-out", "32", "--halo-lr", "3"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["processes"] == 1
    _product_close(os.path.join(runs[2], "cli_mesh.tif"), out + ".tif")


def test_mesh_refusals(runs):
    for r in range(2):
        rec = _record(runs[2], r)
        assert "world size is 2" in rec["mesh_too_large"]
    # make_mesh(1) holds rank 0 only: rank 1 may not predict over it
    assert _record(runs[2], 0)["outside_mesh"] == ""
    assert "not part of the mesh" in _record(runs[2], 1)["outside_mesh"]


def _sum_forward(x, w1, w2, w3):
    a = (x + w3 + w2[:, ::2, ::2, :1] + w1[:, ::10, ::10])[:, 1:-1, 1:-1]
    return a.repeat_interleave(4, 1).repeat_interleave(4, 2)


def _sum_forward_jax(x, w1, w2, w3):
    a = (x + w3 + w2[:, ::2, ::2, :1] + w1[:, ::10, ::10])[:, 1:-1, 1:-1]
    return jnp.repeat(jnp.repeat(a, 4, 1), 4, 2)


def test_no_group_is_refused_and_a_one_rank_group_starts():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="timeout"):
        distributed.initialize(device="cpu", timeout_s=0)
    assert distributed.initialize(device="cpu")
    try:
        assert not distributed.initialize(device="cpu")  # already up: a no-op
        assert distributed.process_count() == 1 and distributed.is_primary()
        with pytest.raises(ValueError, match="world size is 1"):
            make_mesh(2, device="cpu")
        mesh = make_mesh(device="cpu")
        assert mesh.size() == 1
        # any jnp.pad mode: the one-rank mesh's tiles equal JAX's on a
        # one-device mesh, bit for bit (a forward of additions and repeats
        # that reads every raster's padding)
        plan = TilePlan(out_h=32, out_w=96, **worker.TILING)
        inputs = {k: v[:, : 8 * r] for (k, v), r in
                  zip(worker.host_inputs(1).items(), (1, 10, 2, 1))}
        got = sharded_predict_tiles(_sum_forward, {k: torch.from_numpy(v) for k, v in
                                                   inputs.items()},
                                    plan, mesh, pad_mode="reflect")
        want = jax_sharded_predict_tiles(
            _sum_forward_jax, {k: jnp.asarray(v) for k, v in inputs.items()},
            JaxTilePlan(out_h=32, out_w=96, **worker.TILING), jax_make_mesh(1),
            pad_mode="reflect")
        assert tuple(got.shape) == (3, 32, 32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(TypeError, match="broadcast"):
            replicated(mesh)(object())
    finally:
        torch.distributed.destroy_process_group()


def test_torchrun_environment_starts_a_group(monkeypatch):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
                     RANK="0").items():
        monkeypatch.setenv(k, v)
    assert distributed.initialize(device="cpu", timeout_s=60)
    try:
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_backend() == "gloo"
    finally:
        torch.distributed.destroy_process_group()

"""PyTorch port: the tile engine, band-streamed continent inference and the
DeepBedMap API on the CPU, against the JAX package on a small multi-tile
region, plus the port's own seam equivalence (tiled == untiled)."""

import jax
import numpy as np
import pytest
import torch

from deepbedmap_tpu import DeepBedMap as JaxDeepBedMap
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.inference import (
    TilePlan,
    make_tile_group_forward,
    predict_continent,
    predict_region,
    predict_region_tiled,
)
from deepbedmap_tpu_torch.inference.engine import pad_inputs
from deepbedmap_tpu_torch.models import build_generator

CFG = dict(num_residual_blocks=2)


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
def jax_params():
    # init_scale=1.0 only draws O(1) weights, so outputs are O(1) and the
    # tolerances below bite; the forward config is CFG on both sides
    _, params = jax_build_generator(JaxGeneratorConfig(**CFG, init_scale=1.0))
    return params


@pytest.fixture(scope="module")
def port(jax_params):
    return DeepBedMap.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params), GeneratorConfig(**CFG),
        device="cpu",
    )


def _inputs_nchw(lh, lw, seed):
    rs = np.random.RandomState(seed)
    return {
        "X": rs.rand(1, 1, lh, lw).astype(np.float32),
        "W1": (rs.rand(1, 1, 10 * lh, 10 * lw) - 0.2).astype(np.float32),
        "W2": (rs.rand(1, 2, 2 * lh, 2 * lw) - 0.2).astype(np.float32),
        "W3": rs.rand(1, 1, lh, lw).astype(np.float32),
    }


def test_predict_continent_matches_jax(jax_params, port):
    # 2 bands x 3 tiles: band halos, the B=2 remainder clamp and the
    # conditioning clip (the inputs go below zero) all run on both sides
    res = 250.0
    bounds = (0.0, 0.0, 96 * res, 64 * res)
    inputs = _inputs_nchw(16, 24, seed=0)
    kw = dict(tile_out=32, halo_lr=3, tiles_per_dispatch=2)
    want = JaxDeepBedMap(jax_params, JaxGeneratorConfig(**CFG)).predict_continent(
        inputs, bounds, **kw
    )
    got = port.predict_continent(inputs, bounds, **kw)
    assert got.data.shape == want.data.shape == (64, 96)
    assert got.bounds == want.bounds
    scale = np.abs(want.data).max()
    assert scale > 0.5
    # fp32 on both sides in another summation order; atol 1e-5 of the range
    np.testing.assert_allclose(got.data, want.data, rtol=1e-4, atol=1e-5 * scale)


def test_port_tiled_equals_untiled():
    # the port's own seeded weights (init_scale 0.1): the generator's far
    # field then decays fast, so an 8-px halo makes tiles match the untiled
    # region to ~2e-7 of the range (with a 3-px halo they differ by ~7e-3)
    dbm = DeepBedMap(cfg=GeneratorConfig(**CFG), device="cpu")
    plan = TilePlan(out_h=64, out_w=96, tile_out=32, halo_lr=8)
    nchw = _inputs_nchw(16, 24, seed=3)
    host = {k: np.maximum(v, 0).transpose(0, 2, 3, 1) for k, v in nchw.items()}
    dev = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
    fwd = dbm.forward_fn()
    whole = predict_region(fwd, dev, plan)[0, ..., 0].numpy()
    tiled = predict_region_tiled(fwd, dev, plan)[0, ..., 0].numpy()
    assert whole.shape == (64, 96)
    scale = np.abs(whole).max()
    np.testing.assert_allclose(tiled, whole, rtol=1e-4, atol=1e-5 * scale)
    # the band loop and batched tile groups compute the same crops as the
    # tile loop: equal up to the round-off of another batch size
    for b in (1, 2):
        banded = predict_continent(fwd, host, plan, tiles_per_dispatch=b,
                                   prefetch=b - 1, device="cpu")
        np.testing.assert_allclose(banded, tiled, rtol=1e-6, atol=1e-6 * scale)
    pair = make_tile_group_forward(fwd, plan)(pad_inputs(dev, plan), [1, 0], [2, 1])
    np.testing.assert_allclose(pair[0].numpy(), tiled[32:64, 64:96], rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(pair[1].numpy(), tiled[0:32, 32:64], rtol=1e-6,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("option", [dict(mesh=object()), dict(multihost=True)])
def test_unported_continent_options_raise(port, option):
    # the multi-device options are ported (tests/test_torch_port_parallel.py,
    # tests/test_torch_port_multihost.py); what stays true in one process: a
    # mesh that is not a DeviceMesh is refused, and multihost with no process
    # group (world size 1) is the single-device path, bit for bit
    inputs, bounds = _inputs_nchw(8, 8, 0), (0.0, 0.0, 8000.0, 8000.0)
    kw = dict(tile_out=32, halo_lr=3)
    if "mesh" in option:
        with pytest.raises(TypeError, match="DeviceMesh"):
            port.predict_continent(inputs, bounds, **kw, **option)
        return
    want = port.predict_continent(inputs, bounds, tiles_per_dispatch=1, **kw)
    got = port.predict_continent(inputs, bounds, **kw, **option)
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(got.data, want.data)


def test_band_predictor_rejects_bad_arguments(port):
    plan = TilePlan(out_h=32, out_w=32, tile_out=32, halo_lr=3)
    host = {k: v.transpose(0, 2, 3, 1) for k, v in _inputs_nchw(8, 8, 0).items()}
    with pytest.raises(ValueError):
        predict_continent(port.forward_fn(), host, plan, tile_loop="bogus")
    with pytest.raises(ValueError):
        predict_continent(port.forward_fn(), host, plan, tiles_per_dispatch=0)
    with pytest.raises(ValueError):
        TilePlan(out_h=33, out_w=32, tile_out=32)


@pytest.mark.parametrize("entry", ["DeepBedMap", "from_jax_params", "build_generator",
                                   "predict_continent", "from_chainer_npz",
                                   "from_experiment", "selective_tile", "get_model_inputs",
                                   "gapfill_from_coarse", "track_rmse",
                                   "elevation_residuals", "window_coords",
                                   "predict_continent_to_geotiff", "cli"])
def test_entry_points_default_to_the_card(entry, jax_params, tmp_path):
    # every entry point defaults to device "cuda"; without a card it raises
    # rather than carrying on on the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    from deepbedmap_tpu_torch.data import Raster
    from deepbedmap_tpu_torch.data.groundtruth import gapfill_from_coarse, get_model_inputs
    from deepbedmap_tpu_torch.data.tiler import selective_tile
    from deepbedmap_tpu_torch.evalx import elevation_residuals, track_rmse
    from deepbedmap_tpu_torch.ops.interp import window_coords
    from deepbedmap_tpu_torch.train.checkpoint import export_generator_npz
    from deepbedmap_tpu_torch.cli import main as cli_main
    from deepbedmap_tpu_torch.inference import predict_continent_to_geotiff
    from deepbedmap_tpu_torch.utils.tracking import LocalTracker

    cfg = GeneratorConfig(num_residual_blocks=1)
    plan = TilePlan(out_h=32, out_w=32, tile_out=32, halo_lr=3)
    host = {k: v.transpose(0, 2, 3, 1) for k, v in _inputs_nchw(8, 8, 0).items()}
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    npz = str(tmp_path / "srgan_generator_model_weights.npz")
    export_generator_npz(tree, npz)
    run = LocalTracker(str(tmp_path / "runs"))
    run.log_params({"num_residual_blocks": 2})
    run.log_asset(npz)
    r = Raster(np.ones((40, 40), np.float32), left=0.0, top=40_000.0, res=1000.0)
    window = (1000.0, 1000.0, 10_000.0, 10_000.0)
    pts = np.full(3, 5000.0)
    calls = {
        "DeepBedMap": lambda: DeepBedMap(cfg=cfg),
        "from_jax_params": lambda: DeepBedMap.from_jax_params(tree, GeneratorConfig(**CFG)),
        "build_generator": lambda: build_generator(cfg),
        "predict_continent": lambda: predict_continent(lambda *a: None, host, plan),
        "from_chainer_npz": lambda: DeepBedMap.from_chainer_npz(npz, GeneratorConfig(**CFG)),
        "from_experiment": lambda: DeepBedMap.from_experiment(
            str(tmp_path / "runs"), download_path=str(tmp_path / "dl.npz")),
        "selective_tile": lambda: selective_tile(r, [window]),
        "get_model_inputs": lambda: get_model_inputs(window, r, r, r, r, r),
        "gapfill_from_coarse": lambda: gapfill_from_coarse(r, r),
        "track_rmse": lambda: track_rmse(r, pts, pts, pts),
        "elevation_residuals": lambda: elevation_residuals(r, pts, pts, pts),
        "window_coords": lambda: window_coords(window, 250.0),
        "predict_continent_to_geotiff": lambda: predict_continent_to_geotiff(
            lambda *a: None, host, plan, (0.0, 0.0, 8000.0, 8000.0), str(tmp_path / "p")),
        "cli": lambda: cli_main(["serve"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert not (tmp_path / "p.tif").exists()

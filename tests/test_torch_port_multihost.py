"""PyTorch port: continent inference with the row bands distributed over
processes (``inference.multihost``), on the CPU, against JAX and the port
on one process.

A real 2-rank Gloo group (``tests/torch_port_parallel_worker.py``, one
process and one thread per rank, a ``file://`` store) on a 3 x 3-tile
region: band ownership of a callable source (rank 0 bands 0 and 2, rank 1
band 1 and a dummy strip in the second round), the canvas and ``progress``
on rank 0 and None on rank 1, the streamed product on rank 0 only, the
API's ``multihost=True``, the refusal of a mesh that spans another rank,
and the CLI's ``--multihost`` started from ``--coordinator`` /
``--num-processes`` / ``--process-id``. JAX's ``predict_continent_multihost``
runs here, in one process, which its module documents to equal the
single-host path.

Tolerances (stated once): against JAX rtol 1e-4, atol 1e-5 of the range
(fp32 in another summation order); against the port on one process bit for
bit (the same band predictor on the same crops); products within 1 m on at
most 1e-3 of their pixels against JAX's or another batch composition's
(int16 rounding of outputs that differ by round-off), byte for byte against
the port's own single-process product of the same options.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu import DeepBedMap as JaxDeepBedMap
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.inference import TilePlan as JaxTilePlan
from deepbedmap_tpu.inference.multihost import (
    predict_continent_multihost as jax_predict_continent_multihost,
)
from deepbedmap_tpu.inference.multihost import (
    predict_continent_multihost_to_geotiff as jax_predict_continent_multihost_to_geotiff,
)
from deepbedmap_tpu_torch.bridge import state_dict_to_jax_params
from deepbedmap_tpu_torch.cli import main
from deepbedmap_tpu_torch.data.geotiff import read_geotiff
from deepbedmap_tpu_torch.inference import (
    TilePlan,
    predict_continent,
    predict_continent_to_geotiff,
)
from tests import torch_port_parallel_worker as worker

RTOL_JAX, ATOL_JAX = 1e-4, 1e-5  # of the range
PRODUCT_SHARE = 1e-3  # pixels that may differ by 1 m
PLAN = dict(out_h=96, out_w=96, **worker.TILING)


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
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("world2"))
    worker.finish(worker.launch("cli_multihost,multihost", 2, d))
    records = []
    for r in range(2):
        with open(os.path.join(d, f"record_r{r}.json")) as f:
            records.append(json.load(f))
    return d, records


@pytest.fixture(scope="module")
def jax_dbm():
    params = state_dict_to_jax_params(worker.infer_model().model.state_dict())
    return JaxDeepBedMap(jax.tree_util.tree_map(jnp.asarray, params),
                         JaxGeneratorConfig(num_residual_blocks=1))


def _product_close(got_path, want_path):
    got, _ = read_geotiff(got_path)
    want, _ = read_geotiff(want_path)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and diff.max() <= 1
    assert (diff > 0).mean() <= PRODUCT_SHARE


def test_band_ownership_and_rounds(run):
    _, (r0, r1) = run
    assert r0["loaded"] == [0, 2] and r1["loaded"] == [1]  # band b on rank b % 2
    assert r0["progress"] == [[1, 3], [2, 3], [3, 3]] and r1["progress"] == []
    assert not r0["canvas_is_none"] and r1["canvas_is_none"]


def test_multihost_canvas_matches_jax_and_one_process(run, jax_dbm):
    d, _ = run
    got = np.load(os.path.join(d, "mh_canvas_r0.npy"))
    want = jax_predict_continent_multihost(jax_dbm.forward_fn(), worker.host_inputs(),
                                           JaxTilePlan(**PLAN))
    scale = np.abs(want).max()
    assert got.shape == (96, 96) and scale > 0.5
    np.testing.assert_allclose(got, want, rtol=RTOL_JAX, atol=ATOL_JAX * scale)
    single = predict_continent(worker.infer_model().forward_fn(), worker.host_inputs(),
                               TilePlan(**PLAN), tiles_per_dispatch=1, device="cpu")
    np.testing.assert_array_equal(got, single)


def test_multihost_product_on_rank_zero(run, jax_dbm, tmp_path):
    d, (r0, r1) = run
    assert r0["mh_product"] == os.path.join(d, "mh_product.tif") and r1["mh_product"] is None
    single = predict_continent_to_geotiff(
        worker.infer_model().forward_fn(), worker.host_inputs(), TilePlan(**PLAN),
        worker.BOUNDS, str(tmp_path / "single"), overviews=1, predictor=True,
        tiles_per_dispatch=1, device="cpu")
    with open(r0["mh_product"], "rb") as a, open(single, "rb") as b:
        assert a.read() == b.read()
    want = jax_predict_continent_multihost_to_geotiff(
        jax_dbm.forward_fn(), worker.host_inputs(), JaxTilePlan(**PLAN), worker.BOUNDS,
        str(tmp_path / "jax"), overviews=1, predictor=True)
    _product_close(r0["mh_product"], want)


def test_api_multihost(run):
    d, (r0, r1) = run
    assert not r0["api_is_none"] and r1["api_is_none"]
    np.testing.assert_array_equal(np.load(os.path.join(d, "mh_api_r0.npy")),
                                  np.load(os.path.join(d, "mh_canvas_r0.npy")))
    assert r0["api_stream"] is None and r1["api_stream"] is None
    _product_close(os.path.join(d, "mh_api_product.tif"), os.path.join(d, "mh_product.tif"))


def test_multihost_refuses_a_mesh_of_other_ranks(run):
    _, records = run
    for r, rec in enumerate(records):
        assert f"this is rank {r}" in rec["mh_wide_mesh"]


def test_cli_multihost(run, tmp_path, capsys):
    d, (r0, r1) = run
    assert r0["cli_multihost"]["rc"] == r1["cli_multihost"]["rc"] == 0
    assert r1["cli_multihost"]["last_line"] == ""  # only rank 0 prints
    res = json.loads(r0["cli_multihost"]["last_line"])
    assert res == {"command": "continent", "bounds": list(worker.BOUNDS),
                   "out": os.path.join(d, "cli_multihost.tif"), "sharded": False,
                   "streamed": True, "processes": 2}
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    for k, v in worker.inputs_nchw().items():
        np.save(inputs / f"{k}.npy", v)
    out = str(tmp_path / "single")
    assert main(["continent", "--inputs", str(inputs), "--bounds",
                 ",".join(map(str, worker.BOUNDS)), "-o", out, "--blocks", "1", "--device",
                 "cpu", "--stream", "--tile-out", "32", "--halo-lr", "3"]) == 0
    capsys.readouterr()
    _product_close(os.path.join(d, "cli_multihost.tif"), out + ".tif")

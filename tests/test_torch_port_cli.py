"""PyTorch port: the CLI (``python -m deepbedmap_tpu_torch``) driven
in-process through ``main(argv)`` with ``--device cpu`` on tiny synthetic
data: ``train`` then ``predict --checkpoint`` on its checkpoint, ``predict``
(NetCDF, and GeoTIFF without h5py), ``evaluate``,
``continent --stream --overviews 1``, the ``verify-weights`` rehearsal of
``tests/test_cli.py``, TF32 turned off by the programs, and the multi-device
options of ``continent`` on a world of one process. ``pandas``
is unimportable in every test (the card's machine has none)."""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.train.checkpoint import export_generator_npz
from deepbedmap_tpu_torch import DeepBedMap, GeneratorConfig
from deepbedmap_tpu_torch.cli import main
from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.data.raster import Raster, read_netcdf, write_netcdf
from deepbedmap_tpu_torch.evalx.track import grdtrack
from deepbedmap_tpu_torch.ops.interp import as_f32
from tests.test_torch_parity import _t, torch_generator_forward

RASTERS = ("bed_lowres", "surface", "velocity_x", "velocity_y", "accumulation")
FLAGS = ("--bed", "--surface", "--velocity-x", "--velocity-y", "--accumulation")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_pandas(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)


def run_cli(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """A 2-RRDB generator's weights in the reference's Chainer npz layout."""
    _, params = jax_build_generator(JaxGeneratorConfig(num_residual_blocks=2,
                                                       init_scale=1.0))
    path = str(tmp_path_factory.mktemp("weights") / "srgan_generator_model_weights.npz")
    export_generator_npz(params, path)
    return path


def _rasters():
    rs = np.random.RandomState(0)
    shapes = {"bed_lowres": (40, 1000.0), "surface": (400, 100.0),
              "velocity_x": (90, 450.0), "velocity_y": (90, 450.0),
              "accumulation": (40, 1000.0)}
    return {k: Raster(rs.rand(n, n).astype(np.float32), left=-5000.0, top=35000.0, res=r)
            for k, (n, r) in shapes.items()}


@pytest.mark.parametrize("fmt", ["netcdf", "geotiff"])
def test_cli_predict(capsys, tmp_path, monkeypatch, npz, fmt):
    rasters = _rasters()
    argv = ["predict", "--npz", npz, "--blocks", "2", "--device", "cpu",
            "--bounds", "1000,1000,10000,10000"]
    for name, flag in zip(RASTERS, FLAGS):
        path = str(tmp_path / name) + (".nc" if fmt == "netcdf" else ".tif")
        r = rasters[name]
        if fmt == "netcdf":
            write_netcdf(r, path)
        else:
            geotiff.write_geotiff(path, r.data, r.left, r.top, r.res, compress=True)
        argv += [flag, path]
    out = str(tmp_path / ("dem.nc" if fmt == "netcdf" else "dem.tif"))
    if fmt == "geotiff":  # the GeoTIFF path needs no h5py
        monkeypatch.setitem(sys.modules, "h5py", None)
    rc, res = run_cli(capsys, argv + ["-o", out])
    assert rc == 0 and res["shape"] == [36, 36] and res["out"] == out
    if fmt == "netcdf":
        got = read_netcdf(out)
    else:
        data, meta = geotiff.read_geotiff(out)
        got = Raster(data, meta["left"], meta["top"], meta["res"])
    want = DeepBedMap.from_chainer_npz(npz, GeneratorConfig(num_residual_blocks=2),
                                       device="cpu").predict((1000.0, 1000.0, 1e4, 1e4),
                                                             rasters)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.bounds == want.bounds


@pytest.mark.parametrize("fmt", ["netcdf", "geotiff"])
def test_cli_evaluate(capsys, tmp_path, fmt):
    rs = np.random.RandomState(1)
    dem = Raster(rs.rand(40, 40).astype(np.float32) * 100, 0.0, 10_000.0, 250.0)
    path = str(tmp_path / ("dem.nc" if fmt == "netcdf" else "dem.tif"))
    if fmt == "netcdf":
        write_netcdf(dem, path)
    else:
        geotiff.write_geotiff(path, dem.data, dem.left, dem.top, dem.res, nodata=-2000.0,
                              compress=True)
    tx = rs.uniform(1000, 9000, 200)
    ty = rs.uniform(1000, 9000, 200)
    tz = grdtrack(as_f32(dem.data, "cpu"), as_f32(tx, "cpu"), as_f32(ty, "cpu"),
                  0.0, 10_000.0, 250.0).numpy()
    track = str(tmp_path / "track.csv")
    with open(track, "w") as f:  # quoted header names, an extra column
        f.write('"id","x","y","z"\n')
        for i, row in enumerate(zip(tx, ty, tz)):
            f.write(f"{i}," + ",".join(repr(float(v)) for v in row) + "\n")
    rc, res = run_cli(capsys, ["evaluate", "--dem", path, "--track", track,
                               "--device", "cpu"])
    assert rc == 0 and res["points"] == 200
    assert res["rmse_m"] < 1e-3  # exact self-samples


@pytest.mark.parametrize("entry", ["cli", "serve_forever"])
def test_programs_turn_tf32_off(capsys, tmp_path, monkeypatch, entry):
    # cuDNN convs default to TF32; the programs run the convs around the
    # 3xTF32 kernels in fp32, or their DEMs would differ from the reference's
    from deepbedmap_tpu_torch import serve

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    if entry == "cli":
        dem = Raster(np.zeros((8, 8), np.float32), 0.0, 2000.0, 250.0)
        path = str(tmp_path / "dem.tif")
        geotiff.write_geotiff(path, dem.data, dem.left, dem.top, dem.res, compress=True)
        track = tmp_path / "track.csv"
        track.write_text("x,y,z\n1000,1000,0\n")
        rc, res = run_cli(capsys, ["evaluate", "--dem", path, "--track", str(track),
                                   "--device", "cpu"])
        assert rc == 0 and res["rmse_m"] == 0.0
    else:
        class Server:
            server_port = 8500

            def serve_forever(self):
                pass

        monkeypatch.setattr(serve, "make_server", lambda *a, **k: Server())
        serve.serve_forever(SimpleNamespace(device="cpu"))
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _continent_inputs(tmp_path):
    rs = np.random.RandomState(0)
    lh, lw = 16, 24  # 64x96 output at tile 32
    inputs_dir = tmp_path / "inputs"
    inputs_dir.mkdir()
    inputs = {"X": rs.rand(1, 1, lh, lw), "W1": rs.rand(1, 1, 10 * lh, 10 * lw),
              "W2": rs.rand(1, 2, 2 * lh, 2 * lw), "W3": rs.rand(1, 1, lh, lw)}
    for k, v in inputs.items():
        np.save(inputs_dir / f"{k}.npy", v.astype(np.float32))
    return str(inputs_dir), {k: v.astype(np.float32) for k, v in inputs.items()}


def test_cli_continent_streamed(capsys, tmp_path):
    inputs_dir, inputs = _continent_inputs(tmp_path)
    out = str(tmp_path / "dem")
    rc, res = run_cli(capsys, [
        "continent", "--inputs", inputs_dir, "--bounds", "0,0,24000,16000", "-o", out,
        "--blocks", "1", "--tile-out", "32", "--halo-lr", "2", "--stream",
        "--overviews", "1", "--device", "cpu",
    ])
    assert rc == 0 and res["streamed"] and res["out"] == out + ".tif"
    arr, meta = geotiff.read_geotiff(out + ".tif")
    assert arr.shape == (64, 96)
    assert meta["res"] == 250.0 and meta["crs_epsg"] == 3031
    # the untrained generator is the seeded one: page 0 is its canvas in int16
    canvas = DeepBedMap(cfg=GeneratorConfig(num_residual_blocks=1), device="cpu"
                        ).predict_continent(inputs, (0.0, 0.0, 24000.0, 16000.0),
                                            tile_out=32, halo_lr=2).data
    np.testing.assert_array_equal(arr, np.where(np.isfinite(canvas), canvas,
                                                -2000).astype(np.int16))
    page1, meta1 = geotiff.read_geotiff(out + ".tif", page=1)
    assert page1.shape == (32, 48) and meta1["res"] == 500.0


def test_cli_verify_weights_rehearsal(capsys, tmp_path):
    """The real-weight parity harness on a synthetic artifact: a JAX model's
    weights exported to the reference Chainer npz layout play the released
    artifact, the independent torch oracle (tests/test_torch_parity.py)
    produces the 'reference output grid', and the port's one-command CLI
    must import the npz, reproduce that grid, and pass; a corrupted artifact
    and an all-NaN grid must fail."""
    cfg = JaxGeneratorConfig(num_residual_blocks=2)
    _, params = jax_build_generator(cfg)
    npz = str(tmp_path / "srgan_generator_model_weights.npz")
    export_generator_npz(params, npz)

    rs = np.random.RandomState(7)
    arrays = str(tmp_path / "arrays")
    os.makedirs(arrays)
    inputs = {
        "X": rs.rand(1, 1, 11, 11).astype(np.float32),
        "W1": rs.rand(1, 1, 110, 110).astype(np.float32),
        "W2": rs.rand(1, 2, 22, 22).astype(np.float32),
        "W3": rs.rand(1, 1, 11, 11).astype(np.float32),
    }
    for k, v in inputs.items():
        np.save(f"{arrays}/{k}.npy", v)
    g = {k: np.asarray(v) for k, v in np.load(npz).items()}
    with torch.no_grad():
        expected = torch_generator_forward(
            g, *(_t(inputs[k]) for k in ("X", "W1", "W2", "W3")),
            cfg.num_residual_blocks, cfg.residual_scaling,
        ).numpy()[0, 0]
    np.save(str(tmp_path / "expected.npy"), expected)
    base = ["verify-weights", "--inputs", arrays, "--blocks", "2", "--atol", "1e-5",
            "--device", "cpu"]

    rc, res = run_cli(capsys, base + ["--npz", npz, "--expected",
                                      str(tmp_path / "expected.npy")])
    assert rc == 0 and res["pass"] is True
    assert res["max_abs_err"] < 1e-5
    assert res["pixels_compared"] == 36 * 36

    bad = {k: v.copy() for k, v in g.items()}
    bad["final_conv_layer2/deform_conv/b"] = bad["final_conv_layer2/deform_conv/b"] + 1e-3
    badpath = str(tmp_path / "bad.npz")
    np.savez(badpath, **bad)
    rc2, res2 = run_cli(capsys, base + ["--npz", badpath, "--expected",
                                        str(tmp_path / "expected.npy")])
    assert rc2 == 1 and res2["pass"] is False

    np.save(str(tmp_path / "allnan.npy"), np.full_like(expected, np.nan))
    rc3, res3 = run_cli(capsys, base + ["--npz", npz, "--expected",
                                        str(tmp_path / "allnan.npy")])
    assert rc3 == 1 and res3["pass"] is False
    assert res3["pixels_compared"] == 0 and "finite" in res3["error"]


@pytest.mark.parametrize("argv", [
    # train's live curves are ported (tests/test_torch_port_viz.py);
    # --checkpoint reads the port's own checkpoints
    # (test_cli_train_then_predict_from_checkpoint)
    ["continent", "--inputs", "x", "--bounds", "0,0,1,1", "-o", "y", "--mesh-devices", "2"],
    ["continent", "--inputs", "x", "--bounds", "0,0,1,1", "-o", "y", "--multihost"],
])
def test_cli_unported_options_raise(argv, tmp_path, capsys):
    # the multi-device options are ported (tests/test_torch_port_parallel.py,
    # tests/test_torch_port_multihost.py); on a world of one process the CLI
    # refuses a 2-rank mesh, naming the world size, and --multihost without
    # --num-processes runs as one process; either way its group is gone after
    if "--mesh-devices" in argv:
        with pytest.raises(ValueError, match="world size is 1"):
            main(argv + ["--device", "cpu"])
        assert not torch.distributed.is_initialized()
        return
    inputs = tmp_path / "x"
    inputs.mkdir()
    rs = np.random.RandomState(0)
    for k, c, r in (("X", 1, 1), ("W1", 1, 10), ("W2", 2, 2), ("W3", 1, 1)):
        np.save(inputs / f"{k}.npy", rs.rand(1, c, 8 * r, 8 * r).astype(np.float32))
    sub = {"x": str(inputs), "y": str(tmp_path / "y"), "0,0,1,1": "0,0,8000,8000"}
    argv = [sub.get(a, a) for a in argv] + ["--device", "cpu", "--blocks", "1",
                                            "--tile-out", "32", "--halo-lr", "3"]
    rc, res = run_cli(capsys, argv)
    assert rc == 0 and not torch.distributed.is_initialized()
    assert res["sharded"] is False and res["processes"] == 1
    dem, _ = geotiff.read_geotiff(str(tmp_path / "y.tif"))
    assert dem.shape == (32, 32)


def test_cli_train_then_predict_from_checkpoint(capsys, tmp_path, monkeypatch):
    ck = str(tmp_path / "run.ckpt")
    rc, res = run_cli(capsys, ["train", "--synthetic-tiles", "10", "--epochs", "2",
                               "--batch-size", "4", "--blocks", "1", "--out", ck,
                               "--device", "cpu"])
    # JAX's summary line (deepbedmap_tpu/cli.py:cmd_train)
    assert rc == 0 and sorted(res) == sorted(
        ["command", "tiles", "epochs", "first_g_loss", "final_g_loss", "checkpoint"])
    assert res["command"] == "train" and res["tiles"] == 10 and res["epochs"] == 2
    assert res["checkpoint"] == ck and np.isfinite([res["first_g_loss"], res["final_g_loss"]]).all()

    rasters = _rasters()
    argv = ["predict", "--checkpoint", ck, "--blocks", "1", "--device", "cpu",
            "--bounds", "1000,1000,10000,10000", "-o", str(tmp_path / "dem.tif")]
    for name, flag in zip(RASTERS, FLAGS):
        path = str(tmp_path / name) + ".tif"
        r = rasters[name]
        geotiff.write_geotiff(path, r.data, r.left, r.top, r.res, compress=True)
        argv += [flag, path]
    monkeypatch.setitem(sys.modules, "h5py", None)
    rc, res = run_cli(capsys, argv)
    assert rc == 0 and res["shape"] == [36, 36]
    got, _ = geotiff.read_geotiff(str(tmp_path / "dem.tif"))
    want = DeepBedMap.from_checkpoint(ck, GeneratorConfig(num_residual_blocks=1),
                                      device="cpu").predict((1000.0, 1000.0, 1e4, 1e4), rasters)
    np.testing.assert_array_equal(got, want.data)

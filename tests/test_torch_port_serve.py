"""PyTorch port: the HTTP inference service (``deepbedmap_tpu_torch/serve.py``)
over loopback on the CPU, with ``pandas`` unimportable in every test (the
card's machine has none). The twelve cases of ``tests/test_serve.py`` on the
port's server, then: ``/predict`` of the port's server against the JAX
server's with the same weights through ``bridge.py``; the GeoTIFF and
preloaded paths without ``h5py``; concurrent requests; and the locks around
the CUDA kernel library's build, its launch counters and the packed-weight
cache."""

import json
import sys
import threading
import time
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepbedmap_tpu import DeepBedMap as JaxDeepBedMap
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.serve import make_server as jax_make_server
from deepbedmap_tpu_torch import DeepBedMap, GeneratorConfig
from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.data.raster import Raster, read_netcdf, write_netcdf
from deepbedmap_tpu_torch.evalx.track import grdtrack
from deepbedmap_tpu_torch.ops import _kernels, _packed
from deepbedmap_tpu_torch.ops.interp import as_f32
from deepbedmap_tpu_torch.serve import make_server

TINY = GeneratorConfig(num_residual_blocks=1)
# the port's server against the JAX server: fp32 on both sides in another
# summation order, within 1e-4 of the output's range (chip_smoke.py's
# TOL_GENERATOR)
TOL_GENERATOR = 1e-4


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
    """``import pandas`` raises in every test of this file."""
    monkeypatch.setitem(sys.modules, "pandas", None)


def _rasters():
    rs = np.random.RandomState(0)

    def r(h, w, res):
        return Raster(
            rs.rand(h, w).astype(np.float32), left=-5000.0, top=35000.0, res=res
        )

    return {
        "bed_lowres": r(40, 40, 1000.0),
        "surface": r(400, 400, 100.0),
        "velocity_x": r(90, 90, 450.0),
        "velocity_y": r(90, 90, 450.0),
        "accumulation": r(40, 40, 1000.0),
    }


def _write_csv(path, x, y, z):
    """A track file as pandas' ``to_csv(index=False)`` writes it, by numpy."""
    np.savetxt(path, np.column_stack([x, y, z]), delimiter=",", header="x,y,z",
               comments="", fmt="%.17g")


def _post(base, path, payload, headers=None):
    req = urllib.request.Request(
        base + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{srv.server_port}", thread


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=5)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def dbm():
    return DeepBedMap(cfg=TINY, device="cpu")


@pytest.fixture(scope="module")
def server(tmp_path_factory, dbm):
    tmp = tmp_path_factory.mktemp("serve")
    raster_paths = {}
    for name, raster in _rasters().items():
        p = str(tmp / f"{name}.nc")
        write_netcdf(raster, p)
        raster_paths[name] = p
    srv = make_server(dbm, data_root=str(tmp))
    base, thread = _start(srv)
    yield base, raster_paths, tmp
    _stop(srv, thread)


def test_healthz(server):
    base, _, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["status"] == "ok"
    assert body["model"]["num_residual_blocks"] == 1
    assert body["model"]["device"] == "cpu"


def test_predict_roundtrip(server, dbm):
    base, raster_paths, tmp = server
    out = str(tmp / "dem.nc")
    bounds = [1000.0, 1000.0, 10000.0, 10000.0]
    status, body = _post(base, "/predict",
                         {"bounds": bounds, "rasters": raster_paths, "out": out})
    assert status == 200, body
    assert body["shape"] == [36, 36]
    dem = read_netcdf(out)
    assert dem.bounds == tuple(bounds)
    assert np.isfinite(dem.data).all()
    # the served prediction is the model's own, bit for bit
    direct = dbm.predict(tuple(bounds), {k: read_netcdf(v) for k, v in raster_paths.items()})
    np.testing.assert_array_equal(dem.data, direct.data)

    status2, body2 = _post(
        base, "/predict",
        {"bounds": [2000.0, 2000.0, 11000.0, 11000.0], "rasters": raster_paths},
    )
    assert status2 == 200 and body2["shape"] == [36, 36]


def test_evaluate_endpoint(server):
    base, raster_paths, tmp = server
    dem = read_netcdf(raster_paths["bed_lowres"])
    rs = np.random.RandomState(3)
    tx = rs.uniform(0, 30000, 50)
    ty = rs.uniform(5000, 30000, 50)
    tz = grdtrack(as_f32(dem.data, "cpu"), as_f32(tx, "cpu"), as_f32(ty, "cpu"),
                  dem.left, dem.top, dem.res).numpy()
    track = str(tmp / "track.csv")
    _write_csv(track, tx, ty, tz)
    status, body = _post(
        base, "/evaluate", {"dem": raster_paths["bed_lowres"], "track": track}
    )
    assert status == 200, body
    assert body["rmse_m"] < 1e-4  # exact self-samples
    assert body["points"] == 50


def test_dem_product_endpoint(server):
    """/dem serves crops of a finished GeoTIFF product through windowed
    reads: bounds- and pixel-window selection, overview pages, stats,
    inline values, NetCDF out, and the window cap."""
    base, _, tmp = server
    rs = np.random.RandomState(7)
    data = (rs.rand(64, 80) * 1000 - 200).astype(np.float32)
    data[5, :4] = np.nan
    w = geotiff.GeoTiffStripWriter(
        str(tmp / "product.tif"), height=64, width=80,
        left=10000.0, top=74000.0, res=125.0,
        dtype=np.int16, nodata=-2000.0, compress=True, overviews=1,
    )
    w.write_strip(data)
    w.close()
    want = np.where(np.isfinite(data), data, -2000.0).astype(np.int16)

    code, body = _post(base, "/dem", {
        "product": "product.tif", "rows": [5, 7], "cols": [0, 6], "values": True,
    })
    assert code == 200, body
    assert body["shape"] == [2, 6]
    assert body["left"] == 10000.0 and body["top"] == 74000.0 - 5 * 125.0
    got = body["values"]
    assert got[0][:4] == [None] * 4
    assert got[0][4] == float(want[5, 4])

    out = "crop.nc"
    code, body = _post(base, "/dem", {
        "product": "product.tif",
        "bounds": [10000.0 + 10 * 125.0, 74000.0 - 30 * 125.0,
                   10000.0 + 30 * 125.0, 74000.0 - 10 * 125.0],
        "out": out,
    })
    assert code == 200, body
    assert body["shape"] == [20, 20]
    back = read_netcdf(str(tmp / out))
    np.testing.assert_allclose(back.data, want[10:30, 10:30].astype(np.float32))
    assert back.res == 125.0
    assert body["stats"]["valid_pct"] == 100.0

    code, body = _post(base, "/dem", {
        "product": "product.tif", "rows": [0, 32], "cols": [0, 40], "page": 1,
    })
    assert code == 200, body
    assert body["shape"] == [32, 40] and body["res"] == 250.0

    code, body = _post(base, "/dem", {
        "product": "product.tif", "rows": [0, 64], "cols": [0, 80], "values": True,
    })
    assert code == 200  # 5120 px <= inline cap
    code, body = _post(base, "/dem", {"product": "../escape.tif", "rows": [0, 1]})
    assert code == 403


def test_error_surfacing(server):
    base, _, _ = server
    status, body = _post(base, "/predict", {"bounds": [0, 0, 1000, 1000], "rasters": {}})
    assert status == 500
    assert "error" in body


def test_path_escape_rejected(server):
    base, raster_paths, _ = server
    for bad in ("/etc/passwd", "../../etc/passwd"):
        status, body = _post(
            base, "/predict",
            {"bounds": [1000.0, 1000.0, 10000.0, 10000.0],
             "rasters": {**raster_paths, "bed_lowres": bad}},
        )
        assert status == 403, body
        assert "escapes data root" in body["error"]
    status, body = _post(
        base, "/predict",
        {"bounds": [1000.0, 1000.0, 10000.0, 10000.0], "rasters": raster_paths,
         "out": "/tmp/evil.nc"},
    )
    assert status == 403, body


def test_oversize_body_and_window_rejected(server):
    base, raster_paths, _ = server
    status, body = _post(
        base, "/predict", {"bounds": [0.0, 0.0, 3e9, 3e9], "rasters": raster_paths},
    )
    assert status == 500 and "max_window_px" in body["error"]
    status, body = _post(base, "/predict", {"pad": "x" * (1 << 20)})
    assert status == 500 and "cap" in body["error"]


def test_oversize_body_is_answered_not_reset(dbm, tmp_path):
    # a body over the cap but within 16x of it is read away before the error
    # answer: closing on unread data would reset the connection, and the
    # client, still sending, would get a broken pipe instead of the reason
    srv = make_server(dbm, data_root=str(tmp_path), max_body_bytes=1 << 18)
    base, thread = _start(srv)
    try:
        for _ in range(3):
            status, body = _post(base, "/predict", {"pad": "x" * 4_000_000})
            assert status == 500 and "cap" in body["error"]
    finally:
        _stop(srv, thread)


def test_huge_padding_rejected(server):
    base, raster_paths, _ = server
    for padding in (1e9, -1.0):
        status, body = _post(
            base, "/predict",
            {"bounds": [0.0, 0.0, 1000.0, 1000.0], "rasters": raster_paths,
             "padding": padding},
        )
        assert status == 500 and "padding" in body["error"]


def test_negative_content_length_rejected(server):
    import http.client

    base, _, _ = server
    conn = http.client.HTTPConnection(base.removeprefix("http://"), timeout=30)
    try:
        conn.putrequest("POST", "/predict", skip_accept_encoding=True)
        conn.putheader("Content-Length", "-1")
        conn.endheaders()
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 500 and "cap" in body["error"]
    finally:
        conn.close()


def test_bearer_token_required(tmp_path, dbm):
    srv = make_server(dbm, data_root=str(tmp_path), token="s3cret")
    base, thread = _start(srv)
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            assert resp.status == 200
        status, body = _post(base, "/evaluate", {"dem": "x", "track": "y"})
        assert status == 401
        status, body = _post(base, "/evaluate", {"dem": "missing.nc", "track": "t.csv"},
                             headers={"Authorization": "Bearer s3cret"})
        assert status != 401  # authorized; fails later on the missing file
    finally:
        _stop(srv, thread)


def test_bucketed_windows_match_direct_predict(tmp_path, dbm):
    """bucket_px rounds windows up to power-of-two buckets; the sliced-back
    result must equal predicting the bucketed window and cropping it."""
    raster_paths = {}
    rasters = _rasters()
    for name, raster in rasters.items():
        p = str(tmp_path / f"{name}.nc")
        write_netcdf(raster, p)
        raster_paths[name] = p
    with pytest.raises(ValueError):
        make_server(dbm, data_root=str(tmp_path), bucket_px=6)  # not a multiple of 4
    srv = make_server(dbm, data_root=str(tmp_path), bucket_px=8)
    base, thread = _start(srv)
    try:
        # 3000x2000 m at 250 m/px = 12x8 px -> buckets to 16x8
        out = str(tmp_path / "bucketed.nc")
        status, body = _post(base, "/predict", {
            "bounds": [0.0, 25000.0, 3000.0, 27000.0], "rasters": raster_paths,
            "out": out})
        assert status == 200, body
        assert body["shape"] == [8, 12]
        got = read_netcdf(out)
        bucketed = dbm.predict((0.0, 25000.0, 4000.0, 27000.0), rasters)
        np.testing.assert_array_equal(got.data, bucketed.data[:8, :12])
        assert got.left == 0.0 and got.top == 27000.0 and got.res == 250.0
    finally:
        _stop(srv, thread)


def test_cache_invalidates_on_rewrite(server):
    """A rewritten raster file must not be served stale."""
    import os

    base, _, tmp = server
    p = str(tmp / "mutable.nc")
    write_netcdf(Raster(np.full((4, 4), 7.0, np.float32), left=0.0, top=4000.0,
                        res=1000.0), p)
    track = str(tmp / "flat_track.csv")
    _write_csv(track, [1500.0], [1500.0], [7.0])
    status, body = _post(base, "/evaluate", {"dem": p, "track": track})
    assert status == 200 and body["rmse_m"] < 1e-6
    write_netcdf(Raster(np.full((4, 4), 9.0, np.float32), left=0.0, top=4000.0,
                        res=1000.0), p)
    os.utime(p, ns=(time.time_ns(), time.time_ns() + 1))  # force an mtime change
    status, body = _post(base, "/evaluate", {"dem": p, "track": track})
    assert status == 200
    assert abs(body["rmse_m"] - 2.0) < 1e-6  # z=7 vs new dem=9


def test_predict_matches_jax_server(tmp_path):
    # the same O(1) weights in both servers, through bridge.py
    _, params = jax_build_generator(JaxGeneratorConfig(num_residual_blocks=1,
                                                       init_scale=1.0))
    port = DeepBedMap.from_jax_params(jax.tree_util.tree_map(np.asarray, params), TINY,
                                      device="cpu")
    ref = JaxDeepBedMap(params, JaxGeneratorConfig(num_residual_blocks=1))
    raster_paths = {}
    for name, raster in _rasters().items():
        raster_paths[name] = str(tmp_path / f"{name}.nc")
        write_netcdf(raster, raster_paths[name])
    outs = {}
    for name, srv in (("port", make_server(port, data_root=str(tmp_path))),
                      ("jax", jax_make_server(ref, data_root=str(tmp_path)))):
        base, thread = _start(srv)
        try:
            status, body = _post(base, "/predict", {
                "bounds": [1000.0, 1000.0, 10000.0, 10000.0], "rasters": raster_paths,
                "out": f"{name}.tif", "format": "geotiff"})
            assert status == 200, body
        finally:
            _stop(srv, thread)
        outs[name], meta = geotiff.read_geotiff(str(tmp_path / f"{name}.tif"))
        assert meta["left"] == 1000.0 and meta["top"] == 10000.0 and meta["res"] == 250.0
    scale = np.abs(outs["jax"]).max()
    assert outs["port"].shape == (36, 36) and scale > 0.1
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0, atol=TOL_GENERATOR * scale)


def test_geotiff_and_preloaded_paths_need_no_h5py(tmp_path, dbm, monkeypatch):
    """What the card's machine runs: preloaded rasters, GeoTIFF out, /dem and
    /evaluate on GeoTIFF, with neither pandas nor h5py importable; and four
    concurrent /predict requests, each equal to a single one."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    rasters = _rasters()
    srv = make_server(dbm, raster_cache=rasters, data_root=str(tmp_path))
    base, thread = _start(srv)
    names = {k: k for k in rasters}
    bounds = (1000.0, 1000.0, 10000.0, 10000.0)
    try:
        status, body = _post(base, "/predict", {"bounds": list(bounds), "rasters": names,
                                                "out": "one.tif", "format": "geotiff"})
        assert status == 200, body
        one, _ = geotiff.read_geotiff(str(tmp_path / "one.tif"))
        np.testing.assert_array_equal(one, dbm.predict(bounds, rasters).data)

        results = [None] * 4

        def request(i):
            results[i] = _post(base, "/predict", {
                "bounds": list(bounds), "rasters": names, "out": f"c{i}.tif",
                "format": "geotiff"})

        threads = [threading.Thread(target=request, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i in range(4):
            assert results[i][0] == 200, results[i]
            got, _ = geotiff.read_geotiff(str(tmp_path / f"c{i}.tif"))
            np.testing.assert_array_equal(got, one)

        status, body = _post(base, "/dem", {"product": "one.tif", "rows": [3, 9],
                                            "cols": [2, 30], "values": True})
        assert status == 200, body
        np.testing.assert_array_equal(np.array(body["values"], np.float32), one[3:9, 2:30])

        rs = np.random.RandomState(5)
        tx, ty = rs.uniform(2000, 9000, 40), rs.uniform(2000, 9000, 40)
        tz = rs.uniform(-1, 1, 40)
        _write_csv(str(tmp_path / "t.csv"), tx, ty, tz)
        status, body = _post(base, "/evaluate", {"dem": "one.tif", "track": "t.csv"})
        assert status == 200, body
        assert body["rmse_m"] == dbm.track_rmse(Raster(one, 1000.0, 10000.0, 250.0),
                                                tx, ty, tz)
        # NetCDF is what needs h5py: it fails as a request error
        status, body = _post(base, "/predict", {"bounds": list(bounds), "rasters": names,
                                                "out": "x.nc"})
        assert status == 500 and "h5py" in body["error"]
    finally:
        _stop(srv, thread)


class _FakeLib:
    """Stands in for a loaded library: any attribute is a settable function."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_kernel_library_builds_once_under_concurrent_first_use(tmp_path, monkeypatch):
    calls = {"build": 0, "load": 0}

    def slow_build(srcs, out_dir, so):
        calls["build"] += 1
        time.sleep(0.05)
        return ""

    def load(path):
        calls["load"] += 1
        return _FakeLib()

    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "_build", slow_build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", load)
    monkeypatch.setenv("DEEPBEDMAP_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait()
        got.append(_kernels.library())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(lib is got[0] for lib in got)


def test_launch_counts_survive_concurrent_launches(monkeypatch):
    # 16 threads launch 2000 times each with a short switch interval: a lost
    # update of launches[name] would show in the count
    lib = types.SimpleNamespace(rdb_forward=lambda *args: 0)
    monkeypatch.setattr(_kernels, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(_kernels.launches, "rdb_forward", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_kernels._call("rdb_forward")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _kernels.launches["rdb_forward"] == 16 * 2000


def test_packed_weights_packed_once_under_concurrent_first_use():
    calls = []

    def pack(w):
        calls.append(1)
        time.sleep(0.05)
        return w * 2

    w = torch.ones(3)
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait()
        got.append(_packed.packed(pack, [w]))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 8 and all(g is got[0] for g in got)

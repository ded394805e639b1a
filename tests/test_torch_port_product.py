"""PyTorch port: the continent product (``DeepBedMap.predict_continent`` with
``outfilepath``, buffered and streamed into the int16 LZW GeoTIFF) on the
CPU, on ``tests/test_torch_port_continent.py``'s region (2 bands x 3 tiles).
The buffered product must decode to the int16 of its own canvas exactly; the
streamed product must be byte-identical to the JAX package's
``GeoTiffStripWriter`` fed the port's canvas in the same strips; the canvas
agrees with JAX's within that file's tolerance. The failure paths of
``tests/test_continent.py`` are ported: writer errors surface in the caller,
a failed forward leaves no file, ``abort`` semantics."""

import threading

import jax
import numpy as np
import pytest
import torch

from deepbedmap_tpu import DeepBedMap as JaxDeepBedMap
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.data import geotiff as jax_geotiff
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.inference import TilePlan, predict_continent_to_geotiff

CFG = dict(num_residual_blocks=2)
RES = 250.0
BOUNDS = (0.0, 0.0, 96 * RES, 64 * RES)
KW = dict(tile_out=32, halo_lr=3, tiles_per_dispatch=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs_nchw(lh, lw, seed):
    rs = np.random.RandomState(seed)
    return {
        "X": rs.rand(1, 1, lh, lw).astype(np.float32),
        "W1": (rs.rand(1, 1, 10 * lh, 10 * lw) - 0.2).astype(np.float32),
        "W2": (rs.rand(1, 2, 2 * lh, 2 * lw) - 0.2).astype(np.float32),
        "W3": rs.rand(1, 1, lh, lw).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_params():
    # O(1) weights so that the int16 product holds more than zeros
    _, params = jax_build_generator(JaxGeneratorConfig(**CFG, init_scale=1.0))
    return params


@pytest.fixture(scope="module")
def port(jax_params):
    return DeepBedMap.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params), GeneratorConfig(**CFG),
        device="cpu",
    )


@pytest.fixture(scope="module")
def buffered(port, tmp_path_factory):
    """The buffered product (``save_continent_dem``) and its canvas."""
    out = str(tmp_path_factory.mktemp("buffered") / "dem")
    raster = port.predict_continent(_inputs_nchw(16, 24, 0), BOUNDS, outfilepath=out, **KW)
    return raster.data, out + ".tif"


def _int16(canvas):
    return np.where(np.isfinite(canvas), canvas, -2000.0).astype(np.int16)


def test_buffered_product_is_the_canvas(buffered, jax_params):
    canvas, path = buffered
    back, meta = geotiff.read_geotiff(path)
    np.testing.assert_array_equal(back, _int16(canvas))
    assert len(np.unique(back)) > 3  # O(1) outputs: the product is not all zeros
    assert meta == {"left": 0.0, "top": 64 * RES, "res": RES, "nodata": -2000.0,
                    "crs_epsg": 3031}
    with open(path, "rb") as f:
        _, tags = geotiff._read_ifd_tags(f, 0)
    assert geotiff._T_TILE_OFFSETS in tags and geotiff._T_STRIP_OFFSETS not in tags
    # the canvas against JAX's: fp32 on both sides in another summation
    # order, atol 1e-5 of the range (tests/test_torch_port_continent.py)
    want = JaxDeepBedMap(jax_params, JaxGeneratorConfig(**CFG)).predict_continent(
        _inputs_nchw(16, 24, 0), BOUNDS, **KW).data
    scale = np.abs(want).max()
    np.testing.assert_allclose(canvas, want, rtol=1e-4, atol=1e-5 * scale)


# (rows_per_strip as passed, as the JAX writer gets it, overviews, predictor);
# None resolves to tile_out / 8 rows
STREAM_CASES = [(None, 4, 0, False), (None, 4, 2, True), (0, None, 1, False),
                (8, 8, 2, False)]


@pytest.mark.parametrize("rps,writer_rps,overviews,predictor", STREAM_CASES)
def test_streamed_product_matches_jax_writer(port, buffered, tmp_path, rps, writer_rps,
                                             overviews, predictor):
    canvas, buffered_path = buffered
    out = str(tmp_path / "streamed")
    assert port.predict_continent(
        _inputs_nchw(16, 24, 0), BOUNDS, outfilepath=out, stream_product=True,
        rows_per_strip=rps, overviews=overviews, predictor=predictor, **KW) is None
    ref = str(tmp_path / "jax.tif")
    w = jax_geotiff.GeoTiffStripWriter(
        ref, height=64, width=96, left=0.0, top=64 * RES, res=RES, dtype=np.int16,
        nodata=-2000.0, compress=True, rows_per_strip=writer_rps, overviews=overviews,
        predictor=predictor,
    )
    for band in range(2):  # the band loop's strips: tile_out rows each
        w.write_strip(canvas[band * 32 : (band + 1) * 32])
    w.close()
    with open(out + ".tif", "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    page0, _ = geotiff.read_geotiff(out + ".tif")
    np.testing.assert_array_equal(page0, geotiff.read_geotiff(buffered_path)[0])


def test_product_options_need_the_streamed_writer(port, tmp_path):
    inputs = _inputs_nchw(8, 8, 0)
    bounds = (0.0, 0.0, 8000.0, 8000.0)
    for option in (dict(overviews=1), dict(predictor=True)):
        with pytest.raises(ValueError, match="stream_product"):
            port.predict_continent(inputs, bounds, outfilepath=str(tmp_path / "x"),
                                   tile_out=32, halo_lr=3, **option)
    with pytest.raises(ValueError, match="outfilepath"):
        port.predict_continent(inputs, bounds, stream_product=True, tile_out=32, halo_lr=3)
    assert not list(tmp_path.iterdir())


def _host_inputs(plan, seed):
    rs = np.random.RandomState(seed)
    lh, lw = plan.lr_shape
    return {
        "X": rs.rand(1, lh, lw, 1).astype(np.float32),
        "W1": rs.rand(1, 10 * lh, 10 * lw, 1).astype(np.float32),
        "W2": rs.rand(1, 2 * lh, 2 * lw, 2).astype(np.float32),
        "W3": rs.rand(1, lh, lw, 1).astype(np.float32),
    }


def test_streamed_product_surfaces_writer_error(port, tmp_path, monkeypatch):
    """A writer-thread failure mid-stream (e.g. disk full) must surface in the
    caller, under the prefetching band pipeline too, without deadlocking the
    strip queue or leaking the drain thread, and leave no partial product."""
    calls = {"n": 0}
    orig = geotiff.GeoTiffStripWriter.write_strip

    def failing_write(self, rows):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("disk full (simulated)")
        return orig(self, rows)

    monkeypatch.setattr(geotiff.GeoTiffStripWriter, "write_strip", failing_write)
    plan = TilePlan(out_h=96, out_w=64, tile_out=32, halo_lr=3)
    n0 = threading.active_count()
    with pytest.raises(OSError, match="disk full"):
        predict_continent_to_geotiff(
            port.forward_fn(), _host_inputs(plan, 13), plan,
            (0.0, 0.0, 64 * RES, 96 * RES), str(tmp_path / "dem"),
            clip_conditioning=False, prefetch=2, device="cpu",
        )
    assert threading.active_count() == n0  # drain thread joined
    assert not (tmp_path / "dem.tif").exists()


def test_streamed_product_forward_failure_leaves_clean_filesystem(port, tmp_path):
    """A compute-path failure mid-stream (a band input of the wrong shape)
    must abort the writer: no open handle, no partial .tif left behind."""
    plan = TilePlan(out_h=96, out_w=64, tile_out=32, halo_lr=3)
    inputs = _host_inputs(plan, 17)
    inputs["W1"] = inputs["W1"][:, :11]
    n0 = threading.active_count()
    with pytest.raises(ValueError, match="W1"):
        predict_continent_to_geotiff(
            port.forward_fn(), inputs, plan, (0.0, 0.0, 64 * RES, 96 * RES),
            str(tmp_path / "dem2"), clip_conditioning=False, device="cpu",
        )
    assert threading.active_count() == n0
    assert not (tmp_path / "dem2.tif").exists()


def test_strip_writer_abort_semantics(tmp_path):
    """abort() closes and unlinks a partial write, is idempotent, and never
    deletes a finished product when called after close()."""
    path = str(tmp_path / "w.tif")
    w = geotiff.GeoTiffStripWriter(
        path, height=16, width=8, left=0.0, top=16 * RES, res=RES,
        dtype=np.int16, nodata=-2000.0, compress=True,
    )
    w.write_strip(np.ones((8, 8), np.int16))
    w.abort()
    assert w._f.closed and not (tmp_path / "w.tif").exists()
    w.abort()  # idempotent

    w2 = geotiff.GeoTiffStripWriter(
        path, height=8, width=8, left=0.0, top=8 * RES, res=RES,
        dtype=np.int16, nodata=-2000.0, compress=True,
    )
    w2.write_strip(np.ones((8, 8), np.int16))
    w2.close()
    w2.abort()  # after close: must not unlink the finished file
    data, _ = geotiff.read_geotiff(path)
    np.testing.assert_array_equal(data, np.ones((8, 8), np.int16))

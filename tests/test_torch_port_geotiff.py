"""PyTorch port: the GeoTIFF codec (``deepbedmap_tpu_torch/data/geotiff.py``,
its native LZW ``data/_tiffnative.py`` and ``save_array_to_grid``) against the
JAX package's: the same arrays and strips must give byte-identical files, each
package must read the other's files to equal arrays, and the native LZW must
give the pure-Python codec's bytes. All exact: no tolerance."""

import threading
import time
import types

import numpy as np
import pytest

from deepbedmap_tpu.data import geotiff as jax_geotiff
from deepbedmap_tpu.data import tiler as jax_tiler
from deepbedmap_tpu_torch.data import _tiffnative, geotiff
from deepbedmap_tpu_torch.data import tiler
from deepbedmap_tpu_torch.data.raster import read_netcdf


def _field(h, w, seed, dtype, border):
    """A smooth field with noise (so LZW and PREDICTOR=2 both matter) and a
    missing border: NaN for floats, the nodata value for integers."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = 300 * np.sin(xx / 17.0) * np.cos(yy / 23.0) - 150 + rs.randn(h, w) * 4
    fill = np.nan if np.dtype(dtype).kind == "f" else -2000
    a = a.astype(dtype)
    if border:
        a[:3] = fill
        a[:, -2:] = fill
    return a


# (dtype, tiled, compress, predictor, shape, bigtiff)
WRITE_CASES = [
    ("int16", False, False, False, (70, 90), None),
    ("int16", False, True, False, (70, 90), None),
    ("int16", False, True, True, (70, 90), None),
    ("int16", True, False, False, (70, 90), None),
    ("int16", True, True, False, (70, 90), None),
    ("int16", True, True, True, (70, 90), True),
    ("float32", False, False, False, (70, 90), None),
    ("float32", False, True, False, (1200, 600), None),  # three ~1 MB strips
    ("float32", True, False, False, (70, 90), None),
    ("float32", True, True, False, (70, 90), True),
]


@pytest.mark.parametrize("dtype,tiled,compress,predictor,shape,bigtiff", WRITE_CASES)
def test_write_geotiff_byte_identical(tmp_path, dtype, tiled, compress, predictor, shape,
                                      bigtiff):
    a = _field(*shape, seed=1, dtype=dtype, border=True)
    nodata = -2000.0 if dtype == "int16" else -9999.0
    kw = dict(left=-1.6e6, top=-2.5e5, res=250.0, nodata=nodata, compress=compress,
              tiled=tiled, tile_size=32, bigtiff=bigtiff, predictor=predictor)
    jax_geotiff.write_geotiff(str(tmp_path / "jax.tif"), a, **kw)
    geotiff.write_geotiff(str(tmp_path / "port.tif"), a, **kw)
    got = (tmp_path / "port.tif").read_bytes()
    assert got == (tmp_path / "jax.tif").read_bytes()
    back, meta = geotiff.read_geotiff(str(tmp_path / "port.tif"))
    np.testing.assert_array_equal(back, a)
    assert meta == {"left": -1.6e6, "top": -2.5e5, "res": 250.0, "nodata": nodata,
                    "crs_epsg": 3031}


def _write_strips(module, path, canvas, rows_per_strip, overviews, predictor):
    h, w = canvas.shape
    wr = module.GeoTiffStripWriter(
        path, height=h, width=w, left=0.0, top=h * 250.0, res=250.0, dtype=np.int16,
        nodata=-2000.0, compress=True, rows_per_strip=rows_per_strip or None,
        overviews=overviews, predictor=predictor,
    )
    for r0 in range(0, h, 16):  # uneven: the last strip is 2 rows
        wr.write_strip(canvas[r0 : r0 + 16])
    wr.close()


@pytest.mark.parametrize("rows_per_strip", [0, 8])
@pytest.mark.parametrize("overviews", [0, 2])
@pytest.mark.parametrize("predictor", [False, True])
def test_strip_writer_byte_identical(tmp_path, rows_per_strip, overviews, predictor):
    canvas = _field(50, 70, seed=2, dtype="float32", border=True)
    canvas[20:26, 30:41] = np.nan  # a hole spanning whole 2x2 and 4x4 blocks
    args = (canvas, rows_per_strip, overviews, predictor)
    _write_strips(jax_geotiff, str(tmp_path / "jax.tif"), *args)
    _write_strips(geotiff, str(tmp_path / "port.tif"), *args)
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()


def _windows(h, w):
    """The whole page, a ragged window, its last pixel, and rows running past
    the end with all columns."""
    return [((0, h), (0, w)), ((h // 5, h - 1), (w // 7, w - 2)), ((h - 1, h), (w - 1, w)),
            ((h // 2, h + 999), None)]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("layout", ["tiled", "strips+overviews"])
def test_each_package_reads_the_others_files(tmp_path, writer, layout):
    canvas = _field(50, 70, seed=3, dtype="float32", border=True)
    path = str(tmp_path / "f.tif")
    module = jax_geotiff if writer == "jax" else geotiff
    pages = [0]
    if layout == "tiled":
        ints = np.where(np.isfinite(canvas), canvas, -2000).astype(np.int16)
        module.write_geotiff(path, ints, 0.0, 50 * 250.0, 250.0, nodata=-2000.0,
                             compress=True, tiled=True, tile_size=16, predictor=True)
    else:
        _write_strips(module, path, canvas, 8, 2, True)
        pages = [0, 1, 2]
    for page in pages:
        a, meta_a = jax_geotiff.read_geotiff(path, page=page)
        b, meta_b = geotiff.read_geotiff(path, page=page)
        np.testing.assert_array_equal(b, a)
        assert meta_b == meta_a and b.dtype == a.dtype == np.int16
        assert geotiff.read_geotiff_meta(path, page) == jax_geotiff.read_geotiff_meta(path, page)
        for rows, cols in _windows(*a.shape):
            wa, ma = jax_geotiff.read_geotiff_window(path, rows, cols, page=page)
            wb, mb = geotiff.read_geotiff_window(path, rows, cols, page=page)
            np.testing.assert_array_equal(wb, wa)
            assert mb == ma
            c0, c1 = cols or (0, a.shape[1])
            np.testing.assert_array_equal(wb, a[rows[0] : rows[1], c0:c1])
    if layout != "tiled":
        assert geotiff.read_geotiff_meta(path, 2)["res"] == 1000.0


def _lzw_payloads():
    rs = np.random.RandomState(4)
    smooth = _field(64, 300, seed=5, dtype="int16", border=False)
    return {
        "smooth": smooth.tobytes(),
        "predicted": geotiff._hdiff(smooth).tobytes(),
        "random": rs.randint(0, 256, 20000).astype(np.uint8).tobytes(),
        "runs": bytes(5000) + b"\x07" * 7000 + bytes(range(256)) * 40,
        "empty": b"",
        "one": b"\x2a",
    }


@pytest.mark.parametrize("name", list(_lzw_payloads()))
def test_native_lzw_equals_python_lzw(name):
    data = _lzw_payloads()[name]
    encoded = geotiff._lzw_encode_py(data)
    assert _tiffnative.lzw_encode(data) == encoded
    assert geotiff.lzw_encode(data) == encoded  # the port's public path is native
    assert _tiffnative.lzw_decode(encoded) == data
    assert geotiff._lzw_decode_py(encoded) == data
    if data:
        blocks = [data, data[: len(data) // 2], data[::3]]
        assert _tiffnative.lzw_encode_blocks(blocks) == [geotiff._lzw_encode_py(b)
                                                         for b in blocks]
        decoded = _tiffnative.lzw_decode_blocks(
            [geotiff._lzw_encode_py(b) for b in blocks], [len(b) for b in blocks])
        assert decoded == b"".join(blocks)


@pytest.mark.parametrize("dtype", [None, "int16"])
def test_save_array_to_grid_matches_jax(tmp_path, dtype):
    a = _field(36, 44, seed=6, dtype="float32", border=False)[None]
    bounds = (-1.6e6, -2.6e5, -1.6e6 + 44 * 250.0, -2.6e5 + 36 * 250.0)
    jax_tiler.save_array_to_grid(a, bounds, str(tmp_path / "jax"), dtype=dtype,
                                 save_netcdf=True)
    tiler.save_array_to_grid(a, bounds, str(tmp_path / "port"), dtype=dtype,
                             save_netcdf=True)
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()
    nc = read_netcdf(str(tmp_path / "port.nc"))
    np.testing.assert_array_equal(nc.data, a[0])
    assert nc.bounds == bounds and nc.nodata == -2000.0
    with pytest.raises(ValueError):
        tiler.save_array_to_grid(a[0], bounds, str(tmp_path / "bad"))


class _FakeLib:
    """Stands in for a loaded library: any attribute is a settable function."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_native_build_is_locked(tmp_path, monkeypatch):
    # 8 threads ask for the codec at once: one build and one load, and every
    # thread gets the same library
    calls = {"build": 0, "load": 0}

    def slow_build(so):
        calls["build"] += 1
        time.sleep(0.05)

    def load(path):
        calls["load"] += 1
        return _FakeLib()

    monkeypatch.setattr(_tiffnative, "_lib", None)
    monkeypatch.setattr(_tiffnative, "path", None)
    monkeypatch.setattr(_tiffnative, "_build", slow_build)
    monkeypatch.setattr(_tiffnative.ctypes, "CDLL", load)
    monkeypatch.setenv("DEEPBEDMAP_TORCH_BUILD_DIR", str(tmp_path / "native"))
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait()
        got.append(_tiffnative.library())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert _tiffnative.path.startswith(str(tmp_path / "native"))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    # no quiet fall-back to the Python codec: a codec that cannot be built
    # makes the product path raise
    bad = tmp_path / "tiffcodec.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_tiffnative, "_lib", None)
    monkeypatch.setattr(_tiffnative, "path", None)
    monkeypatch.setattr(_tiffnative, "_SRC", bad)
    monkeypatch.setenv("DEEPBEDMAP_TORCH_BUILD_DIR", str(tmp_path / "native"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        geotiff.write_geotiff(str(tmp_path / "x.tif"), np.zeros((4, 4), np.int16),
                              0.0, 4.0, 1.0, compress=True)

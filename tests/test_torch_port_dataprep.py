"""PyTorch port: data prep's host layers against the JAX package.

``data/proj.py``, ``config.TilingConfig``, ``data/windows.py`` and
``data/geojson.py`` are copies: each function's output equals JAX's exactly
on seeded inputs, and the cases of ``tests/test_data.py`` (projection, window
goldens) and ``tests/test_geojson.py`` run on the port. ``data/pipeline.py``
reads the survey formats without pandas: on each of the 11 packaged
configs, with ``tests/survey_fixtures.py``'s miniatures (junk header lines
and columns, multi-file globs, single-member zips, ``*`` markers, lon/lat
files), ``ascii_to_xyz`` equals JAX's pandas result bit for bit; its table
reader and float parser equal ``pd.read_csv`` on edge cases; a converter
other than ``A-B`` raises; and the module imports and runs with pandas
blocked. Tolerance: none anywhere in this file.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch

from deepbedmap_tpu.config import TilingConfig as JaxTilingConfig
from deepbedmap_tpu.data import geojson as jax_geojson
from deepbedmap_tpu.data import pipeline as jax_pipeline
from deepbedmap_tpu.data import proj as jax_proj
from deepbedmap_tpu.data import windows as jax_windows
from deepbedmap_tpu.data.raster import Raster as JaxRaster
from deepbedmap_tpu_torch.config import DEFAULT_TILING, TilingConfig
from deepbedmap_tpu_torch.data import geojson, pipeline, proj, windows
from deepbedmap_tpu_torch.data.raster import Raster
from tests.survey_fixtures import make_survey_miniature

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = pipeline.list_survey_configs()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(a, b) -> bool:
    """Equal bit for bit, NaN and the sign of zero included."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool((a.view(np.int64) == b.view(np.int64)).all())


def _ulps(a, b) -> str:
    """Where two float64 arrays differ: how many values and how many ulps."""
    ia = np.asarray(a, np.float64).view(np.int64)
    ib = np.asarray(b, np.float64).view(np.int64)
    bad = np.nonzero(ia != ib)[0]
    return f"{len(bad)} values differ, first at {bad[:3]} by {np.abs(ia - ib)[bad[:3]]} ulps"


def test_tiling_config_matches_jax():
    assert dataclasses.asdict(TilingConfig()) == dataclasses.asdict(JaxTilingConfig())
    assert DEFAULT_TILING == TilingConfig()


def test_projection_matches_jax_and_round_trips():
    rs = np.random.RandomState(0)
    lon = rs.uniform(-180, 180, 1000)
    lat = rs.uniform(-89.9, -60, 1000)
    x, y = proj.lonlat_to_xy(lon, lat)
    jx, jy = jax_proj.lonlat_to_xy(lon, lat)
    assert _same(x, jx) and _same(y, jy)
    lon2, lat2 = proj.xy_to_lonlat(x, y)
    jlon2, jlat2 = jax_proj.xy_to_lonlat(x, y)
    assert _same(lon2, jlon2) and _same(lat2, jlat2)
    assert proj.parallel_radius(-71.0) == jax_proj.parallel_radius(-71.0)
    # tests/test_data.py's goldens: round trip, true scale on -71, the pole
    dlon = (np.asarray(lon2) - lon + 180) % 360 - 180
    np.testing.assert_allclose(dlon, 0, atol=1e-9)
    np.testing.assert_allclose(lat2, lat, atol=1e-9)
    x71, y71 = proj.lonlat_to_xy(0.0, -71.0)
    np.testing.assert_allclose(np.hypot(x71, y71), proj.parallel_radius(-71.0), rtol=1e-12)
    x0, y0 = proj.lonlat_to_xy(0.0, -90.0)
    assert abs(x0) < 1e-6 and abs(y0) < 1e-6
    xe, ye = proj.lonlat_to_xy(90.0, -80.0)
    assert xe > 0 and abs(ye) < 1e-6


def _rasters(data, left, top, res):
    return (Raster(data.astype(np.float32), left=left, top=top, res=res),
            JaxRaster(data.astype(np.float32), left=left, top=top, res=res))


def test_get_window_bounds_golden_and_matches_jax():
    # reference doctest (data_prep.py:513-521), as tests/test_data.py holds it
    golden = Raster.from_centers(np.zeros((40, 36)), x=np.arange(0.5, 36.5),
                                 y=np.arange(0.5, 40.5))
    assert windows.get_window_bounds(golden) == [(0.0, 4.0, 36.0, 40.0),
                                                 (0.0, 1.0, 36.0, 37.0)]
    rs = np.random.RandomState(1)
    data = rs.normal(size=(97, 83))
    data[rs.rand(97, 83) < 0.002] = np.nan
    ours, theirs = _rasters(data, -1_600_123.0, -250_456.0, 250.0)
    for size, step in ((36, 3), (36, 7), (20, 1), (90, 3)):
        got = windows.get_window_bounds(ours, size, size, step)
        assert got == jax_windows.get_window_bounds(theirs, size, size, step)
    assert len(windows.get_window_bounds(ours, 20, 20, 1)) > 100


def test_filter_within_polygon_matches_jax():
    square = np.array([[0, 0], [100, 0], [100, 100], [0, 100]], np.float64)
    cases = [(10, 10, 20, 20), (95, 95, 105, 105), (200, 200, 210, 210)]
    assert windows.filter_within_polygon(cases, square, buffer=10.0) == [0, 1]
    rs = np.random.RandomState(2)
    notch = np.array([(20.0, 0), (100, 0), (100, 90), (0, 90), (0, 20), (20, 20)])
    origins = rs.uniform(-20, 110, (500, 2))
    wb = [(x, y, x + 9, y + 9) for x, y in origins]
    for poly, buffer in ((square, 10.0), (notch, 5.0), (notch, 0.0)):
        got = windows.filter_within_polygon(wb, poly, buffer=buffer)
        assert got == jax_windows.filter_within_polygon(wb, poly, buffer=buffer)


def _multipolygon_doc():
    # tests/test_geojson.py's: two squares, the first with a hole
    return {"type": "FeatureCollection", "features": [{
        "type": "Feature", "properties": {},
        "geometry": {"type": "MultiPolygon", "coordinates": [
            [[[0, 0], [100, 0], [100, 100], [0, 100], [0, 0]],
             [[40, 40], [60, 40], [60, 60], [40, 60], [40, 40]]],
            [[[200, 0], [300, 0], [300, 100], [200, 100], [200, 0]]],
        ]},
    }]}


def test_geojson_load_and_membership_match_jax():
    ps = geojson.load_polygons(_multipolygon_doc())
    jps = jax_geojson.load_polygons(_multipolygon_doc())
    assert ps.num_polygons == jps.num_polygons == 2
    for (o, hs), (jo, jhs) in zip(ps.polygons, jps.polygons):
        assert _same(o, jo) and len(hs) == len(jhs) == len(hs)
        assert all(_same(h, jh) for h, jh in zip(hs, jhs))
    # tests/test_geojson.py's points, then seeded ones
    px = np.array([50.0, 10.0, 250.0, 150.0, 50.0])
    py = np.array([50.0, 10.0, 50.0, 50.0, 41.0])
    assert ps.contains(px, py).tolist() == [False, True, True, False, False]
    bx = np.array([50.0, 105.0, 150.0, 50.0])
    by = np.array([50.0, 50.0, 50.0, 50.0])
    assert ps.contains_buffered(bx, by, buffer=10.0).tolist() == [True, True, False, True]
    rs = np.random.RandomState(3)
    qx, qy = rs.uniform(-20, 320, 2000), rs.uniform(-20, 120, 2000)
    assert (ps.contains(qx, qy) == jps.contains(qx, qy)).all()
    assert _same(ps.boundary_distance(qx, qy), jps.boundary_distance(qx, qy))
    for buffer in (0.0, 3.0, 10.0):
        assert (ps.contains_buffered(qx, qy, buffer)
                == jps.contains_buffered(qx, qy, buffer)).all()


def test_geojson_filter_matches_single_ring_filter_and_jax():
    rng = np.random.RandomState(0)
    square = np.array([[0, 0], [1000, 0], [1000, 1000], [0, 1000]], float)
    ps = geojson.PolygonSet(((square, ()),))
    origins = rng.rand(50, 2) * 1200 - 100
    bounds = [(x, y, x + 50, y + 50) for x, y in origins]
    multi = geojson.filter_within_polygons(bounds, ps, buffer=25.0)
    assert windows.filter_within_polygon(bounds, square, buffer=25.0) == multi
    assert len(multi) > 5
    jps = jax_geojson.load_polygons(_multipolygon_doc())
    wb = [(x, y, x + 20, y + 20) for x, y in rng.uniform(-30, 320, (300, 2))]
    assert (geojson.filter_within_polygons(wb, geojson.load_polygons(_multipolygon_doc()), 8.0)
            == jax_geojson.filter_within_polygons(wb, jps, 8.0))
    assert geojson.filter_within_polygons([], ps) == []


@pytest.mark.parametrize("to_lonlat", [False, True])
def test_write_tiles_geojson_matches_jax(tmp_path, to_lonlat):
    bounds = [(-1_600_000.0, -180_000.0, -1_590_000.0, -170_000.0),
              (-1_580_000.0, -160_000.0, -1_570_000.0, -150_000.0)]
    ours, theirs = tmp_path / "ours.geojson", tmp_path / "theirs.geojson"
    geojson.write_tiles_geojson(bounds, str(ours), to_lonlat=to_lonlat)
    jax_geojson.write_tiles_geojson(bounds, str(theirs), to_lonlat=to_lonlat)
    assert ours.read_bytes() == theirs.read_bytes()
    doc = json.loads(ours.read_text())
    assert doc["type"] == "FeatureCollection" and len(doc["features"]) == 2
    ring = doc["features"][0]["geometry"]["coordinates"][0]
    assert tuple(ring[0]) == tuple(ring[-1])
    if to_lonlat:
        # the 4326 twin reprojects back onto the same projected corners
        ps = geojson.load_polygons(str(ours), reproject_lonlat=True)
        outer, _ = ps.polygons[0]
        np.testing.assert_allclose(outer[0], bounds[0][:2], atol=1.0)
        np.testing.assert_allclose(outer[2], bounds[0][2:], atol=1.0)
        jouter = jax_geojson.load_polygons(str(theirs), reproject_lonlat=True).polygons[0][0]
        assert _same(outer, jouter)
    else:
        assert "3031" in doc["crs"]["properties"]["name"]


def test_packaged_survey_configs_are_jax_copies():
    jax_configs = jax_pipeline.list_survey_configs()
    assert [os.path.basename(p) for p in CONFIGS] == [os.path.basename(p) for p in jax_configs]
    assert len(CONFIGS) == 11
    for ours, theirs in zip(CONFIGS, jax_configs):
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), ours
    assert pipeline.survey_config_path("2010tr") == CONFIGS[CONFIGS.index(
        pipeline.survey_config_path("2010tr"))]
    with pytest.raises(ValueError):
        pipeline.survey_config_path("no_such_survey")


@pytest.mark.parametrize("config", CONFIGS, ids=[os.path.basename(c)[:-5] for c in CONFIGS])
def test_ascii_to_xyz_matches_jax(config, tmp_path):
    """Every packaged format on the fixture's miniature: the port's columns
    equal JAX's pandas columns bit for bit (pandas' float parser included:
    the miniatures carry 17-digit numbers, where it is not correctly
    rounded)."""
    expected = make_survey_miniature(config, str(tmp_path), n_points=400, seed=7)
    jax_config = os.path.join(jax_pipeline.SURVEYS_DIR, os.path.basename(config))
    theirs = jax_pipeline.ascii_to_xyz(jax_config, data_dir=str(tmp_path))
    ours = pipeline.ascii_to_xyz(config, data_dir=str(tmp_path))
    assert isinstance(ours, pipeline.XYZ) and len(ours) == len(theirs) == len(expected)
    for k in "xyz":
        assert getattr(ours, k).dtype == np.float64
        assert _same(getattr(ours, k), theirs[k].to_numpy(np.float64)), (
            k, _ulps(getattr(ours, k), theirs[k].to_numpy(np.float64)))
        np.testing.assert_allclose(getattr(ours, k), expected[k].to_numpy(), rtol=1e-9)


def _pandas_table(path, sep, skip, names, usecols, na_values=None):
    df = pd.read_csv(path, sep=sep, header=skip, names=names, usecols=usecols,
                     na_values=na_values)
    return {c: df[c].to_numpy(np.float64) for c in df.columns}


EDGE_ROWS = [
    ["1", "2.5", "-3e2"],
    ["0.30000000000000004", "123456789012345678", "1.7976931348623157e308"],
    ["-0.0", "", "NA"],
    ["4.9e-324", "1E5", "+7"],
    ["1.5", "*", "2"],
    ["nan", "-inf", "Infinity"],
    ["12345.678901234567890123", ".5", "5."],
]


@pytest.mark.parametrize("sep", [",", "\t", "\\s+"])
def test_read_survey_table_matches_pandas(tmp_path, sep):
    """Blank and whitespace-only lines (not counted toward ``skip``), CRLF,
    a BOM, short and long rows, NA strings, ``na_values``, quotes, 17+ digit
    numbers, exponents, signed zero, infinities: what ``pd.read_csv`` reads."""
    write = {",": ",", "\t": "\t", "\\s+": "  "}[sep]
    names = ["a", "b", "c", "d"]
    lines = ["# junk 0", "", "  ", "junk,1\tline", write.join(names)]
    for i, r in enumerate(EDGE_ROWS):
        r = [f if f or sep != "\\s+" else "NaN" for f in r]
        lines.append(write.join(r + [str(i)]))
    lines += ["", write.join(["9", "8"])]  # a short row
    if sep != "\\s+":
        lines += [write.join(['"3.25"', "1", "2", "3", "4"])]  # quoted, long
    else:
        lines = ["  " + ln if ln else ln for ln in lines]  # leading whitespace
    path = tmp_path / "t.txt"
    path.write_bytes(b"\xef\xbb\xbf" + "\r\n".join(lines).encode() + b"\r\n")
    for usecols in (["a", "b", "c"], ["c", "a"]):
        ours = pipeline.read_survey_table(str(path), sep, 3, names, usecols, "*")
        theirs = _pandas_table(str(path), sep, 3, names, usecols, "*")
        assert list(ours) == list(theirs)
        for k in ours:
            assert _same(ours[k], theirs[k]), (k, ours[k], theirs[k])


def test_parse_floats_matches_pandas():
    rs = np.random.RandomState(4)
    values = np.concatenate([
        rs.uniform(-2e6, 2e6, 3000), rs.uniform(-1, 1, 3000) * 10.0 ** rs.randint(-30, 30, 3000),
        rs.uniform(-1, 1, 100) * 1e-310])
    words = [repr(float(v)) for v in values] + [
        f"{v:.{p}g}" for v, p in zip(values[:2000], rs.randint(1, 25, 2000))] + [
        "1e400", "-1e400", "1e-700", "-1e-400", "0e400", " 7 ", "+.5e-3", "-Inf"]
    theirs = pd.read_csv(io.StringIO("a\n" + "\n".join(words) + "\n"))["a"].to_numpy()
    assert theirs.dtype == np.float64
    ours = pipeline.parse_floats(words)
    assert _same(ours, theirs), _ulps(ours, theirs)
    # correctly rounded parsing would differ: the test reaches the 17-digit rounding
    assert not _same(np.array([float(w) for w in words]), theirs)
    for word in ("1e", "abc", "1.2.3", "--1", "e5", ".", " inf", "0x10"):
        with pytest.raises(ValueError):
            pipeline.parse_floats([word])


def _survey(tmp_path, converter="ELEVATION-BOTTOM"):
    doc = {"pipeline": [{
        "type": "readers.text", "filename": "s.csv", "separator": ",", "skip": 0,
        "header": "Y,X,ELEVATION,BOTTOM", "usecols": "X,Y,ELEVATION,BOTTOM",
        "converters": {"Z": converter}, "dropcols": "ELEVATION,BOTTOM"}]}
    (tmp_path / "s.csv").write_text("Y,X,ELEVATION,BOTTOM\n1,2,10,3\n4,5,20,6\n")
    (tmp_path / "s.json").write_text(json.dumps(doc))
    return str(tmp_path / "s.json")


def test_converter_other_than_difference_raises(tmp_path):
    xyz = pipeline.ascii_to_xyz(_survey(tmp_path))
    assert xyz.z.tolist() == [7.0, 14.0] and xyz.x.tolist() == [2.0, 5.0]
    for expr in ("ELEVATION+BOTTOM", "ELEVATION-NOPE", "ELEVATION*2", "__import__('os')"):
        with pytest.raises(ValueError, match="converter"):
            pipeline.ascii_to_xyz(_survey(tmp_path, expr))


def test_zip_must_hold_one_member(tmp_path):
    config = next(c for c in CONFIGS if "WISE" in c)
    make_survey_miniature(config, str(tmp_path), n_points=20)
    with zipfile.ZipFile(tmp_path / "WISE_ISODYN_RadarByFlight_ASCII.zip", "a") as zf:
        zf.writestr("second.txt", "x")
    with pytest.raises(ValueError, match="one file"):
        pipeline.ascii_to_xyz(config, data_dir=str(tmp_path))


def test_pipeline_runs_with_pandas_blocked(tmp_path):
    """The card's machine has no pandas: the reader imports and runs with
    ``pandas`` refused, and gives the same table as in this process."""
    config = next(c for c in CONFIGS if "Basler" in c)
    make_survey_miniature(config, str(tmp_path), n_points=50)
    want = pipeline.ascii_to_xyz(config, data_dir=str(tmp_path))
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np\n"
        "from deepbedmap_tpu_torch.data import pipeline, gridder, builder\n"
        f"xyz = pipeline.ascii_to_xyz({config!r}, data_dir={str(tmp_path)!r})\n"
        f"np.save({str(tmp_path / 'xyz.npy')!r}, np.stack([xyz.x, xyz.y, xyz.z]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    got = np.load(tmp_path / "xyz.npy")
    assert _same(got, np.stack([want.x, want.y, want.z]))

"""PyTorch port: the training-array builder (``data/builder.py``) and the
CLI's ``grid`` and ``build`` against the JAX package on the CPU.

``build_training_arrays`` on ``tests/test_builder.py``'s scene (two survey
grids in a common low-res frame) against JAX's: every array within 1e-6 of
its range (the same float32 sampling; in practice equal), with
``drop_invalid`` on a grid with a hole, the saved ``*_data.npy`` files and a
``CONTENT_HASH`` equal to ``content_hash`` of them; then
``tests/test_builder.py``'s cases on the port. The CLI's ``grid`` and
``build`` against JAX's ``cmd_grid`` / ``cmd_build`` on a survey miniature:
the JSON lines equal, the NetCDF grids bit for bit, the arrays within 1e-6
of their range; and the port's GeoTIFF route (``grid -o *.tif``, ``build``
over ``*.tif``) equal to its NetCDF route bit for bit.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from deepbedmap_tpu import cli as jax_cli
from deepbedmap_tpu.data.builder import build_training_arrays as jax_build
from deepbedmap_tpu.data.raster import Raster as JaxRaster
from deepbedmap_tpu.data.windows import get_window_bounds as jax_window_bounds
from deepbedmap_tpu_torch.cli import main
from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.data.builder import build_training_arrays
from deepbedmap_tpu_torch.data.dataset import ARRAY_KEYS, TileDataset, content_hash
from deepbedmap_tpu_torch.data.pipeline import survey_config_path
from deepbedmap_tpu_torch.data.raster import Raster, read_raster, write_netcdf
from deepbedmap_tpu_torch.data.windows import get_window_bounds
from tests import test_builder as jax_cases
from tests.survey_fixtures import bed_elevation, make_survey_miniature

TOL_ARRAYS = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(raster_cls):
    """tests/test_builder.py's scene, built with ``raster_cls``."""
    field = jax_cases._field
    x0, y1 = -1_600_000.0, -140_000.0
    size = 160
    yy, xx = np.mgrid[0:size, 0:size]
    truth = field(x0 + (xx + 0.5) * 250.0, y1 - (yy + 0.5) * 250.0)
    hr = {"survey_a": raster_cls(truth[:96, :96].copy(), left=x0, top=y1, res=250.0),
          "survey_b": raster_cls(truth[96:, 96:].copy(), left=x0 + 96 * 250.0,
                                 top=y1 - 96 * 250.0, res=250.0)}
    pad = 8
    wl = size // 4 + 2 * pad
    yyl, xxl = np.mgrid[0:wl, 0:wl]
    lx0, ly1 = x0 - pad * 1000.0, y1 + pad * 1000.0
    cxl, cyl = lx0 + (xxl + 0.5) * 1000.0, ly1 - (yyl + 0.5) * 1000.0
    ws = size + 2 * 4 * pad
    yys, xxs = np.mgrid[0:ws, 0:ws]
    cxs, cys = lx0 + (xxs + 0.5) * 250.0, ly1 - (yys + 0.5) * 250.0
    return dict(
        hr=hr,
        lowres=raster_cls(field(cxl, cyl), left=lx0, top=ly1, res=1000.0),
        surface=raster_cls(field(cxs, cys) + 2000.0, left=lx0, top=ly1, res=250.0),
        velocity=(raster_cls(field(cxs, cys) * 0.1, left=lx0, top=ly1, res=250.0),
                  raster_cls(field(cxs, cys) * -0.1, left=lx0, top=ly1, res=250.0)),
        accumulation=raster_cls(field(cxl, cyl) * 0.01 + 100.0, left=lx0, top=ly1,
                                res=1000.0),
    )


def _assert_arrays_close(got: dict, want: dict) -> None:
    for k in ARRAY_KEYS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        scale = float(w.max() - w.min()) or 1.0
        assert float(np.abs(g.astype(np.float64) - w).max()) <= TOL_ARRAYS * scale, k


@pytest.mark.parametrize("hole", [False, True])
def test_build_training_arrays_matches_jax(tmp_path, hole):
    ours, theirs = _scene(Raster), _scene(JaxRaster)
    wb = {name: get_window_bounds(r, 36, 36, 12) for name, r in ours["hr"].items()}
    assert wb == {name: jax_window_bounds(r, 36, 36, 12) for name, r in theirs["hr"].items()}
    if hole:  # one NaN under one window: its tile is dropped
        ours["hr"]["survey_a"].data[10, 10] = np.nan
        theirs["hr"]["survey_a"].data[10, 10] = np.nan
    kw = lambda s: dict(lowres=s["lowres"], surface=s["surface"], velocity=s["velocity"],
                        accumulation=s["accumulation"])
    ds = build_training_arrays(ours["hr"], wb, out_dir=str(tmp_path / "ours"),
                               device="cpu", **kw(ours))
    jax_ds = jax_build(theirs["hr"], wb, out_dir=str(tmp_path / "theirs"), **kw(theirs))
    assert len(ds) == len(jax_ds) == sum(map(len, wb.values())) - hole
    saved = {k: np.load(tmp_path / "ours" / f"{k}_data.npy") for k in ARRAY_KEYS}
    jax_saved = {k: np.load(tmp_path / "theirs" / f"{k}_data.npy") for k in ARRAY_KEYS}
    _assert_arrays_close(saved, jax_saved)
    # the returned dataset is the saved arrays, NHWC on the device
    assert isinstance(ds, TileDataset) and ds.device == torch.device("cpu")
    for k in ARRAY_KEYS:
        assert torch.equal(ds.arrays[k], torch.from_numpy(saved[k].transpose(0, 2, 3, 1)))
    assert (tmp_path / "ours" / "CONTENT_HASH").read_text().strip() == content_hash(saved)
    loaded = TileDataset.load_npy_dir(str(tmp_path / "ours"), suffix="_data", device="cpu",
                                      expected_hash=content_hash(saved))
    assert all(torch.equal(loaded.arrays[k], ds.arrays[k]) for k in ARRAY_KEYS)


@pytest.mark.parametrize("case", ["test_build_training_arrays_contract",
                                  "test_build_drops_nan_tiles"])
def test_jax_builder_case_on_the_port(case, tmp_path, monkeypatch):
    """``tests/test_builder.py``'s cases, their own assertions, with the
    port's builder (on the CPU), windows and rasters."""
    monkeypatch.setattr(jax_cases, "build_training_arrays",
                        lambda *a, **kw: build_training_arrays(*a, device="cpu", **kw))
    monkeypatch.setattr(jax_cases, "get_window_bounds", get_window_bounds)
    fn = getattr(jax_cases, case)
    fixtures = {"scene": _scene(Raster), "tmp_path": tmp_path}
    fn(*[fixtures[name] for name in inspect.signature(fn).parameters])


def test_builder_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    s = _scene(Raster)
    wb = {name: get_window_bounds(r, 36, 36, 24) for name, r in s["hr"].items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        build_training_arrays(s["hr"], wb, lowres=s["lowres"], surface=s["surface"],
                              velocity=s["velocity"], accumulation=s["accumulation"])


SURVEY_ORIGIN = (-1_600_000.0, -250_000.0)
SURVEY_SPAN = 12_000.0


def _conditioning(pad=6_000.0):
    """Seeded conditioning rasters over the survey plus ``pad``, at the
    reference resolutions: bed 1000 m, surface 100 m, velocity 500 m,
    accumulation 1000 m."""
    x0, y0 = SURVEY_ORIGIN

    def grid(res, fn):
        left, top = x0 - pad, y0 + SURVEY_SPAN + pad
        n = int((SURVEY_SPAN + 2 * pad) / res)
        xs = left + (np.arange(n) + 0.5) * res
        ys = top - (np.arange(n) + 0.5) * res
        xx, yy = np.meshgrid(xs, ys)
        return Raster(fn(xx, yy).astype(np.float32), left=left, top=top, res=res)

    return {"lowres": grid(1000.0, bed_elevation),
            "surface": grid(100.0, lambda x, y: bed_elevation(x, y) + 1500.0),
            "velocity_x": grid(500.0, lambda x, y: 0.001 * (x - x0)),
            "velocity_y": grid(500.0, lambda x, y: 0.001 * (y - y0)),
            "accumulation": grid(1000.0, lambda x, y: 0.2 + 0 * x)}


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_grid_and_build_match_jax(tmp_path, capsys):
    config = survey_config_path("bed_depth_below_WGS84_datum")
    data = tmp_path / "survey"
    data.mkdir()
    make_survey_miniature(config, str(data), n_points=6000, seed=3, span_m=SURVEY_SPAN,
                          origin=SURVEY_ORIGIN)
    out = {}
    for tag, run, extra in (("jax", jax_cli.main, []), ("ours", main, ["--device", "cpu"])):
        (tmp_path / tag).mkdir()
        grid_path = str(tmp_path / tag / "survey.nc")
        assert run(["grid", config, "-o", grid_path, "--data-dir", str(data)] + extra) == 0
        out[tag] = {"grid": _json(capsys), "raster": read_raster(grid_path)}
    assert {**out["ours"]["grid"], "out": None} == {**out["jax"]["grid"], "out": None}
    ours, theirs = out["ours"]["raster"], out["jax"]["raster"]
    assert (ours.left, ours.top, ours.res) == (theirs.left, theirs.top, theirs.res)
    assert ours.data.tobytes() == theirs.data.tobytes()
    assert np.isfinite(ours.data).mean() > 0.5

    # the GeoTIFF route: a float32 GeoTIFF with NaN kept, equal to the NetCDF
    tif = str(tmp_path / "ours_tif" / "survey.tif")
    os.makedirs(os.path.dirname(tif))
    assert main(["grid", config, "-o", tif, "--data-dir", str(data), "--device", "cpu"]) == 0
    assert {**_json(capsys), "out": None} == {**out["ours"]["grid"], "out": None}
    from_tif = read_raster(tif)
    assert (from_tif.left, from_tif.top, from_tif.res) == (ours.left, ours.top, ours.res)
    assert from_tif.data.tobytes() == ours.data.tobytes()

    rasters = _conditioning()
    flags = {}
    for name, raster in rasters.items():
        write_netcdf(raster, str(tmp_path / f"{name}.nc"))
        geotiff.write_geotiff(str(tmp_path / f"{name}.tif"), raster.data, raster.left,
                              raster.top, raster.res)
        flags[name] = "--" + name.replace("_", "-")
    builds = {}
    for tag, run, surveys, ext, extra in (
            ("jax", jax_cli.main, "jax", "nc", []),
            ("ours", main, "ours", "nc", ["--device", "cpu"]),
            ("ours_tif", main, "ours_tif", "tif", ["--device", "cpu"])):
        argv = ["build", "--surveys", str(tmp_path / surveys), "-o", str(tmp_path / f"{tag}_out")]
        for name, flag in flags.items():
            argv += [flag, str(tmp_path / f"{name}.{ext}")]
        assert run(argv + extra) == 0
        builds[tag] = (_json(capsys), {k: np.load(tmp_path / f"{tag}_out" / f"{k}_data.npy")
                                       for k in ARRAY_KEYS})
    line, arrays = builds["ours"]
    assert line["tiles"] > 0 and line["windows"] == {"survey": line["tiles"]}
    assert {**line, "out": None} == {**builds["jax"][0], "out": None}
    _assert_arrays_close(arrays, builds["jax"][1])
    tif_line, tif_arrays = builds["ours_tif"]
    assert {**tif_line, "out": None} == {**line, "out": None}
    assert all(tif_arrays[k].tobytes() == arrays[k].tobytes() for k in ARRAY_KEYS)
    assert (tmp_path / "ours_out" / "CONTENT_HASH").read_text().strip() == content_hash(arrays)

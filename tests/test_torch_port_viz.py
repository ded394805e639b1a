"""PyTorch port: the figures (``viz/figures.py``, ``viz/paper.py``), the
figure set (``viz/figure_set.py``), the live training curves
(``viz/live.py``) and the CLI's ``figures`` and ``train --live-png`` /
``--live-term``, against the JAX package on the CPU.

The arrays each figure puts on its axes (hillshades, roughness images,
transect lines) are held against JAX's figure of the same raster, on
``tests/test_viz.py``'s 48 x 56 DEM. matplotlib is needed to draw; without it
importing ``deepbedmap_tpu_torch.viz`` still works and the CLI refuses
before computing."""

import json
import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepbedmap_tpu.data.raster import Raster as JaxRaster  # noqa: E402
from deepbedmap_tpu.evalx.track import grdtrack as jax_grdtrack  # noqa: E402
from deepbedmap_tpu.viz import analysis as jax_analysis  # noqa: E402
from deepbedmap_tpu.viz import live as jax_live  # noqa: E402
from deepbedmap_tpu.viz import figures as jax_figures  # noqa: E402
from deepbedmap_tpu.viz import paper as jax_paper  # noqa: E402
from deepbedmap_tpu_torch.cli import main  # noqa: E402
from deepbedmap_tpu_torch.data.raster import Raster  # noqa: E402
from deepbedmap_tpu_torch.viz import figure_set, figures, live, paper  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_HILLSHADE = 1e-5  # absolute, on [0, 1]
TOL_VARIANCE = 1e-6  # x max(x^2): the one-pass std's error scale
TOL_TRANSECT = 1e-4  # of the profile's range
# a region small enough for the CPU (its 3-D panels dominate), large enough
# that the example's absolute closeup and tile offsets still land in it
SMALL_REGION = (-1_631_500.0, -127_000.0, -1_615_500.0, -95_000.0)


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
def _close_figs():
    yield
    plt.close("all")


@pytest.fixture
def dems():
    """``tests/test_viz.py``'s DEM, as a JAX and a port ``Raster``."""
    rs = np.random.RandomState(42)
    h, w = 48, 56
    yy, xx = np.mgrid[0:h, 0:w]
    data = (-800.0 + 120.0 * np.sin(xx / 7.0) + 90.0 * np.cos(yy / 5.0)
            + rs.randn(h, w) * 15.0).astype(np.float32)
    kw = dict(left=-1_600_000.0, top=-100_000.0, res=250.0)
    return JaxRaster(data=data, **kw), Raster(data=data, **kw)


def _image(ax, i):
    return np.ma.filled(np.ma.asarray(ax.images[i].get_array(), dtype=np.float64), np.nan)


def _close_hillshade(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_HILLSHADE)


def _close_roughness(got, want, grid):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok] ** 2, want[ok] ** 2, rtol=0,
                               atol=TOL_VARIANCE * float(np.nanmax(grid * grid)))


def _close_profile(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=TOL_TRANSECT * np.ptp(want[ok]))


def _jax_transect(grid, r, xs, ys):
    import jax.numpy as jnp

    return np.asarray(jax_grdtrack(jnp.asarray(grid), jnp.asarray(xs), jnp.asarray(ys),
                                   r.left, r.top, r.res))


def _close_roughness_profile(got, rough, r, xs, ys):
    """A roughness profile: JAX's grdtrack of the port's roughness grid within
    ``TOL_TRANSECT`` of its range. The grid itself is held to JAX's within
    ``TOL_VARIANCE`` (``_close_roughness``), which at a DEM's magnitudes
    allows ~1e-2 m of std, more than 1e-4 of a profile's range."""
    _close_profile(got, _jax_transect(rough, r, xs, ys))


def test_plot_dem_hillshade_matches_jax(dems):
    jr, tr = dems
    want = jax_figures.plot_dem(jr, title="dem")
    got = figures.plot_dem(tr, title="dem", device="cpu")
    np.testing.assert_array_equal(_image(got, 0), _image(want, 0))
    _close_hillshade(_image(got, 1), _image(want, 1))


def test_closeup_fig_hillshade_matches_jax(dems):
    jr, tr = dems
    kw = dict(letter="a", name="Test Glacier", midx=-1_595_000.0, midy=-105_000.0,
              annotations=[(-1_595_000.0, -105_000.0, "feature")], size=3_000.0)
    want = jax_paper.closeup_fig(jr, **kw)
    got = paper.closeup_fig(tr, device="cpu", **kw)
    assert got.get_title() == want.get_title() and len(got.images) == 2
    assert got.images[1].get_extent() == want.images[1].get_extent()
    _close_hillshade(_image(got, 1), _image(want, 1))


def test_fig_roughness_grids_match_jax(dems):
    jr, tr = dems
    xs = np.linspace(-1_598_000.0, -1_590_000.0, 25)
    ys = np.full_like(xs, -105_000.0)
    want = jax_paper.fig_roughness_grids({"DeepBedMap": jr, "Groundtruth": jr},
                                         transect_xy=(xs, ys))
    got = paper.fig_roughness_grids({"DeepBedMap": tr, "Groundtruth": tr},
                                    transect_xy=(xs, ys), device="cpu")
    for i in (1, 2):  # the roughness panels
        assert got.axes[i].get_title() == want.axes[i].get_title()
        _close_roughness(_image(got.axes[i], 0), _image(want.axes[i], 0), tr.data)


def test_plot_transect_matches_jax(dems):
    jr, tr = dems
    xs = np.linspace(-1_598_000.0, -1_590_000.0, 40)
    ys = np.full_like(xs, -105_000.0)
    want = jax_figures.plot_transect({"a": jr}, xs, ys)
    got = figures.plot_transect({"a": tr}, xs, ys, device="cpu")
    np.testing.assert_array_equal(got.lines[0].get_xdata(), want.lines[0].get_xdata())
    _close_profile(got.lines[0].get_ydata(), want.lines[0].get_ydata())


def test_fig_transect_matches_jax(dems):
    jr, tr = dems
    xs = np.linspace(-1_598_000.0, -1_590_000.0, 40)
    ys = np.full_like(xs, -105_000.0)
    want = jax_paper.fig_transect({"DeepBedMap": jr, "BEDMAP2": jr}, xs, ys)
    got = paper.fig_transect({"DeepBedMap": tr, "BEDMAP2": tr}, xs, ys, device="cpu")
    (elev_got, rough_got), (elev_want, _) = got.axes[:2], want.axes[:2]
    assert len(elev_got.lines) == len(elev_want.lines) == len(rough_got.lines) == 2
    for lg, lw in zip(elev_got.lines, elev_want.lines):
        _close_profile(lg.get_ydata(), lw.get_ydata())
    rough = paper.roughness(tr, device="cpu").numpy()
    _close_roughness(rough, np.asarray(jax_analysis.standard_deviation_2d(tr.data)), tr.data)
    for line in rough_got.lines:
        _close_roughness_profile(line.get_ydata(), rough, tr, xs, ys)


def test_fig_input_thumbnails_hillshade_matches_jax(dems):
    jr, tr = dems
    want = jax_paper.fig_input_thumbnails({"BEDMAP2": jr, "Accumulation": jr})
    got = paper.fig_input_thumbnails({"BEDMAP2": tr, "Accumulation": tr}, device="cpu")
    assert [len(a.images) for a in got.axes] == [len(a.images) for a in want.axes] == [2, 1]
    _close_hillshade(_image(got.axes[0], 1), _image(want.axes[0], 1))


def test_figure_set_arrays_match_jax():
    """What the figure set computes (the card's part of the figures) against
    JAX's analysis and grdtrack on the same seeded DEM family."""
    got = figure_set.figure_arrays(SMALL_REGION, device="cpu")
    assert len(got) == 2 + 2 + 3 + 6
    dems = figure_set.synthetic_dems(SMALL_REGION)
    dbm = dems["DeepBedMap"]
    for name in ("BEDMAP2", "DeepBedMap"):
        _close_hillshade(got[f"fig1 {name} hillshade"],
                         np.asarray(jax_analysis.hillshade(dems[name].data)))
    for c in figure_set.closeups(SMALL_REGION):
        window, _ = paper.closeup_window(dbm, c["midx"], c["midy"], c["size"])
        assert window.size > 0
        _close_hillshade(got[f"fig4 {c['letter']}) hillshade"],
                         np.asarray(jax_analysis.hillshade(window, dbm.res)))
    xs, ys = figure_set.transect_xy(SMALL_REGION)
    for name in ("DeepBedMap", "Groundtruth", "BedMachine"):
        r = dems[name]
        rough = got[f"fig5 {name} roughness"]
        _close_roughness(rough, np.asarray(jax_analysis.standard_deviation_2d(r.data)), r.data)
        _close_profile(got[f"fig6 {name} elevation"], _jax_transect(r.data, r, xs, ys))
        _close_roughness_profile(got[f"fig6 {name} roughness"], rough, r, xs, ys)


def test_sparkline_and_terminal_lines_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    series = list(rs.randn(57)) + [float("nan")]
    for width in (40, 10):
        assert live.sparkline(series, width) == jax_live.sparkline(series, width)
    assert live.sparkline([]) == jax_live.sparkline([]) == ""
    curves = {}
    for mod in (live, jax_live):
        c = mod.LiveCurves(out_png=None, terminal=False)
        for epoch in range(12):
            c(epoch, {"g_loss": rs.rand(), "d_loss": 2.0, "psnr": float(epoch),
                      "dev_ssim": rs.rand(), "lr": "n/a", "other_metric": -epoch})
        curves[mod] = c
        rs = np.random.RandomState(3)
        rs.randn(57)
    assert curves[live].render_terminal() == curves[jax_live].render_terminal()
    png = str(tmp_path / "curves.png")
    assert curves[live].render(png) == png
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_viz_imports_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import deepbedmap_tpu_torch.viz as v, deepbedmap_tpu_torch.viz.figure_set; "
            "assert 'jax' not in sys.modules; print(v.hillshade.__module__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "deepbedmap_tpu_torch.viz.analysis"


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_figures_writes_the_figure_set(capsys, tmp_path, monkeypatch):
    real_main = figure_set.main
    monkeypatch.setattr(figure_set, "main",
                        lambda out, device: real_main(out, device, region=SMALL_REGION))
    out = str(tmp_path / "figs")
    rc = main(["figures", "-o", out, "--device", "cpu"])
    assert rc == 0 and _last_json(capsys) == {"command": "figures", "out": out, "rc": 0}
    assert sorted(os.listdir(out)) == sorted(figure_set.FIGURES)
    for name in figure_set.FIGURES:
        assert os.path.getsize(os.path.join(out, name)) > 1000


def test_cli_without_matplotlib_refuses_before_computing(capsys, tmp_path, monkeypatch):
    import deepbedmap_tpu_torch.train.loop as loop

    def no_training(*a, **k):
        raise AssertionError("train ran a step before refusing --live-png")

    monkeypatch.setattr(loop, "fit", no_training)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc = main(["figures", "-o", str(tmp_path / "f"), "--device", "cpu"])
    res = _last_json(capsys)
    assert rc != 0 and res["command"] == "figures" and "matplotlib" in res["error"]
    assert not os.path.exists(tmp_path / "f")
    rc = main(["train", "--synthetic-tiles", "8", "--live-png", str(tmp_path / "c.png"),
               "--device", "cpu"])
    res = _last_json(capsys)
    assert rc != 0 and res["command"] == "train" and "matplotlib" in res["error"]


@pytest.mark.parametrize("png", [False, True])
def test_cli_train_live_curves(capsys, tmp_path, png):
    """``--live-term`` prints one sparkline line per metric after each epoch,
    then the JSON line; ``--live-png`` also redraws the PNG."""
    argv = ["train", "--synthetic-tiles", "6", "--epochs", "2", "--batch-size", "4",
            "--blocks", "1", "--live-term", "--device", "cpu"]
    curves = str(tmp_path / "curves.png")
    rc = main(argv + (["--live-png", curves] if png else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and json.loads(lines[-1])["command"] == "train"
    spark = lines[:-1]
    assert len(spark) % 2 == 0 and spark  # two epochs, the same metrics in each
    per_epoch = len(spark) // 2
    names = [line.split()[1] for line in spark]
    assert names[:per_epoch] == names[per_epoch:]
    assert "generator_loss" in names and "val_generator_loss" in names
    for line in spark[per_epoch:]:  # two points per series after epoch 2
        assert len(line.split()[2]) == 2 and set(line.split()[2]) <= set(live._BLOCKS)
    assert os.path.exists(curves) == png

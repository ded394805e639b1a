"""PyTorch port: grid sampling (``ops/interp.py``), ``selective_tile``
(``data/tiler.py``), the metrics (``ops/metrics.py``) and track sampling
(``evalx/track.py``) on the CPU, each against its JAX function on the same
numpy inputs.

JAX computes coordinates in float32 (64-bit types off). At Antarctic
magnitudes (|x| ~ 1.6e6 m, one float32 ulp 0.125 m) that decides whether a
sample at the first or last cell center is inside the grid; the port copies
the float32 arithmetic, so every NaN mask here must equal JAX's exactly."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.data.raster import Raster as JaxRaster
from deepbedmap_tpu.data.tiler import selective_tile as jax_selective_tile
from deepbedmap_tpu.evalx import track as jax_track
from deepbedmap_tpu.ops import interp as jax_interp
from deepbedmap_tpu.ops import metrics as jax_metrics
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.data import tiler
from deepbedmap_tpu_torch.data.tiler import selective_tile
from deepbedmap_tpu_torch.evalx import track
from deepbedmap_tpu_torch.ops import interp, metrics

METHODS = ["bilinear", "bicubic", "nearest"]
# (left, top, res, h, w): small magnitudes, and grids near Pine Island Glacier
# in EPSG:3031 metres where float32 coordinates are coarse
GRIDS = {
    "small": (0.0, 7.0, 1.0, 8, 8),
    "antarctic_1km": (-1_620_000.0, -230_000.0, 1000.0, 40, 50),
    "antarctic_450m": (-1_600_137.0, -250_021.0, 450.0, 37, 29),
}


def _assert_same(got, want, rel=1e-6):
    """NaN masks identical; values within ``rel`` of want's range."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if ok.any():
        scale = max(np.abs(want[ok]).max(), 1e-30)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=rel * scale)


def _grid_and_points(name, seed):
    left, top, res, h, w = GRIDS[name]
    rs = np.random.RandomState(seed)
    data = rs.randn(h, w).astype(np.float32)
    # every cell center, the first and last ones +- 1 float32 ulp, a ring just
    # outside the hull, and random points over and beyond the grid (float64)
    jj, ii = np.meshgrid(np.arange(-1, w + 1), np.arange(-1, h + 1))
    xs = left + res * (jj.ravel() + 0.5)
    ys = top - res * (ii.ravel() + 0.5)
    edges_x = np.array([left + res / 2, left + res * (w - 0.5)])
    edges_y = np.array([top - res / 2, top - res * (h - 0.5)])
    ex = np.concatenate([np.nextafter(np.float32(edges_x), np.float32(np.inf)),
                         np.nextafter(np.float32(edges_x), np.float32(-np.inf))])
    ey = np.concatenate([np.nextafter(np.float32(edges_y), np.float32(np.inf)),
                         np.nextafter(np.float32(edges_y), np.float32(-np.inf))])
    gx, gy = np.meshgrid(np.concatenate([edges_x, ex]), np.concatenate([edges_y, ey]))
    rx = rs.uniform(left - res, left + res * (w + 1), 3000)
    ry = rs.uniform(top - res * (h + 1), top + res, 3000)
    xs = np.concatenate([xs, gx.ravel().astype(np.float64), rx])
    ys = np.concatenate([ys, gy.ravel().astype(np.float64), ry])
    return data, xs, ys, (left, top, res)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("method", METHODS)
def test_samplers_match_jax(method, grid):
    data, xs, ys, (left, top, res) = _grid_and_points(grid, seed=len(grid))
    fn = f"sample_grid_{method}"
    want = getattr(jax_interp, fn)(jnp.asarray(data), jnp.asarray(xs), jnp.asarray(ys),
                                   left, top, res)
    got = getattr(interp, fn)(torch.from_numpy(data), interp.as_f32(xs, "cpu"),
                              interp.as_f32(ys, "cpu"), left, top, res)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    assert np.isnan(want).any() and (~np.isnan(want)).any()
    # the same float32 operations in the same order: 1e-6 of the range
    # (on the CPU they agree bit for bit)
    _assert_same(got.numpy(), want)


def test_bicubic_interpolates_nodes_and_quadratics():
    # Keys (a = -0.5) reproduces degree-2 polynomials inside the grid and
    # returns node values at the nodes
    left, top, res, h, w = -1_600_000.0, -250_000.0, 1000.0, 20, 24
    xc = left + res * (np.arange(w) + 0.5)
    yc = top - res * (np.arange(h) + 0.5)
    u, v = (xc - xc.mean()) / 1e4, (yc - yc.mean()) / 1e4
    quad = (1.0 + 0.5 * u[None, :] - 0.3 * v[:, None] + 0.2 * u[None, :] ** 2
            - 0.1 * (u[None, :] * v[:, None])).astype(np.float32)
    rs = np.random.RandomState(3)
    px = rs.uniform(xc[2], xc[-3], 500)
    py = rs.uniform(yc[-3], yc[2], 500)
    got = interp.sample_grid_bicubic(torch.from_numpy(quad), interp.as_f32(px, "cpu"),
                                     interp.as_f32(py, "cpu"), left, top, res).numpy()
    pu, pv = (px - xc.mean()) / 1e4, (py - yc.mean()) / 1e4
    exact = 1.0 + 0.5 * pu - 0.3 * pv + 0.2 * pu ** 2 - 0.1 * pu * pv
    # float32 coordinates at 1.6e6 m: 0.125 m of position error on slopes of
    # order 1e-4 per metre, and float32 sums
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)
    nodes = interp.sample_grid_bicubic(
        torch.from_numpy(quad), interp.as_f32(np.tile(xc, h), "cpu"),
        interp.as_f32(np.repeat(yc, w), "cpu"), left, top, res).numpy()
    np.testing.assert_array_equal(nodes.reshape(h, w), quad)


@pytest.mark.parametrize(
    "bounds,res",
    [((-1_600_000.0, -250_000.0, -1_314_000.0, 36_000.0), 100.0),
     ((-1_600_137.0, -250_021.0, -1_520_000.0, -170_000.0), 450.0),
     ((0.5, 0.5, 2.5, 2.5), 1.0),
     ((1_000.0, 1_000.0, 10_000.0, 10_000.0), 1000.0)],
)
def test_window_coords_match_jax(bounds, res):
    jx, jy = jax_interp.window_coords(bounds, res)
    tx, ty = interp.window_coords(bounds, res, device="cpu")
    for j, t, lo, hi in ((jx, tx, bounds[0], bounds[2]), (jy, ty, bounds[1], bounds[3])):
        j = np.asarray(j)
        assert t.dtype == torch.float32 and t.shape == j.shape
        # the port rounds float64 centers to float32, JAX computes them in
        # float32: within one float32 ulp of the larger endpoint
        ulp = np.spacing(np.float32(max(abs(lo), abs(hi))))
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=ulp)
        assert t[0] == np.float32(j[0]) and t[-1] == np.float32(j[-1])


# ---------------------------------------------------------------------------
# selective_tile


def _diag(raster_cls):
    # the reference selective_tile doctest grid: flipud(diag(arange(8))),
    # y = linspace(7, 0, 8), x = linspace(0, 7, 8)  (data_prep.py:640-644)
    data = np.flipud(np.diag(np.arange(8))).astype(np.float32)
    return raster_cls.from_centers(data, x=np.linspace(0, 7, 8), y=np.linspace(7, 0, 8))


def test_selective_tile_goldens():
    # the JAX goldens of tests/test_data.py:25-56, on the port; exact
    raster = _diag(Raster)
    tiles = selective_tile(raster, [(0.5, 0.5, 2.5, 2.5), (2.5, 1.5, 4.5, 3.5)],
                           device="cpu")
    expected = np.array([[[[0.0, 2.0], [1.0, 0.0]]], [[[3.0, 0.0], [0.0, 0.0]]]],
                        np.float32)
    np.testing.assert_array_equal(tiles.numpy(), expected)
    padded = selective_tile(raster, [(0.5, 0.5, 2.5, 2.5)], padding=2.0, gapfiller=-99.0,
                            device="cpu").numpy()
    assert padded.shape == (1, 1, 6, 6)
    assert (padded == -99.0).any()
    np.testing.assert_array_equal(padded[0, 0, 2:4, 2:4],
                                  np.array([[0.0, 2.0], [1.0, 0.0]], np.float32))
    assert selective_tile(raster, [(0.5, 0.5, 4.5, 4.5)], resolution=2.0,
                          device="cpu").shape == (1, 1, 2, 2)


def _antarctic_raster(cls, res, h, w, seed, voids=True):
    rs = np.random.RandomState(seed)
    data = (rs.randn(h, w) * 100 - 500).astype(np.float32)
    if voids:
        data[rs.rand(h, w) < 0.05] = np.nan
    return cls(data, left=-1_610_000.0 - 37.0 * (res == 450.0), top=-240_000.0, res=res)


@pytest.mark.parametrize(
    "kw",
    [dict(),  # grid-aligned windows: samples on cell centers, first/last too
     dict(padding=1000.0),
     dict(padding=3000.0, gapfiller=-5000.0),
     dict(resolution=500.0, gapfiller=0.0),
     dict(resolution=250.0, padding=1000.0, interpolate=False),
     dict(padding=1000.0, interpolate=False, gapfiller=-1.0)],
)
@pytest.mark.parametrize("res", [1000.0, 450.0])
def test_selective_tile_matches_jax(kw, res):
    h, w = (30, 34) if res == 1000.0 else (66, 75)
    port_r, jax_r = (_antarctic_raster(c, res, h, w, seed=5) for c in (Raster, JaxRaster))
    # windows from the raster's own edge to beyond it, one shape each
    x0, y1 = port_r.left, port_r.top
    windows = [(x0 + dx, y1 - 9000.0 - dy, x0 + 9000.0 + dx, y1 - dy)
               for dx, dy in ((0.0, 0.0), (4000.0, 2000.0), (21_000.0, 19_000.0),
                              (26_000.0, 23_000.0))]
    with warnings.catch_warnings(record=True) as seen_jax:
        warnings.simplefilter("always")
        want = jax_selective_tile(jax_r, windows, **kw)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = selective_tile(port_r, windows, device="cpu", **kw)
    assert got.dtype == torch.float32
    _assert_same(got.numpy(), want)
    if kw.get("gapfiller") is not None:
        assert not np.isnan(want).any()
    # the same warning, naming the same tiles, when NaN is left in
    assert [str(m.message) for m in seen] == [str(m.message) for m in seen_jax]
    assert bool(seen) == bool(np.isnan(want).any())


@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize(
    "at",
    [(0.0, 0.0),  # the padded window on the grid's top-left edge
     (0.45, 0.55),  # inside: only a corner of the grid goes to the device
     (0.93, 0.9),  # over the bottom-right edge
     (1.2, -0.3)],  # off the grid
)
@pytest.mark.parametrize("res", [1000.0, 450.0])
def test_selective_tile_crops_to_the_reached_cells(at, interpolate, res):
    # one 9 km window on a 120 x 130 grid at EPSG:3031 magnitudes: the port
    # uploads only the cells its samples reach, and its tiles equal the
    # whole grid's bit for bit (and JAX's within 1e-6 of the range, masks
    # exact)
    port_r, jax_r = (_antarctic_raster(c, res, 120, 130, seed=6) for c in (Raster, JaxRaster))
    xmin, ymin, xmax, ymax = port_r.bounds
    x0 = xmin + at[0] * (xmax - xmin)
    y1 = ymax - at[1] * (ymax - ymin)
    window = [(x0 + 1000.0, y1 - 10_000.0, x0 + 10_000.0, y1 - 1000.0)]
    kw = dict(padding=1000.0, resolution=500.0, interpolate=interpolate)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = selective_tile(port_r, window, device="cpu", **kw).numpy()
        want = jax_selective_tile(jax_r, window, **kw)
    _assert_same(got, want)
    half = 250.0
    r0, r1, c0, c1 = tiler._reach(port_r, np.array([x0 + half, x0 + 11_000.0 - half]),
                                  np.array([y1 - half, y1 - 11_000.0 + half]))
    assert (r1 - r0) * (c1 - c0) < 0.2 * port_r.data.size
    ys = np.linspace(y1 - half, y1 - 11_000.0 + half, 22)
    xs = np.linspace(x0 + half, x0 + 11_000.0 - half, 22)
    gx = interp.as_f32(np.tile(xs, 22), "cpu")
    gy = interp.as_f32(np.repeat(ys, 22), "cpu")
    sampler = interp.sample_grid_bilinear if interpolate else interp.sample_grid_nearest
    whole = sampler(torch.from_numpy(port_r.data), gx, gy, port_r.left, port_r.top, res)
    np.testing.assert_array_equal(got.reshape(-1), whole.numpy())


# ---------------------------------------------------------------------------
# metrics and tracks


def test_psnr_golden_and_rmse_match_jax():
    ones = torch.ones(2, 1, 4, 4)
    # the reference's psnr doctest (data_range 2**32); float32 log10
    assert abs(float(metrics.psnr(ones, 2 * ones)) - 192.65919722494797) < 1e-4
    rs = np.random.RandomState(0)
    a = rs.randn(500).astype(np.float32)
    b = rs.randn(500).astype(np.float32)
    b[rs.rand(500) < 0.1] = np.nan
    a[:3] = np.nan
    want = float(jax_metrics.rmse(jnp.asarray(a), jnp.asarray(b)))
    got = float(metrics.rmse(torch.from_numpy(a), torch.from_numpy(b)))
    # float32 sums in another order
    assert got == pytest.approx(want, rel=1e-6)
    assert float(metrics.psnr(torch.from_numpy(a[3:]), torch.from_numpy(2 * a[3:]))) == \
        pytest.approx(float(jax_metrics.psnr(jnp.asarray(a[3:]), jnp.asarray(2 * a[3:]))),
                      rel=1e-6)
    # all NaN: the count is floored at 1, so 0 rather than NaN
    nan = torch.full((4,), float("nan"))
    assert float(metrics.rmse(nan, nan)) == 0.0


@pytest.mark.parametrize("method", METHODS)
def test_grdtrack_and_track_rmse_match_jax(method):
    rs = np.random.RandomState(11)
    h, w, res = 48, 52, 250.0
    data = np.cumsum(np.cumsum(rs.randn(h, w), 0), 1).astype(np.float32)
    data[5, 7] = np.nan
    port_r = Raster(data, left=-1_612_000.0, top=-236_000.0, res=res)
    jax_r = JaxRaster(data, left=-1_612_000.0, top=-236_000.0, res=res)
    x = rs.uniform(port_r.left - 500, port_r.left + w * res + 500, 4000)
    y = rs.uniform(port_r.top - h * res - 500, port_r.top + 500, 4000)
    z = rs.randn(4000) * 3 + 1.0
    want = jax_track.grdtrack(jnp.asarray(data), jnp.asarray(x), jnp.asarray(y),
                              port_r.left, port_r.top, res, method=method)
    got = track.grdtrack(torch.from_numpy(data), interp.as_f32(x, "cpu"),
                         interp.as_f32(y, "cpu"), port_r.left, port_r.top, res, method=method)
    _assert_same(got.numpy(), want)
    # residuals and RMSE: within 1e-6 relative (float32 sums in another order)
    _assert_same(track.elevation_residuals(port_r, x, y, z, method, device="cpu"),
                 jax_track.elevation_residuals(jax_r, x, y, z, method))
    want_rmse = jax_track.track_rmse(jax_r, x, y, z, method)
    assert track.track_rmse(port_r, x, y, z, method, device="cpu") == \
        pytest.approx(want_rmse, rel=1e-6)

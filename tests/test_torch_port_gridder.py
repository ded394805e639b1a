"""PyTorch port: gridding (``deepbedmap_tpu_torch/data/gridder.py``,
``ops/spline.py``, ``ops/gmt_surface.py``) against the JAX package on the
CPU.

Tolerances: ``get_region``, ``blockmedian`` (even and odd counts, ties,
NaN; equal values, the sign of a zero median aside), ``distance_mask`` and
the exact backend of ``xyz_to_grid`` (the same float64 host arithmetic) are
equal bit for bit; the x2 prolongation equals ``jax.image.resize`` bit for
bit on most shapes and within 1 ulp of the inputs' magnitude on all;
``solve_tension_spline`` and the relax backend (float32 sums in JAX's
order, which XLA may still fuse differently) within 1e-5 of the result's
range. Then every case of
``tests/test_gridder.py`` runs through the port.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.ndimage import maximum_filter

from deepbedmap_tpu.data import gridder as jax_gridder
from deepbedmap_tpu.ops import spline as jax_spline
from deepbedmap_tpu_torch.data import gridder
from deepbedmap_tpu_torch.data.pipeline import XYZ
from deepbedmap_tpu_torch.ops import spline
from tests import test_gridder as jax_cases

TOL_RELAX = 1e-5


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
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _within_range(got, want, rel: float) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert (np.isnan(got) == np.isnan(want)).all()
    ok = ~np.isnan(want)
    scale = float(want[ok].max() - want[ok].min())
    err = float(np.abs(got[ok] - want[ok]).max())
    assert err <= rel * scale, (err, rel * scale)


def _cloud(seed, n, span, z_scale=1.0):
    rs = np.random.RandomState(seed)
    return pd.DataFrame({"x": rs.uniform(0, span, n), "y": rs.uniform(0, span, n),
                         "z": z_scale * rs.normal(size=n)})


def test_get_region_both_modes_match_jax():
    # the reference doctest (data_prep.py:365-370): '-250/9500/0/9750'
    doctest = pd.DataFrame(10000 * np.random.RandomState(seed=42).rand(30).reshape(10, 3),
                           columns=["x", "y", "z"])
    assert gridder.get_region(doctest) == (500.0, 8500.0, 0.0, 9750.0)
    assert gridder.get_region(doctest, mode="surface") == (-250.0, 9500.0, 0.0, 9750.0)
    rs = np.random.RandomState(5)
    for i in range(20):
        df = pd.DataFrame({"x": rs.uniform(-2e6, 2e6) + rs.uniform(0, 3e4 * (i + 1), 40),
                           "y": rs.uniform(-2e6, 2e6) + rs.uniform(0, 5e4, 40), "z": 0.0})
        xyz = XYZ(df.x.to_numpy(), df.y.to_numpy(), df.z.to_numpy())
        for mode, inc in (("round", 250), ("surface", 250), ("surface", 1000)):
            want = jax_gridder.get_region(df, inc, mode=mode)
            assert gridder.get_region(df, inc, mode=mode) == want
            assert gridder.get_region(xyz, inc, mode=mode) == want


@pytest.mark.parametrize("seed,spacing", [(0, 250.0), (1, 100.0), (2, 333.0)])
def test_blockmedian_matches_jax(seed, spacing):
    """Cells with even and odd counts, ties, NaN z, points outside the
    region: the port's float64 medians equal pandas' groupby medians."""
    rs = np.random.RandomState(seed)
    df = _cloud(seed, 4000, 3200.0, 10.0)
    df.loc[:600, "x"] = np.round(df.x[:601] / 50) * 50  # ties in x
    df.loc[:1500, "z"] = np.round(df.z[:1501])  # ties in z
    df.loc[rs.choice(4000, 30, replace=False), "z"] = np.nan
    region = (0.0, 3000.0, 0.0, 3000.0)
    want = jax_gridder.blockmedian(df, region, spacing)
    got = gridder.blockmedian(df, region, spacing, device="cpu")
    counts = df.assign(c=0).groupby(
        np.floor(df.y / spacing + 0.5) * 1e4 + np.floor(df.x / spacing + 0.5)).size()
    assert (counts % 2 == 0).any() and (counts % 2 == 1).any()
    assert len(got) == len(want)
    for k in "xyz":
        a, b = getattr(got, k), want[k].to_numpy(np.float64)
        # equal values; a median of tied zeros is -0.0 or 0.0 as each
        # selection happens to pick
        assert ((a == b) | (np.isnan(a) & np.isnan(b))).all(), k


def _chebyshev_far(has, radius):
    """Independent of scipy: the Chebyshev distance to the nearest data
    cell, by brute force."""
    rows, cols = np.nonzero(has)
    ii, jj = np.mgrid[0:has.shape[0], 0:has.shape[1]]
    d = np.full(has.shape, np.inf)
    for r, c in zip(rows, cols):
        d = np.minimum(d, np.maximum(np.abs(ii - r), np.abs(jj - c)))
    return d > radius


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 4])
def test_distance_mask_matches_scipy_and_brute_force(radius):
    rs = np.random.RandomState(radius)
    has = rs.rand(23, 31) < 0.03
    has[0, 5] = has[22, 30] = has[10, 0] = True  # data on the border
    got = spline.distance_mask(has, radius)
    assert _same(got, jax_spline.distance_mask(has, radius))
    assert _same(got, _chebyshev_far(has, radius))


@pytest.mark.parametrize("shape,crop,exact", [
    ((4, 4), (8, 8), False), ((5, 7), (9, 13), True), ((3, 6), (5, 12), True),
    ((9, 4), (18, 7), False), ((60, 70), (119, 140), True), ((33, 21), (66, 42), False)])
def test_prolongation_matches_jax_image_resize(shape, crop, exact):
    """JAX's ``jax.image.resize(..., 'linear')`` at an exact x2, edges
    included: bit for bit where XLA fuses every multiply-add, else within 1
    ulp of the inputs' magnitude around each output; and within 2 such ulps
    of ``F.interpolate(bilinear, align_corners=False)``, which rounds each
    product."""
    z = np.random.RandomState(6).normal(size=shape).astype(np.float32) * 100
    want = np.asarray(jax.image.resize(jnp.asarray(z), (2 * shape[0], 2 * shape[1]),
                                       method="linear"))[: crop[0], : crop[1]]
    got = spline.prolong(torch.from_numpy(z), crop).numpy()
    ulp = np.spacing(np.repeat(np.repeat(
        maximum_filter(np.abs(z), size=3, mode="nearest"), 2, 0), 2, 1))[: crop[0], : crop[1]]
    assert (np.abs(got.astype(np.float64) - want) <= ulp).all()
    if exact:
        assert _same(got, want)
    torch_bilinear = torch.nn.functional.interpolate(
        torch.from_numpy(z)[None, None], scale_factor=2, mode="bilinear",
        align_corners=False)[0, 0, : crop[0], : crop[1]].numpy()
    assert (np.abs(torch_bilinear.astype(np.float64) - got) <= 2 * ulp).all()
    assert got[0, 0] == z[0, 0] and got[-1, -1] == torch_bilinear[-1, -1]


@pytest.mark.parametrize("shape,tension", [((40, 40), 0.35), ((67, 53), 0.35), ((40, 40), 0.0)])
def test_solve_tension_spline_matches_jax(shape, tension):
    rs = np.random.RandomState(7)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    truth = 50 * np.sin(xx / 7.0) * np.cos(yy / 9.0) + 0.4 * xx
    mask = rs.rand(*shape) < 0.15
    data = np.where(mask, truth, 0.0).astype(np.float32)
    want = np.asarray(jax_spline.solve_tension_spline(
        jnp.asarray(data), jnp.asarray(mask), tension=tension, iterations=150))
    got = spline.solve_tension_spline(data, mask, tension=tension, iterations=150,
                                      device="cpu")
    assert got.dtype == torch.float32
    _within_range(got.numpy(), want, TOL_RELAX)
    assert (got.numpy()[mask] == data[mask]).all()  # constrained nodes pinned


def _raster_equal(got, want):
    assert (got.left, got.top, got.res, got.nodata) == (want.left, want.top, want.res,
                                                        want.nodata)
    assert _same(got.data, want.data)


def test_xyz_to_grid_exact_matches_jax_on_the_goldens():
    # the reference doctest cloud (data_prep.py:393-404) and the 40x40 golden
    cloud = pd.DataFrame(600 * np.random.RandomState(seed=42).rand(60).reshape(20, 3),
                         columns=["x", "y", "z"])
    region = gridder.get_region(cloud)
    _raster_equal(gridder.xyz_to_grid(cloud, region, spacing=250, device="cpu"),
                  jax_gridder.xyz_to_grid(cloud, region, spacing=250))
    rs = np.random.RandomState(42)
    x, y = rs.uniform(0, 9750, 2500), rs.uniform(0, 9750, 2500)
    z = 500 + 0.05 * x - 0.03 * y + 120 * np.sin(x / 1300.0) * np.cos(y / 900.0)
    xyz = XYZ(x, y, z)
    got = gridder.xyz_to_grid(xyz, (0.0, 9750.0, 0.0, 9750.0), spacing=250,
                              backend="exact", device="cpu")
    _raster_equal(got, jax_gridder.xyz_to_grid(pd.DataFrame({"x": x, "y": y, "z": z}),
                                               (0.0, 9750.0, 0.0, 9750.0), spacing=250))
    assert abs(float(np.mean(got.data)) - 596.553894) < 1e-3


@pytest.mark.parametrize("offset_correction", [True, False])
def test_xyz_to_grid_relax_matches_jax(offset_correction):
    rs = np.random.RandomState(11)
    x, y = rs.uniform(0, 10000, 3000), rs.uniform(0, 10000, 3000)
    df = pd.DataFrame({"x": x, "y": y,
                       "z": 0.08 * x - 0.05 * y + 150 * np.sin(x / 1500.0)})
    region = (0.0, 10000.0, 0.0, 10000.0)
    kw = dict(spacing=250, iterations=120, backend="relax",
              offset_correction=offset_correction)
    want = jax_gridder.xyz_to_grid(df, region, **kw)
    got = gridder.xyz_to_grid(df, region, device="cpu", **kw)
    assert (got.left, got.top, got.res) == (want.left, want.top, want.res)
    _within_range(got.data, want.data, TOL_RELAX)


def test_gridline_to_pixel_and_backend_guard():
    z = torch.arange(9.0).reshape(3, 3)
    assert spline.gridline_to_pixel(z).tolist() == [[2.0, 3.0], [5.0, 6.0]]
    with pytest.raises(ValueError):
        gridder.xyz_to_grid(_cloud(0, 10, 500.0), (0.0, 500.0, 0.0, 500.0),
                            backend="gmt", device="cpu")


def test_port_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    xyz = _cloud(0, 30, 1000.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        gridder.blockmedian(xyz, (0.0, 1000.0, 0.0, 1000.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        gridder.xyz_to_grid(xyz, (0.0, 1000.0, 0.0, 1000.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        spline.solve_tension_spline(np.zeros((8, 8)), np.zeros((8, 8), bool))


def test_blockmedian_reduces_to_cells():
    # tests/test_gridder.py's case, on the port's XYZ table
    rs = np.random.RandomState(0)
    xyz = pd.DataFrame({"x": rs.rand(500) * 1000, "y": rs.rand(500) * 1000, "z": rs.rand(500)})
    med = gridder.blockmedian(xyz, (0, 1000, 0, 1000), spacing=250, device="cpu")
    assert isinstance(med, XYZ) and 0 < len(med) <= 25
    assert len(med.x) == len(med.y) == len(med.z)


def _solve_on_port(data, has_data, tension=0.35, iterations=300):
    return spline.solve_tension_spline(np.asarray(data), np.asarray(has_data),
                                       tension=tension, iterations=iterations,
                                       device="cpu").numpy()


PORTED = {
    "get_region": gridder.get_region,
    "blockmedian": functools.partial(gridder.blockmedian, device="cpu"),
    "xyz_to_grid": functools.partial(gridder.xyz_to_grid, device="cpu"),
    "solve_tension_spline": _solve_on_port,
    "distance_mask": spline.distance_mask,
    "gridline_to_pixel": lambda z: spline.gridline_to_pixel(torch.tensor(np.asarray(z))),
}
# every case of tests/test_gridder.py but the one that reads DataFrame
# columns, which test_blockmedian_reduces_to_cells above restates
GRIDDER_CASES = [name for name, fn in inspect.getmembers(jax_cases, inspect.isfunction)
                 if name.startswith("test_") and name != "test_blockmedian_reduces_to_cells"]


@pytest.mark.parametrize("case", GRIDDER_CASES)
def test_jax_gridder_case_on_the_port(case, monkeypatch):
    """The case's own assertions, with the module's gridding functions
    replaced by the port's on the CPU."""
    for name, fn in PORTED.items():
        monkeypatch.setattr(jax_cases, name, fn)
    getattr(jax_cases, case)()

"""PyTorch port: the classical baselines (``evalx/baselines.py``) and the
terrain analysis (``viz/analysis.py``) against the JAX package on the CPU.

The baselines must reproduce ``jax.image.resize`` (Keys a = -0.5, the
antialiased triangle, JAX's edge renormalisation, and its NaN spread: one
NaN input makes a dense-matrix resize all NaN), not ``F.interpolate``.
``standard_deviation_2d`` keeps JAX's one-pass float32 formula, whose
cancellation sets the tolerance; ``hillshade`` is ``jnp.gradient``'s."""

import numpy as np
import pytest
import torch

from deepbedmap_tpu.data.raster import Raster as JaxRaster
from deepbedmap_tpu.evalx import baselines as jax_baselines
from deepbedmap_tpu.viz import analysis as jax_analysis
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.evalx import bicubic_upsample, bilinear_resample
from deepbedmap_tpu_torch.viz import hillshade, standard_deviation_2d

# the baselines: 1e-6 of each output's range (fp32 sums of the same weights
# in another order; the port rounds float64 products once)
TOL_BASELINE = 1e-6
# the roughness variance: 1e-6 x max(x^2), the one-pass formula's error
# scale (s2 / n - mean^2 cancels at a DEM's magnitudes)
TOL_VARIANCE = 1e-6
TOL_HILLSHADE = 1e-5  # absolute, on [0, 1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _field(shape, seed, dem: bool):
    """A unit-variance field, or a DEM-scale one (around -900 m)."""
    rs = np.random.RandomState(seed)
    if not dem:
        return rs.randn(*shape).astype(np.float32)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    return (-900.0 + 350.0 * np.sin(xx / 9.0) + 250.0 * np.cos(yy / 7.0)
            + 15.0 * rs.randn(h, w)).astype(np.float32)


def _pair(data, res=1000.0):
    kw = dict(left=-1_600_000.0, top=-100_000.0, res=res)
    return JaxRaster(data, **kw), Raster(data, **kw)


def _assert_rasters_close(got: Raster, want, tol: float):
    assert got.data.shape == want.data.shape
    assert (got.left, got.top, got.res, got.crs) == (want.left, want.top, want.res, want.crs)
    assert got.data.dtype == np.float32
    nan = np.isnan(want.data)
    np.testing.assert_array_equal(np.isnan(got.data), nan)
    if not nan.all():
        span = np.ptp(want.data[~nan])
        np.testing.assert_allclose(got.data[~nan], want.data[~nan], rtol=0, atol=tol * span)


SHAPES = [(6, 7), (13, 17), (24, 28), (31, 30)]  # odd and even sides


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dem", [False, True])
@pytest.mark.parametrize("fn,factor", [
    ("bicubic_upsample", 4),
    ("bilinear_resample", 2),
    ("bilinear_resample", 0.5),
    ("bilinear_resample", 1 / 2.5),  # the synthetic-HRES baseline's
])
def test_baselines_match_jax(shape, dem, fn, factor):
    jr, tr = _pair(_field(shape, sum(shape), dem))
    want = getattr(jax_baselines, fn)(jr, factor)
    got = {"bicubic_upsample": bicubic_upsample,
           "bilinear_resample": bilinear_resample}[fn](tr, factor, device="cpu")
    _assert_rasters_close(got, want, TOL_BASELINE)


@pytest.mark.parametrize("fn,factor", [
    ("bicubic_upsample", 4), ("bilinear_resample", 2), ("bilinear_resample", 1 / 2.5)])
def test_baselines_spread_a_nan_as_jax(fn, factor):
    """One NaN in the input: JAX's dense per-axis products make the whole
    output NaN (NaN x 0 is NaN); the port's equal masks show it does too."""
    data = _field((6, 7), 1, dem=False)
    data[2, 3] = np.nan
    jr, tr = _pair(data)
    want = getattr(jax_baselines, fn)(jr, factor)
    got = {"bicubic_upsample": bicubic_upsample,
           "bilinear_resample": bilinear_resample}[fn](tr, factor, device="cpu")
    assert np.isnan(want.data).all()
    _assert_rasters_close(got, want, TOL_BASELINE)


def test_bicubic_is_not_torch_interpolate():
    """``F.interpolate``'s bicubic (Keys a = -0.75) is not JAX's cubic: the
    port's answer is JAX's, far from it."""
    jr, tr = _pair(_field((24, 28), 3, dem=False))
    got = bicubic_upsample(tr, 4, device="cpu").data
    other = torch.nn.functional.interpolate(
        torch.from_numpy(tr.data)[None, None], scale_factor=4, mode="bicubic")[0, 0].numpy()
    assert np.abs(got - other).max() > 0.05
    _assert_rasters_close(Raster(got, tr.left, tr.top, tr.res / 4),
                          jax_baselines.bicubic_upsample(jr, 4), TOL_BASELINE)


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("dem", [False, True])
def test_standard_deviation_2d_matches_jax(window, dem):
    grid = _field((40, 50), window, dem)
    want = np.asarray(jax_analysis.standard_deviation_2d(grid, window))
    got = standard_deviation_2d(grid, window, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    half = window // 2
    assert np.isnan(want[:half]).all() and np.isnan(want[:, -half:]).all()
    inner = ~np.isnan(want)
    np.testing.assert_allclose(got[inner] ** 2, want[inner] ** 2, rtol=0,
                               atol=TOL_VARIANCE * float(np.max(grid * grid)))


@pytest.mark.parametrize("azimuth,altitude,vert_exag", [
    (315.0, 45.0, 1.0), (200.0, 30.0, 1.0), (315.0, 45.0, 3.0)])
def test_hillshade_matches_jax(azimuth, altitude, vert_exag):
    grid = _field((40, 50), 7, dem=True)
    want = np.asarray(jax_analysis.hillshade(grid, 250.0, azimuth, altitude, vert_exag))
    got = hillshade(grid, 250.0, azimuth, altitude, vert_exag, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_HILLSHADE)


def test_a_tensor_stays_on_its_device():
    grid = torch.from_numpy(_field((12, 14), 2, dem=True))
    assert hillshade(grid).device.type == "cpu"  # the default device is ignored
    assert standard_deviation_2d(grid).device.type == "cpu"


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the default device raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tr = _pair(_field((6, 7), 0, dem=False))
    grid = _field((6, 7), 0, dem=False)
    for call in (lambda: bicubic_upsample(tr), lambda: bilinear_resample(tr, 0.5),
                 lambda: standard_deviation_2d(grid), lambda: hillshade(grid)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

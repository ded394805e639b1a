"""PyTorch port: the single-region workflow on the CPU against the JAX package.
NetCDF I/O (``data/raster.py``), the ground truth and the model's inputs
(``data/groundtruth.py``), and ``DeepBedMap.predict`` / ``track_rmse`` on
tests/test_api.py's 9 km window, in the default and the Pallas-trunk
configurations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu import DeepBedMap as JaxDeepBedMap
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.data import groundtruth as jax_groundtruth
from deepbedmap_tpu.data import raster as jax_raster
from deepbedmap_tpu.evalx.track import grdtrack as jax_grdtrack
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.data import groundtruth, raster
from deepbedmap_tpu_torch.evalx.track import grdtrack
from deepbedmap_tpu_torch.ops.interp import as_f32

KEYS = ("X", "W1", "W2", "W3")
WINDOW = (1000.0, 1000.0, 10000.0, 10000.0)  # tests/test_api.py's 9 km window


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same(got, want, rel=1e-6):
    """NaN masks identical; values within ``rel`` of want's range."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(np.abs(want[ok]).max(), 1e-30)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=rel * scale)


def _source_rasters(left, top, seed, voids, sizes=None):
    """The five source rasters as (port, JAX) dicts, from one seeded array
    each: bed 1000 m, surface 100 m, velocity 450 m (another grid than the
    500 m it is resampled to), accumulation 1000 m."""
    rs = np.random.RandomState(seed)
    sizes = sizes or {"bed_lowres": (40, 1000.0), "surface": (400, 100.0),
                      "velocity_x": (90, 450.0), "velocity_y": (90, 450.0),
                      "accumulation": (40, 1000.0)}
    port, ref = {}, {}
    for name, (n, res) in sizes.items():
        data = (rs.rand(n, n) - 0.3).astype(np.float32)
        if name in voids:
            data[rs.rand(n, n) < 0.03] = np.nan
        port[name] = raster.Raster(data, left=left, top=top, res=res)
        ref[name] = jax_raster.Raster(data.copy(), left=left, top=top, res=res)
    return port, ref


@pytest.mark.parametrize(
    "origin,voids",
    [
        # tests/test_api.py's rasters, with voids everywhere: the surface's
        # stay NaN, the others are gapfilled
        ((-5000.0, 35000.0), ("bed_lowres", "surface", "velocity_x", "accumulation")),
        # EPSG:3031 near Pine Island Glacier, the window's padded edge on the
        # bed's first cell centers (float32 coordinates decide inside/outside)
        ((-1_600_000.0, -240_000.0), ("bed_lowres", "velocity_y")),
    ],
)
def test_get_model_inputs_matches_jax(origin, voids):
    left, top = origin
    port, ref = _source_rasters(left, top, seed=1, voids=voids)
    window = (left + 1000.0, top - 10_000.0, left + 10_000.0, top - 1000.0)
    names = ("bed_lowres", "surface", "velocity_x", "velocity_y", "accumulation")
    want = jax_groundtruth.get_model_inputs(window, *(ref[k] for k in names))
    got = groundtruth.get_model_inputs(window, *(port[k] for k in names), device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "X": (1, 1, 11, 11), "W1": (1, 1, 110, 110), "W2": (1, 2, 22, 22),
        "W3": (1, 1, 11, 11)}
    for k in KEYS:
        # the same float32 sampling: masks exact, values within 1e-6 of the
        # range (bit for bit on the CPU)
        _assert_same(got[k].numpy(), want[k])
    assert np.isnan(want["W1"]).any() == ("surface" in voids)
    assert not any(np.isnan(want[k]).any() for k in ("X", "W2", "W3"))
    if "bed_lowres" in voids:
        assert (want["X"] == -5000.0).any()


def test_gapfill_from_coarse_matches_jax():
    rs = np.random.RandomState(4)
    fine = (rs.rand(60, 70) * 100).astype(np.float32)
    fine[rs.rand(60, 70) < 0.1] = np.nan
    fine[0, :] = np.nan  # at the fine grid's edge, beyond the coarse hull
    coarse = (rs.rand(32, 37) * 100).astype(np.float32)
    left, top = -1_600_000.0, -250_000.0
    want = jax_groundtruth.gapfill_from_coarse(
        jax_raster.Raster(fine, left, top, 100.0), jax_raster.Raster(coarse, left, top, 200.0))
    got = groundtruth.gapfill_from_coarse(
        raster.Raster(fine, left, top, 100.0), raster.Raster(coarse, left, top, 200.0),
        device="cpu")
    assert (got.left, got.top, got.res) == (want.left, want.top, want.res)
    _assert_same(got.data, want.data)
    assert np.isnan(want.data).any() and np.isnan(want.data).sum() < np.isnan(fine).sum()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_netcdf_and_get_image_with_bounds_across_packages(tmp_path, capsys, writer):
    # files written by one package's write_netcdf, read back by the other's
    # read_netcdf / get_image_with_bounds; two tiles mosaic over their union
    write = {"port": raster.write_netcdf, "jax": jax_raster.write_netcdf}[writer]
    cls = {"port": raster.Raster, "jax": jax_raster.Raster}[writer]
    rs = np.random.RandomState(2)
    a = rs.rand(12, 16).astype(np.float32)
    b = rs.rand(12, 10).astype(np.float32)
    b[3, 4] = -9999.0
    paths = [str(tmp_path / "a.nc"), str(tmp_path / "b.nc")]
    write(cls(a, left=-1_600_000.0, top=-250_000.0, res=250.0), paths[0])
    write(cls(b, left=-1_596_000.0, top=-247_000.0, res=250.0, nodata=-9999.0), paths[1])

    for p in paths:
        want = (jax_raster.read_netcdf(p), raster.read_netcdf(p))
        assert want[0].bounds == want[1].bounds and want[0].nodata == want[1].nodata
        np.testing.assert_array_equal(want[1].data, want[0].data)
    crop = (-1_599_100.0, -252_600.0, -1_597_400.0, -250_100.0)
    w0, w1 = jax_raster.read_netcdf(paths[0], bounds=crop), raster.read_netcdf(paths[0],
                                                                                bounds=crop)
    assert w1.bounds == w0.bounds and w1.data.shape == (11, 8)
    np.testing.assert_array_equal(w1.data, w0.data)

    want = jax_groundtruth.get_image_with_bounds(paths)
    jax_out = capsys.readouterr().out
    got = groundtruth.get_image_with_bounds(paths)
    assert capsys.readouterr().out == jax_out != ""  # 24 x 26: warns, as JAX
    assert got.bounds == want.bounds == (-1_600_000.0, -253_000.0, -1_593_500.0, -247_000.0)
    np.testing.assert_array_equal(got.data, want.data)
    # NaN where no tile covers the union, and at b's nodata
    assert np.isnan(got.data[0, 0]) and np.isnan(got.data[15, 20])
    assert np.isnan(got.data[3, 20]) and got.data[3, 19] == b[3, 3]
    single = groundtruth.get_image_with_bounds(paths[:1], strict_multiple_of=4)
    assert capsys.readouterr().out == ""  # 12 x 16 is divisible by 4
    np.testing.assert_array_equal(single.data, a)


# ---------------------------------------------------------------------------
# DeepBedMap.predict and track_rmse

# (generator flags, window)
CONFIGS = {
    # the defaults at 2 RRDBs: XLA's trunk and tail on JAX's side
    "default": (dict(num_residual_blocks=2), WINDOW),
    # JAX runs its K1 Pallas kernel interpreted on the resident trunk, bf16
    # multiplicands off (as tests/test_torch_port_generator.py). That kernel
    # takes latent widths W with W + 2 a multiple of 8, so the window is
    # 14 km (16 low-res px with the padding) instead of 9 km (11 px)
    "pallas_trunk": (dict(num_residual_blocks=2, rdb_resident="always",
                          fused_rdb="always", rdb_mxu_bf16=False),
                     (1000.0, 1000.0, 15000.0, 15000.0)),
}


@pytest.fixture(scope="module")
def rasters():
    return _source_rasters(-5000.0, 35000.0, seed=0, voids=("velocity_x",))


@pytest.fixture(scope="module", params=list(CONFIGS))
def predictions(request, rasters):
    flags, window = CONFIGS[request.param]
    # weights drawn at init_scale=1.0 so the output is O(1) and the
    # tolerance bites; the forward config is ``flags`` on both sides
    _, params = jax_build_generator(JaxGeneratorConfig(**flags, init_scale=1.0), lr=16)
    ref = JaxDeepBedMap(params, JaxGeneratorConfig(**flags))
    port = DeepBedMap.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                      GeneratorConfig(**flags), device="cpu")
    port_r, jax_r = rasters
    return ref, ref.predict(window, jax_r), port, port.predict(window, port_r), window


def test_predict_matches_jax(predictions):
    _, want, _, got, window = predictions
    side = int((window[2] - window[0]) / 250.0)
    assert got.data.shape == want.data.shape == (side, side)
    assert got.bounds == want.bounds == window
    assert got.res == want.res == 250.0
    scale = np.abs(want.data).max()
    assert scale > 0.5  # a meaningful scale for the tolerance
    # fp32 on both sides in another summation order through 2 RRDBs and the
    # deformable tail: within 1e-5 of the output's range
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-5 * scale)


def test_track_rmse_matches_jax(predictions):
    ref, want, port, got, _ = predictions
    rs = np.random.RandomState(1)
    tx = rs.uniform(500, 10_500, 3000)  # some points outside the DEM
    ty = rs.uniform(500, 10_500, 3000)
    tz = np.asarray(jax_grdtrack(jnp.asarray(want.data), jnp.asarray(tx), jnp.asarray(ty),
                                 want.left, want.top, want.res))
    tz = tz + rs.randn(3000) * 0.1
    same = raster.Raster(want.data, want.left, want.top, want.res)
    # the same DEM on both sides: float32 sums in another order, 1e-6
    assert port.track_rmse(same, tx, ty, tz) == pytest.approx(
        ref.track_rmse(want, tx, ty, tz), rel=1e-6)
    # and against its own bicubic samples the port's DEM scores ~0, as in
    # tests/test_api.py
    oz = grdtrack(torch.from_numpy(got.data), as_f32(tx, "cpu"), as_f32(ty, "cpu"),
                  got.left, got.top, got.res).numpy()
    assert np.isnan(oz).any()
    assert port.track_rmse(got, tx, ty, oz) < 1e-5

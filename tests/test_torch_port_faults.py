"""PyTorch port: three repairs, each against the reference's behaviour.

1. ``evalx.read_track_csv`` reads what ``pandas.read_csv(...)[["x", "y",
   "z"]]`` reads (empty fields and NA strings as NaN, quoted numbers and
   headers, extra and reordered columns, CRLF, a header-only file), exactly;
   the CLI's ``evaluate`` on such a file equals JAX's ``cmd_evaluate``
   (``rmse_m`` rounded to 4 decimals by both; ``track_rmse`` within 1e-6
   relative of JAX's, the float32 sums taken in another order).
2. ``ops.deform_conv.choose_method`` sends a CUDA tensor to the kernels
   exactly where K7 / K8 take the layer's shape and clamp, and follows JAX's
   off-TPU rule everywhere else, an uncovered clamp included (a table of
   shapes, no card needed).
3. ``config.check_card_supported`` refuses generator widths that a kernel
   the configuration forces (``'always'``) does not take; a generator built
   on ``device="cuda"`` with such widths raises ``NotImplementedError`` at
   construction (before the device is resolved, so no card is needed).
   Under ``'auto'`` the widths and clamps the kernels do not take resolve to
   the plain trunk and the plain tail (``trunk_kernel``, ``tail_kernel``)
   and pass; the CPU runs any width and clamp.
"""

import json
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from deepbedmap_tpu import cli as jax_cli
from deepbedmap_tpu.data.raster import Raster as JaxRaster
from deepbedmap_tpu.evalx import track_rmse as jax_track_rmse
from deepbedmap_tpu_torch import DeepBedMap, GeneratorConfig
from deepbedmap_tpu_torch.cli import main
from deepbedmap_tpu_torch.config import (
    check_card_supported,
    conv_kernel,
    tail_kernel,
    trunk_kernel,
)
from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.evalx.track import read_track_csv, track_rmse
from deepbedmap_tpu_torch.models.api import build_generator
from deepbedmap_tpu_torch.ops.deform_conv import choose_method, deform_conv2d
from deepbedmap_tpu_torch.train.state import create_gan_state

TOL_RMSE = 1e-6  # relative: float32 sums in another order

CSVS = {
    "empty_z": "x,y,z\n1000,2000,3\n4000,5000,\n",
    "nan_x": "x,y,z\nnan,2000,3\n4000,5000,6\n",
    "quoted_numbers": '"x","y","z"\n"1500.5","2000","-3e2"\n4000,"5000",6\n',
    "reordered_extra_columns": "id,z,note,y,x\n7,3.25,a,2000,1000\n8,6,b,5000,4000\n",
    "crlf": "x,y,z\r\n1000,2000,3\r\n4000,5000,6\r\n",
    "header_only": "x,y,z\n",
    "na_strings": "x,y,z\n1000,NA,3\n4000,5000,null\nN/A,2000,n/a\n",
    "blank_line": "x,y,z\n1000,2000,3\n\n4000,5000,6\n",
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", sorted(CSVS))
def test_read_track_csv_matches_pandas(tmp_path, case):
    path = tmp_path / f"{case}.csv"
    path.write_bytes(CSVS[case].encode())
    want = pd.read_csv(path)[["x", "y", "z"]]
    got = read_track_csv(str(path))
    for col, arr in zip("xyz", got):
        assert arr.dtype == np.float64
        np.testing.assert_array_equal(arr, want[col].to_numpy(np.float64), err_msg=col)


def test_read_track_csv_refuses_what_is_not_a_track(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("x,y\n1,2\n")
    with pytest.raises(ValueError, match="no column"):
        read_track_csv(str(path))
    path.write_text("x,y,z\n1,2,deep\n")
    with pytest.raises(ValueError, match="'z'"):
        read_track_csv(str(path))


def _dem_and_track(tmp_path):
    """A 40 x 40 DEM as GeoTIFF and a track CSV with an empty z, a NaN x, a
    quoted number, CRLF endings and extra columns in another order."""
    rs = np.random.RandomState(3)
    dem = rs.rand(40, 40).astype(np.float32) * 100
    path = str(tmp_path / "dem.tif")
    geotiff.write_geotiff(path, dem, 0.0, 10_000.0, 250.0, nodata=-2000.0, compress=True)
    tx = rs.uniform(1000, 9000, 60)
    ty = rs.uniform(1000, 9000, 60)
    tz = rs.uniform(0, 100, 60)
    lines = ['"id","z","y","x","note"']
    for i, (x, y, z) in enumerate(zip(tx.tolist(), ty.tolist(), tz.tolist())):
        zs = "" if i == 5 else f'"{z!r}"' if i == 7 else repr(z)
        xs = "nan" if i == 9 else repr(x)
        lines.append(f"{i},{zs},{y!r},{xs},n{i}")
    track = str(tmp_path / "track.csv")
    with open(track, "w", newline="") as f:
        f.write("\r\n".join(lines) + "\r\n")
    return path, track


def test_cli_evaluate_on_a_pandas_track_equals_jax(tmp_path, capsys, monkeypatch):
    dem_path, track = _dem_and_track(tmp_path)
    assert jax_cli.main(["evaluate", "--dem", dem_path, "--track", track]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setitem(sys.modules, "pandas", None)  # the port reads without it
    assert main(["evaluate", "--dem", dem_path, "--track", track, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert np.isfinite(got["rmse_m"]) and got["points"] == 60

    # the library call on the same arrays
    x, y, z = read_track_csv(track)
    data, meta = geotiff.read_geotiff(dem_path)
    data = np.where(data == meta["nodata"], np.nan, data).astype(np.float32)
    ours = track_rmse(Raster(data, meta["left"], meta["top"], meta["res"]), x, y, z,
                      device="cpu")
    theirs = float(jax_track_rmse(JaxRaster(data, meta["left"], meta["top"], meta["res"]),
                                  x, y, z))
    assert abs(ours - theirs) <= TOL_RMSE * abs(theirs)


# (device, x shape NHWC, weight OIHW, padding, clamp) -> JAX's method off the
# TPU, or 'pallas' where K7 / K8 take the layer on the card; a clamp beyond
# their windows takes JAX's rule, as a shape they do not take
CHOICES = [
    ("cuda", (1, 20, 30, 64), (64, 64, 3, 3), 1, 2, "pallas"),
    ("cuda", (1, 300, 300, 64), (1, 64, 3, 3), 1, 2, "pallas"),
    ("cuda", (2, 9, 9, 64), (64, 64, 3, 3), 1, 0, "pallas"),
    ("cuda", (1, 20, 30, 64), (64, 64, 3, 3), 1, 3, "shifts"),  # beyond the window
    ("cuda", (1, 20, 30, 64), (64, 64, 3, 3), 1, 1.5, "shifts"),
    ("cuda", (1, 300, 300, 64), (1, 64, 3, 3), 1, 3, "zproj"),
    ("cuda", (1, 20, 30, 32), (16, 32, 5, 5), 2, 2, "shifts"),
    ("cuda", (1, 256, 256, 32), (8, 32, 3, 3), 1, 2, "zproj"),
    ("cuda", (1, 256, 256, 32), (16, 32, 3, 3), 1, 2, "shifts"),
    ("cuda", (1, 255, 256, 128), (1, 128, 3, 3), 1, 2, "shifts"),
    ("cuda", (1, 20, 30, 64), (64, 64, 3, 3), 0, 2, "shifts"),
    ("cuda", (1, 20, 30, 64), (16, 64, 3, 3), 1, 2, "shifts"),
    ("cuda", (1, 300, 300, 64), (16, 64, 3, 3), 1, 2, "zproj"),
    ("cpu", (1, 20, 30, 64), (64, 64, 3, 3), 1, 2, "shifts"),
    ("cpu", (1, 300, 300, 64), (1, 64, 3, 3), 1, 2, "zproj"),
    ("cpu", (1, 300, 300, 64), (64, 64, 3, 3), 1, 2, "shifts"),
    ("cpu", (1, 20, 30, 64), (64, 64, 3, 3), 1, 3, "shifts"),
    ("cuda", (1, 20, 30, 32), (16, 32, 5, 5), 2, 3, "shifts"),
]


@pytest.mark.parametrize("device,x_shape,w_shape,padding,clamp,want", CHOICES)
def test_choose_method(device, x_shape, w_shape, padding, clamp, want):
    assert choose_method(device, x_shape, w_shape, padding, clamp) == want


def test_auto_on_an_odd_layer_runs_the_plain_sampler():
    # 32 -> 16 channels, 5x5, padding 2: what 'auto' picks is what it runs
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 12, 14, 32, generator=gen)
    off = torch.randn(1, 12, 14, 50, generator=gen)
    w = torch.randn(16, 32, 5, 5, generator=gen) * 0.05
    b = torch.randn(16, generator=gen)
    got = deform_conv2d(x, off, w, b, padding=2, clamp=2)
    want = deform_conv2d(x, off, w, b, padding=2, clamp=2, method="shifts")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="method='pallas'"):
        deform_conv2d(x, off, w, b, padding=2, clamp=2, method="pallas")


@pytest.mark.parametrize(
    "flags",
    [dict(inblock_channels=24, fused_conv="always"),
     dict(base_channels=48, fused_conv="always"),
     # a resident trunk is K1 even with fused_rdb='never'
     dict(growth_channels=16, fused_rdb="never", rdb_resident="always"),
     dict(growth_channels=16, rdb_resident="always"),
     dict(base_channels=48, fused_rdb="always"),
     dict(growth_channels=16, rdb_resident="never", fused_rdb="always"),
     dict(base_channels=32, growth_channels=16, rdb_resident="always", rrdb_sweep=True),
     dict(growth_channels=16, rdb_resident="always", rrdb_fused=True)],
)
def test_widths_the_kernels_do_not_take_are_refused_on_the_card(flags):
    # 'always' forces a kernel: a width it does not take is refused, naming it
    cfg = GeneratorConfig(num_residual_blocks=1, **flags)
    with pytest.raises(NotImplementedError, match="no kernels on the card"):
        check_card_supported(cfg)
    for build in (lambda: build_generator(cfg, device="cuda"),
                  lambda: DeepBedMap(cfg=cfg, device="cuda"),
                  lambda: create_gan_state(cfg, device="cuda")):
        with pytest.raises(NotImplementedError, match="no kernels on the card"):
            build()
    if "fused_conv" in flags:
        return  # K10's plain version takes K10's widths only, on either device
    # the CPU runs every trunk width through the plain versions
    model = build_generator(cfg, device="cpu")
    lr = 6
    xs = [torch.rand(1, lr, lr, 1), torch.rand(1, 10 * lr, 10 * lr, 1),
          torch.rand(1, 2 * lr, 2 * lr, 2), torch.rand(1, lr, lr, 1)]
    with torch.inference_mode():
        assert torch.isfinite(model(*xs)).all()


@pytest.mark.parametrize(
    "flags,trunk,tail",
    [(dict(base_channels=48), "plain", False),
     (dict(growth_channels=16), "plain", True),
     (dict(base_channels=32, growth_channels=16), "plain", False),
     (dict(deform_clamp=3), "rdb", False),
     (dict(deform_clamp=3, tail_fused=False), "rdb", False),
     (dict(base_channels=48, fused_rdb="never"), "plain", False)],
)
def test_auto_sends_widths_the_kernels_do_not_take_to_the_plain_path(flags, trunk, tail):
    # under 'auto' the resolution, made from the config before any launch,
    # gives the plain trunk (and the plain composition of the fused tail)
    # where the kernels do not take the widths or the clamp, as JAX's 'auto'
    # sends what it does not fuse to XLA; nothing is refused on the card
    cfg = GeneratorConfig(num_residual_blocks=1, **flags)
    check_card_supported(cfg)
    assert (trunk_kernel(cfg), tail_kernel(cfg), conv_kernel(cfg)) == (trunk, tail, False)
    model = build_generator(cfg, device="cpu")
    lr = 6
    xs = [torch.rand(1, lr, lr, 1), torch.rand(1, 10 * lr, 10 * lr, 1),
          torch.rand(1, 2 * lr, 2 * lr, 2), torch.rand(1, lr, lr, 1)]
    with torch.inference_mode():
        assert torch.isfinite(model(*xs)).all()


@pytest.mark.parametrize("flags", [{}, dict(rrdb_fused=True, fused_conv="always"),
                                   dict(inblock_channels=16, fused_conv="always"),
                                   dict(inblock_channels=24), dict(deform_clamp=0),
                                   dict(deform_clamp=1, tail_fused=False),
                                   # no kernel runs the trunk: any growth width
                                   dict(fused_rdb="never", growth_channels=16),
                                   dict(fused_rdb="never", growth_channels=48),
                                   dict(compute_dtype="bfloat16", growth_channels=16),
                                   # nor the unfused tail at other than 64 channels,
                                   # where the plain samplers take any clamp
                                   dict(fused_rdb="never", base_channels=48,
                                        tail_fused=False, deform_clamp=3),
                                   dict(fused_rdb="never", base_channels=20,
                                        tail_fused=False),
                                   # K10 runs only at float32 under 'auto'
                                   dict(compute_dtype="bfloat16", fused_conv="auto",
                                        inblock_channels=24)])
def test_kernel_widths_pass(flags):
    check_card_supported(GeneratorConfig(**flags))

"""PyTorch port on a CUDA card: the continent band loop's transfers
(``inference.continent``: the bands' real rows uploaded on a side stream
from page-locked memory or through a page-locked staging buffer, the edge
rows replicated on the device, the strips downloaded on a second side stream
into page-locked buffers). The canvas must equal the serial loop's and the
one made from host-padded bands bit for bit, with page-locked and with
pageable inputs; the streamed product's strips must survive a writer that
falls behind; a band's upload and dispatch must not synchronise; every copy
from page-locked inputs is counted as asynchronous.

The tests carry the ``card`` marker and skip without a card. On the card's
machine, which has no JAX (``tests/conftest.py`` imports it), run them with
``python -m pytest --noconftest -p no:cacheprovider -q -m card
tests/test_torch_port_band_transfers.py``."""

import time

import numpy as np
import pytest
import torch

from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.data import geotiff
from deepbedmap_tpu_torch.inference import continent
from deepbedmap_tpu_torch.inference.engine import INPUT_RATIOS, TilePlan
from deepbedmap_tpu_torch.utils import profiling

RES = 250.0
LH, LW = 48, 24  # 6 bands x 3 tiles of 32 px
BOUNDS = (0.0, 0.0, 4 * LW * RES, 4 * LH * RES)
KW = dict(tile_out=32, halo_lr=3, tiles_per_dispatch=2)
PLAN = TilePlan(out_h=4 * LH, out_w=4 * LW, tile_out=32, halo_lr=3)
CHANNELS = {"X": 1, "W1": 1, "W2": 2, "W3": 1}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dbm(card):
    return DeepBedMap(cfg=GeneratorConfig(num_residual_blocks=1, init_scale=1.0), device=card)


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _inputs_nchw(pinned: bool, seed: int = 7):
    """NCHW float32 rasters, partly below 0 (the clip runs), in page-locked
    or in pageable host memory."""
    rs = np.random.RandomState(seed)
    out = {}
    for key, ratio in INPUT_RATIOS.items():
        a = rs.rand(1, CHANNELS[key], ratio * LH, ratio * LW).astype(np.float32) - 0.2
        host = torch.empty(a.shape, dtype=torch.float32, pin_memory=pinned)
        out[key] = host.copy_(torch.from_numpy(a)).numpy()
    return out


def _host_padded_band(inputs_host, plan, band, device="cuda", ring=None):
    """The band as the host used to make it: the rows cut and edge-padded
    with ``np.pad``, made contiguous, then moved to ``device``."""
    lh = plan.lr_shape[0]
    r0, r1 = band * plan.tile_lr - plan.pad_lr, (band + 1) * plan.tile_lr + plan.pad_lr
    out = {}
    for key, ratio in INPUT_RATIOS.items():
        a = inputs_host[key]
        rr0, rr1 = r0 * ratio, r1 * ratio
        sl = a[:, max(0, rr0) : min(ratio * lh, rr1)]
        sl = np.pad(sl, ((0, 0), (max(0, -rr0), max(0, rr1 - ratio * lh)), (0, 0), (0, 0)),
                    mode="edge")
        out[key] = torch.from_numpy(np.ascontiguousarray(sl, np.float32)).to(device)
    return out


@pytest.mark.card
@pytest.mark.parametrize("pinned", [True, False], ids=["page-locked", "pageable"])
def test_canvas_equals_the_serial_and_the_host_padded_canvas(dbm, monkeypatch, pinned):
    nchw = _inputs_nchw(pinned)
    assert torch.from_numpy(nchw["W1"]).is_pinned() == pinned
    serial = dbm.predict_continent(nchw, BOUNDS, prefetch=0, **KW).data
    gy = PLAN.grid[0]
    for prefetch in (1, 2, 3):
        profiling.enable()
        got = dbm.predict_continent(nchw, BOUNDS, prefetch=prefetch, **KW).data
        counters = profiling.snapshot()["counters"]
        profiling.disable()
        profiling.reset()
        np.testing.assert_array_equal(got, serial)
        # four rasters and a strip a band, all on the side streams
        assert counters["continent.copies.async"] == 5 * gy
        assert "continent.copies.sync" not in counters
        sent = {"continent.upload_bytes.pinned", "continent.upload_bytes.pageable"}
        assert set(counters) & sent == {"continent.upload_bytes." +
                                        ("pinned" if pinned else "pageable")}
    monkeypatch.setattr(continent, "_band_inputs", _host_padded_band)
    want = dbm.predict_continent(nchw, BOUNDS, prefetch=0, **KW).data
    np.testing.assert_array_equal(serial, want)


@pytest.mark.card
def test_streamed_strips_survive_a_writer_that_falls_behind(dbm, monkeypatch, tmp_path):
    nchw = _inputs_nchw(True)
    canvas = dbm.predict_continent(nchw, BOUNDS, prefetch=2, **KW).data
    written = []
    write_strip = geotiff.GeoTiffStripWriter.write_strip

    def slow_write_strip(self, strip):
        # the band loop runs ahead and the writer's queue fills meanwhile
        time.sleep(0.2)
        written.append(np.array(strip, copy=True))
        return write_strip(self, strip)

    monkeypatch.setattr(geotiff.GeoTiffStripWriter, "write_strip", slow_write_strip)
    dbm.predict_continent(nchw, BOUNDS, outfilepath=str(tmp_path / "dem"),
                          stream_product=True, prefetch=2, rows_per_strip=0, **KW)
    assert len(written) == PLAN.grid[0]
    np.testing.assert_array_equal(np.concatenate(written), canvas)


@pytest.mark.card
def test_a_bands_upload_and_dispatch_do_not_synchronise(dbm, card):
    host = {k: v.transpose(0, 2, 3, 1) for k, v in _inputs_nchw(True).items()}
    dispatch, fetch = continent._make_band_pipeline(dbm.forward_fn(), PLAN, True, "scan", 2,
                                                    card, 2)
    fetch(dispatch(host, 0))  # first calls: kernels loaded, buffers allocated
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [dispatch(host, band) for band in range(PLAN.grid[0])]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    strips = [fetch(p) for p in pending]
    want = [fetch(dispatch(host, band)) for band in range(PLAN.grid[0])]
    for got, w in zip(strips, want):
        np.testing.assert_array_equal(got, w)

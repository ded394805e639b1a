"""PyTorch port: the telemetry registry (``utils.profiling``) and its spans at
the layer boundaries, on the CPU at a tiny size: nothing recorded and no
profiler range entered with the switch off, the spans' parents and roots,
the band loop's counts, the leaf spans as profiler ranges (and no enclosing
one), the Chrome export, ``--telemetry`` and threads."""

import json
import threading

import numpy as np
import pytest
import torch

from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.cli import main
from deepbedmap_tpu_torch.config import DiscriminatorConfig, GeneratorConfig, TrainConfig
from deepbedmap_tpu_torch.data.dataset import TileDataset
from deepbedmap_tpu_torch.data.raster import Raster
from deepbedmap_tpu_torch.data.tiler import selective_tile
from deepbedmap_tpu_torch.inference.engine import INPUT_RATIOS, TilePlan
from deepbedmap_tpu_torch.models.discriminator import Discriminator
from deepbedmap_tpu_torch.models.generator import Generator
from deepbedmap_tpu_torch.train.loop import make_epoch_fns
from deepbedmap_tpu_torch.train.state import GANState, make_optimizer
from deepbedmap_tpu_torch.utils import profiling

RES = 250.0
BOUNDS = (0.0, 0.0, 96 * RES, 64 * RES)  # 2 bands x 3 tiles of 32 px
CONTINENT = dict(tile_out=32, halo_lr=3, tiles_per_dispatch=2)
WINDOW = (1000.0, 1000.0, 9000.0, 9000.0)
ROOTS = ("continent.pass", "predict", "predict.inputs", "train.step")
LEAVES = ("continent.slice", "continent.upload", "continent.dispatch", "continent.fetch",
          "continent.consume", "tiler.cut", "tiler.upload", "tiler.sample",
          "tiler.nan_check", "predict.forward", "predict.fetch", "train.take",
          "train.d_update", "train.g_update")


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
def clean_registry():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def dbm():
    return DeepBedMap(cfg=GeneratorConfig(num_residual_blocks=1, init_scale=1.0),
                      device="cpu")


def _inputs_nchw(lh=16, lw=24, seed=0):
    rs = np.random.RandomState(seed)
    return {"X": rs.rand(1, 1, lh, lw).astype(np.float32),
            "W1": (rs.rand(1, 1, 10 * lh, 10 * lw) - 0.2).astype(np.float32),
            "W2": (rs.rand(1, 2, 2 * lh, 2 * lw) - 0.2).astype(np.float32),
            "W3": rs.rand(1, 1, lh, lw).astype(np.float32)}


def _rasters(seed=0):
    """The five sources over a 40 km square, NaN voids in the surface (which
    has no gap filler) and in one velocity."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, (n, res) in {"bed_lowres": (40, 1000.0), "surface": (400, 100.0),
                           "velocity_x": (90, 450.0), "velocity_y": (90, 450.0),
                           "accumulation": (40, 1000.0)}.items():
        data = (rs.rand(n, n) - 0.3).astype(np.float32)
        if name in ("surface", "velocity_x"):
            data[rs.rand(n, n) < 0.03] = np.nan
        out[name] = Raster(data, left=-5000.0, top=35000.0, res=res)
    return out


@pytest.fixture(scope="module")
def trainer():
    """A train-epoch function and a state: one RRDB, batch 2, on the CPU."""
    dataset = TileDataset.synthetic(4, seed=0, device="cpu")
    t_cfg = TrainConfig(batch_size=2)
    g = Generator(GeneratorConfig(num_residual_blocks=1))
    d = Discriminator(DiscriminatorConfig())
    state = GANState(step=0, g=g, g_opt=make_optimizer(t_cfg, g.parameters()),
                     d=d, d_opt=make_optimizer(t_cfg, d.parameters()))
    train_fn, _ = make_epoch_fns(dataset, t_cfg)
    return train_fn, state


def _drive(dbm, trainer, steps=1):
    """A tiny continent pass, one region request and ``steps`` train steps."""
    dbm.predict_continent(_inputs_nchw(), BOUNDS, **CONTINENT)
    dbm.predict(WINDOW, _rasters())
    train_fn, state = trainer
    train_fn(state, np.arange(2 * steps).reshape(steps, 2))


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_switch_off_records_nothing_and_touches_no_clock_lock_or_range(
        dbm, trainer, monkeypatch):
    calls = {"clock": 0, "range": 0, "lock": 0}
    clock, range_ = profiling._clock, torch.profiler.record_function

    def counting_clock():
        calls["clock"] += 1
        return clock()

    def counting_range(*a, **kw):
        calls["range"] += 1
        return range_(*a, **kw)

    class CountingLock:
        def __enter__(self):
            calls["lock"] += 1

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "_clock", counting_clock)
    monkeypatch.setattr(torch.profiler, "record_function", counting_range)
    monkeypatch.setattr(profiling._registry, "lock", CountingLock())
    assert not profiling.recording()
    _drive(dbm, trainer)
    assert calls == {"clock": 0, "range": 0, "lock": 0}
    monkeypatch.undo()
    assert profiling.snapshot() == {"spans": {}, "counters": {}, "dropped": 0}


def test_recording_follows_the_switch_and_the_profiler():
    assert not profiling.recording()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
    assert not profiling.recording()
    profiling.enable()
    assert profiling.recording()


def test_spans_have_their_parents_and_share_their_roots(dbm, trainer, tmp_path):
    profiling.enable()
    _drive(dbm, trainer, steps=2)
    path = str(tmp_path / "t.json")
    profiling.export(path)
    spans = [e for e in _events(path) if e.get("cat") == "span"]
    by_id = {e["args"]["id"]: e for e in spans}
    roots = {n: [e for e in spans if e["name"] == n] for n in ROOTS}
    assert [len(roots[n]) for n in ROOTS] == [1, 1, 1, 2]
    for e in spans:
        parent = by_id.get(e["args"]["parent"])
        top = e if parent is None else by_id[e["args"]["root"]]
        assert top["args"]["parent"] is None
        want = {"continent": "continent.pass", "tiler": "predict.inputs",
                "predict": "predict", "train": "train.step"}[e["name"].split(".")[0]]
        if e["name"] in ROOTS[:2] or e["name"] == "train.step":
            assert parent is None and e["args"]["root"] == e["args"]["id"]
        elif e["name"] == "train.epoch_metrics":
            continue
        else:
            assert parent["name"] == want
            assert top["name"] == ("predict" if want == "predict.inputs" else want)
            assert top["ts"] <= e["ts"] and e["ts"] + e["dur"] <= top["ts"] + top["dur"]
    # the two steps keep their own roots
    step_ids = {e["args"]["id"] for e in roots["train.step"]}
    assert {e["args"]["root"] for e in spans if e["name"] == "train.g_update"} == step_ids
    snap = profiling.snapshot()["spans"]
    for name in LEAVES + ROOTS:
        assert snap[name]["calls"] >= 1, name
        assert 0 <= snap[name]["self_ms"] <= snap[name]["total_ms"], name
    assert snap["predict.inputs"]["self_ms"] < snap["predict.inputs"]["total_ms"]
    assert snap["train.take"]["calls"] == snap["train.d_update"]["calls"] == 2


def test_band_loop_counts_the_plans_tiles_and_every_byte_as_pageable(dbm):
    profiling.enable()
    dbm.predict_continent(_inputs_nchw(), BOUNDS, **CONTINENT)
    plan = TilePlan(out_h=64, out_w=96, tile_out=32, halo_lr=3)
    gy, gx = plan.grid
    # only the rows that exist are sent: each of the two bands loses its
    # halo beyond the region's edge, which the device replicates
    rows_lr = plan.tile_lr + plan.pad_lr
    channels = {"X": 1, "W1": 1, "W2": 2, "W3": 1}
    band_bytes = sum(4 * rows_lr * r * plan.lr_shape[1] * r * channels[k]
                     for k, r in INPUT_RATIOS.items())
    snap = profiling.snapshot()
    # on the CPU every band's four rasters and its strip are plain copies
    assert snap["counters"] == {"continent.tiles": gy * gx, "continent.bands": gy,
                                "continent.upload_bytes.pageable": gy * band_bytes,
                                "continent.copies.sync": 5 * gy}
    spans = snap["spans"]
    assert spans["continent.pass"]["calls"] == 1
    assert spans["continent.slice"]["calls"] == spans["continent.upload"]["calls"] == 4 * gy
    for name in ("continent.dispatch", "continent.fetch", "continent.consume"):
        assert spans[name]["calls"] == gy
    # the fused tail's device spans, on the host clock on the CPU: three
    # forwards of 2 tiles, two offset convs each
    forwards = gy * -(-gx // 2)
    assert spans["tail.deform64"]["calls"] == spans["tail.zproj"]["calls"] == forwards
    assert spans["tail.offset_convs"]["calls"] == 2 * forwards
    assert spans["tail.projection"]["device_ms"] > 0
    assert "total_ms" not in spans["tail.deform64"]


@pytest.mark.parametrize("gapfiller,checks", [(None, 1), (0.0, 0)])
def test_nan_check_only_without_a_gap_filler(gapfiller, checks):
    profiling.enable()
    raster = _rasters()["surface"]
    tiles = selective_tile(raster, [WINDOW], padding=1000.0, gapfiller=gapfiller,
                           device="cpu")
    spans = profiling.snapshot()["spans"]
    assert spans.get("tiler.nan_check", {}).get("calls", 0) == checks
    assert spans["tiler.cut"]["calls"] == spans["tiler.sample"]["calls"] == 1
    assert torch.isnan(tiles).any().item() == (gapfiller is None)
    # the grid's two coordinate vectors and the cut
    up = profiling.snapshot()["counters"]["tiler.upload_bytes"]
    assert up > 4 * tiles.shape[-1] * tiles.shape[-2] // 2


def test_region_request_has_one_nan_check_and_counts_itself(dbm):
    profiling.enable()
    for _ in range(2):
        dbm.predict(WINDOW, _rasters())
    snap = profiling.snapshot()
    assert snap["counters"]["predict.requests"] == 2
    spans = snap["spans"]
    # five sources a request; only the surface has no gap filler
    assert spans["tiler.upload"]["calls"] == 10
    assert spans["tiler.nan_check"]["calls"] == 2
    assert spans["predict.inputs"]["total_ms"] >= spans["tiler.sample"]["total_ms"]


def test_the_profiler_sees_the_leaves_and_no_enclosing_span(dbm, trainer, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _drive(dbm, trainer)
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    ranges = {e["name"] for e in _events(path) if e.get("cat") == "user_annotation"}
    assert set(LEAVES) <= ranges
    assert not ranges & set(ROOTS)
    assert not {n for n in ranges if n.startswith("tail.")}
    # the registry recorded the profiled slice with the switch off
    assert profiling.snapshot()["spans"]["continent.pass"]["calls"] == 1


def test_export_writes_a_chrome_trace(dbm, tmp_path):
    profiling.enable()
    dbm.predict_continent(_inputs_nchw(), BOUNDS, **CONTINENT)
    path = tmp_path / "t.json"
    profiling.export(str(path))
    events = _events(path)
    kinds = {e["ph"] for e in events}
    assert kinds == {"M", "X", "C"}
    for e in events:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and isinstance(e["ts"], float) and isinstance(e["tid"], int)
    devices = [e for e in events if e.get("cat") == "device"]
    assert devices and all(e["tid"] == 0 and e["name"].startswith("tail.") for e in devices)
    counts = [e for e in events if e["ph"] == "C" and e["name"] == "continent.tiles"]
    assert counts[-1]["args"] == {"continent.tiles": 6}


def test_records_stop_at_the_cap_and_the_aggregates_go_on(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    profiling.enable()
    for _ in range(5):
        with profiling.span("outer", range=False, tiles=2):
            with profiling.span("inner"):
                pass
    snap = profiling.snapshot()
    assert snap["spans"]["outer"]["calls"] == snap["spans"]["inner"]["calls"] == 5
    assert snap["spans"]["outer"]["tiles"] == 10
    assert snap["dropped"] == 7
    assert len(profiling._registry.records) == 3


def test_cli_telemetry_writes_the_trace_and_the_summary(tmp_path, capsys):
    path = str(tmp_path / "run.json")
    rc = main(["--telemetry", path, "train", "--synthetic-tiles", "4", "--epochs", "1",
               "--blocks", "1", "--batch-size", "2", "--device", "cpu"])
    capsys.readouterr()
    assert rc == 0
    names = {e["name"] for e in _events(path) if e["ph"] == "X"}
    assert {"train.step", "train.take", "train.d_update", "train.g_update",
            "train.eval_step", "train.epoch_metrics"} <= names
    with open(path + ".summary.json") as f:
        summary = json.load(f)
    assert summary["counters"]["train.steps"] >= 1
    assert summary["spans"]["train.g_update"]["total_ms"] > 0


def test_two_threads_keep_their_requests_apart():
    profiling.enable()
    barrier = threading.Barrier(2, timeout=30)
    seen = {}

    def request(name):
        with profiling.span("request", range=False) as root:
            barrier.wait()
            with profiling.span("work") as leaf:
                barrier.wait()
            seen[name] = (root.id, leaf.root, leaf.parent.id)

    threads = [threading.Thread(target=request, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    (ra, la, pa), (rb, lb, pb) = seen["a"], seen["b"]
    assert ra != rb and (la, pa) == (ra, ra) and (lb, pb) == (rb, rb)
    assert profiling.snapshot()["spans"]["work"]["calls"] == 2

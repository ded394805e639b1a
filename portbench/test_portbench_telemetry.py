"""The readers of the program's own spans and counters on a synthetic
`snapshot()`, and without the registry, the span or the counter; on the
card, one continent pass whose longest idle gap a program span names."""

import sys

import pytest

from portbench import harness, tracing

SPANS = {
    "continent.slice": {"calls": 12, "total_ms": 66.0, "self_ms": 66.0},
    "continent.upload": {"calls": 12, "total_ms": 132.0, "self_ms": 132.0},
    "continent.fetch": {"calls": 3, "total_ms": 330.0, "self_ms": 330.0},
    "tail.offset_convs": {"calls": 66, "device_ms": 165.0},
    "tail.deform64": {"calls": 33, "device_ms": 99.0},
    "predict.inputs": {"calls": 50, "total_ms": 500.0, "self_ms": 20.0},
    "train.g_update": {"calls": 5, "total_ms": 400.0, "self_ms": 400.0},
    "train.d_update": {"calls": 5, "total_ms": 150.0, "self_ms": 150.0},
}
COUNTERS = {"continent.tiles": 66, "continent.upload_bytes.pageable": 228,
            "continent.upload_bytes.pinned": 102, "predict.requests": 50,
            "train.steps": 5}
EXPECT = {
    "band_slice_ms_per_tile.continent": 1.0,
    "band_upload_ms_per_tile.continent": 2.0,
    "fetch_wait_ms_per_tile.continent": 5.0,
    "pageable_upload_share.continent": 100.0 * 228 / 330,
    "tail_offset_convs_ms.continent": 5.0,
    "inputs_ms.region": 10.0,
    "g_update_ms.train": 80.0,
    "d_update_ms.train": 30.0,
}
# what each reader needs: (span, counter) left out one at a time
NEEDS = {
    "band_slice_ms_per_tile.continent": ("continent.slice", "continent.tiles"),
    "band_upload_ms_per_tile.continent": ("continent.upload", "continent.tiles"),
    "fetch_wait_ms_per_tile.continent": ("continent.fetch", "continent.tiles"),
    "pageable_upload_share.continent": (None, "continent.upload_bytes.*"),
    "tail_offset_convs_ms.continent": ("tail.offset_convs", "tail.deform64"),
    "inputs_ms.region": ("predict.inputs", "predict.requests"),
    "g_update_ms.train": ("train.g_update", "train.steps"),
    "d_update_ms.train": ("train.d_update", "train.steps"),
}


def reader(name):
    return harness._load_module(harness.HERE / "metrics" / f"{name}.py",
                                "portbench_metric_" + name.replace(".", "_"))


@pytest.fixture
def registry(monkeypatch):
    """The program's registry answering with a copy of ``state``."""
    from deepbedmap_tpu_torch.utils import profiling

    state = {"spans": {k: dict(v) for k, v in SPANS.items()}, "counters": dict(COUNTERS),
             "dropped": 0}
    monkeypatch.setattr(profiling, "snapshot", lambda: state)
    return state


def test_every_new_metric_is_declared_with_its_cells():
    import json

    spec = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in EXPECT:
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"]
        for cell in m["workloads"]:
            assert name in [x["name"] for x in harness.load_cell(harness.HERE.parent,
                                                                 cell).per_layer]


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_on_a_synthetic_snapshot(name, registry):
    assert reader(name).read({}) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_without_its_span_or_counter(name, registry):
    span, counter = NEEDS[name]
    if span is not None:
        saved = registry["spans"].pop(span)
        assert reader(name).read({}) is None
        registry["spans"][span] = saved
    if counter.endswith("*"):
        for k in [k for k in registry["counters"] if k.startswith(counter[:-1])]:
            del registry["counters"][k]
    elif counter in registry["counters"]:
        del registry["counters"][counter]
    else:
        del registry["spans"][counter]
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_without_the_registry(name, registry, monkeypatch):
    import deepbedmap_tpu_torch.utils as utils
    from deepbedmap_tpu_torch.utils import profiling

    # a program without the module
    with monkeypatch.context() as m:
        m.delattr(utils, "profiling")
        m.setitem(sys.modules, "deepbedmap_tpu_torch.utils.profiling", None)
        assert reader(name).read({}) is None
    assert reader(name).read({}) is not None
    # a program that has the module but no registry in it, as older versions
    monkeypatch.delattr(profiling, "snapshot")
    assert reader(name).read({}) is None


@pytest.mark.card
def test_a_continent_pass_has_its_idle_gaps_named_by_the_band_loop(card):
    from deepbedmap_tpu_torch.utils import profiling

    cell = harness.load_cell(harness.HERE.parent, "continent_fp32")
    cell.seed = 2**31 + 77
    run = harness.load_driver(cell).Run(cell)
    run.setup()
    profiling.reset()
    summary = tracing.profile(run._pass)
    name, seconds = summary["idle_gaps"][0]
    print("longest idle gaps:", summary["idle_gaps"][:5])
    assert name.startswith("continent."), (name, seconds)
    for metric in ("band_slice_ms_per_tile.continent", "band_upload_ms_per_tile.continent",
                   "fetch_wait_ms_per_tile.continent", "pageable_upload_share.continent",
                   "tail_offset_convs_ms.continent"):
        assert reader(metric).read({}) > 0, metric
    run.release()

"""The trace arithmetic on a synthetic Chrome trace: the union of device
intervals, the idle gaps and the host operator that spans each."""

import pytest

from portbench import tracing


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    # host: an outer operator spanning the first gap, an inner one inside it
    ev("cpu_op", "aten::to", 0.0, 400.0),
    ev("cpu_op", "aten::copy_", 110.0, 50.0),
    ev("cpu_op", "aten::cat", 390.0, 300.0),
    ev("cuda_runtime", "cudaLaunchKernel", 100.0, 900.0),  # not a host operator
    # device: [0, 100] and [50, 120] overlap; gaps 120..200, 300..700, 750..800
    ev("kernel", "k1", 0.0, 100.0),
    ev("kernel", "k2", 50.0, 70.0),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200.0, 100.0),
    ev("kernel", "k1", 700.0, 50.0),
    ev("gpu_memset", "Memset (Device)", 800.0, 200.0),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5000.0},  # not an interval
]


def test_summarize_union_gaps_and_host_operators():
    s = tracing.summarize(EVENTS)
    busy = 120.0 + 100.0 + 50.0 + 200.0
    assert s["window_s"] == pytest.approx(1000.0 / 1e6)
    assert s["busy_s"] == pytest.approx(busy / 1e6)
    assert s["idle_share"] == pytest.approx(1 - busy / 1000.0)
    assert s["htod_s"] == pytest.approx(100.0 / 1e6)
    assert s["device_ops"][0] == ["Memset (Device)", pytest.approx(200e-6)]
    assert dict((n, t) for n, t in s["device_ops"])["k1"] == pytest.approx(150e-6)
    # longest first: 300..700 overlaps aten::to and aten::cat, spanned by
    # neither: the larger overlap (aten::cat, 300 of 400 us) names it
    assert s["idle_gaps"] == [["aten::cat", pytest.approx(400e-6)],
                              ["aten::to", pytest.approx(80e-6)],
                              ["no host operator", pytest.approx(50e-6)]]


def test_summarize_needs_a_device_event():
    with pytest.raises(RuntimeError):
        tracing.summarize([ev("cpu_op", "aten::add", 0.0, 10.0)])

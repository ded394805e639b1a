"""The harness finds a configuration, a traffic mix, a limit and a metric
that a later change adds as new files, and refuses JAX by whole names."""

import json
import shutil

import pytest

from portbench import harness

ROOT = harness.HERE.parent


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark with one more cell made of new files only."""
    bench = tmp_path / "portbench"
    shutil.copytree(harness.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "deepbedmap_fp32.json").read_text())
    config.update(name="deepbedmap_new", program={"upsample_phase_conv": True})
    (bench / "configs" / "deepbedmap_new.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "continent_band3.json").read_text())
    (bench / "traffic" / "continent_band1.json").write_text(json.dumps(dict(traffic, bands=1)))
    (bench / "limits" / "new_cell.json").write_text(json.dumps({"tile_gap": {"limit": 0.5}}))
    (bench / "metrics" / "answer.new.py").write_text("def read(ctx):\n    return 42\n")
    (bench / "metrics" / "silent.new.py").write_text("def read(ctx):\n    return None\n")
    spec["configs"].append({"name": "deepbedmap_new", "source": "x", "reduced": [],
                            "file": "portbench/configs/deepbedmap_new.json", "why": "x"})
    spec["workloads"].append({"name": "new_cell", "config": "deepbedmap_new",
                              "traffic": "continent_band1", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("new_cell")
    for name in ("answer.new", "silent.new"):
        spec["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "device",
                                  "moves": "continent_tiles_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_new_files_are_found_by_name(tree):
    cell = harness.load_cell(tree, "new_cell", tree / "portbench")
    assert cell.config["program"] == {"upsample_phase_conv": True}
    assert cell.traffic["bands"] == 1
    assert cell.limits == {"tile_gap": {"limit": 0.5}}
    assert [m["name"] for m in cell.end_to_end] == ["continent_tiles_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert "answer.new" in names and "silent.new" in names
    assert "mfu.continent" not in names  # it lists its cells
    assert harness.load_driver(cell, tree / "portbench").Run
    cell.per_layer = [m for m in cell.per_layer if m["name"].endswith(".new")]
    got = harness.read_layer_metrics(cell, {}, tree / "portbench")
    assert got == {"answer.new": {"value": 42.0, "unit": "%"}}
    # a metric without a `workloads` key reaches every cell reporting its metric
    old = harness.load_cell(tree, "continent_fp32", tree / "portbench")
    assert "answer.new" in [m["name"] for m in old.per_layer]


def test_every_cell_of_the_benchmark_loads():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell.limits, f"{w['name']} has no limits"
        assert harness.load_driver(cell).Run
        for m in cell.per_layer:
            assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_forbidden_modules_compares_whole_top_level_names():
    modules = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1, "deepbedmap_tpu": 1,
               "deepbedmap_tpu.ops.rdb": 1, "deepbedmap_tpu_torch": 1,
               "deepbedmap_tpu_torch.ops": 1, "jaxtyping": 1, "flaxen": 1, "torch": 1}
    assert harness.forbidden_modules(modules) == [
        "deepbedmap_tpu", "deepbedmap_tpu.ops.rdb", "flax", "jax", "jax.numpy", "jaxlib.xla"]


def test_judge_fails_a_number_over_or_without_its_limit():
    cell = harness.Cell("c", 1, {}, {}, {"a": {"limit": 1.0}, "b": {"limit": 1.0}}, [], [])
    got = harness.judge(cell, {"a": 0.5, "b": 2.0, "c": 0.0, "d": float("nan")})
    assert [c["ok"] for c in got] == [True, False, False, False]

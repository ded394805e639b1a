"""The training and single-region cells driven on the CPU at a tiny size:
a sound run is correct; each fault the cell can have, planted under the
timed path, and the control in the program's place are not."""

import copy
import json

import numpy as np
import pytest

from portbench import harness


def _read(*parts):
    return json.loads(harness.HERE.joinpath(*parts).read_text())


def _cell(workload, config, traffic, **updates):
    """The cell's files at a tiny size, on the CPU."""
    cell = harness.Cell(workload, 1, _read("configs", f"{config}.json"),
                        _read("traffic", f"{traffic}.json"),
                        _read("limits", f"{workload}.json"), [], [],
                        seed=2**31 + 501, device="cpu")
    cell.config["generator"]["num_residual_blocks"] = 1
    cell.traffic.update(updates)
    return cell


def _train_cell():
    cell = _cell("train_fp32", "deepbedmap_fp32", "train_b128", tiles=160)
    cell.config["train"]["batch_size"] = 8
    return cell


def _region_cell():
    return _cell("region_fp32", "deepbedmap_fp32", "region_closed", domain_km=40,
                 sides_km=[8, 16], check_within=6, check_requests=2)


def _readings(cell, seconds=0.0):
    run = harness.load_driver(cell).Run(cell)
    run.setup()
    run.window(seconds)
    run.release()
    return run


def _correct(run):
    return all(c["ok"] for c in harness.judge(run.cell, run.check()))


def _broken_step(monkeypatch, fault):
    from deepbedmap_tpu_torch.train import loop

    make = loop.make_train_step

    def make_broken(*args, **kw):
        step = make(*args, **kw)

        def broken(state, batch):
            if fault == "unchanged":
                return state, step(copy.deepcopy(state), batch)[1]
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)

        return broken

    monkeypatch.setattr(loop, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_train_cell_fails_each_fault(fault, monkeypatch):
    if fault:
        _broken_step(monkeypatch, fault)
    assert _correct(_readings(_train_cell())) == (fault is None)


def test_train_cell_control_in_the_programs_place_is_not_correct():
    run = _readings(_train_cell())
    run.readings = run.follow("tf32")
    assert not _correct(run)


def test_region_cell_sound_then_an_altered_answer(monkeypatch):
    assert _correct(_readings(_region_cell(), 0.5))
    from deepbedmap_tpu_torch import DeepBedMap

    forward_fn = DeepBedMap.forward_fn

    def altered(self):
        fwd = forward_fn(self)

        def run(*xs):
            out = fwd(*xs).clone()
            out[:, out.shape[1] // 2, out.shape[2] // 2] += 0.01 * float(out.max() - out.min())
            return out

        return run

    monkeypatch.setattr(DeepBedMap, "forward_fn", altered)
    assert not _correct(_readings(_region_cell(), 0.5))


def test_region_cell_control_in_the_programs_place_is_not_correct():
    run = _readings(_region_cell(), 0.5)
    run.kept = {i: run.reference_dem(run.requests[i], lower=True).numpy() for i in run.kept}
    assert not _correct(run)


def test_region_requests_repeat_their_sizes_for_every_seed():
    sizes = []
    for seed in (1, 2**31 + 7):
        cell = _region_cell()
        cell.seed = seed
        run = harness.load_driver(cell).Run(cell)
        reqs = run._windows(np.random.default_rng(seed), 2)
        sizes.append(sorted(w[2] - w[0] for w in reqs))
    assert sizes[0] == sizes[1]

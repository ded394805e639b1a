"""The plain reference against the program's plain path (the port's CPU
forward) at a tiny size, its control one precision step down, and a run of
the continent cells on the CPU with the timed path sound and broken."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import generator as reference
from portbench.weights import generator_weights

WEIGHTS = {"scale": 1.0, "offset_scale": 0.001, "bias_std": 1.0}


def _inputs(lr, seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"X": (1, 1, lr, lr), "W1": (1, 1, 10 * lr, 10 * lr), "W2": (1, 2, 2 * lr, 2 * lr),
              "W3": (1, 1, lr, lr)}
    return [torch.tensor(rs.uniform(0, 500, s), dtype=torch.float32) for s in shapes.values()]


def _program(p, blocks, **flags):
    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.models.generator import Generator

    g = Generator(GeneratorConfig(num_residual_blocks=blocks, **flags))
    g.load_state_dict(p)
    return g.eval()


@pytest.mark.parametrize("flags, trunk", [({}, "fp32"), ({"rdb_resident": "always"}, "bf16"),
                                          ({"rdb_resident": "never"}, "fp32")])
def test_reference_equals_the_programs_plain_path(flags, trunk):
    blocks, lr = 2, 12
    p = generator_weights(WEIGHTS, blocks, seed=3, device="cpu")
    xs = _inputs(lr)
    with torch.no_grad():
        got = _program(p, blocks, **flags)(*(a.permute(0, 2, 3, 1).contiguous() for a in xs))
        want = reference.generator(p, *xs, blocks=blocks, trunk_precision=trunk)
        lower = reference.generator(p, *xs, blocks=blocks,
                                    precision=reference.LOWER["fp32"],
                                    trunk_precision=reference.LOWER[trunk])
    got = got.permute(0, 3, 1, 2)
    assert got.shape == want.shape == (1, 1, 4 * (lr - 2), 4 * (lr - 2))
    gap, control = reference.widest_gap(got, want), reference.widest_gap(lower, want)
    # fp32 rounding alone; a bf16 trunk also flips roundings at bf16 ties
    assert gap < (5e-4 if trunk == "bf16" else 2e-5)
    assert control > 10 * gap


def test_roundings():
    t = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -3.0, 0.0])
    assert reference.round_to(t, "tf32").tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-9, -3.0, 0.0]
    assert reference.round_to(t, "fp32") is t
    assert reference.round_to(t, "bf16")[0] == 1.0
    assert reference.round_to(torch.tensor([448.0, 1.0, 0.3]), "fp8").tolist() == \
        pytest.approx([448.0, 1.0, 0.3125])
    assert reference.widest_gap(torch.tensor([1.0, float("nan")]),
                                torch.tensor([1.0, 2.0])) == float("inf")


def _tiny_cell(workload):
    cell = harness.load_cell(harness.HERE.parent, workload)
    cell.device, cell.seed = "cpu", 2**31 + 77
    cell.config["generator"]["num_residual_blocks"] = 2
    cell.traffic.update(tile_out=40, halo_lr=2, tiles_per_band=3)
    return cell


def _correct(cell):
    run = harness.load_driver(cell).Run(cell)
    run.setup()
    run.window(0.0)
    run.release()
    return all(c["ok"] for c in harness.judge(cell, run.check()))


@pytest.mark.parametrize("workload", ["continent_fp32", "continent_bf16mxu"])
def test_a_sound_run_is_correct_and_an_altered_answer_is_not(workload, monkeypatch):
    assert _correct(_tiny_cell(workload))
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
    assert not _correct(_tiny_cell(workload))


@pytest.mark.parametrize("workload", ["continent_fp32", "continent_bf16mxu"])
def test_the_control_in_the_programs_place_is_not_correct(workload, monkeypatch):
    """The reference one precision step below the configuration's, put in
    the program's place, fails the cell's limit."""
    cell = _tiny_cell(workload)
    run = harness.load_driver(cell).Run(cell)
    run.setup()
    run.window(0.0)
    run.release()
    run.saved = [(pos, run.reference_tile(*pos, lower=True).numpy()) for pos, _ in run.saved]
    assert not all(c["ok"] for c in harness.judge(cell, run.check()))


@pytest.mark.card
def test_the_card_path_is_correct_at_a_small_size(card):
    cell = _tiny_cell("continent_fp32")
    cell.device = "cuda"
    cell.traffic.update(tile_out=200, halo_lr=18)
    assert _correct(cell)

"""The HAT continent cell: driven on the CPU at a tiny size (embed 12, 2
heads, window 4 with keys of 6, 2 x 2 HABs and their OCABs, 40-px tiles
whose 14-px latent pads to 16), a sound run is correct; each fault planted
under the timed path (the relative-position biases, the shifted windows'
mask or the shift dropped, the CAB branch left out, the OCAB's zero-padded
keys left out of the softmax), the attention's products in TF32 and the
control in the program's place are not. The cell's files are found by name,
the counts equal the program's, and the reference's copy is the repo's."""

import json

import pytest
import torch

from portbench import harness
from portbench.counts import hat as counts
from portbench.counts import peaks

WORKLOAD = "continent_hat_fp32"
TINY = dict(embed_dim=12, depths=[2, 2], num_heads=[2, 2], window_size=4, compress_ratio=3,
            squeeze_factor=4)
FAULTS = ["bias", "mask", "shift", "cab", "oca_pad"]


def _tiny_cell():
    cell = harness.load_cell(harness.HERE.parent, WORKLOAD)
    cell.device, cell.seed = "cpu", 2**31 + 79
    cell.config["generator"].update(TINY)
    cell.traffic.update(tile_out=40, halo_lr=2, tiles_per_band=3)
    return cell


def _run(cell):
    run = harness.load_driver(cell).Run(cell)
    run.setup()
    run.window(0.0)
    run.release()
    return run


def _correct(run):
    return all(c["ok"] for c in harness.judge(run.cell, run.check()))


def _plant(monkeypatch, fault):
    """The reference's fault of that name, in the program's place: the
    program's model runs the plain reference with the fault planted."""
    from portbench.reference import hat as reference

    def forward(self, x, w1, w2, w3):
        nchw = [a.permute(0, 3, 1, 2) for a in (x, w1, w2, w3)]
        out = reference.hat(self.state_dict(), *nchw, cfg=vars(self.cfg), drop=(fault,))
        return out.permute(0, 2, 3, 1)

    from deepbedmap_tpu_torch.models import hat

    monkeypatch.setattr(hat.HAT, "forward", forward)


@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_a_sound_run_is_correct_and_each_fault_is_not(fault, monkeypatch):
    if fault:
        _plant(monkeypatch, fault)
    assert _correct(_run(_tiny_cell())) == (fault is None)


@pytest.mark.parametrize("in_place", [{"lower": True}, {"attn_precision": "tf32"}],
                         ids=["control", "attention_in_tf32"])
def test_the_reference_at_lower_precision_in_the_programs_place_is_not_correct(in_place):
    run = _run(_tiny_cell())
    run.saved = [(pos, run.reference_tile(*pos, **in_place).numpy()) for pos, _ in run.saved]
    assert not _correct(run)


def test_the_calibration_reads_every_fault():
    run = _run(_tiny_cell())
    got = run.check(control=True)
    assert got["tile_gap_share"] < 0.01
    for name in FAULTS + ["attn_tf32"]:
        assert got[f"fault_{name}_tile_gap_share"] > 0.01, name


def test_the_cell_loads_with_its_files():
    cell = harness.load_cell(harness.HERE.parent, WORKLOAD)
    assert cell.chips == 1 and cell.traffic["driver"] == "continent_hat"
    assert cell.config["reduced"] == [] and cell.limits["tile_gap_share"]["limit"] > 0
    assert [m["name"] for m in cell.end_to_end] == ["continent_tiles_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names == ["mfu.continent_hat", "window_msa_roofline.continent_hat",
                     "oca_roofline.continent_hat", "cab_ms.continent_hat",
                     "device_idle_share.continent_hat", "window_attn_ms.continent_hat",
                     "swin_mlp_ms.continent_hat"]
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    config = {c["name"]: c for c in bench["configs"]}["hat_x4_fp32"]
    assert config["reduced"] == [] and len(config["source"]) <= 200
    assert len(cell.config["source"]) <= 200
    # the published widths, and the traffic of continent_band3 with its driver
    assert cell.config["generator"] == dict(
        embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16, compress_ratio=3,
        squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5)
    band3 = json.loads((harness.HERE / "traffic" / "continent_band3.json").read_text())
    assert {**cell.traffic, "driver": "continent"} == band3


def test_the_reference_copy_is_the_repos():
    ours = (harness.HERE / "reference" / "hat.py").read_bytes()
    assert ours == (harness.HERE.parent / "reference" / "hat.py").read_bytes()


@pytest.mark.parametrize("lr, cfg", [(288, {}), (252, {}), (16, TINY)])
def test_hat_counts_match_the_programs(lr, cfg):
    from deepbedmap_tpu_torch.config import HATConfig
    from deepbedmap_tpu_torch.utils import flops

    assert counts.hat_tile_flops(cfg, lr) == flops.hat_tile_flops(HATConfig(**cfg), lr)


def test_the_layer_bounds_are_set_by_operations():
    side = counts.padded_side(None, 288)
    assert side == 288
    msa, oca = counts.msa_layer(2, side, None), counts.oca_layer(2, side, None)
    assert msa["by"] == oca["by"] == "operations"
    tile = counts.hat_tile_flops(None, 288)
    peak = peaks.TENSOR_CORE_FLOPS["tf32"]
    assert 36 * msa["s"] == pytest.approx(2 * (tile["msa_linears"] + tile["window_attention"])
                                          / peak)
    assert 6 * oca["s"] == pytest.approx(2 * (tile["oca_linears"] + tile["overlap_attention"])
                                         / peak)
    assert msa["s"] == pytest.approx(0.149e-3, rel=0.01)  # a call at (2, 288, 288, 180)
    assert oca["s"] == pytest.approx(0.226e-3, rel=0.01)

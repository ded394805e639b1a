"""The SwinIR continent cell: driven on the CPU at a tiny size (embed 12, 2
heads, window 4, 2 x 2 Swin layers, 40-px tiles whose 14-px latent pads to
16), a sound run is correct; each fault planted under the timed path (the
relative-position bias, the shifted windows' mask or the shift dropped),
the attention's products in TF32 and the control in the program's place are
not. The counts against the program's, and the window kernel against its
plain version on the card at the cell's shapes."""

import json

import pytest
import torch

from portbench import harness
from portbench.counts import peaks
from portbench.counts import swinir as counts

WORKLOAD = "continent_swinir_fp32"
TINY = dict(embed_dim=12, depths=[2, 2], num_heads=[2, 2], window_size=4)


def _tiny_cell():
    cell = harness.load_cell(harness.HERE.parent, WORKLOAD)
    cell.device, cell.seed = "cpu", 2**31 + 77
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
    from deepbedmap_tpu_torch.models import swinir
    from deepbedmap_tpu_torch.ops import window_attn

    attention = swinir.window_attention

    def faulty(qkv, table, heads, window, shift):
        return attention(qkv, torch.zeros_like(table) if fault == "bias" else table, heads,
                         window, 0 if fault == "shift" else shift)

    monkeypatch.setattr(swinir, "window_attention", faulty)
    if fault == "mask":
        monkeypatch.setattr(window_attn, "shift_mask",
                            lambda h, w, ws, s, device="cpu": torch.zeros(
                                (h // ws) * (w // ws), ws * ws, ws * ws, device=device))


@pytest.mark.parametrize("fault", [None, "bias", "mask", "shift"])
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


def test_the_cell_loads_with_its_files():
    cell = harness.load_cell(harness.HERE.parent, WORKLOAD)
    assert cell.chips == 1 and cell.traffic["driver"] == "continent_swinir"
    assert cell.config["reduced"] == [] and cell.limits["tile_gap_share"]["limit"] > 0
    assert [m["name"] for m in cell.end_to_end] == ["continent_tiles_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names == ["mfu.continent_swinir", "window_msa_roofline.continent_swinir",
                     "window_attn_ms.continent_swinir", "swin_mlp_ms.continent_swinir",
                     "device_idle_share.continent_swinir"]
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    config = {c["name"]: c for c in bench["configs"]}["swinir_m_x4_fp32"]
    assert config["reduced"] == []


@pytest.mark.parametrize("lr, cfg", [(288, {}), (252, {}), (16, TINY)])
def test_swinir_counts_match_the_programs(lr, cfg):
    from deepbedmap_tpu_torch.config import SwinIRConfig
    from deepbedmap_tpu_torch.utils import flops

    assert counts.swinir_tile_flops(cfg, lr) == flops.swinir_tile_flops(SwinIRConfig(**cfg), lr)


def test_the_msa_bound_is_set_by_operations():
    b = counts.msa_layer(2, counts.padded_side(None, 288), None)
    assert b["by"] == "operations"
    tile = counts.swinir_tile_flops(None, 288)
    flops = 2 * (tile["msa_linears"] + tile["window_attention"])  # 2 tiles
    assert 36 * b["s"] == pytest.approx(flops / peaks.TENSOR_CORE_FLOPS["tf32"])
    assert 36 * b["s"] == pytest.approx(3.69e-3, rel=0.01)  # ~3.7 ms a forward of 2 tiles


@pytest.mark.card
@pytest.mark.parametrize("shift", [0, 4])
def test_the_window_kernel_equals_its_plain_version_at_the_cells_shapes(card, shift):
    """At (2, 288, 288, 3 x 180), 6 heads: the kernel within 1e-5 of the
    largest output of the plain version in float64 (fp32 products of 30
    terms and a 64-term softmax: ~1e-7); the plain version on q, k and v
    rounded to TF32 lies outside it (~1e-4), so a TF32 kernel would fail."""
    from deepbedmap_tpu_torch.ops import _kernels, window_attn
    from portbench.reference.swinir import round_to

    g = torch.Generator(device=card).manual_seed(11)
    qkv = torch.randn(2, 288, 288, 540, generator=g, device=card)
    table = torch.randn(225, 6, generator=g, device=card)
    before = _kernels.launches["window_attn"]
    got = window_attn.window_attention(qkv, table, 6, 8, shift)
    torch.cuda.synchronize()
    assert _kernels.launches["window_attn"] == before + 1
    want = window_attn.window_attention_plain(qkv.double(), table.double(), 6, 8, shift)
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) < 1e-5 * scale
    tf32 = window_attn.window_attention_plain(round_to(qkv, "tf32").double(), table.double(),
                                              6, 8, shift)
    assert float((tf32 - want).abs().max()) > 1e-5 * scale

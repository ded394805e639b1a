"""The benchmark's copies of the operation counts against the program's
(`deepbedmap_tpu_torch/utils/flops.py`), and the layer bounds."""

import pytest

from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.utils import flops
from portbench.counts import layers, model, peaks


@pytest.mark.parametrize("lr, cfg", [(288, {}), (11, {}), (40, {"num_residual_blocks": 2,
                                                              "growth_channels": 16})])
def test_generator_counts_match_the_programs(lr, cfg):
    want = flops.generator_tile_flops(GeneratorConfig(**cfg), lr)
    assert model.generator_tile_flops(cfg, lr) == want


@pytest.mark.parametrize("batch, hr", [(128, 36), (16, 36)])
def test_train_step_counts_match_the_programs(batch, hr):
    assert model.discriminator_tile_flops(None, hr) == flops.discriminator_tile_flops(None, hr)
    assert model.train_step_flops(batch=batch, hr=hr) == flops.train_step_flops(batch=batch,
                                                                                 hr=hr)


@pytest.mark.parametrize("batch, side", [(2, 286), (1, 50)])
def test_trunk_bound_counts_the_generators_trunk(batch, side):
    stage = model.generator_tile_flops({}, side + 2)["trunk"]
    got = layers.trunk(batch, side, 12, 64, 32, "fp32")
    assert got["by"] == "operations"
    assert got["s"] == pytest.approx(batch * stage / peaks.TENSOR_CORE_FLOPS["tf32"])
    bf16 = layers.trunk(batch, side, 12, 64, 32, "bf16")
    assert bf16["s"] == pytest.approx(batch * stage / peaks.TENSOR_CORE_FLOPS["bf16"])


@pytest.mark.parametrize("batch, side", [(2, 1144), (1, 192)])
def test_tail_bound_counts_the_generators_tail(batch, side):
    stages = model.generator_tile_flops({}, side // 4 + 2)
    got = layers.tail(batch, side, 64)
    ops_s = batch * (stages["deform64"] + stages["deform1"]) / peaks.TENSOR_CORE_FLOPS["tf32"]
    assert got["s"] >= ops_s
    assert got["s"] == pytest.approx(max(ops_s, (batch * side * side * 65 * 4
                                                 + 4 * (2 * 18 * 577 + 9 * 64 * 65 + 65))
                                         / peaks.HBM_BYTES_PER_S))

"""PyTorch port: the utility surfaces against the JAX package on the CPU:
the analytic FLOP counts (``utils/flops.py``, whose H100 peaks are also
``chip_smoke.py``'s bound constants), the NCHW helpers of ``models/api.py``,
``MetricLogger`` (``utils/logging.py``) and the ``torch.profiler`` trace
(``utils/profiling.py``)."""

import csv
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.config import LossConfig as JaxLossConfig
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.models import generator_forward_nchw as jax_forward_nchw
from deepbedmap_tpu.utils import flops as jax_flops
from deepbedmap_tpu.utils.logging import MetricLogger as JaxMetricLogger
from deepbedmap_tpu_torch.bridge import jax_params_to_state_dict
from deepbedmap_tpu_torch.config import GeneratorConfig, LossConfig
from deepbedmap_tpu_torch.models import (
    Generator,
    example_inputs_nhwc,
    generator_forward_nchw,
    nchw_to_nhwc,
    nhwc_to_nchw,
)
from deepbedmap_tpu_torch.utils import flops
from deepbedmap_tpu_torch.utils.logging import MetricLogger
from deepbedmap_tpu_torch.utils.profiling import timed, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONFIGS = [
    {},  # the paper's generator
    dict(num_residual_blocks=3, base_channels=32, growth_channels=16),
    dict(upsample_phase_conv=True, inblock_channels=16),
]


@pytest.mark.parametrize("flags", CONFIGS)
@pytest.mark.parametrize("lr", [11, 288])
def test_flop_counts_equal_jax(flags, lr):
    """Exact: the same float arithmetic on the same configuration."""
    got = flops.generator_tile_flops(GeneratorConfig(**flags), lr)
    assert got == jax_flops.generator_tile_flops(JaxGeneratorConfig(**flags), lr)
    assert flops.discriminator_tile_flops(hr=4 * (lr - 2)) == \
        jax_flops.discriminator_tile_flops(hr=4 * (lr - 2))
    for adv in (False, True):
        assert flops.train_step_flops(
            GeneratorConfig(**flags), loss_cfg=LossConfig(differentiable_adversarial=adv),
            batch=16, lr=lr, hr=4 * (lr - 2)) == jax_flops.train_step_flops(
            JaxGeneratorConfig(**flags),
            loss_cfg=JaxLossConfig(differentiable_adversarial=adv),
            batch=16, lr=lr, hr=4 * (lr - 2))
    peak = flops.H100_TF32_TC_PEAK_FLOPS
    assert flops.generator_mfu(0.0123, GeneratorConfig(**flags), lr, peak) == \
        jax_flops.generator_mfu(0.0123, JaxGeneratorConfig(**flags), lr, peak)
    assert flops.train_step_mfu(0.38, batch=128, peak_flops=peak) == \
        jax_flops.train_step_mfu(0.38, batch=128, peak_flops=peak)


def test_peaks_are_the_h100s_and_chip_smoke_uses_them():
    """The H100 SXM's data-sheet peaks, in one place: ``chip_smoke.py``'s
    bound constants are the port's (imported, not restated), the ``*_mfu``
    default denominator is the bf16 tensor-core peak, and no TPU peak is
    left in the port."""
    import chip_smoke

    assert (flops.H100_BF16_TC_PEAK_FLOPS, flops.H100_TF32_TC_PEAK_FLOPS,
            flops.H100_FP32_PEAK_FLOPS, flops.H100_HBM_BYTES_PER_S) == \
        (989e12, 495e12, 67e12, 3.35e12)
    assert chip_smoke.PEAK_TF32_TC is flops.H100_TF32_TC_PEAK_FLOPS
    assert chip_smoke.PEAK_FP32_FLOPS is flops.H100_FP32_PEAK_FLOPS
    assert chip_smoke.PEAK_HBM_BYTES is flops.H100_HBM_BYTES_PER_S
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        source = f.read()
    for name in ("PEAK_TF32_TC", "PEAK_FP32_FLOPS", "PEAK_HBM_BYTES"):
        assert f"{name} = " not in source
    # one K1 call at the main-path shape, bounded as before the move
    b = chip_smoke.bound(2 * 2 * 286 * 286 * chip_smoke.RDB_MACS, 2 * 4 * 2 * 286 * 286 * 64)
    assert b["bound_by"] == "operations"
    np.testing.assert_allclose(b["bound_ms"], 0.4748, rtol=1e-3)
    m = flops.generator_mfu(0.1)
    assert m["mfu"] == flops.generator_tile_flops()["total"] / 0.1 / 989e12
    sources = glob.glob(os.path.join(ROOT, "deepbedmap_tpu_torch", "**", "*.py"),
                        recursive=True)
    for path in sources:
        with open(path) as f:
            text = f.read().lower()
        assert "v5e" not in text and "197e12" not in text, path


def test_nchw_helpers_and_example_inputs():
    a = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    assert nchw_to_nhwc(a).shape == (2, 4, 5, 3)
    assert torch.equal(nhwc_to_nchw(nchw_to_nhwc(a)), a)
    np.testing.assert_array_equal(nchw_to_nhwc(a).numpy(), a.numpy().transpose(0, 2, 3, 1))
    xs = example_inputs_nhwc(2, 11, device="cpu")
    assert [tuple(x.shape) for x in xs] == [(2, 11, 11, 1), (2, 110, 110, 1),
                                            (2, 22, 22, 2), (2, 11, 11, 1)]
    again = example_inputs_nhwc(2, 11, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(xs, again))
    assert all(float(x.min()) >= 0.0 and float(x.max()) < 1.0 for x in xs)


def test_example_inputs_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example_inputs_nhwc()


def test_generator_forward_nchw_matches_jax():
    """A 2-RRDB generator through the bridge, NCHW in and out, within the
    generator tolerance of ``tests/test_torch_port_generator.py``."""
    flags = dict(num_residual_blocks=2)
    lr = 11
    model, params = jax_build_generator(JaxGeneratorConfig(**flags, init_scale=1.0), lr=lr)
    rs = np.random.RandomState(7)
    xs = [rs.rand(1, 1, lr, lr), rs.rand(1, 1, 10 * lr, 10 * lr),
          rs.rand(1, 2, 2 * lr, 2 * lr), rs.rand(1, 1, lr, lr)]
    xs = [a.astype(np.float32) for a in xs]
    want = np.asarray(jax_forward_nchw(model, params, *map(jnp.asarray, xs)))
    port = Generator(GeneratorConfig(**flags))
    port.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        got = generator_forward_nchw(port, *map(torch.from_numpy, xs)).numpy()
    assert got.shape == want.shape == (1, 1, 4 * (lr - 2), 4 * (lr - 2))
    scale = np.abs(want).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def test_metric_logger_writes_what_jax_writes(tmp_path):
    records = [({"psnr": 20.5, "g_loss": 1.25}, 0), ({"psnr": 21.0, "g_loss": 1.0}, 1),
               ({"psnr": 22.0, "g_loss": 0.5, "extra": 3.0}, 2)]
    for cls, d in ((JaxMetricLogger, "jax"), (MetricLogger, "port")):
        log = cls(str(tmp_path / d), name="run")
        log.log_params({"lr": 1.6e-4, "blocks": 12})
        for metrics, step in records:
            log.log_metrics(metrics, step=step)

    def jsonl(d):
        with open(tmp_path / d / "run.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert all(isinstance(r.pop("ts"), float) for r in rows)
        return rows

    def table(d):
        with open(tmp_path / d / "run.csv", newline="") as f:
            return list(csv.reader(f))

    assert jsonl("port") == jsonl("jax") and len(jsonl("port")) == 4
    assert table("port") == table("jax")
    assert table("port")[0] == ["step", "g_loss", "psnr"]


def test_trace_writes_a_chrome_trace(tmp_path):
    out = str(tmp_path / "trace")
    with trace(out, device="cpu") as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = glob.glob(os.path.join(out, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    assert any(e.key == "aten::matmul" for e in prof.key_averages())


def test_trace_on_the_card_needs_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with trace(str(tmp_path / "t")):
            pass
    assert not os.path.exists(tmp_path / "t")


def test_timed_reports_to_its_sink():
    lines = []
    with timed("block", sink=lines.append):
        pass
    assert len(lines) == 1 and lines[0].startswith("block: ") and lines[0].endswith("s")

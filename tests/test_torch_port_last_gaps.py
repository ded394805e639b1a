"""PyTorch port: the last surfaces JAX has, against the JAX package on the CPU.

- the tile engine's pad modes: every mode ``jnp.pad`` takes, through
  ``pad_inputs``, ``predict_region`` and ``predict_region_tiled`` (a forward
  of additions and repeats that reads every raster's padding: equal to JAX's
  bit for bit, or within 1e-6 of the range for the modes that compute a
  statistic or a ramp in float32, whose sums JAX orders otherwise), and the
  generator itself under one of them;
- ``out_channels=2`` on the unfused tail (init scale 1.0: the float32
  tolerance of ``tests/test_torch_port_generator.py``, rtol 1e-4 and 1e-5 of
  the range);
- ``compute_dtype='float16'`` (init scale 0.1, JAX's own bf16 test's scale):
  the port's distance from JAX's float16 forward smaller than that forward's
  distance from JAX's float32 one, both within 2e-2 of the range, the rule
  of ``tests/test_torch_port_options.py`` for bfloat16 (the float16 dense
  block equals JAX's bit for bit; its convs' float32 sums in another order
  flip some float16 roundings elsewhere);
- the package exports and ``config``'s defaults and ``replace``;
- non-blocking checkpoints: a restore after ``wait_for_checkpoints`` equals
  the state as it was saved bit for bit, though the state moved on while the
  file was written; a writer that fails raises at the wait and leaves no
  file at the path; saves started from eight threads at once all commit.
"""

import dataclasses
import os
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepbedmap_tpu as jax_pkg
import deepbedmap_tpu.config as jax_config
import deepbedmap_tpu.models as jax_models
import deepbedmap_tpu.ops as jax_ops
import deepbedmap_tpu.train as jax_train
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.inference import engine as jax_engine
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.models.generator import Generator as JaxGenerator
import deepbedmap_tpu_torch as port_pkg
import deepbedmap_tpu_torch.config as port_config
import deepbedmap_tpu_torch.models as port_models
import deepbedmap_tpu_torch.ops as port_ops
import deepbedmap_tpu_torch.train as port_train
from deepbedmap_tpu_torch.bridge import jax_params_to_state_dict
from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
from deepbedmap_tpu_torch.inference import engine
from deepbedmap_tpu_torch.models import Generator
from deepbedmap_tpu_torch.train import checkpoint
from deepbedmap_tpu_torch.train.state import create_gan_state

TOL_STAT = 1e-6  # float32 statistics and ramps, summed in another order
TOL_HALF = 2e-2  # JAX's own reduced-precision bound (tests/test_models.py:154-194)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the pad modes ---------------------------------------------------------------

PLAN = dict(out_h=32, out_w=64, tile_out=32, halo_lr=3)  # pad_lr 4, 2 tiles


def _inputs(seed):
    lh, lw = PLAN["out_h"] // 4, PLAN["out_w"] // 4
    rs = np.random.RandomState(seed)
    return {k: rs.randn(1, r * lh, r * lw, c).astype(np.float32)
            for k, r, c in (("X", 1, 1), ("W1", 10, 1), ("W2", 2, 2), ("W3", 1, 1))}


def _close(mode, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, mode
    if mode in ("mean", "linear_ramp", "median"):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_STAT * np.abs(want).max(),
                                   err_msg=mode)
    else:
        np.testing.assert_array_equal(got, want, err_msg=mode)


def _sum_forward(x, w1, w2, w3):
    a = (x + w3 + w2[:, ::2, ::2, :1] + w1[:, ::10, ::10])[:, 1:-1, 1:-1]
    return a.repeat_interleave(4, 1).repeat_interleave(4, 2)


def _sum_forward_jax(x, w1, w2, w3):
    a = (x + w3 + w2[:, ::2, ::2, :1] + w1[:, ::10, ::10])[:, 1:-1, 1:-1]
    return jnp.repeat(jnp.repeat(a, 4, 1), 4, 2)


@pytest.mark.parametrize("mode", engine.PAD_MODES)
def test_pad_modes_match_jax(mode):
    # the statistic and ramp modes pad H first and W from the padded H, as
    # numpy: their corners would differ if the axes were padded apart
    inputs = _inputs(seed=len(mode))
    plan, jplan = engine.TilePlan(**PLAN), jax_engine.TilePlan(**PLAN)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    want = jax_engine.pad_inputs(jin, jplan, mode)
    got = engine.pad_inputs(tin, plan, mode)
    for k in inputs:
        _close(mode, got[k], want[k])
    for fn, jfn in ((engine.predict_region, jax_engine.predict_region),
                    (engine.predict_region_tiled, jax_engine.predict_region_tiled)):
        _close(mode, fn(_sum_forward, tin, plan, pad_mode=mode),
               jfn(_sum_forward_jax, jin, jplan, pad_mode=mode))


@pytest.mark.parametrize("mode", ["reflect", "symmetric", "wrap", "edge"])
def test_pad_wider_than_the_axis_matches_jnp_pad(mode):
    # numpy repeats the reflection where the pad exceeds the axis; the
    # port's gather index is np.pad of the index vector itself
    a = np.random.RandomState(1).randn(1, 3, 2, 2).astype(np.float32)
    want = jnp.pad(jnp.asarray(a), ((0, 0), (7, 7), (7, 7), (0, 0)), mode=mode)
    np.testing.assert_array_equal(engine.pad_hw(torch.from_numpy(a), 7, mode).numpy(),
                                  np.asarray(want))


def test_pad_mode_refusal():
    with pytest.raises(ValueError, match="pad mode"):
        engine.pad_hw(torch.zeros(1, 2, 2, 1), 1, "nearest")


def test_generator_region_under_a_pad_mode_matches_jax():
    # the whole generator (2 RRDBs, init scale 1.0) through predict_region
    # with 'symmetric': the float32 tolerance of the generator tests
    flags, lr = dict(num_residual_blocks=2), PLAN["out_h"] // 4 + 8
    _, params = jax_build_generator(JaxGeneratorConfig(**flags, init_scale=1.0), lr=lr)
    jmodel = JaxGenerator(JaxGeneratorConfig(**flags))

    def jfwd(*xs):
        return jmodel.apply({"params": params}, *xs)

    model = Generator(GeneratorConfig(**flags))
    model.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    inputs = _inputs(seed=5)
    with torch.inference_mode():
        got = engine.predict_region(model, {k: torch.from_numpy(v) for k, v in inputs.items()},
                                    engine.TilePlan(**PLAN), pad_mode="symmetric").numpy()
    want = np.asarray(jax_engine.predict_region(
        jfwd, {k: jnp.asarray(v) for k, v in inputs.items()}, jax_engine.TilePlan(**PLAN),
        pad_mode="symmetric"))
    assert got.shape == want.shape == (1, 32, 64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


# --- two configurations JAX builds -------------------------------------------------

GEN_LR = 11


def _forwards(flags, init_scale, *others):
    """JAX's forward of ``flags`` and of each of ``others`` (flags of the
    same parameter tree), and the port's of ``flags``, on one crop."""
    _, params = jax_build_generator(
        JaxGeneratorConfig(num_residual_blocks=2, **flags, init_scale=init_scale), lr=GEN_LR)
    rs = np.random.RandomState(42)
    lr = GEN_LR
    xs = [rs.rand(1, lr, lr, 1), rs.rand(1, 10 * lr, 10 * lr, 1),
          rs.rand(1, 2 * lr, 2 * lr, 2), rs.rand(1, lr, lr, 1)]
    xs = [a.astype(np.float32) for a in xs]
    wants = [np.asarray(JaxGenerator(JaxGeneratorConfig(num_residual_blocks=2, **f)).apply(
        {"params": params}, *map(jnp.asarray, xs))) for f in (flags, *others)]
    model = Generator(GeneratorConfig(num_residual_blocks=2, **flags))
    model.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, xs))
    assert got.dtype == torch.float32
    return got.numpy(), wants


def test_two_output_channels_on_the_unfused_tail_match_jax():
    got, (want,) = _forwards(dict(out_channels=2, tail_fused=False), 1.0)
    out = 4 * (GEN_LR - 2)
    assert got.shape == want.shape == (1, out, out, 2)
    scale = np.abs(want).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def test_float16_generator_matches_jax():
    got, (want16, want32) = _forwards(dict(compute_dtype="float16"), 0.1, {})
    scale = np.abs(want32).max()
    d_port, d_jax = np.abs(got - want16).max(), np.abs(want16 - want32).max()
    print(f"float16: port vs JAX-fp16 {d_port:.3e}, JAX-fp16 vs JAX-fp32 {d_jax:.3e}, "
          f"range {scale:.3e}")
    assert 0 < d_port < d_jax <= TOL_HALF * scale


# --- exports -------------------------------------------------------------------------

EXPORTS = {
    "package": (jax_pkg, port_pkg, ["GeneratorConfig", "DiscriminatorConfig", "LossConfig",
                                    "TrainConfig", "InferenceConfig", "DeepBedMap"]),
    "ops": (jax_ops, port_ops, ["nearest_upsample", "space_to_depth", "avg_pool", "ssim",
                                "psnr", "rmse", "sigmoid_cross_entropy", "ragan_loss",
                                "generator_loss", "binary_accuracy", "deform_conv2d"]),
    "train": (jax_train, port_train, ["GANState", "create_gan_state", "make_train_step",
                                      "make_eval_step", "StepMetrics", "train_epoch", "fit"]),
    "models": (jax_models, port_models, ["Generator", "Discriminator", "build_generator",
                                         "build_discriminator", "generator_forward_nchw",
                                         "count_params", "summary", "param_table", "to_dot"]),
}


@pytest.mark.parametrize("package", list(EXPORTS))
def test_package_exports_match_jax(package):
    theirs, ours, names = EXPORTS[package]
    for name in names:
        assert hasattr(theirs, name), (package, name)  # the list is JAX's
        assert callable(getattr(ours, name)), (package, name)


def test_config_defaults_and_replace_match_jax():
    for name in ("DEFAULT_GENERATOR", "DEFAULT_DISCRIMINATOR", "DEFAULT_LOSS", "DEFAULT_TRAIN",
                 "DEFAULT_INFERENCE", "DEFAULT_TILING"):
        assert dataclasses.asdict(getattr(port_config, name)) == dataclasses.asdict(
            getattr(jax_config, name)), name
    cfg = port_config.replace(port_config.DEFAULT_GENERATOR, growth_channels=16)
    assert cfg.growth_channels == 16 and port_config.DEFAULT_GENERATOR.growth_channels == 32
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_config.replace(jax_config.DEFAULT_GENERATOR, growth_channels=16))


# --- non-blocking checkpoints ----------------------------------------------------------


def _state():
    return create_gan_state(GeneratorConfig(num_residual_blocks=1),
                            t_cfg=TrainConfig(ema_decay=0.5), seed=0, device="cpu")


def test_nonblocking_checkpoint_restores_bit_for_bit(tmp_path):
    state = _state()
    with torch.no_grad():
        for p in state.g.parameters():
            p.add_(0.25)
    saved = {"g": {k: v.clone() for k, v in state.g.state_dict().items()},
             "d": {k: v.clone() for k, v in state.d.state_dict().items()},
             "g_ema": {k: v.clone() for k, v in state.g_ema.items()}}
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(state, path, block=False)
    with torch.no_grad():  # the state moves on while the file is written
        for p in list(state.g.parameters()) + list(state.d.parameters()):
            p.mul_(-3.0)
    checkpoint.wait_for_checkpoints()
    back = checkpoint.restore_checkpoint(path, device="cpu")
    for key in ("g", "d"):
        got = getattr(back, key).state_dict()
        assert got.keys() == saved[key].keys()
        for name, t in saved[key].items():
            assert torch.equal(got[name], t), (key, name)
    for name, t in saved["g_ema"].items():
        assert torch.equal(back.g_ema[name], t), name
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]  # no temporary file left


def test_a_failed_writer_raises_at_the_wait_and_leaves_no_file(tmp_path, monkeypatch):
    def broken_save(payload, f):
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken_save)
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(_state(), path, block=False)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.wait_for_checkpoints()
    assert os.listdir(tmp_path) == []
    checkpoint.wait_for_checkpoints()  # the error is raised once


def test_concurrent_nonblocking_saves_all_commit(tmp_path, monkeypatch):
    # eight threads each start four non-blocking saves (a stand-in state and
    # a slow stand-in writer) under a short switch interval: every file is
    # committed and no writer is lost from the shared list
    def slow_save(payload, f):
        time.sleep(0.002)
        with open(f, "wb") as fh:
            fh.write(str(payload["step"]).encode())

    monkeypatch.setattr(checkpoint.torch, "save", slow_save)
    empty = types.SimpleNamespace(state_dict=dict)

    def fake(step):
        model = types.SimpleNamespace(cfg=GeneratorConfig(), in_px=36, state_dict=dict)
        return types.SimpleNamespace(step=step, g=model, d=model, g_opt=empty, d_opt=empty,
                                     g_ema=None)

    def saver(i):
        for j in range(4):
            checkpoint.save_checkpoint(fake(4 * i + j), str(tmp_path / f"c{i}_{j}"),
                                       block=False)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=saver, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        checkpoint.wait_for_checkpoints()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(os.listdir(tmp_path)) == sorted(f"c{i}_{j}" for i in range(8)
                                                  for j in range(4))
    for i in range(8):
        for j in range(4):
            assert (tmp_path / f"c{i}_{j}").read_text() == str(4 * i + j)

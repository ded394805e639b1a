"""PyTorch port: weight bridge, parameter count, config guards, and that the
port package never loads JAX."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.models.api import count_params as jax_count_params
from deepbedmap_tpu_torch.bridge import (
    jax_params_to_state_dict,
    state_dict_to_jax_params,
)
from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.models import Generator, build_generator, count_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tree():
    _, params = jax_build_generator(JaxGeneratorConfig(num_residual_blocks=2))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def test_bridge_round_trips_exactly(jax_tree):
    _, tree = jax_tree
    sd = jax_params_to_state_dict(tree)
    back = state_dict_to_jax_params(sd)
    a, b = _leaves(tree), _leaves(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # every bridged key is a parameter of the port's generator, and vice versa
    model = Generator(GeneratorConfig(num_residual_blocks=2))
    model.load_state_dict(sd, strict=True)
    # conv kernels become OIHW; the offset convs keep JAX's [:9]=dy, [9:]=dx
    np.testing.assert_array_equal(
        sd["final_conv_layer1.offset_conv.weight"].numpy(),
        tree["final_conv_layer1"]["offset_conv"]["kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        sd["residual_network.1.residual_dense_block3.conv_layer5.weight"].numpy(),
        tree["residual_network"]["block"]["residual_dense_block3"]["conv_layer5"][
            "kernel"][1].transpose(3, 2, 0, 1),
    )


def test_count_params_matches_jax(jax_tree):
    params, tree = jax_tree
    n_jax = jax_count_params(params)
    assert n_jax == 1_713_509
    assert count_params(jax_params_to_state_dict(tree)) == n_jax
    assert count_params(
        build_generator(GeneratorConfig(num_residual_blocks=2), device="cpu")
    ) == n_jax


def test_seeded_init_is_deterministic_and_chainer_scaled():
    a = build_generator(GeneratorConfig(num_residual_blocks=1), seed=3, device="cpu")
    b = build_generator(GeneratorConfig(num_residual_blocks=1), seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    w = a.residual_network[0].residual_dense_block1.conv_layer5.weight
    expected_std = 0.1 * np.sqrt(2.0 / (192 * 9))
    assert abs(w.std().item() / expected_std - 1.0) < 0.05
    assert torch.all(a.pre_residual_conv_layer.bias == 0)


def test_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import deepbedmap_tpu_torch, deepbedmap_tpu_torch.api\n"
        "import deepbedmap_tpu_torch.bridge, deepbedmap_tpu_torch.inference\n"
        "import deepbedmap_tpu_torch.ops.tail, deepbedmap_tpu_torch.ops._kernels\n"
        "import deepbedmap_tpu_torch.ops.conv3x3, deepbedmap_tpu_torch.ops.deform_conv\n"
        "import deepbedmap_tpu_torch.models, deepbedmap_tpu_torch.device\n"
        "import deepbedmap_tpu_torch.train.checkpoint, deepbedmap_tpu_torch.utils.tracking\n"
        "import deepbedmap_tpu_torch.ops.interp, deepbedmap_tpu_torch.ops.metrics\n"
        "import deepbedmap_tpu_torch.data.tiler, deepbedmap_tpu_torch.data.raster\n"
        "import deepbedmap_tpu_torch.data.groundtruth, deepbedmap_tpu_torch.evalx.track\n"
        "import deepbedmap_tpu_torch.utils, deepbedmap_tpu_torch.evalx\n"
        "import deepbedmap_tpu_torch.data.geotiff, deepbedmap_tpu_torch.data._tiffnative\n"
        "import deepbedmap_tpu_torch.serve, deepbedmap_tpu_torch.cli\n"
        "import deepbedmap_tpu_torch.ops.losses, deepbedmap_tpu_torch.ops.ssim\n"
        "import deepbedmap_tpu_torch.ops.resize, deepbedmap_tpu_torch.ops._autograd\n"
        "import deepbedmap_tpu_torch.models.discriminator, deepbedmap_tpu_torch.data.dataset\n"
        "import deepbedmap_tpu_torch.train.state, deepbedmap_tpu_torch.train.steps\n"
        "import deepbedmap_tpu_torch.train.loop, deepbedmap_tpu_torch.train\n"
        "import deepbedmap_tpu_torch.hpo, deepbedmap_tpu_torch.hpo.engine\n"
        "import deepbedmap_tpu_torch.models.summary, deepbedmap_tpu_torch.evalx.fixed\n"
        "import deepbedmap_tpu_torch.train.objective, deepbedmap_tpu_torch.data.manifest\n"
        "import deepbedmap_tpu_torch.data.packaging, deepbedmap_tpu_torch.data.proj\n"
        "import deepbedmap_tpu_torch.data.windows, deepbedmap_tpu_torch.data.geojson\n"
        "import deepbedmap_tpu_torch.data.pipeline, deepbedmap_tpu_torch.data.gridder\n"
        "import deepbedmap_tpu_torch.data.builder, deepbedmap_tpu_torch.ops.spline\n"
        "import deepbedmap_tpu_torch.ops.gmt_surface, deepbedmap_tpu_torch.data\n"
        "import deepbedmap_tpu_torch.evalx.baselines, deepbedmap_tpu_torch.viz\n"
        "import deepbedmap_tpu_torch.viz.live, deepbedmap_tpu_torch.viz.figure_set\n"
        "import deepbedmap_tpu_torch.utils.profiling, deepbedmap_tpu_torch.utils.flops\n"
        "import deepbedmap_tpu_torch.parallel, deepbedmap_tpu_torch.parallel.tp\n"
        "import deepbedmap_tpu_torch.inference.multihost\n"
        "import deepbedmap_tpu_torch.utils.logging\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deepbedmap_tpu', 'h5py', 'pandas', "
        "'yaml', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "flags",
    [
        # the combinations the JAX generator asserts against
        # (deepbedmap_tpu/models/generator.py:193-195, 225-226)
        dict(upsample_phase_conv=True, tail_hcw=True, tail_fused=False),
        dict(tail_hcw=True),
        # the fused tail has a single output channel
        dict(out_channels=2),
    ],
)
def test_unported_config_flags_raise(flags):
    with pytest.raises(ValueError):
        Generator(GeneratorConfig(num_residual_blocks=1, **flags))


@pytest.mark.parametrize(
    "flags",
    [
        dict(upsample_phase_conv=True),
        dict(tail_hcw=True, tail_fused=False),
        dict(compute_dtype="bfloat16"),
        dict(fused_rdb="never"),
        dict(compute_dtype="float16"),
        dict(out_channels=2, tail_fused=False),
    ],
)
def test_option_trees_map_onto_jax(flags):
    # each option's JAX tree bridges onto the port's generator in that
    # option, key for key and shape for shape, and back exactly
    _, params = jax_build_generator(JaxGeneratorConfig(num_residual_blocks=2, **flags))
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = jax_params_to_state_dict(tree)
    model = Generator(GeneratorConfig(num_residual_blocks=2, **flags))
    model.load_state_dict(sd, strict=True)
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in sd.items()}
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    a, b = _leaves(tree), _leaves(state_dict_to_jax_params(model.state_dict()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize(
    "flags",
    [
        dict(rrdb_fused=True),
        dict(fused_conv="auto"),
        dict(fused_conv="always"),
        dict(tail_fused=False),
        dict(rrdb_fused=True, fused_conv="always", tail_fused=False),
        dict(rrdb_sweep=True),
        dict(rdb_resident="never"),
        dict(rdb_resident="never", rrdb_fused=True),
        dict(upsample_phase_conv=True),
        dict(tail_hcw=True, tail_fused=False),
        dict(compute_dtype="bfloat16"),
        dict(fused_rdb="never"),
    ],
)
def test_ported_config_flags_build(flags):
    # the kernel flags change the forward only: the parameter tree (keys and
    # shapes) is the default configuration's, as in JAX, so one state_dict
    # (and one bridged JAX tree) serves every configuration
    want = Generator(GeneratorConfig(num_residual_blocks=1)).state_dict()
    got = Generator(GeneratorConfig(num_residual_blocks=1, **flags)).state_dict()
    assert list(got) == list(want)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize(
    "flags,calls",
    [
        ({}, {"rdb_fused": 6}),
        (dict(rdb_resident="never"), {"rdb_banded": 6}),
        # JAX's precedence: rrdb_fused acts only on a resident trunk
        # (models/generator.py), so this is K6 per dense block, not K4
        (dict(rdb_resident="never", rrdb_fused=True), {"rdb_banded": 6}),
        (dict(rdb_resident="never", rrdb_sweep=True), {"rdb_banded": 6}),
        (dict(rrdb_fused=True), {"rrdb_fused": 2}),
        (dict(rrdb_sweep=True), {"rrdb_sweep": 2}),
        # and the sweep wins over rrdb_fused (models/blocks.py)
        (dict(rrdb_sweep=True, rrdb_fused=True), {"rrdb_sweep": 2}),
    ],
)
def test_trunk_dispatch_follows_jax_precedence(monkeypatch, flags, calls):
    # the trunk's kernel wrappers, counted as the CPU forward calls them
    # (each still runs its plain version)
    from deepbedmap_tpu_torch.models import blocks

    seen = {}
    for name in ("rdb_fused", "rdb_banded", "rrdb_fused", "rrdb_sweep"):
        def spy(*args, _name=name, _fn=getattr(blocks, name)):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(blocks, name, spy)
    model = Generator(GeneratorConfig(num_residual_blocks=2, **flags))
    model.reset_parameters(torch.Generator().manual_seed(0))
    lr = 6
    xs = [torch.rand(1, lr, lr, 1), torch.rand(1, 10 * lr, 10 * lr, 1),
          torch.rand(1, 2 * lr, 2 * lr, 2), torch.rand(1, lr, lr, 1)]
    with torch.inference_mode():
        out = model(*xs)
    assert out.shape == (1, 4 * (lr - 2), 4 * (lr - 2), 1)
    assert seen == calls


def test_config_fields_match_jax():
    import dataclasses

    from deepbedmap_tpu import config as jax_config
    from deepbedmap_tpu_torch import config

    for ours, theirs in ((GeneratorConfig, JaxGeneratorConfig),
                         (config.InferenceConfig, jax_config.InferenceConfig),
                         (config.DiscriminatorConfig, jax_config.DiscriminatorConfig),
                         (config.LossConfig, jax_config.LossConfig),
                         (config.TrainConfig, jax_config.TrainConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [
            (f.name, f.default) for f in dataclasses.fields(theirs)
        ]
    assert dataclasses.asdict(config.LossConfig.recommended(ssim_window=5)) == \
        dataclasses.asdict(jax_config.LossConfig.recommended(ssim_window=5))

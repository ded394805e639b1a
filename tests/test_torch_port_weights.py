"""PyTorch port: trained weights without JAX. The Chainer-npz import and
export (``train/checkpoint.py``), ``DeepBedMap.from_chainer_npz`` and
``DeepBedMap.from_experiment`` on the copied trackers (``utils/tracking.py``),
each against the JAX package on the same files."""

import jax
import numpy as np
import pytest
import torch

from deepbedmap_tpu import DeepBedMap as JaxDeepBedMap
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.train import checkpoint as jax_checkpoint
from deepbedmap_tpu.utils import tracking as jax_tracking
from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.bridge import jax_params_to_state_dict, state_dict_to_jax_params
from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.train import checkpoint
from deepbedmap_tpu_torch.utils import tracking
from test_tracking import tracker_server  # noqa: F401  (the JAX tests' localhost server)

CFG = dict(num_residual_blocks=2)
ORDERS = ["xy", "yx"]


@pytest.fixture(scope="module")
def tree():
    _, params = jax_build_generator(JaxGeneratorConfig(**CFG), seed=7)
    return jax.tree_util.tree_map(np.asarray, params)


def _leaves(t):
    flat = jax.tree_util.tree_flatten_with_path(t)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        # bit for bit: the import only moves and transposes the arrays
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("order", ORDERS)
def test_from_chainer_npz_matches_jax_import(tree, tmp_path, order):
    path = str(tmp_path / "gen.npz")
    jax_checkpoint.export_generator_npz(tree, path, offset_order=order)
    # the port's import gives JAX's flax-layout tree, leaf for leaf
    a = _leaves(jax_checkpoint.import_chainer_generator_npz(path, 2, order))
    b = _leaves(checkpoint.import_chainer_generator_npz(path, 2, order))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # and DeepBedMap loads exactly the bridged JAX params
    dbm = DeepBedMap.from_chainer_npz(path, GeneratorConfig(**CFG), offset_order=order,
                                      device="cpu")
    _assert_state_dicts_equal(dbm.model.state_dict(), jax_params_to_state_dict(tree))


@pytest.mark.parametrize("order", ORDERS)
def test_offset_halves_follow_offset_order(tree, tmp_path, order):
    # 'xy': the npz holds the offset conv's x half (JAX's [9:]) first
    path = str(tmp_path / "gen.npz")
    checkpoint.export_generator_npz(tree, path, offset_order=order)
    npz = np.load(path)
    w = tree["final_conv_layer1"]["offset_conv"]["kernel"].transpose(3, 2, 0, 1)
    b = tree["final_conv_layer1"]["offset_conv"]["bias"]
    first = slice(9, 18) if order == "xy" else slice(0, 9)
    np.testing.assert_array_equal(npz["final_conv_layer1/offset_conv/W"][:9], w[first])
    np.testing.assert_array_equal(npz["final_conv_layer1/offset_conv/b"][:9], b[first])
    # read in the other order, the halves come back swapped
    other = {"xy": "yx", "yx": "xy"}[order]
    sd = DeepBedMap.from_chainer_npz(path, GeneratorConfig(**CFG), offset_order=other,
                                     device="cpu").model.state_dict()
    got = sd["final_conv_layer1.offset_conv.weight"].numpy()
    np.testing.assert_array_equal(got[:9], w[9:])
    np.testing.assert_array_equal(got[9:], w[:9])


@pytest.mark.parametrize("order", ORDERS)
def test_export_matches_jax_export(tree, tmp_path, order):
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    # the port exports from its state_dict through the bridge
    checkpoint.export_generator_npz(
        state_dict_to_jax_params(jax_params_to_state_dict(tree)), ours, offset_order=order)
    jax_checkpoint.export_generator_npz(tree, theirs, offset_order=order)
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.keys()) == sorted(b.keys())
    for k in b.keys():
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the reference's Chainer names and shapes (tests/test_checkpoint_hpo.py:83)
    names = set(a.keys())
    assert "input_block/conv_on_X/W" in names
    assert "residual_network/0/residual_dense_block1/conv_layer1/W" in names
    assert "residual_network/1/residual_dense_block3/conv_layer5/b" in names
    assert "final_conv_layer2/deform_conv/b" in names
    assert "pre_residual_conv_layer/W" in names
    assert a["input_block/conv_on_W1/W"].shape == (32, 1, 30, 30)
    assert a["input_block/conv_on_W2/W"].shape == (32, 2, 6, 6)


def _log_run(tracker, tree, tmp_path, hp):
    npz = tmp_path / "srgan_generator_model_weights.npz"
    checkpoint.export_generator_npz(tree, str(npz))
    tracker.log_params(hp)
    tracker.log_asset(str(npz))


def test_from_experiment_local_tracker(tree, tmp_path):
    # as tests/test_tracking.py:200: the newest run's weights and logged
    # hyperparameters rebuild the generator, here on the port's tracker copy
    root = str(tmp_path / "experiments")
    hp = {"num_residual_blocks": 2, "residual_scaling": 0.25, "generator_lr": 1.6e-4}
    old = tracking.LocalTracker(root)
    old.log_params({"num_residual_blocks": 1})
    new = tracking.LocalTracker(root)
    _log_run(new, tree, tmp_path, hp)
    assert tracking.LocalTracker.list_experiments(root) == [old.experiment_key,
                                                            new.experiment_key]
    # the JAX package reads the same layout and picks the same run
    assert jax_tracking.LocalTracker.list_experiments(root) == \
        tracking.LocalTracker.list_experiments(root)

    dl = str(tmp_path / "dl" / "w.npz")
    dbm = DeepBedMap.from_experiment(root, "latest", download_path=dl, device="cpu")
    assert dbm.cfg.num_residual_blocks == 2
    assert dbm.cfg.residual_scaling == 0.25
    _assert_state_dicts_equal(dbm.model.state_dict(), jax_params_to_state_dict(tree))
    want = JaxDeepBedMap.from_experiment(root, "latest",
                                         download_path=str(tmp_path / "dl2" / "w.npz"))
    assert (want.cfg.num_residual_blocks, want.cfg.residual_scaling) == (2, 0.25)
    _assert_state_dicts_equal(
        dbm.model.state_dict(),
        jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want.params)))
    # an explicit key that does not exist raises instead of minting a run
    with pytest.raises(FileNotFoundError):
        DeepBedMap.from_experiment(root, "no-such-key", download_path=dl, device="cpu")


def test_from_experiment_http_tracker(tree, tmp_path, tracker_server):  # noqa: F811
    base, store = tracker_server
    old = tracking.HTTPTracker(base)
    old.log_params({"num_residual_blocks": 1})
    store.experiments[old.experiment_key]["created_ts"] -= 100.0  # force older
    _log_run(tracking.HTTPTracker(base, api_key="secret"), tree, tmp_path,
             {"num_residual_blocks": 2, "residual_scaling": 0.2})
    dbm = DeepBedMap.from_experiment(base, "latest", download_path=str(tmp_path / "w.npz"),
                                     api_key="secret", device="cpu")
    assert (dbm.cfg.num_residual_blocks, dbm.cfg.residual_scaling) == (2, 0.2)
    _assert_state_dicts_equal(dbm.model.state_dict(), jax_params_to_state_dict(tree))

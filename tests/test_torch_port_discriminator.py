"""PyTorch port: the VGG discriminator against flax's on the same variables
(the bridge), in train and eval mode at a 36^2 input (a 1 x 1 map before the
head) and at 72^2 (2 x 2, where a wrong flatten order shows), the BatchNorm
statistics after two train-mode forwards in sequence, the bridge's round
trip, the parameter count and the seeded init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import DiscriminatorConfig as JaxDiscriminatorConfig
from deepbedmap_tpu.models.api import build_discriminator as jax_build_discriminator
from deepbedmap_tpu.models.api import count_params as jax_count_params
from deepbedmap_tpu.models.discriminator import Discriminator as JaxDiscriminator
from deepbedmap_tpu_torch.bridge import jax_d_vars_to_state_dict, state_dict_to_jax_d_vars
from deepbedmap_tpu_torch.config import DiscriminatorConfig
from deepbedmap_tpu_torch.models import Discriminator, build_discriminator, count_params

# logits: fp32 on both sides through ten convs and two BatchNorms' worth of
# reductions in another order; 1e-4 of the logits' largest magnitude as the
# generator's forwards are held (tests/test_torch_port_generator.py)
TOL_LOGITS = 1e-4
TOL_STATS = 1e-5  # BatchNorm running statistics, relative to their magnitude


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[36, 72])
def jax_vars(request):
    """Flax variables at init scale 1.0 (activations O(1)), with running
    statistics moved off their init so eval mode reads them."""
    hr = request.param
    _, variables = jax_build_discriminator(JaxDiscriminatorConfig(init_scale=1.0), seed=3,
                                           hr=hr)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rs = np.random.RandomState(hr)
    for stats in variables["batch_stats"].values():
        stats["mean"] = (rs.randn(*stats["mean"].shape) * 0.1).astype(np.float32)
        stats["var"] = (1.0 + rs.rand(*stats["var"].shape)).astype(np.float32)
    return hr, variables


def _port(hr, variables):
    d = Discriminator(DiscriminatorConfig(init_scale=1.0), in_px=hr)
    d.load_state_dict(jax_d_vars_to_state_dict(variables))
    return d


def _tiles(hr, seed, n=6):
    return np.random.RandomState(seed).rand(n, hr, hr, 1).astype(np.float32)


def test_param_count_matches_jax_and_reference(jax_vars):
    hr, variables = jax_vars
    want = jax_count_params(variables["params"])
    assert count_params(build_discriminator(hr=hr, device="cpu")) == want
    if hr == 36:  # the reference's tiles: a 1 x 1 map before the head
        assert want == 10_370_761


def test_bridge_round_trips_exactly(jax_vars):
    hr, variables = jax_vars
    back = state_dict_to_jax_d_vars(jax_d_vars_to_state_dict(variables))
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for (path, want), got in zip(flat, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    d = _port(hr, variables)
    sd = jax_d_vars_to_state_dict(state_dict_to_jax_d_vars(d.state_dict()))
    assert sorted(sd) == sorted(d.state_dict())
    for k, v in d.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_flax(jax_vars, train):
    hr, variables = jax_vars
    x = _tiles(hr, 1)
    if train:
        want, _ = JaxDiscriminator(JaxDiscriminatorConfig()).apply(
            variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = JaxDiscriminator(JaxDiscriminatorConfig()).apply(variables, jnp.asarray(x),
                                                                train=False)
    d = _port(hr, variables).train(train)
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (6, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LOGITS * np.abs(want).max())


def test_batch_stats_after_two_train_forwards(jax_vars):
    # real then fake, in sequence (never concatenated), as the D update runs
    # them: flax's biased batch variance, momentum 0.9
    hr, variables = jax_vars
    real, fake = _tiles(hr, 2), _tiles(hr, 3) * 2 - 0.5
    model = JaxDiscriminator(JaxDiscriminatorConfig())
    _, mut = model.apply(variables, jnp.asarray(real), train=True, mutable=["batch_stats"])
    _, mut = model.apply({"params": variables["params"], **mut}, jnp.asarray(fake),
                         train=True, mutable=["batch_stats"])
    d = _port(hr, variables).train()
    with torch.no_grad():
        d(torch.from_numpy(real))
        d(torch.from_numpy(fake))
    got = state_dict_to_jax_d_vars(d.state_dict())["batch_stats"]
    for layer, stats in mut["batch_stats"].items():
        for k, want in stats.items():
            want = np.asarray(want)
            np.testing.assert_allclose(got[layer][k], want, rtol=0,
                                       atol=TOL_STATS * np.abs(want).max(),
                                       err_msg=f"{layer}.{k}")


def test_seeded_init_is_deterministic_and_chainer_scaled():
    a = build_discriminator(seed=5, device="cpu")
    b = build_discriminator(seed=5, device="cpu")
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    # He normal, std = 0.1 * sqrt(2 / fan_in), for conv and dense weights
    for name, fan_in in (("conv_layer8", 512 * 9), ("linear_1", 512)):
        w = getattr(a, name).weight
        np.testing.assert_allclose(float(w.detach().std()), 0.1 * np.sqrt(2.0 / fan_in), rtol=0.05)
    assert torch.all(a.batch_norm1.var == 1) and torch.all(a.batch_norm1.scale == 1)
    assert torch.all(a.conv_layer0.bias == 0) and a.conv_layer1.bias is None

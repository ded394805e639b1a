"""PyTorch port: the losses, SSIM, average pooling and the generator loss's
gradient against the JAX package on the same seeded numpy inputs, and the
reference's golden values with JAX's own tolerances (tests/test_losses.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import LossConfig as JaxLossConfig
from deepbedmap_tpu.ops import losses as jax_losses
from deepbedmap_tpu.ops.metrics import psnr as jax_psnr
from deepbedmap_tpu.ops.resize import avg_pool as jax_avg_pool
from deepbedmap_tpu.ops.ssim import ssim as jax_ssim
from deepbedmap_tpu_torch.config import LossConfig
from deepbedmap_tpu_torch.ops import losses
from deepbedmap_tpu_torch.ops.metrics import psnr
from deepbedmap_tpu_torch.ops.resize import avg_pool
from deepbedmap_tpu_torch.ops.ssim import ssim

# losses and metrics: both sides fp32, sums in another order
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_ragan_golden():
    loss = losses.ragan_loss(real_logits=_t([[1.1], [-0.5]]),
                             fake_logits=_t([[-0.3], [1.0]]))
    assert np.isclose(float(loss), 1.56670504, atol=1e-4)


def test_psnr_golden():
    value = psnr(torch.ones(2, 3, 3, 1), torch.full((2, 3, 3, 1), 2.0))
    assert np.isclose(float(value), 192.65919722494797, atol=1e-4)


def test_ssim_golden():
    value = ssim(torch.ones(2, 9, 9, 1), torch.full((2, 9, 9, 1), 2.0))
    assert np.isclose(float(value), 0.800004, atol=1e-5)


def test_generator_loss_golden():
    terms = losses.generator_loss(
        y_pred=torch.ones(2, 12, 12, 1),
        y_true=torch.full((2, 12, 12, 1), 10.0),
        fake_logits=_t([[-1.2], [0.5]]),
        real_logits=_t([[0.5], [-0.8]]),
        x_topo=torch.full((2, 3, 3, 1), 9.0),
    )
    assert np.isclose(float(terms.total), 4.35108415, atol=1e-4)


def test_ssim_shape_mismatch_raises():
    with pytest.raises(ValueError):
        ssim(torch.ones(1, 9, 9, 1), torch.ones(1, 10, 10, 1))


def _logits(rs, n=16):
    x = (rs.randn(n, 1) * 3).astype(np.float32)
    x[:2] = [[0.0], [-0.0]]  # the >= 0 branch at zero
    return x


@pytest.mark.parametrize("name", ["sigmoid_cross_entropy", "ragan_loss", "binary_accuracy"])
def test_logit_losses_match_jax(name):
    rs = np.random.RandomState(0)
    a, b = _logits(rs), _logits(rs)
    if name != "ragan_loss":
        b = (rs.rand(*b.shape) > 0.5).astype(np.float32)
    want = float(getattr(jax_losses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(losses, name)(_t(a), _t(b)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("window,stride,shape", [
    (4, None, (3, 36, 36, 1)),  # the topographic loss's pool
    (9, 1, (2, 20, 17, 1)),  # SSIM's window
    (3, 2, (1, 11, 13, 2)),
])
def test_avg_pool_matches_jax(window, stride, shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(jax_avg_pool(jnp.asarray(x), window, stride))
    got = avg_pool(_t(x), window, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("window", [9, 5])
def test_ssim_and_psnr_match_jax(window):
    rs = np.random.RandomState(2)
    a = rs.rand(3, 36, 36, 1).astype(np.float32)
    b = (a + 0.1 * rs.randn(*a.shape)).astype(np.float32)
    np.testing.assert_allclose(float(ssim(_t(a), _t(b), window)),
                               float(jax_ssim(jnp.asarray(a), jnp.asarray(b), window)),
                               rtol=RTOL)
    np.testing.assert_allclose(float(psnr(_t(a), _t(b))),
                               float(jax_psnr(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)


def _gen_loss_inputs(seed):
    rs = np.random.RandomState(seed)
    y_pred = rs.rand(4, 36, 36, 1).astype(np.float32)
    y_true = (y_pred + 0.2 * rs.randn(*y_pred.shape)).astype(np.float32)
    x_topo = rs.rand(4, 9, 9, 1).astype(np.float32)
    return y_pred, y_true, _logits(rs, 4), _logits(rs, 4), x_topo


CFGS = {
    "default": dict(),
    "recommended": dict(differentiable_adversarial=True, adversarial_weight=0.5,
                        d_instance_noise=100.0),
    "window5": dict(ssim_window=5, content_weight=0.5),
}


@pytest.mark.parametrize("cfg", list(CFGS))
def test_generator_loss_terms_match_jax(cfg):
    ins = _gen_loss_inputs(3)
    want = jax_losses.generator_loss(*map(jnp.asarray, ins), cfg=JaxLossConfig(**CFGS[cfg]))
    got = losses.generator_loss(*map(_t, ins), cfg=LossConfig(**CFGS[cfg]))
    for name in got._fields:
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("cfg", list(CFGS))
def test_generator_loss_gradient_matches_jax(cfg):
    # gradients of the total in the prediction and in both logits: within
    # 1e-4 of each gradient's largest magnitude (fp32, sums in another order)
    ins = _gen_loss_inputs(4)

    def total(y_pred, fake_logits, real_logits):
        return jax_losses.generator_loss(
            y_pred, jnp.asarray(ins[1]), fake_logits, real_logits, jnp.asarray(ins[4]),
            cfg=JaxLossConfig(**CFGS[cfg])).total

    want = jax.grad(total, argnums=(0, 1, 2))(*(jnp.asarray(ins[i]) for i in (0, 2, 3)))
    leaves = [_t(ins[i]).requires_grad_() for i in (0, 2, 3)]
    got = torch.autograd.grad(
        losses.generator_loss(leaves[0], _t(ins[1]), leaves[1], leaves[2], _t(ins[4]),
                              cfg=LossConfig(**CFGS[cfg])).total, leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())

"""PyTorch port: gradients through the hand-written kernels.

On a CUDA tensor every kernel wrapper goes through
``ops._autograd.kernel_with_plain_grad``: the forward is the kernel, the
backward autograd of its plain twin recomputed on the saved inputs, as the
JAX package's custom VJPs differentiate the plain composition. The CPU has no
kernel, so the helper is tested here with stand-in forwards (the plain twin,
and the plain twin perturbed: the output moves, the gradients do not, which
shows the backward is the twin's), through the dense-block wrappers' own
glue (``ops.rdb._differentiable``, one dense block and a whole RRDB).
``chip_smoke.py`` phase 22 holds every kernel's gradients on the card against
autograd of its plain version.

Then the generator's gradients of JAX's generator loss (the live adversarial
term, so D's backward is in the chain) at 2 RRDBs in all four configurations
against ``jax.grad`` of JAX's ``make_g_loss_fn`` (its default XLA path,
which its kernels' VJPs differentiate too), within 1e-4 of each gradient's
largest magnitude; and K9 (``deform_conv2d_zform``), whose JAX kernel has no
VJP, raises when a gradient is asked of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.config import LossConfig as JaxLossConfig
from deepbedmap_tpu.models import Discriminator as JaxDiscriminator
from deepbedmap_tpu.models import Generator as JaxGenerator
from deepbedmap_tpu.train.steps import make_g_loss_fn as jax_make_g_loss_fn
from deepbedmap_tpu_torch.bridge import state_dict_to_jax_d_vars, state_dict_to_jax_params
from deepbedmap_tpu_torch.config import GeneratorConfig, LossConfig
from deepbedmap_tpu_torch.models import Generator, build_discriminator, build_generator
from deepbedmap_tpu_torch.ops import rdb
from deepbedmap_tpu_torch.ops._packed import packed
from deepbedmap_tpu_torch.ops._autograd import kernel_with_plain_grad, refuse_grad
from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d_zform
from deepbedmap_tpu_torch.train.steps import make_g_loss_fn

TOL_GRAD = 1e-4  # of each gradient's largest magnitude


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain(x, w, b):
    return torch.tanh(x @ w + b) * x.sum()


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(5, 4, generator=g).requires_grad_(),
            torch.randn(4, 3, generator=g).requires_grad_(),
            torch.randn(3, generator=g).requires_grad_())


@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_helper_backward_is_the_plain_twins(offset):
    # offset 0: a stand-in computing the twin's function; 3: a perturbed one,
    # whose output is off by 3 but whose gradients must stay the twin's
    x, w, b = _inputs()
    want_out = _plain(x, w, b)
    want = torch.autograd.grad(want_out.sum(), (x, w, b))

    def stand_in(x, w, b):
        assert not torch.is_grad_enabled()  # the forward records nothing
        return _plain(x, w, b) + offset

    out = kernel_with_plain_grad(stand_in, _plain, x, w, b)
    torch.testing.assert_close(out, want_out + offset, rtol=0, atol=0)
    got = torch.autograd.grad(out.sum(), (x, w, b))
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, rtol=0, atol=0)


def test_helper_passes_none_and_inputs_without_grad():
    x, w, b = _inputs(1)
    w_fixed = w.detach()
    out = kernel_with_plain_grad(lambda x, w, b, r: _plain(x, w, b) + 1.0,
                                 lambda x, w, b, r: _plain(x, w, b), x, w_fixed, b, None)
    gx, gb = torch.autograd.grad(out.sum(), (x, b))
    wx, wb = torch.autograd.grad(_plain(x, w_fixed, b).sum(), (x, b))
    torch.testing.assert_close(gx, wx, rtol=0, atol=0)
    torch.testing.assert_close(gb, wb, rtol=0, atol=0)
    # nothing needs a gradient: the kernel runs bare, no graph
    with torch.no_grad():
        bare = kernel_with_plain_grad(lambda *a: _plain(*a[:3]), _plain, x, w, b, None)
    assert bare.grad_fn is None


@pytest.mark.parametrize("blocks", [1, 3])
def test_dense_block_glue_routes_gradients_to_the_source_weights(blocks):
    # ops.rdb's own glue, as K1/K6 (one block) and K4/K5 (a whole RRDB) use
    # it on the card, with a perturbed stand-in for the kernel launch
    g = torch.Generator().manual_seed(blocks)
    f, gr = 16, 8
    cins, couts = [f + gr * j for j in range(5)], [gr, gr, gr, gr, f]

    def block():
        return ([(torch.randn(co, ci, 3, 3, generator=g) * 0.1).requires_grad_()
                 for ci, co in zip(cins, couts)],
                [(torch.randn(co, generator=g) * 0.1).requires_grad_() for co in couts])

    x = torch.randn(2, 6, 7, f, generator=g).requires_grad_()
    if blocks == 1:
        ks, bs = block()
        reference, leaves = rdb.rdb_reference, [x, *ks, *bs]
    else:
        parts = [block() for _ in range(3)]
        ks, bs = [p[0] for p in parts], [p[1] for p in parts]
        reference = rdb.rrdb_reference
        leaves = [x, *[k for blk in ks for k in blk], *[b for blk in bs for b in blk]]
    want_out = reference(x, ks, bs, 0.1)
    upstream = torch.randn(want_out.shape, generator=g)
    want = torch.autograd.grad(want_out, leaves, upstream)
    out = rdb._differentiable(lambda x: reference(x, ks, bs, 0.1).detach() + 0.5,
                              x, ks, bs, 0.1, blocks)
    torch.testing.assert_close(out, want_out + 0.5)
    got = torch.autograd.grad(out, leaves, upstream)
    for a, b in zip(got, want):  # the same recompute on the same inputs
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_packed_weights_carry_no_gradient():
    w = torch.randn(4, 4, requires_grad=True)
    got = packed(torch.mul, [w], 2)
    assert got.grad_fn is None and not got.requires_grad


def test_zform_refuses_a_gradient():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 6, 7, 8, generator=g)
    off = torch.randn(1, 6, 7, 18, generator=g)
    w = torch.randn(16, 8, 3, 3, generator=g) * 0.1
    want = deform_conv2d_zform(x, off, w, None)  # no input needs a gradient
    for i, t in enumerate((x, off, w)):
        args = [x, off, w]
        args[i] = t.clone().requires_grad_()
        with pytest.raises(ValueError, match="no gradient"):
            deform_conv2d_zform(*args, None)
        with torch.no_grad():
            torch.testing.assert_close(deform_conv2d_zform(*args, None), want)
    with pytest.raises(ValueError):
        refuse_grad("k9", None, torch.zeros(1, requires_grad=True))


CONFIGS = {
    "default": {},
    "kernel": dict(rrdb_fused=True, fused_conv="always", tail_fused=False),
    "banded": dict(rdb_resident="never"),
    "sweep": dict(rrdb_sweep=True),
}


@pytest.fixture(scope="module")
def jax_g_grads():
    """Weights, batch, and jax.grad of JAX's generator loss (live adversarial
    term) at 2 RRDBs, built once for the four configurations."""
    g = build_generator(GeneratorConfig(num_residual_blocks=2), seed=3, device="cpu")
    d = build_discriminator(seed=4, device="cpu")
    rs = np.random.RandomState(6)
    shapes = dict(X=(11, 11, 1), W1=(110, 110, 1), W2=(22, 22, 2), W3=(11, 11, 1),
                  Y=(36, 36, 1))
    batch = {k: rs.rand(2, *s).astype(np.float32) for k, s in shapes.items()}
    gp = state_dict_to_jax_params(g.state_dict())
    dv = state_dict_to_jax_d_vars(d.state_dict())
    fn = jax_make_g_loss_fn(JaxGenerator(JaxGeneratorConfig(num_residual_blocks=2)),
                            JaxDiscriminator(), JaxLossConfig(differentiable_adversarial=True))
    (loss, _), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        gp, dv["params"], dv["batch_stats"], {k: jnp.asarray(v) for k, v in batch.items()})
    return g.state_dict(), d, batch, float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_generator_gradients_match_jax(jax_g_grads, config):
    sd, d, batch, want_loss, want = jax_g_grads
    g = Generator(GeneratorConfig(num_residual_blocks=2, **CONFIGS[config]))
    g.load_state_dict(sd)
    params = dict(g.named_parameters())
    loss, _ = make_g_loss_fn(g, d, LossConfig(differentiable_adversarial=True))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    grads = torch.autograd.grad(loss, list(params.values()))
    got = state_dict_to_jax_params(dict(zip(params, grads)))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), gr in zip(flat_want, jax.tree_util.tree_leaves(got)):
        scale = np.abs(w).max()
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(gr, w, rtol=0, atol=TOL_GRAD * scale,
                                   err_msg=jax.tree_util.keystr(path))

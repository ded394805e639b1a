"""PyTorch port: GAN training on the CPU against the JAX package.

One D+G step of ``make_train_step`` from the same weights and batch as JAX's
jitted step (1 RRDB, batch 4, the deformable clamp at 1, which roughly
halves each JAX step's compile time): the five metrics, every gradient (read from
both Adams' first moments, m = (1 - b1) g after one step), the BatchNorm
statistics and the updated parameters. Also ``make_eval_step``, ``make_lr``
against optax's schedules, three Adam steps against optax, the split and the
epoch batches, ``fit``'s history against the same steps taken by hand,
instance noise, remat, the dataset, and checkpoints.

Tolerances (stated once): metrics rtol 1e-5; gradients 1e-4 of each tensor's
largest magnitude; BatchNorm statistics 1e-5 of their largest magnitude;
parameters after a step within 1e-3 * lr wherever |g| > 1e-3 of the
tensor's largest gradient (Adam's first step is ~lr * sign(g), so elements
whose gradient is round-off-sized may move by lr either way in either
implementation; the share of elements outside that set is printed). A GAN
step is not well-conditioned everywhere in fp32: a LeakyReLU whose input
round-off flips in D moves, through train-mode BatchNorm, which couples a
channel's pixels, a whole tensor's gradient (measured: D's conv0 bias by
3.4e-3 of its range, port vs JAX). So each result is held to the larger
of its tolerance and ``NOISE_K`` times the change JAX's own step shows
from weights perturbed by ``PERTURB`` (``_perturbed``), and parameters
only where that change is under |g| / ``NOISE_K``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.config import LossConfig as JaxLossConfig
from deepbedmap_tpu.config import TrainConfig as JaxTrainConfig
from deepbedmap_tpu.data import dataset as jax_dataset
from deepbedmap_tpu.models import Discriminator as JaxDiscriminator
from deepbedmap_tpu.models import Generator as JaxGenerator
from deepbedmap_tpu.train.state import GANState as JaxGANState
from deepbedmap_tpu.train.state import make_lr as jax_make_lr
from deepbedmap_tpu.train.state import make_optimizer as jax_make_optimizer
from deepbedmap_tpu.train.steps import make_eval_step as jax_make_eval_step
from deepbedmap_tpu.train.steps import make_train_step as jax_make_train_step
from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.bridge import state_dict_to_jax_d_vars, state_dict_to_jax_params
from deepbedmap_tpu_torch.config import GeneratorConfig, LossConfig, TrainConfig
from deepbedmap_tpu_torch.data import packaging
from deepbedmap_tpu_torch.data.dataset import (
    TileDataset,
    content_hash,
    epoch_batches,
    train_dev_split,
)
from deepbedmap_tpu_torch.train.checkpoint import (
    checkpoint_has_ema,
    restore_checkpoint,
    save_checkpoint,
)
from deepbedmap_tpu_torch.train.loop import _metrics_to_host, fit, make_epoch_fns
from deepbedmap_tpu_torch.train.state import create_gan_state, make_lr, make_optimizer
from deepbedmap_tpu_torch.train.steps import make_eval_step, make_train_step

RTOL_METRICS = 1e-5
TOL_GRAD = 1e-4
TOL_STATS = 1e-5
TOL_PARAM = 1e-3  # of lr
# JAX's step again from weights multiplied by (1 + PERTURB * N(0, 1)): a
# result that moves more than its tolerance under that is round-off-bound,
# and is held to NOISE_K times that move instead
PERTURB, NOISE_K = 1e-5, 3
G_FLAGS = dict(num_residual_blocks=1, deform_clamp=1)
METRICS = ("discriminator_loss", "discriminator_accu", "generator_loss",
           "generator_psnr", "generator_ssim")

# JAX's step for each case: (TrainConfig, LossConfig) kwargs. EMA and the
# D learning-rate scale share one JAX step: with the default (detached)
# adversarial term G's update does not read D's, so each is checked on its
# own outputs (g_ema; D's parameters) and one compile serves both.
CASES = {
    "default": ({}, {}),
    "differentiable_adversarial": ({}, dict(differentiable_adversarial=True)),
    "ema_and_d_lr_scale": (dict(ema_decay=0.9, d_lr_scale=0.5), {}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0, n=4):
    rs = np.random.RandomState(seed)
    shapes = dict(X=(11, 11, 1), W1=(110, 110, 1), W2=(22, 22, 2), W3=(11, 11, 1),
                  Y=(36, 36, 1))
    return {k: rs.rand(n, *s).astype(np.float32) for k, s in shapes.items()}


def _port_state(t_kw, seed=0):
    # the generator drawn at init scale 1.0: at the default 0.1 its output is
    # ~1e-5 and nearly constant, so D's train-mode BatchNorm over the fake
    # batch normalises round-off (variance far below eps), and D's gradients
    # and statistics change by O(1) with the summation order of the convs
    # (one PyTorch thread or eight); with outputs of O(1) the step is
    # well-conditioned and the tolerances below compare arithmetic
    return create_gan_state(GeneratorConfig(**G_FLAGS, init_scale=1.0),
                            t_cfg=TrainConfig(batch_size=4, **t_kw), seed=seed, device="cpu")


def _jax_state(port, t_cfg):
    gp = jax.tree_util.tree_map(jnp.asarray, state_dict_to_jax_params(port.g.state_dict()))
    dv = jax.tree_util.tree_map(jnp.asarray, state_dict_to_jax_d_vars(port.d.state_dict()))
    tx = jax_make_optimizer(t_cfg)
    return JaxGANState(
        step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=tx.init(gp),
        d_params=dv["params"], d_batch_stats=dv["batch_stats"],
        d_opt=tx.init(dv["params"]), g_ema=gp if t_cfg.ema_decay > 0 else None)


@pytest.fixture(scope="module")
def jax_steps():
    """Each case's JAX jitted step, built once and reused: case -> (fn,
    TrainConfig)."""
    built = {}

    def get(case):
        if case not in built:
            t_kw, l_kw = CASES[case]
            t_cfg = JaxTrainConfig(batch_size=4, **t_kw)
            fn = jax.jit(jax_make_train_step(JaxGenerator(JaxGeneratorConfig(**G_FLAGS)),
                                             JaxDiscriminator(), t_cfg,
                                             JaxLossConfig(**l_kw)))
            built[case] = fn, t_cfg
        return built[case]

    return get


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturbed(state, seed=5):
    """JAX's state with every G and D parameter multiplied by (1 + PERTURB
    * N(0, 1)): the same step on it shows how far round-off-sized changes
    move each result."""
    rs = np.random.RandomState(seed)

    def perturb(tree):
        return jax.tree_util.tree_map(
            lambda a: a * (1 + PERTURB * rs.randn(*a.shape)).astype(np.float32), tree)

    return state.replace(g_params=perturb(state.g_params), d_params=perturb(state.d_params))


def _change(want, other):
    """Elementwise |other - want|, the largest over the perturbed steps when
    ``other`` is a list of them."""
    others = other if isinstance(other, list) else [other]
    return np.max([np.abs(o - want) for o in others], axis=0)


def _tol(want, other, rel):
    """max(rel * range, NOISE_K * the perturbed step's change)."""
    return max(rel * np.abs(want).max(), NOISE_K * _change(want, other).max())


def _check_param(name, got, want, grad, grad_other, lr, leafwise=False):
    """Within TOL_PARAM * lr where |g| > 1e-3 of the largest and the
    perturbed step moved g by less than |g| / NOISE_K (elsewhere Adam's
    ~lr * sign(g) may go either way); with ``leafwise`` that change is the
    largest over the tensor. The share left out is printed."""
    change = _change(grad, grad_other)
    if leafwise:
        change = change.max()
    ok = (np.abs(grad) > 1e-3 * np.abs(grad).max()) & (NOISE_K * change < np.abs(grad))
    print(f"{name}: {100 * (1 - ok.mean()):.2f}% of elements left out")
    err = np.abs(np.asarray(got, np.float64) - want)[ok]
    assert err.max(initial=0.0) <= TOL_PARAM * lr, (name, err.max(), lr)
    return ok


def _compare_step(port, jax_new, jax_other, t_cfg, leafwise=False):
    """Every gradient, parameter and BatchNorm statistic of the port's state
    after one step against JAX's (``jax_other``: JAX's step from perturbed
    weights, or a list of such steps; ``leafwise``: see ``_check_param``).
    Returns G's well-conditioned elements by parameter."""
    ok_g = {}
    b1 = t_cfg.adam_beta1
    others = jax_other if isinstance(jax_other, list) else [jax_other]
    for model, opt, jx, mu, other_mus, to_jax, lr in (
        (port.g, port.g_opt, jax_new.g_params, jax_new.g_opt[0].mu,
         [o.g_opt[0].mu for o in others], state_dict_to_jax_params, t_cfg.learning_rate),
        (port.d, port.d_opt, jax_new.d_params, jax_new.d_opt[0].mu,
         [o.d_opt[0].mu for o in others], lambda sd: state_dict_to_jax_d_vars(sd)["params"],
         t_cfg.learning_rate * t_cfg.d_lr_scale),
    ):
        grads_port = _flat(to_jax({k: opt.state[p]["exp_avg"] / (1 - b1)
                                   for k, p in model.named_parameters()}))
        params_port = _flat(to_jax(dict(model.named_parameters())))
        grads_jax = {k: v / (1 - b1) for k, v in _flat(mu).items()}
        flat_others = [_flat(o) for o in other_mus]
        grads_other = {k: [f[k] / (1 - b1) for f in flat_others] for k in grads_jax}
        params_jax = _flat(jx)
        assert sorted(grads_port) == sorted(grads_jax)
        for k, gj in grads_jax.items():
            tol = _tol(gj, grads_other[k], TOL_GRAD)
            if model is port.d and k == "['linear_2']['bias']":
                # RaGAN compares each logit with the other side's mean, so it
                # does not see a shift of every logit: this gradient is 0 up
                # to round-off
                tol = max(tol, 1e-6)
            assert tol > 0, k
            err = np.abs(grads_port[k] - gj).max()
            assert err <= tol, (f"gradient {k}", err, tol, np.abs(gj).max())
            ok = _check_param(k, params_port[k], params_jax[k], gj, grads_other[k], lr,
                              leafwise)
            if model is port.g:
                ok_g[k] = ok
    stats = _flat(state_dict_to_jax_d_vars(port.d.state_dict())["batch_stats"])
    want = _flat(jax_new.d_batch_stats)
    other = [_flat(o.d_batch_stats) for o in others]
    for k, w in want.items():
        err = np.abs(stats[k] - w).max()
        assert err <= _tol(w, [o[k] for o in other], TOL_STATS), (k, err)
    return ok_g


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(jax_steps, case):
    t_kw, l_kw = CASES[case]
    fn, jt_cfg = jax_steps(case)
    port = _port_state(t_kw)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_state = _jax_state(port, jt_cfg)
    jax_new, jax_metrics = fn(jax_state, jbatch)
    jax_other, other_metrics = fn(_perturbed(jax_state), jbatch)
    t_cfg = TrainConfig(batch_size=4, **t_kw)
    port, metrics = make_train_step(t_cfg, LossConfig(**l_kw))(
        port, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert port.step == int(jax_new.step) == 1
    for name in METRICS:
        want = float(getattr(jax_metrics, name))
        err = abs(float(getattr(metrics, name)) - want)
        assert err <= _tol(np.array([want]), np.array([float(getattr(other_metrics, name))]),
                           RTOL_METRICS), (name, err, want)
    ok_g = _compare_step(port, jax_new, jax_other, t_cfg)
    if t_cfg.ema_decay > 0:
        ema_jax = _flat(jax_new.g_ema)
        ema_port = _flat(state_dict_to_jax_params(port.g_ema))
        assert sorted(ema_port) == sorted(ema_jax) == sorted(ok_g)
        for k, want in ema_jax.items():
            err = np.abs(ema_port[k] - want)[ok_g[k]]
            assert err.max(initial=0.0) <= TOL_PARAM * t_cfg.learning_rate, k


def test_eval_step_matches_jax():
    port = _port_state({})
    batch = _batch(1)
    jt_cfg = JaxTrainConfig(batch_size=4)
    want = jax.jit(jax_make_eval_step(JaxGenerator(JaxGeneratorConfig(**G_FLAGS)),
                                      JaxDiscriminator(), JaxLossConfig()))(
        _jax_state(port, jt_cfg), {k: jnp.asarray(v) for k, v in batch.items()})
    stats = {k: v.clone() for k, v in port.d.named_buffers()}
    got = make_eval_step()(port, {k: torch.from_numpy(v) for k, v in batch.items()})
    for name in METRICS:
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=RTOL_METRICS, err_msg=name)
    for k, v in port.d.named_buffers():  # eval mode reads the statistics only
        assert torch.equal(v, stats[k]), k


@pytest.mark.parametrize("kw", [
    dict(),
    dict(lr_schedule="cosine", lr_total_steps=50, lr_warmup_steps=10, lr_final_scale=0.1),
    dict(lr_schedule="cosine", lr_total_steps=40, lr_final_scale=0.05),
])
def test_make_lr_matches_optax(kw):
    want, got = jax_make_lr(JaxTrainConfig(**kw)), make_lr(TrainConfig(**kw))
    for step in range(0, 60, 3):
        w = float(want(step)) if callable(want) else want
        g = got(step) if callable(got) else got
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12, err_msg=str(step))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(lr_schedule="cosine", lr_total_steps=10, lr_warmup_steps=2, lr_final_scale=0.1),
])
def test_adam_matches_optax(kw):
    # three steps on the same gradients, the rate set per step from make_lr
    # at the count before the update, as optax reads its schedule
    from deepbedmap_tpu_torch.train.state import learning_rate, set_learning_rate

    rs = np.random.RandomState(5)
    p0 = [rs.randn(7, 5).astype(np.float32) * 0.1, rs.randn(3).astype(np.float32) * 0.1]
    grads = [[rs.randn(*p.shape).astype(np.float32) * 10.0 ** -s for p in p0]
             for s in range(3)]
    t_cfg, jt_cfg = TrainConfig(**kw), JaxTrainConfig(**kw)
    tx = jax_make_optimizer(jt_cfg)
    jp = [jnp.asarray(p) for p in p0]
    js = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer(t_cfg, tp)
    for step, gs in enumerate(grads):
        updates, js = tx.update([jnp.asarray(g) for g in gs], js, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        lr = learning_rate(t_cfg, step)
        set_learning_rate(opt, lr)
        opt.step()
        for i, (p, w, g) in enumerate(zip(tp, jp, gs)):
            _check_param(f"step {step} param {i}", p.detach().numpy(), np.asarray(w), g, g,
                         max(lr, 1e-12))


def test_split_and_epoch_batches_match_jax():
    for n, frac, seed in ((3826, 0.95, 42), (64, 0.9, 7)):
        tr, dev = train_dev_split(n, frac, seed)
        jtr, jdev = jax_dataset.train_dev_split(n, frac, seed)
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(dev, jdev)
        rs, jrs = np.random.RandomState(42), np.random.RandomState(42)
        for _ in range(2):  # two epochs from one RandomState
            np.testing.assert_array_equal(epoch_batches(tr, 32, rs),
                                          jax_dataset.epoch_batches(jtr, 32, jrs))
    assert train_dev_split(3826)[0].shape == (3634,)
    with pytest.raises(ValueError):
        epoch_batches(np.arange(3), 4, np.random.RandomState(0))


def test_dataset_matches_jax(tmp_path):
    ds = TileDataset.synthetic(5, seed=3, device="cpu")
    jds = jax_dataset.TileDataset.synthetic(5, seed=3)
    for k in jax_dataset.ARRAY_KEYS:
        np.testing.assert_array_equal(ds.arrays[k].numpy(), np.asarray(jds.arrays[k]))
    idx = np.array([4, 0, 2])
    for k, v in ds.take(idx).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jds.take(jnp.asarray(idx))[k]))
    h = ds.save_npy_dir(str(tmp_path))
    assert h == jds.save_npy_dir(str(tmp_path / "jax"))
    back = TileDataset.load_npy_dir(str(tmp_path), expected_hash=h, device="cpu")
    assert content_hash({k: v.numpy().transpose(0, 3, 1, 2) for k, v in back.arrays.items()}) == h
    with pytest.raises(ValueError):
        TileDataset.load_npy_dir(str(tmp_path), expected_hash="0" * 64, device="cpu")
    # the package route restores the same arrays, each blob's sha256 checked
    registry = str(tmp_path / "registry")
    files = {f"{k}_data.npy": str(tmp_path / f"{k}.npy") for k in jax_dataset.ARRAY_KEYS}
    pkg_hash = packaging.push("deepbedmap/model/train", files, registry)
    packed = TileDataset.from_package(registry, pkg_hash=pkg_hash, device="cpu")
    for k in jax_dataset.ARRAY_KEYS:
        np.testing.assert_array_equal(packed.arrays[k].numpy(), ds.arrays[k].numpy())


def test_bf16_train_step_matches_jax(jax_steps):
    # bf16 training is GeneratorConfig(compute_dtype='bfloat16'), held as the
    # float32 step is, against the largest change over three perturbation
    # draws: a bf16 forward's round-off is coarser, and one draw's change
    # ranged over 0.4-2x the port's difference from JAX in the generator loss
    # (four draws measured), so a single draw under- or over-states it.
    # TrainConfig.compute_dtype is inert, as in JAX. The parameters and both
    # Adams' state stay float32. G's gradients must lie nearer JAX's bf16
    # step than JAX's bf16 step lies to its float32 one: the port took the
    # bf16 path. A bf16 rounding that flips moves the sums of a whole
    # receptive field, so an element's round-off is its tensor's: Adam's
    # update is held where |g| exceeds NOISE_K times the tensor's largest
    # perturbed change (leafwise)
    flags = dict(G_FLAGS, compute_dtype="bfloat16")
    t_cfg = TrainConfig(batch_size=4, compute_dtype="bfloat16")
    port = create_gan_state(GeneratorConfig(**flags, init_scale=1.0), t_cfg=t_cfg, seed=0,
                            device="cpu")
    jt_cfg = JaxTrainConfig(batch_size=4, compute_dtype="bfloat16")
    fn = jax.jit(jax_make_train_step(JaxGenerator(JaxGeneratorConfig(**flags)),
                                     JaxDiscriminator(), jt_cfg, JaxLossConfig()))
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_state = _jax_state(port, jt_cfg)
    jax_new, jax_metrics = fn(jax_state, jbatch)
    others = [fn(_perturbed(jax_state, seed), jbatch) for seed in (5, 6, 7)]
    fn32, _ = jax_steps("default")
    jax_new32, _ = fn32(jax_state, jbatch)
    port, metrics = make_train_step(t_cfg, LossConfig())(
        port, {k: torch.from_numpy(v) for k, v in batch.items()})
    for model, opt in ((port.g, port.g_opt), (port.d, port.d_opt)):
        for p in model.parameters():
            assert p.dtype == torch.float32
            assert all(v.dtype == torch.float32 for v in opt.state[p].values()
                       if torch.is_tensor(v) and v.is_floating_point())
    for name in METRICS:
        want = float(getattr(jax_metrics, name))
        err = abs(float(getattr(metrics, name)) - want)
        assert err <= _tol(np.array([want]), [np.array([float(getattr(m, name))])
                                              for _, m in others], RTOL_METRICS), (name, err)
    _compare_step(port, jax_new, [o for o, _ in others], t_cfg, leafwise=True)
    b1 = t_cfg.adam_beta1
    g_port = _flat(state_dict_to_jax_params(
        {k: port.g_opt.state[p]["exp_avg"] / (1 - b1) for k, p in port.g.named_parameters()}))
    g16 = {k: v / (1 - b1) for k, v in _flat(jax_new.g_opt[0].mu).items()}
    g32 = {k: v / (1 - b1) for k, v in _flat(jax_new32.g_opt[0].mu).items()}
    d_port = sum(np.abs(g_port[k] - g16[k]).sum() for k in g16)
    d_jax = sum(np.abs(g16[k] - g32[k]).sum() for k in g16)
    print(f"G's gradients: port vs JAX-bf16 {d_port:.3e}, JAX-bf16 vs JAX-fp32 {d_jax:.3e}, "
          f"ratio {d_port / d_jax:.3g}")
    assert d_port < d_jax


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def test_instance_noise_is_deterministic_and_touches_only_d():
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    noisy_cfg = LossConfig(d_instance_noise=0.5, instance_noise_seed=3,
                           instance_noise_half_life_steps=4.0)
    runs = []
    for loss_cfg in (noisy_cfg, noisy_cfg, LossConfig()):
        state = _port_state({})
        step = make_train_step(TrainConfig(batch_size=4), loss_cfg)
        state, m = step(state, batch)
        state, m = step(state, batch)
        runs.append((_params(state.g), _params(state.d), dict(state.d.named_buffers()), m))
    (g1, d1, s1, m1), (g2, d2, s2, m2), (g0, d0, s0, m0) = runs
    for a, b in ((g1, g2), (d1, d2), (s1, s2)):  # a step is a function of (state, batch)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert float(m1.discriminator_loss) == float(m2.discriminator_loss)
    # the detached adversarial term gives G no gradient through D, so G's
    # update does not see the noise: only D's inputs carry it
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
    assert any(not torch.equal(d1[k], d0[k]) for k in d0)
    assert any(not torch.equal(s1[k], s0[k]) for k in s0)
    assert float(m1.generator_psnr) == float(m0.generator_psnr)


def test_remat_leaves_gradients_unchanged():
    from deepbedmap_tpu_torch.models import build_generator

    batch = _batch(3)
    xs = [torch.from_numpy(batch[k]) for k in ("X", "W1", "W2", "W3")]
    grads = []
    for remat in (False, True):
        g = build_generator(GeneratorConfig(num_residual_blocks=2, remat=remat), seed=1,
                            device="cpu")
        loss = (g(*xs) - torch.from_numpy(batch["Y"])).abs().mean()
        grads.append(torch.autograd.grad(loss, list(g.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fit_history_equals_steps_by_hand():
    ds = TileDataset.synthetic(13, seed=1, device="cpu")  # 9 train tiles, 4 dev
    t_cfg = TrainConfig(batch_size=4, train_fraction=0.7, epochs=2)
    stops = []
    state, history = fit(_port_state({}), ds, t_cfg,
                         callback=lambda e, r: stops.append(e) or False)
    assert stops == [0, 1] and [r["epoch"] for r in history] == [0, 1]

    by_hand = _port_state({})
    train_idx, dev_idx = train_dev_split(13, 0.7, 42)
    rs = np.random.RandomState(42)
    dev_batches = epoch_batches(dev_idx, 4, np.random.RandomState(42))
    step, ev = make_train_step(t_cfg), make_eval_step()
    for epoch in range(2):
        ms = [step(by_hand, ds.take(idx))[1]
              for idx in epoch_batches(train_idx, 4, rs)]
        vs = [ev(by_hand, ds.take(idx)) for idx in dev_batches]
        want = {"epoch": epoch, **_metrics_to_host(ms, ""), **_metrics_to_host(vs, "val_")}
        assert history[epoch] == want
    assert state.step == by_hand.step == 4
    for k, v in _params(state.g).items():
        assert torch.equal(v, _params(by_hand.g)[k]), k

    # the callback stops the run
    _, short = fit(_port_state({}), ds, t_cfg, callback=lambda e, r: True)
    assert len(short) == 1
    # make_epoch_fns: the same loop, metrics per step
    train_fn, eval_fn = make_epoch_fns(ds, t_cfg)
    _, ms = train_fn(_port_state({}), epoch_batches(train_idx, 4, np.random.RandomState(42)))
    assert len(ms) == 2 and len(eval_fn(state, dev_batches)) == 1


def test_checkpoint_round_trip(tmp_path):
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    t_cfg = TrainConfig(batch_size=4, ema_decay=0.5)
    step = make_train_step(t_cfg)
    state, _ = step(_port_state({"ema_decay": 0.5}), batch)
    path = str(tmp_path / "run" / "ck.pt")
    save_checkpoint(state, path)
    assert os.listdir(tmp_path / "run") == ["ck.pt"]  # no temporary left behind
    back = restore_checkpoint(path, device="cpu")
    assert back.step == 1 and checkpoint_has_ema(path)
    for a, b in ((state.g, back.g), (state.d, back.d)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    # resuming is exact: the next step from both states agrees bit for bit
    s1, m1 = step(state, batch)
    s2, m2 = step(back, batch)
    for k, v in _params(s1.g).items():
        assert torch.equal(v, _params(s2.g)[k]), k
    for k, v in _params(s1.d).items():
        assert torch.equal(v, _params(s2.d)[k]), k
    assert float(m1.generator_loss) == float(m2.generator_loss)
    for k, v in s1.g_ema.items():
        assert torch.equal(v, s2.g_ema[k]), k


def test_from_checkpoint_prefers_ema(tmp_path):
    batch = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    paths = {}
    for ema in (0.0, 0.5):
        t_cfg = TrainConfig(batch_size=4, ema_decay=ema)
        state, _ = make_train_step(t_cfg)(_port_state({"ema_decay": ema}), batch)
        paths[ema] = (str(tmp_path / f"ck{ema}"), state)
        save_checkpoint(state, paths[ema][0])
    cfg = GeneratorConfig(**G_FLAGS)
    path, state = paths[0.5]
    assert checkpoint_has_ema(path) and not checkpoint_has_ema(paths[0.0][0])
    for use_ema, want in ((True, state.g_ema), (False, dict(state.g.named_parameters()))):
        sd = DeepBedMap.from_checkpoint(path, cfg, use_ema=use_ema, device="cpu").model.state_dict()
        for k, v in want.items():
            assert torch.equal(sd[k], v.detach()), k
    assert any(not torch.equal(state.g_ema[k], p.detach())
               for k, p in state.g.named_parameters())
    path0, state0 = paths[0.0]  # no EMA kept: the trained weights
    sd = DeepBedMap.from_checkpoint(path0, cfg, device="cpu").model.state_dict()
    for k, p in state0.g.named_parameters():
        assert torch.equal(sd[k], p.detach()), k
    with pytest.raises(FileNotFoundError):
        DeepBedMap.from_checkpoint(str(tmp_path / "missing"), cfg, device="cpu")


def test_orbax_directory_raises(tmp_path):
    orbax = tmp_path / "orbax_ck"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for fn in (lambda: restore_checkpoint(str(orbax), device="cpu"),
               lambda: checkpoint_has_ema(str(orbax)),
               lambda: DeepBedMap.from_checkpoint(str(orbax), device="cpu")):
        with pytest.raises(ValueError, match="from_chainer_npz"):
            fn()

"""The GAN's train and eval steps.

Counterpart of ``deepbedmap_tpu/train/steps.py``. The reference runs the D
update, then the G update, per minibatch (trainer, srgan_train.py:1286-1308);
JAX fuses both into one jitted function. Here ``train_step(state, batch)``
updates ``state`` in place and returns it with the step's metrics, as 0-dim
tensors on the state's device (no host synchronisation per step).

Semantics kept from the reference, as JAX keeps them:
- D update: G forward with no gradient; optionally instance noise on the
  real and fake tiles D sees; D in train mode on real, then on fake: two
  forwards in sequence, so the BatchNorm statistics update twice
  (srgan_train.py:1131-1146); RaGAN loss and accuracy; Adam.
- G update: with D's *post-update* parameters and statistics, D in eval mode
  (srgan_train.py:1228-1229). The adversarial term takes detached fake
  logits and literal ones as real logits (srgan_train.py:1229-1233), so it
  carries no gradient, unless ``LossConfig.differentiable_adversarial``.
  PSNR and SSIM are taken on the detached fake. Gradients are taken with
  ``torch.autograd.grad`` over G's parameters only, and each optimizer gets
  its gradients set just before its step and cleared after it, so nothing
  reaches D's parameters from the G update, and no stale ``.grad`` is left.
- then the optional EMA of G's weights, as JAX computes it:
  ``decay * ema + (1 - decay) * param``.

The one stated deviation from JAX: instance noise is drawn from a
``torch.Generator`` seeded from (``instance_noise_seed``, step) on the
tiles' device; JAX draws it from ``fold_in(PRNGKey(seed), step)``, which the
port cannot reproduce. The sigma and its half-life decay are JAX's, and a
step stays a deterministic function of (state, batch).

``make_train_step(..., group=)`` is the step of one rank of a data-parallel
run (``parallel.make_sharded_train_step``): the batch is this rank's rows of
the global batch, and every batch-coupled quantity is the global batch's, as
GSPMD makes it in JAX's sharded step. D's train-mode BatchNorm statistics,
RaGAN's relativistic means, the accuracy and PSNR's MSE go through
``ops.collectives.global_mean``; each rank draws the global batch's instance
noise and keeps its own rows; the parameter gradients are all-reduced to
their mean before Adam; the reported losses and SSIM are the ranks' mean.
``group=None`` is the single-device step, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deepbedmap_tpu_torch.config import LossConfig, TrainConfig
from deepbedmap_tpu_torch.models.discriminator import Discriminator
from deepbedmap_tpu_torch.models.generator import Generator
from deepbedmap_tpu_torch.ops.collectives import global_mean
from deepbedmap_tpu_torch.ops.losses import binary_accuracy, generator_loss, ragan_loss
from deepbedmap_tpu_torch.ops.metrics import psnr
from deepbedmap_tpu_torch.ops.ssim import ssim
from deepbedmap_tpu_torch.train.state import GANState, learning_rate, set_learning_rate
from deepbedmap_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass
class StepMetrics:
    """The five metric series the reference logs (srgan_train.py:1296-1327)."""

    discriminator_loss: torch.Tensor
    discriminator_accu: torch.Tensor
    generator_loss: torch.Tensor
    generator_psnr: torch.Tensor
    generator_ssim: torch.Tensor


Batch = Dict[str, torch.Tensor]  # X, W1, W2, W3, Y, all NHWC


def _accuracy(real_logits: torch.Tensor, fake_logits: torch.Tensor,
              group=None) -> torch.Tensor:
    return binary_accuracy(
        torch.cat([real_logits, fake_logits]),
        torch.cat([torch.ones_like(real_logits), torch.zeros_like(fake_logits)]),
        group,
    )


def _generate(g_model: Generator, batch: Batch) -> torch.Tensor:
    return g_model(batch["X"], batch["W1"], batch["W2"], batch["W3"])


def make_d_loss_fn(d_model: Discriminator, group=None):
    """``d_loss_fn(fake, real) -> (loss, accuracy)``: two train-mode D
    forwards, real first, each updating the BatchNorm statistics."""

    def d_loss_fn(fake: torch.Tensor, real: torch.Tensor):
        d_model.train()
        real_logits = d_model(real, group)
        fake_logits = d_model(fake, group)
        loss = ragan_loss(real_logits, fake_logits, group=group)
        return loss, _accuracy(real_logits.detach(), fake_logits.detach(), group)

    return d_loss_fn


def make_g_loss_fn(
    g_model: Generator, d_model: Discriminator, loss_cfg: LossConfig = LossConfig(),
    group=None,
):
    """``g_loss_fn(batch) -> (total, (psnr, ssim))`` with D in eval mode."""

    def g_loss_fn(batch: Batch):
        d_model.eval()
        fake = _generate(g_model, batch)
        if not loss_cfg.differentiable_adversarial:
            with torch.no_grad():
                fake_logits = d_model(fake)
            real_logits = torch.ones_like(fake_logits)
        else:
            fake_logits = d_model(fake)
            real_logits = d_model(batch["Y"])
        terms = generator_loss(
            y_pred=fake,
            y_true=batch["Y"],
            fake_logits=fake_logits,
            real_logits=real_logits,
            x_topo=batch["X"][:, 1:-1, 1:-1, :],
            cfg=loss_cfg,
            group=group,
        )
        with torch.no_grad():
            g_psnr = psnr(fake, batch["Y"], group=group)
            g_ssim = ssim(fake, batch["Y"], loss_cfg.ssim_window)
        return terms.total, (g_psnr, g_ssim)

    return g_loss_fn


def _instance_noise(loss_cfg: LossConfig, step: int, fake: torch.Tensor,
                    real: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian noise of JAX's sigma (halving every half-life) on both
    tiles, from a ``torch.Generator`` seeded from (``instance_noise_seed``,
    step). Over ``group`` the noise of the global batch is drawn and this
    rank's rows of it kept, so the step does not depend on the rank count."""
    sigma = loss_cfg.d_instance_noise
    if loss_cfg.instance_noise_half_life_steps > 0:
        sigma = sigma * 0.5 ** (step / loss_cfg.instance_noise_half_life_steps)
    seed = np.random.SeedSequence([loss_cfg.instance_noise_seed, step]).generate_state(1)
    gen = torch.Generator(device=fake.device).manual_seed(int(seed[0]))
    n, r = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))

    def noise(t: torch.Tensor) -> torch.Tensor:
        b = t.shape[0]
        full = torch.randn((n * b,) + tuple(t.shape[1:]), generator=gen, device=t.device)
        return full[r * b : (r + 1) * b]

    fake = fake + sigma * noise(fake)
    real = real + sigma * noise(real)
    return fake, real


def _mean_grads(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The ranks' mean of each gradient, in one all-reduce of a flat buffer."""
    if group is None:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def apply_gradients(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], lr: float) -> None:
    """One optimizer step at rate ``lr`` on exactly ``grads``: set on the
    parameters, stepped, cleared."""
    for p, g in zip(params, grads):
        p.grad = g
    set_learning_rate(opt, lr)
    opt.step()
    for p in params:
        p.grad = None


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: torch.nn.Module, decay: float) -> None:
    """ema = decay * ema + (1 - decay) * param for every parameter, in JAX's
    order of operations, as three multi-tensor launches."""
    names, params = zip(*model.named_parameters())
    avg = [ema[n] for n in names]
    torch._foreach_mul_(avg, decay)
    torch._foreach_add_(avg, torch._foreach_mul(params, 1.0 - decay))


def make_train_step(
    t_cfg: TrainConfig = TrainConfig(),
    loss_cfg: LossConfig = LossConfig(),
    group=None,
) -> Callable[[GANState, Batch], Tuple[GANState, StepMetrics]]:
    """The D+G train step (module docstring); it updates the state in place.
    ``group``: the data-parallel reduction group (None: one device).
    Telemetry (``utils.profiling``): spans ``train.d_update``,
    ``train.g_update``, ``train.ema``; counters ``train.steps``,
    ``train.tiles`` (this rank's rows)."""

    def train_step(state: GANState, batch: Batch) -> Tuple[GANState, StepMetrics]:
        g, d = state.g, state.d
        count("train.steps")
        count("train.tiles", batch["Y"].shape[0])
        # ---- discriminator update (G frozen) ----
        with span("train.d_update"):
            with torch.no_grad():
                fake = _generate(g, batch)
            real = batch["Y"]
            if loss_cfg.d_instance_noise > 0:
                fake, real = _instance_noise(loss_cfg, state.step, fake, real, group)
            d_params = list(d.parameters())
            d_loss, d_accu = make_d_loss_fn(d, group)(fake, real)
            d_grads = _mean_grads(torch.autograd.grad(d_loss, d_params), group)
            apply_gradients(state.d_opt, d_params, d_grads,
                            learning_rate(t_cfg, state.step, t_cfg.d_lr_scale))

        # ---- generator update (D frozen, post-update D) ----
        with span("train.g_update"):
            g_params = list(g.parameters())
            g_loss, (g_psnr, g_ssim) = make_g_loss_fn(g, d, loss_cfg, group)(batch)
            g_grads = _mean_grads(torch.autograd.grad(g_loss, g_params), group)
            apply_gradients(state.g_opt, g_params, g_grads, learning_rate(t_cfg, state.step))

        if t_cfg.ema_decay > 0:
            with span("train.ema"):
                ema_update(state.g_ema, g, t_cfg.ema_decay)
        state.step += 1
        d_loss, g_loss = d_loss.detach(), g_loss.detach()
        if group is not None:
            d_loss, g_loss, g_ssim = global_mean(torch.stack([d_loss, g_loss, g_ssim]),
                                                 group).unbind()
        return state, StepMetrics(d_loss, d_accu, g_loss, g_psnr, g_ssim)

    return train_step


def make_eval_step(
    loss_cfg: LossConfig = LossConfig(),
) -> Callable[[GANState, Batch], StepMetrics]:
    """The same metrics with no update: D in eval mode throughout
    (srgan_train.py:1311-1327). One call is the telemetry span
    ``train.eval_step``."""

    @torch.no_grad()
    def eval_step(state: GANState, batch: Batch) -> StepMetrics:
        with span("train.eval_step"):
            state.d.eval()
            fake = _generate(state.g, batch)
            real_logits = state.d(batch["Y"])
            fake_logits = state.d(fake)
            terms = generator_loss(
                y_pred=fake,
                y_true=batch["Y"],
                fake_logits=fake_logits,
                real_logits=torch.ones_like(fake_logits),
                x_topo=batch["X"][:, 1:-1, 1:-1, :],
                cfg=loss_cfg,
            )
            return StepMetrics(
                ragan_loss(real_logits, fake_logits),
                _accuracy(real_logits, fake_logits),
                terms.total,
                psnr(fake, batch["Y"]),
                ssim(fake, batch["Y"], loss_cfg.ssim_window),
            )

    return eval_step

"""The GAN's training state.

Counterpart of ``deepbedmap_tpu/train/state.py``. The reference holds two
Chainer links and two Adam optimizers (compile_srgan_model,
srgan_train.py:1014-1055); JAX holds them as one pytree. Here ``GANState``
holds the step count, the generator and the discriminator (its BatchNorm
statistics are the discriminator's buffers, ``d.named_buffers()``), their two ``torch.optim.Adam``
and the optional EMA of the generator's weights. PyTorch updates it in
place.

Adam is optax's ``adam`` as the reference configures it (alpha = lr, eps 1e-8,
the default betas): both compute m_hat / (sqrt(v_hat) + eps), with other
rounding. Like optax, the schedule is read at the count *before* the update,
so the first update takes ``lr(0)`` (0 under a warmup). The learning rate is
set on the optimizer before each step (``set_learning_rate``); the
discriminator's is scaled by ``TrainConfig.d_lr_scale``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import torch

from deepbedmap_tpu_torch.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    TrainConfig,
)
from deepbedmap_tpu_torch.models.api import build_discriminator, build_generator
from deepbedmap_tpu_torch.models.discriminator import Discriminator
from deepbedmap_tpu_torch.models.generator import Generator


@dataclasses.dataclass
class GANState:
    step: int
    g: Generator
    g_opt: torch.optim.Adam
    d: Discriminator
    d_opt: torch.optim.Adam
    # EMA of the generator's parameters by name (None unless
    # TrainConfig.ema_decay > 0); inference prefers it
    g_ema: Optional[Dict[str, torch.Tensor]] = None


def make_lr(cfg: TrainConfig) -> Union[float, Callable[[int], float]]:
    """The reference's constant alpha, or optax's
    ``warmup_cosine_decay_schedule`` written out: linear warmup from 0 over
    ``lr_warmup_steps`` (from ``learning_rate`` when there is none), then
    cosine decay to ``learning_rate * lr_final_scale`` at
    ``lr_total_steps``."""
    if cfg.lr_schedule == "constant":
        return cfg.learning_rate
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.lr_total_steps <= 0:
        raise ValueError("cosine schedule needs lr_total_steps")
    peak, warmup = cfg.learning_rate, cfg.lr_warmup_steps
    init = 0.0 if warmup else peak
    end = peak * cfg.lr_final_scale
    alpha = 0.0 if peak == 0.0 else end / peak
    decay_steps = cfg.lr_total_steps - warmup
    if decay_steps <= 0:
        raise ValueError("cosine schedule needs lr_total_steps > lr_warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup:  # optax's linear_schedule (a constant when warmup is 0)
            return (init - peak) * (1 - count / warmup) + peak
        t = min(count - warmup, decay_steps)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


def learning_rate(cfg: TrainConfig, step: int, lr_scale: float = 1.0) -> float:
    """The learning rate of the update made at ``step`` (updates so far)."""
    lr = make_lr(cfg)
    return (lr(step) if callable(lr) else lr) * lr_scale


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """Adam with the reference's betas and eps; its rate is set before each
    step (``set_learning_rate``)."""
    return torch.optim.Adam(
        params, lr=cfg.learning_rate, betas=(cfg.adam_beta1, cfg.adam_beta2),
        eps=cfg.adam_eps,
    )


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def create_gan_state(
    g_cfg: GeneratorConfig = GeneratorConfig(),
    d_cfg: DiscriminatorConfig = DiscriminatorConfig(),
    t_cfg: TrainConfig = TrainConfig(),
    seed: Optional[int] = None,
    device="cuda",
) -> GANState:
    """Seeded generator (``seed``) and discriminator (``seed + 1``), as in
    JAX, with zeroed Adam states, on ``device`` (the card unless the caller
    asks for the CPU). ``seed`` defaults to ``t_cfg.seed``. On a CUDA
    device, widths that a forced (``'always'``) kernel does not take raise
    ``NotImplementedError`` before anything is built (``build_generator``).
    A ``GeneratorConfig(compute_dtype='bfloat16')`` trains with float32
    parameters and Adam states; ``t_cfg.compute_dtype`` is inert, as in
    JAX."""
    seed = t_cfg.seed if seed is None else seed
    g = build_generator(g_cfg, seed=seed, device=device)
    d = build_discriminator(d_cfg, seed=seed + 1, device=device)
    g_ema = None
    if t_cfg.ema_decay > 0:
        g_ema = {k: p.detach().clone() for k, p in g.named_parameters()}
    return GANState(
        step=0,
        g=g,
        g_opt=make_optimizer(t_cfg, g.parameters()),
        d=d,
        d_opt=make_optimizer(t_cfg, d.parameters()),
        g_ema=g_ema,
    )

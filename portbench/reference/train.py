"""The plain GAN train step of DeepBedMap: the yardstick of the training cell.

Plain PyTorch, importing nothing of the program, written from the published
training (srgan_train.py:591-1329): per minibatch, the discriminator update
and then the generator update.

- D: ten 3x3/4x4 convs with padding 1 (a bias on the first only), after
  convs 1-9 a batch norm in flax's form (the batch's biased variance
  E[x^2] - E[x]^2 clipped at 0, eps 1e-5; running statistics keep 0.9 of
  their old value and take that variance), LeakyReLU(0.2) after each; the
  map flattened in (H, W, C) order, dense 100, LeakyReLU, dense 1.
- D update: G's output without gradient; D in training mode on the real
  tiles, then on the fakes (the statistics update twice); the relativistic
  average loss (sigmoid cross-entropy in Chainer's stable form); Adam.
- G update: D after its update, in evaluation mode; the loss 1e-2 L1 +
  2e-2 adversarial (on detached fake logits against ones, the targets
  swapped: no gradient) + 2e-3 L1 of the 4x4 mean-pooled prediction against
  X without its outer ring + 5.25 (1 - SSIM) (uniform 9x9 window, VALID,
  C1 = 1e-4, C2 = 9e-4); Adam.
- the dev evaluation: both losses with no update, D in evaluation mode.
- Adam: m, v with betas (0.9, 0.999), bias-corrected, eps 1e-8 added to
  sqrt(v_hat), at the configured rate.

`precision` rounds every product's multiplicands as the generator's does
(straight through for the gradients).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import generator as G
from portbench.reference.generator import lrelu, round_to

D_CHANNELS = (64, 64, 128, 128, 128, 256, 256, 512, 512, 512)
D_KERNELS = (3, 4, 3, 4, 3, 4, 3, 4, 3, 4)
D_STRIDES = (1, 2, 1, 2, 1, 2, 1, 2, 1, 2)
BN_EPS, BN_MOMENTUM = 1e-5, 0.9
WEIGHTS = {"content": 1e-2, "adversarial": 2e-2, "topographic": 2e-3, "structural": 5.25}
SSIM_WINDOW = 9
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def d_param_spec(hr: int = 36, fc: int = 100) -> List[Tuple[str, tuple, object]]:
    """(name, shape, fan_in or the constant it starts at) of D's parameters
    and statistics, by the program's names."""
    spec, c_in, px = [], 1, hr
    for i, (c, k, s) in enumerate(zip(D_CHANNELS, D_KERNELS, D_STRIDES)):
        spec.append((f"conv_layer{i}.weight", (c, c_in, k, k), c_in * k * k))
        if i == 0:
            spec.append(("conv_layer0.bias", (c,), 0.0))
        else:
            spec += [(f"batch_norm{i}.scale", (c,), 1.0), (f"batch_norm{i}.bias", (c,), 0.0),
                     (f"batch_norm{i}.mean", (c,), 0.0), (f"batch_norm{i}.var", (c,), 1.0)]
        c_in, px = c, (px + 2 - k) // s + 1
    spec += [("linear_1.weight", (fc, px * px * c_in), px * px * c_in),
             ("linear_1.bias", (fc,), 0.0), ("linear_2.weight", (1, fc), fc),
             ("linear_2.bias", (1,), 0.0)]
    return spec


STATISTICS = ("mean", "var")


def is_statistic(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in STATISTICS and name.startswith("batch_norm")


def discriminator(p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
                  precision: str = "fp32") -> torch.Tensor:
    """NCHW tiles -> (N, 1) logits; in training mode the running statistics
    in ``p`` are updated in place."""
    a = x
    for i, s in enumerate(D_STRIDES):
        a = F.conv2d(round_to(a, precision), round_to(p[f"conv_layer{i}.weight"], precision),
                     p["conv_layer0.bias"] if i == 0 else None, stride=s, padding=1)
        if i > 0:
            name = f"batch_norm{i}"
            if train:
                mean = a.mean((0, 2, 3))
                var = torch.clamp((a * a).mean((0, 2, 3)) - mean * mean, min=0.0)
                with torch.no_grad():
                    p[f"{name}.mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                    p[f"{name}.var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
            else:
                mean, var = p[f"{name}.mean"], p[f"{name}.var"]
            a = (a - mean[:, None, None]) * (torch.rsqrt(var + BN_EPS)
                                             * p[f"{name}.scale"])[:, None, None] \
                + p[f"{name}.bias"][:, None, None]
        a = lrelu(a)
    a = a.permute(0, 2, 3, 1).reshape(a.shape[0], -1)
    a = lrelu(F.linear(round_to(a, precision), round_to(p["linear_1.weight"], precision),
                       p["linear_1.bias"]))
    return F.linear(round_to(a, precision), round_to(p["linear_2.weight"], precision),
                    p["linear_2.bias"])


def sigmoid_ce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(-(logits * (target - (logits >= 0).float())
                        - torch.log1p(torch.exp(-logits.abs()))))


def ragan(real: torch.Tensor, fake: torch.Tensor, real_target: float = 1.0,
          fake_target: float = 0.0) -> torch.Tensor:
    return sigmoid_ce(real - fake.mean(), real_target) + sigmoid_ce(fake - real.mean(),
                                                                    fake_target)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    k = SSIM_WINDOW
    mu_a, mu_b = F.avg_pool2d(a, k, 1), F.avg_pool2d(b, k, 1)
    var_a = F.avg_pool2d(a * a, k, 1) - mu_a * mu_a
    var_b = F.avg_pool2d(b * b, k, 1) - mu_b * mu_b
    cov = F.avg_pool2d(a * b, k, 1) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean((2 * mu_a * mu_b + c1) * (2 * cov + c2)
                      / ((mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)))


class Adam:
    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = BETAS
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(self.lr * (m / (1 - b1 ** self.t))
                   / (torch.sqrt(v / (1 - b2 ** self.t)) + ADAM_EPS))


class Trainer:
    """The state of a training run: G's and D's parameters and D's
    statistics (by the program's names, copied), and the two Adams."""

    def __init__(self, g: Dict[str, torch.Tensor], d: Dict[str, torch.Tensor], lr: float,
                 blocks: int, precision: str = "fp32"):
        self.g = {k: v.detach().clone().requires_grad_(True) for k, v in g.items()}
        self.d = {k: v.detach().clone().requires_grad_(not is_statistic(k))
                  for k, v in d.items()}
        self.d_names = [k for k in self.d if not is_statistic(k)]
        self.g_opt = Adam(list(self.g.values()), lr)
        self.d_opt = Adam([self.d[k] for k in self.d_names], lr)
        self.blocks, self.precision = blocks, precision

    def generate(self, batch):
        return G.generator(self.g, batch["X"], batch["W1"], batch["W2"], batch["W3"],
                           blocks=self.blocks, precision=self.precision)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One D update then one G update on NCHW ``batch`` (X, W1, W2, W3, Y);
        returns both losses and the gradients each Adam took."""
        with torch.no_grad():
            fake = self.generate(batch)
        real_logits = discriminator(self.d, batch["Y"], True, self.precision)
        fake_logits = discriminator(self.d, fake, True, self.precision)
        d_loss = ragan(real_logits, fake_logits)
        d_params = [self.d[k] for k in self.d_names]
        d_grads = torch.autograd.grad(d_loss, d_params)
        self.d_opt.step(d_params, d_grads)

        fake = self.generate(batch)
        with torch.no_grad():
            fake_logits = discriminator(self.d, fake, False, self.precision)
        g_loss = self.g_loss(fake, batch, fake_logits)
        g_params = list(self.g.values())
        g_grads = torch.autograd.grad(g_loss, g_params)
        self.g_opt.step(g_params, g_grads)
        return {"d_loss": float(d_loss.detach()), "g_loss": float(g_loss.detach()),
                "d_grads": dict(zip(self.d_names, d_grads)),
                "g_grads": dict(zip(self.g, g_grads))}

    @torch.no_grad()
    def evaluate(self, batch: Dict[str, torch.Tensor]) -> Tuple[float, float]:
        """The dev evaluation's D and G losses on NCHW ``batch``: no update, D
        in evaluation mode on the real tiles and on the fakes."""
        fake = self.generate(batch)
        real_logits = discriminator(self.d, batch["Y"], False, self.precision)
        fake_logits = discriminator(self.d, fake, False, self.precision)
        return (float(ragan(real_logits, fake_logits)),
                float(self.g_loss(fake, batch, fake_logits)))

    @staticmethod
    def g_loss(fake, batch, fake_logits) -> torch.Tensor:
        y = batch["Y"]
        adversarial = ragan(torch.ones_like(fake_logits), fake_logits, 0.0, 1.0)
        return (WEIGHTS["content"] * torch.mean(torch.abs(fake - y))
                + WEIGHTS["adversarial"] * adversarial
                + WEIGHTS["topographic"] * torch.mean(torch.abs(
                    F.avg_pool2d(fake, 4) - batch["X"][:, :, 1:-1, 1:-1]))
                + WEIGHTS["structural"] * (1.0 - ssim(fake, y)))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              skip: Sequence[str] = ()) -> Dict[str, float]:
    """Each leaf's |got - want| of a per-leaf norm, over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = sorted(want.values())
    median = norms[len(norms) // 2]
    return {name: abs(got[name] - w) / max(w, median, 1e-30) if math.isfinite(got[name])
            else float("inf") for name, w in want.items() if name not in skip}

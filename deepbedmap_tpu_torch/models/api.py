"""Model construction.

Counterpart of ``deepbedmap_tpu/models/api.py`` (``build_generator``,
``build_discriminator``, ``count_params``, ``example_inputs_nhwc`` and the
reference-layout helpers ``nchw_to_nhwc``, ``nhwc_to_nchw`` and
``generator_forward_nchw``). Weights come from a ``torch.Generator`` seeded
with ``seed``; they differ from the JAX package's for the same seed
(``bridge.jax_params_to_state_dict`` and ``bridge.jax_d_vars_to_state_dict``
carry the JAX weights across).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import torch
from torch import nn

from deepbedmap_tpu_torch.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    HATConfig,
    SwinIRConfig,
    check_card_supported,
)
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.models.discriminator import Discriminator
from deepbedmap_tpu_torch.models.generator import Generator
from deepbedmap_tpu_torch.models.hat import HAT
from deepbedmap_tpu_torch.models.swinir import SwinIR

GeneratorConfigs = Union[GeneratorConfig, SwinIRConfig, HATConfig]


def count_params(model: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Parameters of a module (its buffers, such as BatchNorm statistics, are
    not parameters), or elements of a mapping of tensors."""
    tensors = model.parameters() if isinstance(model, nn.Module) else model.values()
    return sum(t.numel() for t in tensors)


def check_generator_device(cfg: GeneratorConfig, device) -> None:
    """On a CUDA device, refuse widths a forced (``'always'``) kernel does
    not take (``config.check_card_supported``); ``'auto'`` sends them to the
    plain path, and the CPU takes any width. Called before the device is
    resolved, so the refusal does not need a card."""
    if torch.device(device).type == "cuda":
        check_card_supported(cfg)


def make_generator(cfg: GeneratorConfigs = GeneratorConfig(), device="cpu") -> nn.Module:
    """The generator a configuration selects, its parameters not drawn, on
    the CPU: ``SwinIR`` for a ``SwinIRConfig``, ``HAT`` for a ``HATConfig``;
    DeepBedMap's ``Generator`` for a ``GeneratorConfig``, whose widths are
    first held against the kernels of ``device`` (``check_generator_device``).
    SwinIR's and HAT's window kernels refuse the sizes they do not take at
    their first launch (``ops.window_attn``)."""
    if isinstance(cfg, SwinIRConfig):
        return SwinIR(cfg)
    if isinstance(cfg, HATConfig):
        return HAT(cfg)
    check_generator_device(cfg, device)
    return Generator(cfg)


def build_generator(
    cfg: GeneratorConfigs = GeneratorConfig(), seed: int = 42,
    device="cuda",
) -> nn.Module:
    """The generator ``cfg`` selects (``make_generator``) with seeded initial
    weights, on ``device`` (the card unless the caller asks for the CPU; see
    ``device.resolve_device``). The
    weights are drawn on the CPU, so every device gets the same numbers.
    Widths the kernels do not take raise ``NotImplementedError`` on a CUDA
    device (``check_generator_device``)."""
    model = make_generator(cfg, device)
    dev = resolve_device(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)


def build_discriminator(
    cfg: DiscriminatorConfig = DiscriminatorConfig(), seed: int = 42, hr: int = 36,
    device="cuda",
) -> Discriminator:
    """The discriminator for ``hr`` x ``hr`` tiles with seeded initial
    weights, on ``device`` (drawn on the CPU, as ``build_generator``'s)."""
    dev = resolve_device(device)
    model = Discriminator(cfg, in_px=hr)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)


def example_inputs_nhwc(
    batch: int = 1, lr: int = 11, device="cuda", generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, ...]:
    """Training-shaped example inputs, uniform in [0, 1): x (batch, lr, lr, 1),
    w1 (batch, 10 lr, 10 lr, 1), w2 (batch, 2 lr, 2 lr, 2), w3 (batch, lr,
    lr, 1); lr=11 low-res px is a 9 km tile + 1 km pad. Drawn on the CPU from
    ``generator`` (a ``torch.Generator`` seeded with 0 when None), so every
    device gets the same numbers, then moved to ``device``. They differ from
    the JAX package's, which come from ``jax.random.PRNGKey(0)``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    shapes = [(batch, lr, lr, 1), (batch, 10 * lr, 10 * lr, 1),
              (batch, 2 * lr, 2 * lr, 2), (batch, lr, lr, 1)]
    return tuple(torch.rand(s, generator=gen).to(dev) for s in shapes)


def nchw_to_nhwc(a: torch.Tensor) -> torch.Tensor:
    return a.permute(0, 2, 3, 1)


def nhwc_to_nchw(a: torch.Tensor) -> torch.Tensor:
    return a.permute(0, 3, 1, 2)


def generator_forward_nchw(model: Generator, x, w1, w2, w3) -> torch.Tensor:
    """Reference-contract forward: NCHW in, NCHW out
    ((N,1,h,h)... -> (N,1,(h-2)*4,(h-2)*4)), on the model's device. The
    generator holds its weights, so there is no ``params`` argument as in
    JAX; the call keeps autograd's graph unless the caller turns it off."""
    out = model(nchw_to_nhwc(x), nchw_to_nhwc(w1), nchw_to_nhwc(w2), nchw_to_nhwc(w3))
    return nhwc_to_nchw(out).contiguous()

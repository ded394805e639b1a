"""Model construction.

Counterpart of ``deepbedmap_tpu/models/api.py`` (``build_generator``,
``count_params``). Weights come from a ``torch.Generator`` seeded with
``seed``; they differ from the JAX package's for the same seed (use
``bridge.jax_params_to_state_dict`` to run the JAX weights).
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.models.generator import Generator


def count_params(model: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    tensors = model.parameters() if isinstance(model, nn.Module) else model.values()
    return sum(t.numel() for t in tensors)


def build_generator(
    cfg: GeneratorConfig = GeneratorConfig(), seed: int = 42, device="cuda"
) -> Generator:
    """The generator with seeded initial weights, on ``device`` (the card
    unless the caller asks for the CPU; see ``device.resolve_device``). The
    weights are drawn on the CPU, so every device gets the same numbers."""
    dev = resolve_device(device)
    model = Generator(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)

"""Seeded generator weights, drawn on the device in one call.

The benchmark draws the weights itself and hands the same tensors to the
program and to the reference. One normal draw of every parameter at once on
the device (a `torch.Generator` there), then each leaf is a view of it scaled
to its standard deviation: He-normal (std = scale * sqrt(2 / fan_in), the
published init with the configuration's scale) for the convs, `offset_scale`
in place of `scale` for the two offset convs, `bias_std` for every bias.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.generator import param_spec
from portbench.reference.train import d_param_spec

WEIGHTS_STREAM, D_WEIGHTS_STREAM = 1, 4


def seeded_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one ``stream`` of the run's ``seed``
    (weights, inputs, ...): the same seed and stream give the same numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + stream) % (2**63))
    return g


def generator_weights(weights_cfg: dict, blocks: int, seed: int,
                      device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``param_spec(blocks)``."""
    spec = param_spec(blocks)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    draw = torch.randn(total, generator=seeded_generator(seed, device, WEIGHTS_STREAM),
                       device=device)
    out, at = {}, 0
    for name, shape, fan_in in spec:
        n = math.prod(shape)
        if fan_in is None:
            std = weights_cfg["bias_std"]
        else:
            scale = weights_cfg["offset_scale" if ".offset_conv." in name else "scale"]
            std = scale * math.sqrt(2.0 / fan_in)
        out[name] = (draw[at:at + n] * std).view(shape)
        at += n
    return out


def discriminator_weights(scale: float, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``d_param_spec()``: He-normal
    convs and dense layers at ``scale``, the published start for the rest
    (zero biases, batch-norm scale 1 and bias 0, statistics 0 and 1)."""
    spec = d_param_spec()
    total = sum(math.prod(s) for _, s, f in spec if isinstance(f, int))
    draw = torch.randn(total, generator=seeded_generator(seed, device, D_WEIGHTS_STREAM),
                       device=device)
    out, at = {}, 0
    for name, shape, start in spec:
        if isinstance(start, int):
            n = math.prod(shape)
            out[name] = (draw[at:at + n] * (scale * math.sqrt(2.0 / start))).view(shape)
            at += n
        else:
            out[name] = torch.full(shape, start, device=device)
    return out

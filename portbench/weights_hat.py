"""Seeded HAT weights, drawn on the device in one call, as `weights_swinir.py`
draws SwinIR's: one normal draw of every parameter at once (the weights'
stream of the run's seed), each leaf a view of it scaled by its kind
(`reference.hat.param_spec`) and the configuration's `weights`:

- convs He-normal, std = s * sqrt(2 / fan_in): s = `input_scale` for the
  input block, `last_scale` for `conv_last`, `scale` for every other (the
  CAB's two 3x3 convs and the channel attention's 1x1 convs too);
- linears std = `linear_scale` / sqrt(fan_in);
- every bias N(0, `bias_std`^2); LayerNorm weights 1 + N(0, `norm_std`^2),
  their biases N(0, `norm_std`^2); the relative-position tables of the HABs
  and the OCABs N(0, `table_std`^2).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.hat import param_spec
from portbench.weights import WEIGHTS_STREAM, seeded_generator

CONV_SCALES = {"input": "input_scale", "conv": "scale", "ca": "scale", "cab": "scale",
               "last": "last_scale"}
STDS = {"bias": "bias_std", "norm_bias": "norm_std", "table": "table_std"}


def hat_weights(weights_cfg: dict, generator_cfg: dict, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``param_spec(generator_cfg)``."""
    spec = param_spec(generator_cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    draw = torch.randn(total, generator=seeded_generator(seed, device, WEIGHTS_STREAM),
                       device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in spec:
        z = draw[at:at + math.prod(shape)].view(shape)
        at += z.numel()
        if kind in CONV_SCALES:
            out[name] = z * (weights_cfg[CONV_SCALES[kind]] * math.sqrt(2.0 / fan_in))
        elif kind == "linear":
            out[name] = z * (weights_cfg["linear_scale"] / math.sqrt(fan_in))
        elif kind == "norm_weight":
            out[name] = 1.0 + z * weights_cfg["norm_std"]
        else:
            out[name] = z * weights_cfg[STDS[kind]]
    return out

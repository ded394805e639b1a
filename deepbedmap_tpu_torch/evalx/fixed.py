"""Fixed-test-region evaluator (reference get_fixed_test_inputs /
get_deepbedmap_test_result, srgan_train.py:1393-1466).

Counterpart of ``deepbedmap_tpu/evalx/fixed.py``. The reference caches one
test region's conditioning stack (Pine Island / 20xx_Antarctica_DC8_THW)
and, per training epoch, runs the generator over it and reports RMSE
against survey xyz tracks. Here the evaluator is a closure: the inputs and
the track go to the device once, and each call is one forward at batch 1
through the generator's kernels (in the default configuration K1 36 times,
K2 and K3 once), a bicubic sampling of the predicted grid at the track and
an RMSE reduction on the device. JAX jits a function of the params tree;
here the generator is a module that holds its weights, so ``evaluate``
takes the module.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.ops.interp import as_f32, sample_grid_bicubic
from deepbedmap_tpu_torch.ops.metrics import rmse


def make_fixed_evaluator(
    g_model: torch.nn.Module,
    inputs_nchw: Dict[str, np.ndarray],  # X/W1/W2/W3 stack (get_model_inputs)
    track_xyz: Tuple[np.ndarray, np.ndarray, np.ndarray],  # survey x, y, z
    bounds: Tuple[float, float, float, float],  # (xmin, ymin, xmax, ymax)
    resolution: float = 250.0,
    device="cuda",
) -> Callable[[Optional[torch.nn.Module]], float]:
    """Build ``evaluate(g=None) -> rmse_m`` for ``train.objective`` on
    ``device`` (the card unless the caller asks for the CPU). ``g`` is the
    generator to score, ``g_model`` when None; it must live on ``device``.

    ``inputs_nchw`` follow the reference contract (1 km padding on the
    conditioning rasters); the generator output therefore covers ``bounds``
    exactly at ``resolution``. ``evaluate.predict(g=None)`` gives that grid
    as a numpy array; ``evaluate.bounds`` and ``evaluate.resolution`` are the
    arguments.
    """
    dev = resolve_device(device)
    x, w1, w2, w3 = (
        torch.from_numpy(np.ascontiguousarray(
            np.asarray(inputs_nchw[k], np.float32).transpose(0, 2, 3, 1))).to(dev)
        for k in ("X", "W1", "W2", "W3")
    )
    tx, ty, tz = (as_f32(a, dev) for a in track_xyz)
    xmin, ymin, xmax, ymax = bounds

    def predict(g=None) -> torch.Tensor:
        with torch.no_grad():
            return (g_model if g is None else g)(x, w1, w2, w3)[0, :, :, 0]

    def evaluate(g=None) -> float:
        # bicubic: GMT grdtrack's default, what the reference's per-epoch RMSE
        # uses (srgan_train.py:1460-1464)
        sampled = sample_grid_bicubic(predict(g), tx, ty, xmin, ymax, resolution)
        return float(rmse(sampled, tz))

    # the predicted test grid itself: objective() renders and logs it per
    # epoch when a tracker is wired (the reference uploads a predicted
    # test-area image to Comet every epoch, srgan_train.py:1640-1654)
    evaluate.predict = lambda g=None: predict(g).cpu().numpy()
    evaluate.bounds = bounds
    evaluate.resolution = resolution
    return evaluate

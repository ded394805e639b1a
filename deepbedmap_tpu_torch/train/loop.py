"""The epoch loop: the reference's ``trainer`` (srgan_train.py:1267-1329).

Counterpart of ``deepbedmap_tpu/train/loop.py``. JAX scans a jitted step over
an index matrix; here an epoch is a Python loop over the same index batches
(``data.dataset.epoch_batches``, uploaded to the device once per epoch),
gathering each minibatch from the device-resident dataset. Metrics stay on
the device until the epoch ends; the host then reduces them to the per-epoch
means the reference logs (srgan_train.py:1592-1599), as JAX does (numpy
means of the float32 series).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.config import LossConfig, TrainConfig
from deepbedmap_tpu_torch.data.dataset import TileDataset, epoch_batches, train_dev_split
from deepbedmap_tpu_torch.train.state import GANState
from deepbedmap_tpu_torch.train.steps import StepMetrics, make_eval_step, make_train_step
from deepbedmap_tpu_torch.utils.profiling import span


def _metrics_to_host(metrics: List[StepMetrics], prefix: str) -> Dict[str, float]:
    with span("train.epoch_metrics"):
        return {
            f"{prefix}{f.name}": float(np.mean(
                torch.stack([getattr(m, f.name) for m in metrics]).cpu().numpy()))
            for f in dataclasses.fields(StepMetrics)
        }


def make_epoch_fns(
    dataset: TileDataset,
    t_cfg: TrainConfig = TrainConfig(),
    loss_cfg: LossConfig = LossConfig(),
):
    """(train_epoch, eval_epoch) over the device dataset: each takes the
    state and a (num_batches, batch_size) index matrix; ``train_epoch``
    returns the state and the steps' metrics, ``eval_epoch`` the metrics.
    Each train step is the telemetry's root ``train.step``: ``train.take``
    (the minibatch's gather), then the step's own spans."""
    train_step = make_train_step(t_cfg, loss_cfg)
    eval_step = make_eval_step(loss_cfg)

    def rows(batch_indices):
        return torch.as_tensor(batch_indices, dtype=torch.long, device=dataset.device)

    def train_epoch_fn(state: GANState, batch_indices) -> Tuple[GANState, List[StepMetrics]]:
        metrics = []
        for idx in rows(batch_indices):
            with span("train.step", range=False):
                with span("train.take"):
                    batch = dataset.take(idx)
                state, m = train_step(state, batch)
            metrics.append(m)
        return state, metrics

    def eval_epoch_fn(state: GANState, batch_indices) -> List[StepMetrics]:
        return [eval_step(state, dataset.take(idx)) for idx in rows(batch_indices)]

    return train_epoch_fn, eval_epoch_fn


def train_epoch(
    state: GANState,
    dataset: TileDataset,
    indices: np.ndarray,
    rs: np.random.RandomState,
    t_cfg: TrainConfig = TrainConfig(),
    loss_cfg: LossConfig = LossConfig(),
) -> Tuple[GANState, Dict[str, float]]:
    """One epoch over ``indices`` shuffled by ``rs``; returns the state and
    the epoch's mean metrics."""
    train_fn, _ = make_epoch_fns(dataset, t_cfg, loss_cfg)
    state, metrics = train_fn(state, epoch_batches(indices, t_cfg.batch_size, rs))
    return state, _metrics_to_host(metrics, "")


def fit(
    state: GANState,
    dataset: TileDataset,
    t_cfg: TrainConfig = TrainConfig(),
    loss_cfg: LossConfig = LossConfig(),
    epochs: Optional[int] = None,
    callback: Optional[Callable[[int, Dict[str, float]], bool]] = None,
) -> Tuple[GANState, list]:
    """A full training run (reference objective() inner loop,
    srgan_train.py:1608-1706): the 95/5 split at ``split_seed``, each epoch
    shuffled by a ``RandomState(seed)``, the dev set's fixed batches
    evaluated after each epoch. ``callback(epoch, record) -> stop`` ends the
    run early when it returns True (NaN loss, diverged PSNR, pruning)."""
    epochs = t_cfg.epochs if epochs is None else epochs
    train_idx, dev_idx = train_dev_split(len(dataset), t_cfg.train_fraction,
                                         t_cfg.split_seed)
    train_fn, eval_fn = make_epoch_fns(dataset, t_cfg, loss_cfg)
    rs = np.random.RandomState(t_cfg.seed)

    # dev batches are fixed across epochs (srgan_train.py:1311-1327); one
    # full-dev batch when the split is smaller than batch_size
    dev_bs = min(t_cfg.batch_size, len(dev_idx))
    dev_batches = epoch_batches(dev_idx, dev_bs, np.random.RandomState(t_cfg.split_seed))

    history = []
    for epoch in range(epochs):
        batches = epoch_batches(train_idx, t_cfg.batch_size, rs)
        state, train_metrics = train_fn(state, batches)
        record = {
            "epoch": epoch,
            **_metrics_to_host(train_metrics, ""),
            **_metrics_to_host(eval_fn(state, dev_batches), "val_"),
        }
        history.append(record)
        if callback is not None and callback(epoch, record):
            break
    return state, history

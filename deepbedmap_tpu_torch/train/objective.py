"""The end-to-end training objective (reference ``objective(trial)``,
srgan_train.py:1479-1721), on the port's pieces.

Counterpart of ``deepbedmap_tpu/train/objective.py``, with its order of
events:

- hyperparameters drawn from a ``hpo.Trial`` with the reference's search space
  (batch 2^7; lr in [1,2]e-4 step 0.1e-4; 12 RRDBs; residual scaling
  [0.1, 0.3] step 0.05; epochs in [15, 150]) — srgan_train.py:1523-1533;
- per epoch: a train epoch and a dev epoch (``train.loop.make_epoch_fns``),
  then the test RMSE from the evaluator;
- divergence pruning (NaN losses / PSNR <= 0) and Hyperband-style pruning —
  srgan_train.py:1698-1706;
- a checkpoint of the whole train state whenever the test RMSE improves —
  srgan_train.py:1659-1669 — saved with ``block=False``, so that the write
  overlaps the next epoch, and committed when the trial ends, as JAX's;
- the metric records handed to ``log`` and a tracker (the reference streams
  them to Comet.ML).

The trial trains on the dataset's device: a ``TileDataset`` on the card
trains through the kernels there.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional

import numpy as np

from deepbedmap_tpu_torch.bridge import state_dict_to_jax_params
from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
from deepbedmap_tpu_torch.data.dataset import TileDataset, epoch_batches, train_dev_split
from deepbedmap_tpu_torch.hpo import Trial, TrialPruned
from deepbedmap_tpu_torch.models.summary import to_dot
from deepbedmap_tpu_torch.train.checkpoint import (
    export_generator_npz,
    save_checkpoint,
    wait_for_checkpoints,
)
from deepbedmap_tpu_torch.train.loop import _metrics_to_host, make_epoch_fns
from deepbedmap_tpu_torch.train.state import create_gan_state

WEIGHTS_NPZ = "srgan_generator_model_weights.npz"


def suggest_reference_space(trial: Trial) -> Dict:
    """The reference's Optuna search space (srgan_train.py:1523-1533)."""
    return dict(
        batch_size_exponent=trial.suggest_int("batch_size_exponent", 7, 7),
        learning_rate=trial.suggest_float(
            "learning_rate", 1.0e-4, 2.0e-4, step=0.1e-4
        ),
        num_residual_blocks=trial.suggest_int("num_residual_blocks", 12, 12),
        residual_scaling=trial.suggest_float(
            "residual_scaling", 0.1, 0.3, step=0.05
        ),
        num_epochs=trial.suggest_int("num_epochs", 15, 150),
    )


def objective(
    trial: Trial,
    dataset: TileDataset,
    evaluate_rmse: Optional[Callable] = None,
    checkpoint_dir: Optional[str] = None,
    rmse_save_threshold: float = 250.0,
    log: Optional[Callable[[int, Dict], None]] = None,
    suggest=suggest_reference_space,
    tracker=None,  # utils.tracking.Tracker
    rmse_upload_threshold: float = 500.0,
    make_evaluator: Optional[Callable] = None,
) -> float:
    """Train one trial on ``dataset``'s device; returns the best test RMSE
    (minimised).

    ``evaluate_rmse(g) -> float`` scores the trial's generator module on the
    fixed test area (reference get_deepbedmap_test_result;
    ``evalx.make_fixed_evaluator``); when None, the dev-set generator loss
    stands in so the objective works on synthetic data. NOTE the stand-in is
    a loss, not metres — wire a real evaluator for true RMSE.

    ``make_evaluator(g_model) -> evaluate_rmse`` builds the evaluator from
    the TRIAL's generator (hyperparameters like residual_scaling change the
    forward pass, so a fixed-test-area evaluator must be constructed per
    trial — e.g. ``lambda m: evalx.make_fixed_evaluator(m, ...)``). Takes
    precedence over ``evaluate_rmse``.

    ``checkpoint_dir``: the train state is saved to
    ``<checkpoint_dir>/trial_<number>`` (``train.checkpoint.save_checkpoint``)
    whenever the test RMSE improves and is under ``rmse_save_threshold``.

    ``tracker`` closes the reference's Comet loop (srgan_train.py:1575-1688):
    hyperparameters logged up front, the full metric record per epoch (and
    the predicted test area as an image when the evaluator has
    ``.predict``), the generator weights exported to the reference npz
    layout whenever test RMSE improves (< ``rmse_save_threshold``), and —
    when the trial ends (final epoch or pruning) with best RMSE <
    ``rmse_upload_threshold`` — the npz asset plus the model-architecture
    graph uploaded, so ``DeepBedMap.from_experiment`` can rebuild the
    trained model by key.
    """
    hp = suggest(trial)
    batch_size = 2 ** hp["batch_size_exponent"]

    g_cfg = GeneratorConfig(
        num_residual_blocks=hp["num_residual_blocks"],
        residual_scaling=hp["residual_scaling"],
    )
    t_cfg = TrainConfig(
        learning_rate=hp["learning_rate"],
        batch_size=min(batch_size, max(1, int(len(dataset) * 0.95))),
    )
    state = create_gan_state(g_cfg, t_cfg=t_cfg, device=dataset.device)
    if make_evaluator is not None:
        evaluate_rmse = make_evaluator(state.g)

    if tracker is not None:
        # the reference's logged parameter dict (srgan_train.py:1575-1590)
        tracker.log_params(
            {
                "num_residual_blocks": g_cfg.num_residual_blocks,
                "residual_scaling": g_cfg.residual_scaling,
                "generator_optimizer": "adam",
                "generator_lr": t_cfg.learning_rate,
                "generator_epsilon": t_cfg.adam_eps,
                "discriminator_optimizer": "adam",
                "discriminator_lr": t_cfg.learning_rate,
                "discriminator_adam_epsilon": t_cfg.adam_eps,
                "num_epochs": hp["num_epochs"],
                "batch_size": t_cfg.batch_size,
            }
        )

    train_idx, dev_idx = train_dev_split(
        len(dataset), t_cfg.train_fraction, t_cfg.split_seed
    )
    train_fn, eval_fn = make_epoch_fns(dataset, t_cfg)
    rs = np.random.RandomState(t_cfg.seed)
    dev_bs = min(t_cfg.batch_size, len(dev_idx))
    dev_batches = epoch_batches(dev_idx, dev_bs, np.random.RandomState(t_cfg.split_seed))

    # staging dir for the best-weights npz the tracker uploads at trial end;
    # only a tracker consumes it, so without one no dir is created, and a
    # temp staging dir is removed when the trial ends (the finally below)
    weights_dir = None
    tmp_weights = False
    if checkpoint_dir is not None:
        weights_dir = os.path.join(checkpoint_dir, f"trial_{trial.number}_weights")
    elif tracker is not None:
        import tempfile

        weights_dir = tempfile.mkdtemp(prefix=f"dbm_trial_{trial.number}_")
        tmp_weights = True

    try:
        return _run_epochs(
            trial, hp, state, train_fn, eval_fn, train_idx, dev_batches, rs,
            t_cfg, evaluate_rmse, log, tracker, checkpoint_dir,
            rmse_save_threshold, rmse_upload_threshold, weights_dir,
        )
    finally:
        if tmp_weights:
            import shutil

            shutil.rmtree(weights_dir, ignore_errors=True)


def _run_epochs(
    trial, hp, state, train_fn, eval_fn, train_idx, dev_batches, rs,
    t_cfg, evaluate_rmse, log, tracker, checkpoint_dir,
    rmse_save_threshold, rmse_upload_threshold, weights_dir,
):
    best_rmse = math.inf
    for epoch in range(hp["num_epochs"]):
        batches = epoch_batches(train_idx, t_cfg.batch_size, rs)
        state, train_metrics = train_fn(state, batches)
        dev_metrics = eval_fn(state, dev_batches)
        record = {
            **_metrics_to_host(train_metrics, ""),
            **_metrics_to_host(dev_metrics, "val_"),
        }

        if evaluate_rmse is not None:
            rmse_test = float(evaluate_rmse(state.g))
        else:
            rmse_test = record["val_generator_loss"]
        record["rmse_test"] = rmse_test
        # honesty flag: without a wired evaluator the 'rmse' is the dev-set
        # generator loss standing in (a loss, not metres) — consumers (CLI
        # JSON, trackers) can distinguish real RMSE from the proxy
        record["rmse_is_proxy"] = evaluate_rmse is None
        if log is not None:
            log(epoch, record)
        if tracker is not None:
            tracker.log_metrics(record, step=epoch)
            # the reference uploads the predicted test-area image to Comet
            # every epoch — the main qualitative training-progress signal
            # (srgan_train.py:1640-1654); our evaluator exposes the grid
            if evaluate_rmse is not None and hasattr(evaluate_rmse, "predict"):
                _log_predicted_image(tracker, evaluate_rmse, state.g, epoch, rmse_test)

        # divergence detection (srgan_train.py:1698-1706)
        if (
            math.isnan(record["generator_loss"])
            or math.isnan(record["discriminator_loss"])
            or record["generator_psnr"] <= 0
        ):
            _finish_trial(tracker, state, best_rmse, rmse_upload_threshold, weights_dir)
            raise TrialPruned()

        if rmse_test < best_rmse:
            best_rmse = rmse_test
            if checkpoint_dir is not None and rmse_test < rmse_save_threshold:
                # non-blocking: the write overlaps the next epoch
                # (_finish_trial commits it before the trial ends)
                save_checkpoint(
                    state, os.path.join(checkpoint_dir, f"trial_{trial.number}"),
                    block=False,
                )
            if tracker is not None and rmse_test < rmse_save_threshold:
                # reference save_model_weights_and_architecture on improve
                # (srgan_train.py:1659-1669): reference-layout npz, staged
                # for upload at trial end
                os.makedirs(weights_dir, exist_ok=True)
                export_generator_npz(
                    state_dict_to_jax_params(state.g.state_dict()),
                    os.path.join(weights_dir, WEIGHTS_NPZ),
                )

        trial.report(rmse_test, epoch)
        last_epoch = epoch == hp["num_epochs"] - 1
        if trial.should_prune() or last_epoch:
            _finish_trial(tracker, state, best_rmse, rmse_upload_threshold, weights_dir)
            if not last_epoch:
                raise TrialPruned()

    return best_rmse


def _log_predicted_image(tracker, evaluate_rmse, g, epoch, rmse_test):
    """Render the fixed-test-area prediction and attach it to the experiment
    (reference: one predicted image per epoch, srgan_train.py:1640-1654)."""
    import tempfile

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = evaluate_rmse.predict(g)
    fig, ax = plt.subplots(figsize=(6, 5))
    extent = None
    if hasattr(evaluate_rmse, "bounds"):
        xmin, ymin, xmax, ymax = evaluate_rmse.bounds
        extent = (xmin, xmax, ymin, ymax)
    im = ax.imshow(grid, cmap="BrBG", origin="upper", extent=extent)
    fig.colorbar(im, ax=ax, label="bed elevation (m)")
    ax.set_title(f"predicted test area — epoch {epoch}, RMSE {rmse_test:.2f} m")
    fig.tight_layout()
    with tempfile.TemporaryDirectory(prefix="dbm_img_") as d:
        path = os.path.join(d, f"epoch_{epoch:03d}_predicted_test_image.png")
        fig.savefig(path, dpi=90)
        tracker.log_asset(path)
    plt.close(fig)


def _finish_trial(tracker, state, best_rmse, rmse_upload_threshold, weights_dir) -> None:
    """End-of-trial asset upload (reference srgan_train.py:1673-1688): if the
    trial ever beat ``rmse_upload_threshold``, upload the staged best-weights
    npz and set the model-architecture graph on the experiment. Also commits
    any in-flight non-blocking checkpoint save."""
    wait_for_checkpoints()
    if tracker is None or best_rmse >= rmse_upload_threshold:
        return
    npz = os.path.join(weights_dir, WEIGHTS_NPZ)
    if os.path.exists(npz):
        tracker.log_asset(npz)
        tracker.set_model_graph(
            to_dot(state_dict_to_jax_params(state.g.state_dict()), title="generator")
        )

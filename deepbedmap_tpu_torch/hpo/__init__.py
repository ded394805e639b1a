"""Self-contained hyperparameter optimisation (reference L7).

A copy of ``deepbedmap_tpu/hpo`` (stdlib and ``sqlite3`` only): the port
cannot import it, since importing any ``deepbedmap_tpu`` module loads JAX.
The same seed gives the same trials, parameters and sqlite rows in both
(``tests/test_torch_port_hpo.py``).

The reference drives training with Optuna: TPE sampler + Hyperband pruner +
sqlite storage, one async study process per device
(srgan_train.py:1479-1757). This engine has the API surface the objective
needs:

    study = create_study(direction="minimize", storage="sqlite:///...db")
    study.optimize(objective, n_trials=90)
    # objective(trial): trial.suggest_float/int/discrete, trial.report,
    #                   trial.should_prune -> raise TrialPruned

Sampling is TPE-lite (independent per-parameter Parzen estimators, good/bad
split like Optuna's default univariate TPE) after a random startup phase.
Pruning implements the published ASHA rule — SuccessiveHalvingPruner
('halving') and HyperbandPruner ('hyperband': crc32 bracket assignment,
budgets ceil(n_brackets/(s+1)), per-bracket early-stopping rates), matching
the reference's HyperbandPruner(min_resource=15, max_resource=150,
reduction_factor=3) (srgan_train.py:1740-1744); its decisions are pinned
against hand-computed oracles in tests/test_torch_port_hpo.py. A MedianPruner
('median') is also provided.
"""

from deepbedmap_tpu_torch.hpo.engine import (  # noqa: F401
    Study,
    Trial,
    TrialPruned,
    TrialState,
    create_study,
)

"""HPO engine: trials, TPE-lite sampling, rung-based pruning, sqlite storage.

A copy of ``deepbedmap_tpu/hpo/engine.py`` (stdlib and ``sqlite3``; pandas
only inside ``Study.trials_dataframe``). API mirrors the subset of Optuna
the reference objective uses (srgan_train.py:1479-1757): suggest_float (with optional step — Optuna's
discrete_uniform), suggest_int, report/should_prune, FixedTrial-style enqueue,
study.best_trial / trials_dataframe, sqlite-backed multi-process studies
(the reference's share-nothing per-GPU parallelism, SURVEY.md section 2.2).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import sqlite3
import time
from typing import Any, Callable, Dict, List, Optional, Sequence


class TrialPruned(Exception):
    """Raised inside an objective to stop an unpromising trial."""


class TrialState:
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    PRUNED = "PRUNED"
    FAIL = "FAIL"


@dataclasses.dataclass
class FrozenTrial:
    number: int
    state: str
    value: Optional[float]
    params: Dict[str, float]
    intermediate: Dict[int, float]


class Trial:
    def __init__(self, study: "Study", number: int, fixed: Optional[Dict] = None):
        self.study = study
        self.number = number
        self.params: Dict[str, float] = {}
        self.intermediate: Dict[int, float] = {}
        self._fixed = fixed or {}
        self._passed_rungs = 0  # ASHA promotions already granted (permanent)

    # ---- suggest API ----
    def _suggest(self, name, low, high, step=None, log=False, is_int=False):
        if name in self._fixed:
            value = self._fixed[name]
        elif name in self.params:
            return self.params[name]
        else:
            value = self.study._sample(name, low, high, step, log, is_int)
        if step is not None:
            value = low + round((value - low) / step) * step
            value = min(max(value, low), high)
        if is_int:
            value = int(round(value))
        self.params[name] = value
        self.study._record_param(self.number, name, value, low, high, step, log, is_int)
        return value

    def suggest_float(self, name, low, high, step=None, log=False):
        return float(self._suggest(name, low, high, step, log, is_int=False))

    # Optuna's deprecated alias used by the reference (srgan_train.py:1484)
    def suggest_discrete_uniform(self, name, low, high, q):
        return self.suggest_float(name, low, high, step=q)

    def suggest_int(self, name, low, high, step=1):
        return self._suggest(name, low, high, float(step), False, is_int=True)

    def suggest_categorical(self, name, choices: Sequence):
        if name in self._fixed:
            value = self._fixed[name]
        else:
            idx = self.study._sample(name, 0, len(choices) - 1, 1.0, False, True,
                                     choices=choices)
            value = choices[int(idx)]
        self.params[name] = value
        self.study._record_param(
            self.number, name, choices.index(value), 0, len(choices) - 1, 1.0,
            False, True,
        )
        return value

    # ---- pruning API ----
    def report(self, value: float, step: int) -> None:
        self.intermediate[step] = float(value)
        self.study._record_intermediate(self.number, step, float(value))

    def should_prune(self) -> bool:
        return self.study._should_prune(self)


class Study:
    """Minimize/maximize study with optional sqlite persistence."""

    def __init__(
        self,
        direction: str = "minimize",
        storage: Optional[str] = None,
        study_name: str = "default",
        sampler_seed: Optional[int] = None,
        n_startup_trials: int = 10,
        pruner: str = "halving",  # 'halving' | 'hyperband' | 'median' | 'none'
        min_resource: int = 15,
        max_resource: Optional[int] = 150,  # reference srgan_train.py:1742
        reduction_factor: int = 3,
        min_early_stopping_rate: int = 0,
        pruner_n_startup_trials: int = 5,  # Optuna MedianPruner default
    ):
        assert direction in ("minimize", "maximize")
        self.direction = direction
        self.study_name = study_name
        self.n_startup_trials = n_startup_trials
        self.pruner = pruner
        self.min_resource = min_resource
        self.max_resource = max_resource
        self.reduction_factor = reduction_factor
        self.min_early_stopping_rate = min_early_stopping_rate
        self.pruner_n_startup_trials = pruner_n_startup_trials
        self._rng = random.Random(sampler_seed)
        self.trials: List[FrozenTrial] = []
        self._db: Optional[sqlite3.Connection] = None
        if storage is not None:
            path = storage.replace("sqlite:///", "")
            dirname = os.path.dirname(path)
            if dirname:
                os.makedirs(dirname, exist_ok=True)
            self._db = sqlite3.connect(path, timeout=60.0)
            self._init_db()
            self._load_trials()

    # ---- storage ----
    def _init_db(self):
        with self._db:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS trials (study TEXT, number INTEGER, "
                "state TEXT, value REAL, params TEXT, intermediate TEXT, "
                "ts REAL, PRIMARY KEY (study, number))"
            )

    def _load_trials(self):
        rows = self._db.execute(
            "SELECT number, state, value, params, intermediate FROM trials "
            "WHERE study=? ORDER BY number",
            (self.study_name,),
        ).fetchall()
        self.trials = [
            FrozenTrial(
                number=n,
                state=s,
                value=v,
                params=json.loads(p or "{}"),
                intermediate={int(k): vv for k, vv in json.loads(i or "{}").items()},
            )
            for n, s, v, p, i in rows
        ]

    def _claim_number(self) -> int:
        """Atomically allocate the next trial number across processes: INSERT
        a RUNNING placeholder row; the (study, number) primary key makes a
        concurrent claim of the same number an IntegrityError, which we answer
        by re-reading MAX(number) and retrying (no two processes can ever own
        one number, so no trial is lost)."""
        assert self._db is not None
        while True:
            row = self._db.execute(
                "SELECT COALESCE(MAX(number) + 1, 0) FROM trials WHERE study=?",
                (self.study_name,),
            ).fetchone()
            number = int(row[0])
            try:
                with self._db:
                    self._db.execute(
                        "INSERT INTO trials VALUES (?,?,?,?,?,?,?)",
                        (
                            self.study_name,
                            number,
                            TrialState.RUNNING,
                            None,
                            "{}",
                            "{}",
                            time.time(),
                        ),
                    )
                return number
            except sqlite3.IntegrityError:
                continue  # another process claimed it; re-read and retry

    def _persist(self, trial: Trial, state: str, value: Optional[float]):
        if self._db is None:
            return
        with self._db:
            self._db.execute(
                "UPDATE trials SET state=?, value=?, params=?, intermediate=?, "
                "ts=? WHERE study=? AND number=?",
                (
                    state,
                    value,
                    json.dumps(trial.params),
                    json.dumps(trial.intermediate),
                    time.time(),
                    self.study_name,
                    trial.number,
                ),
            )

    def _record_param(self, number, name, value, low, high, step, log, is_int):
        pass  # parameter domains are re-declared by each suggest call

    def _record_intermediate(self, number, step, value):
        """Persist intermediate values as they are reported. Doubles as a
        liveness heartbeat: the row's ``ts`` advances on every report, so
        ``fail_stale_trials`` can tell a crashed worker's abandoned RUNNING
        placeholder from a slow-but-alive trial."""
        if self._db is None:
            return
        with self._db:
            row = self._db.execute(
                "SELECT intermediate FROM trials WHERE study=? AND number=?",
                (self.study_name, number),
            ).fetchone()
            inter = json.loads(row[0] or "{}") if row else {}
            inter[str(step)] = value
            self._db.execute(
                "UPDATE trials SET intermediate=?, ts=? WHERE study=? AND number=?",
                (json.dumps(inter), time.time(), self.study_name, number),
            )

    def fail_stale_trials(self, ttl_seconds: float = 3600.0) -> int:
        """Mark RUNNING rows whose last heartbeat (claim or report) is older
        than ``ttl_seconds`` as FAIL. Reclaims placeholder rows abandoned by
        crashed/killed workers, which would otherwise inflate trial counts
        forever. Returns the number of rows reclaimed."""
        if self._db is None:
            return 0
        cutoff = time.time() - ttl_seconds
        with self._db:
            cur = self._db.execute(
                "UPDATE trials SET state=? WHERE study=? AND state=? AND ts<?",
                (TrialState.FAIL, self.study_name, TrialState.RUNNING, cutoff),
            )
        if cur.rowcount:
            self._load_trials()
        return cur.rowcount

    # ---- sampling ----
    def _sample(self, name, low, high, step, log, is_int, choices=None):
        completed = [
            t for t in self.trials if t.state == TrialState.COMPLETE and name in t.params
        ]
        if len(completed) < self.n_startup_trials:
            return self._random(low, high, log)
        return self._tpe(name, completed, low, high, log, choices=choices)

    def _random(self, low, high, log):
        if log:
            return math.exp(self._rng.uniform(math.log(low), math.log(high)))
        return self._rng.uniform(low, high)

    def _tpe(self, name, completed, low, high, log, n_candidates=24, gamma=0.25,
             choices=None):
        """Univariate Parzen-estimator sampling (TPE-lite). A categorical
        parameter (``choices``, from ``suggest_categorical``) is modelled by
        the index of each trial's choice, the index ``_record_param`` is
        given, and the sample is rounded to an index. (JAX's engine takes
        ``float`` of the choice itself and raises for a string choice once
        the startup trials are done: a stated deviation.)"""
        ordered = sorted(
            completed,
            key=lambda t: t.value if self.direction == "minimize" else -t.value,
        )

        def coord(t):
            v = t.params[name]
            return float(v if choices is None else choices.index(v))

        n_good = max(1, int(math.ceil(gamma * len(ordered))))
        good = [coord(t) for t in ordered[:n_good]]
        bad = [coord(t) for t in ordered[n_good:]] or good

        def transform(v):
            return math.log(v) if log else v

        lo, hi = transform(low), transform(high)
        good_t = [transform(v) for v in good]
        bad_t = [transform(v) for v in bad]
        bandwidth = max((hi - lo) / 10.0, 1e-12)

        def kde(points, x):
            return sum(
                math.exp(-0.5 * ((x - p) / bandwidth) ** 2) for p in points
            ) / (len(points) * bandwidth) + 1e-12

        best_x, best_score = None, -math.inf
        for _ in range(n_candidates):
            center = self._rng.choice(good_t)
            x = self._rng.gauss(center, bandwidth)
            x = min(max(x, lo), hi)
            score = math.log(kde(good_t, x)) - math.log(kde(bad_t, x))
            if score > best_score:
                best_x, best_score = x, score
        x = math.exp(best_x) if log else best_x
        return x if choices is None else float(round(x))

    # ---- pruning ----
    #
    # 'halving' implements Optuna's SuccessiveHalvingPruner (the ASHA
    # promotion rule, Li et al. 2018) and 'hyperband' Optuna's HyperbandPruner
    # — the reference's pruner: HyperbandPruner(min_resource=15,
    # max_resource=150, reduction_factor=3) (srgan_train.py:1740-1744).
    # Semantics validated against hand-computed oracles in
    # tests/test_torch_port_hpo.py.

    def _n_brackets(self) -> int:
        """Hyperband bracket count: floor(log_eta(max/min)) + 1."""
        if self.max_resource is None:
            return 1
        return (
            int(
                math.log(self.max_resource / self.min_resource)
                / math.log(self.reduction_factor)
            )
            + 1
        )

    def _bracket_id(self, trial_number: int) -> int:
        """Deterministic bracket assignment, Optuna's scheme: crc32 of
        '<study>_<number>' modulo the total allocation budget, where bracket
        s gets budget ceil(n_brackets / (s + 1)) — aggressive brackets
        (small early-stopping rate) get proportionally more trials."""
        import zlib

        n = self._n_brackets()
        if n <= 1:
            return 0
        budgets = [math.ceil(n / (s + 1)) for s in range(n)]
        h = zlib.crc32(f"{self.study_name}_{trial_number}".encode()) % sum(budgets)
        for bracket, budget in enumerate(budgets):
            h -= budget
            if h < 0:
                return bracket
        return n - 1

    @staticmethod
    def _rung_value(
        intermediate: Dict[int, float], promotion_step: float
    ) -> Optional[float]:
        """A trial's value at a rung: the value it reported when it first
        crossed ``promotion_step`` (Optuna stores this in trial system attrs
        at crossing time; with should_prune called after every report, the
        first report at step >= promotion_step reconstructs it exactly)."""
        steps = [s for s in intermediate if s >= promotion_step]
        if not steps:
            return None
        return intermediate[min(steps)]

    def _should_prune(self, trial: Trial) -> bool:
        if self.pruner == "none" or not trial.intermediate:
            return False
        step = max(trial.intermediate)
        value = trial.intermediate[step]
        if self.pruner in ("halving", "hyperband"):
            early_stopping_rate = (
                self._bracket_id(trial.number)
                if self.pruner == "hyperband"
                else self.min_early_stopping_rate
            )
            return self._asha_prune(trial, step, value, early_stopping_rate)
        return self._median_prune(trial, step)

    def _asha_prune(
        self, trial: Trial, step: int, value: float, early_stopping_rate: int
    ) -> bool:
        """Successive-halving: walk the rungs the trial has crossed; at each
        rung keep only trials in the top 1/eta of that rung's recorded values
        (ties promote). Rung k completes at min_resource * eta^(rate + k).
        Rungs already passed are never re-checked (ASHA promotions are
        permanent), tracked per live trial in ``trial._passed_rungs``."""
        eta = self.reduction_factor
        sign = 1.0 if self.direction == "minimize" else -1.0
        rung = trial._passed_rungs
        while True:
            promotion_step = self.min_resource * eta ** (early_stopping_rate + rung)
            if step < promotion_step:
                return False
            if math.isnan(value):
                return True
            own = self._rung_value(trial.intermediate, promotion_step)
            competing = sorted(
                sign * rv
                for t in self.trials
                if t.number != trial.number
                for rv in (self._rung_value(t.intermediate, promotion_step),)
                if rv is not None and not math.isnan(rv)
            )
            competing.append(sign * own)
            competing.sort()
            # top-1/eta cutoff; with fewer than eta values only the best
            # promotes (Optuna's promotable_idx = max(len//eta - 1, 0))
            promotable_idx = max(len(competing) // eta - 1, 0)
            if sign * own > competing[promotable_idx]:
                return True
            rung += 1
            trial._passed_rungs = rung

    def _median_prune(self, trial: Trial, step: int) -> bool:
        """Optuna MedianPruner: after ``pruner_n_startup_trials`` completed
        trials, prune if the trial's best intermediate so far is strictly
        worse than the median of completed trials' values at the same step."""
        completed = [t for t in self.trials if t.state == TrialState.COMPLETE]
        if len(completed) < self.pruner_n_startup_trials:
            return False
        peers = [t.intermediate[step] for t in completed if step in t.intermediate]
        if not peers:
            return False
        peers.sort()
        n = len(peers)
        median = (
            peers[n // 2] if n % 2 else 0.5 * (peers[n // 2 - 1] + peers[n // 2])
        )
        best = (
            min(trial.intermediate.values())
            if self.direction == "minimize"
            else max(trial.intermediate.values())
        )
        return best > median if self.direction == "minimize" else best < median

    # ---- driving ----
    def ask(self, fixed: Optional[Dict] = None) -> Trial:
        if self._db is not None:
            number = self._claim_number()  # atomic across processes
            self._load_trials()  # includes our RUNNING placeholder
        else:
            number = len(self.trials)
            self.trials.append(
                FrozenTrial(number, TrialState.RUNNING, None, {}, {})
            )
        trial = Trial(self, number, fixed)
        frozen = next(t for t in self.trials if t.number == number)
        frozen.params = trial.params
        return trial

    def tell(self, trial: Trial, state: str, value: Optional[float]):
        frozen = next(t for t in self.trials if t.number == trial.number)
        frozen.state = state
        frozen.value = value
        frozen.params = trial.params
        frozen.intermediate = trial.intermediate
        self._persist(trial, state, value)

    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int = 10,
        catch: tuple = (),
        stale_ttl: Optional[float] = None,
    ):
        """Run ``n_trials`` trials. ``stale_ttl``: when set and the study is
        sqlite-backed, RUNNING rows with no heartbeat for that many seconds
        are failed before each ask (reclaims crashed peers' placeholders)."""
        for _ in range(n_trials):
            if self._db is not None:
                if stale_ttl is not None:
                    self.fail_stale_trials(stale_ttl)
                self._load_trials()  # pick up other processes' results
            trial = self.ask()
            try:
                value = float(objective(trial))
                self.tell(trial, TrialState.COMPLETE, value)
            except TrialPruned:
                self.tell(trial, TrialState.PRUNED, None)
            except catch:
                self.tell(trial, TrialState.FAIL, None)

    @property
    def best_trial(self) -> FrozenTrial:
        completed = [t for t in self.trials if t.state == TrialState.COMPLETE]
        assert completed, "no completed trials"
        key = (lambda t: t.value) if self.direction == "minimize" else (lambda t: -t.value)
        return min(completed, key=key)

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    @property
    def best_params(self) -> Dict[str, Any]:
        return self.best_trial.params

    def trials_dataframe(self):
        import pandas as pd

        return pd.DataFrame(
            [
                {
                    "number": t.number,
                    "state": t.state,
                    "value": t.value,
                    **{f"params_{k}": v for k, v in t.params.items()},
                }
                for t in self.trials
            ]
        )


def create_study(
    direction: str = "minimize",
    storage: Optional[str] = None,
    study_name: str = "default",
    sampler_seed: Optional[int] = None,
    **kwargs,
) -> Study:
    return Study(
        direction=direction,
        storage=storage,
        study_name=study_name,
        sampler_seed=sampler_seed,
        **kwargs,
    )

"""PyTorch port: the HPO engine (``deepbedmap_tpu_torch/hpo``).

The cases of ``tests/test_hpo_pruner.py`` (hand-computed ASHA, Hyperband
and median-pruner oracles; the reference's configuration is
HyperbandPruner(min_resource=15, max_resource=150, reduction_factor=3),
srgan_train.py:1740-1744) and the HPO cases of ``tests/test_checkpoint_hpo.py``
(convergence, shared sqlite storage, concurrent worker processes, stale
trials, ``suggest_int`` and fixed parameters), run on the port's engine; and
a parity test: a seeded, pruned study of 40 trials through the port's engine
and JAX's gives the same parameters, states, values, intermediate values and
sqlite rows (the ``ts`` column aside), exactly, under each pruner.
"""

import json
import os
import sqlite3
import zlib

import pytest
import torch

from deepbedmap_tpu.hpo import TrialPruned as JaxTrialPruned
from deepbedmap_tpu.hpo import create_study as jax_create_study
from deepbedmap_tpu_torch.hpo import TrialPruned, create_study
from deepbedmap_tpu_torch.hpo.engine import TrialState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def replay(study, histories):
    """Replay scripted (step, value) histories through the engine exactly the
    way train.objective drives it: report -> should_prune after every report.
    Returns {name: decisions} where decisions[i] is should_prune after the
    i-th report. A pruned trial stops reporting, like a real objective."""
    decisions = {}
    for name, hist in histories.items():
        trial = study.ask()
        decisions[name] = []
        pruned = False
        for step, value in hist:
            trial.report(value, step)
            prune = trial.should_prune()
            decisions[name].append(prune)
            if prune:
                study.tell(trial, TrialState.PRUNED, None)
                pruned = True
                break
        if not pruned:
            study.tell(trial, TrialState.COMPLETE, hist[-1][1])
    return decisions


def test_sha_history_1_few_peers_only_best_promotes():
    """min_resource=1, eta=2: rung 0 completes at step 1.

    A reports 1.0@1: competing=[1.0], idx=max(1//2-1,0)=0, 1.0<=1.0 -> keep.
    B reports 2.0@1: competing=[1.0,2.0], idx=max(2//2-1,0)=0, cutoff=1.0,
      2.0>1.0 -> PRUNE (with fewer than eta peers only the best survives).
    C reports 0.5@1: competing=[0.5,1.0,2.0], idx=0, cutoff=0.5 -> keep.
    """
    study = create_study(
        pruner="halving", min_resource=1, reduction_factor=2, max_resource=None
    )
    d = replay(
        study,
        {"A": [(1, 1.0)], "B": [(1, 2.0)], "C": [(1, 0.5)]},
    )
    assert d["A"] == [False]
    assert d["B"] == [True]
    assert d["C"] == [False]


def test_sha_history_2_multi_rung_walk():
    """min_resource=1, eta=2 -> rungs at steps 1, 2, 4.

    A: 1.0@1 keep; 1.0@2 rung1 competing=[1.0] keep; 1.0@4 rung2 keep.
    B: 0.5@1 competing=[1.0,0.5] cutoff=0.5 keep; 0.4@2 rung1
       competing=[1.0,0.4] cutoff=0.4 keep; 0.4@4 rung2 competing=[1.0,0.4]
       cutoff=0.4 keep.
    C: 0.7@1 competing=[1.0,0.5,0.7] idx=max(3//2-1,0)=0 cutoff=0.5,
       0.7>0.5 -> PRUNE at its first report.
    D: 0.3@1 competing=[1.0,0.5,0.7,0.3] idx=max(4//2-1,0)=1 ->
       sorted [0.3,0.5,0.7,1.0] cutoff=0.5, 0.3<=0.5 keep; then 0.6@2:
       rung1 competing=[1.0,0.4,0.6] idx=0 cutoff=0.4, 0.6>0.4 -> PRUNE.
    """
    study = create_study(
        pruner="halving", min_resource=1, reduction_factor=2, max_resource=None
    )
    d = replay(
        study,
        {
            "A": [(1, 1.0), (2, 1.0), (4, 1.0)],
            "B": [(1, 0.5), (2, 0.4), (4, 0.4)],
            "C": [(1, 0.7)],
            "D": [(1, 0.3), (2, 0.6)],
        },
    )
    assert d["A"] == [False, False, False]
    assert d["B"] == [False, False, False]
    assert d["C"] == [True]
    assert d["D"] == [False, True]


def test_sha_history_3_passed_rungs_are_permanent():
    """A promotion is never revoked when later trials beat the old cutoff.

    min_resource=1, eta=2. A: 1.0@1 keep (only value). B: 0.1@1 ->
    competing=[1.0,0.1] cutoff=0.1 keep. A reports 1.0@2 (rung 1): rung 0 was
    already passed, so only rung 1 is checked: competing at rung1 = [1.0]
    (B hasn't reached step 2) -> keep. A stateless re-check of rung 0 would
    have pruned A here (cutoff moved to 0.1) — ASHA must not."""
    study = create_study(
        pruner="halving", min_resource=1, reduction_factor=2, max_resource=None
    )
    a = study.ask()
    a.report(1.0, 1)
    assert not a.should_prune()
    b = study.ask()
    b.report(0.1, 1)
    assert not b.should_prune()
    a.report(1.0, 2)
    assert not a.should_prune()  # rung 0 pass is permanent


def test_sha_rung_value_is_first_crossing_not_best():
    """The rung value is what the trial reported when it crossed the rung,
    not its best-so-far. A posts 1.0@1 (rung 0 value = 1.0) then improves to
    0.05@2; B posts 0.5@1: competing at rung 0 is [1.0, 0.5] (A's 0.05 came
    after A crossed), cutoff 0.5 -> B keeps. If best-so-far were used, A's
    rung value would be 0.05 and B would be pruned."""
    study = create_study(
        pruner="halving", min_resource=1, reduction_factor=2, max_resource=None
    )
    a = study.ask()
    a.report(1.0, 1)
    assert not a.should_prune()
    a.report(0.05, 2)
    assert not a.should_prune()
    study.tell(a, TrialState.COMPLETE, 0.05)
    b = study.ask()
    b.report(0.5, 1)
    assert not b.should_prune()


def test_sha_nan_is_pruned_at_rung():
    study = create_study(
        pruner="halving", min_resource=1, reduction_factor=2, max_resource=None
    )
    t = study.ask()
    t.report(float("nan"), 1)
    assert t.should_prune()


def test_sha_maximize_direction():
    """Same as history 1 mirrored: maximize, so B's 2.0 is the best and A's
    1.0 gets pruned once a better peer exists at the rung."""
    study = create_study(
        direction="maximize",
        pruner="halving",
        min_resource=1,
        reduction_factor=2,
        max_resource=None,
    )
    d = replay(study, {"B": [(1, 2.0)], "A": [(1, 1.0)]})
    assert d["B"] == [False]
    assert d["A"] == [True]


def test_hyperband_bracket_assignment_reference_config():
    """Reference config (srgan_train.py:1740-1744): min=15, max=150, eta=3 ->
    n_brackets = floor(log3(10)) + 1 = 3, budgets [ceil(3/1), ceil(3/2),
    ceil(3/3)] = [3, 2, 1]. Assignment is crc32('<study>_<n>') % 6 mapped
    through cumulative budgets — deterministic, and over many trials every
    bracket is used with frequencies ~ 3:2:1."""
    study = create_study(
        pruner="hyperband",
        study_name="DeepBedMap_tuning",
        min_resource=15,
        max_resource=150,
        reduction_factor=3,
    )
    assert study._n_brackets() == 3
    counts = [0, 0, 0]
    for n in range(600):
        b = study._bracket_id(n)
        # recompute the documented formula independently
        h = zlib.crc32(f"DeepBedMap_tuning_{n}".encode()) % 6
        expected = 0 if h < 3 else (1 if h < 5 else 2)
        assert b == expected
        counts[b] += 1
    assert all(c > 0 for c in counts)
    assert counts[0] > counts[1] > counts[2]


def test_hyperband_late_bracket_never_prunes_before_first_rung():
    """A bracket-s trial's first rung completes at min_resource * eta^s; with
    the reference config a bracket-2 trial cannot be pruned before step
    15 * 9 = 135 no matter how bad it is."""
    study = create_study(
        pruner="hyperband",
        study_name="DeepBedMap_tuning",
        min_resource=15,
        max_resource=150,
        reduction_factor=3,
    )
    # find a trial number in bracket 2 and one in bracket 0
    b2 = next(n for n in range(100) if study._bracket_id(n) == 2)
    b0 = next(n for n in range(100) if study._bracket_id(n) == 0)
    assert b2 != b0

    # a strong early finisher in bracket 0's rung record
    for number, value in [(b0, 0.1)]:
        while len(study.trials) < number:
            filler = study.ask()
            study.tell(filler, TrialState.COMPLETE, 999.0)
        t = study.ask()
        t.report(value, 15)
        t.should_prune()
        study.tell(t, TrialState.COMPLETE, value)

    while len(study.trials) < b2:
        filler = study.ask()
        study.tell(filler, TrialState.COMPLETE, 999.0)
    bad = study.ask()
    assert study._bracket_id(bad.number) == 2
    for step in (15, 45, 134):
        bad.report(1e6, step)
        assert not bad.should_prune()  # first rung for bracket 2 is step 135
    bad.report(1e6, 135)
    pruned_at_135 = bad.should_prune()
    # only prunable at 135 if some other bracket-2 trial recorded a better
    # rung value; none did, so it promotes (sole value at its rung)
    assert not pruned_at_135


def test_median_pruner_oracle():
    """Optuna MedianPruner: no pruning before pruner_n_startup_trials
    completed trials; then prune iff best-so-far > median of completed
    trials' values at the same step.

    3 completed trials report at step 1: values 1.0, 2.0, 3.0 -> median 2.0.
    X reports 2.5@1 -> 2.5 > 2.0 PRUNE. Y reports 2.0@1 -> not strictly
    worse, keep."""
    study = create_study(pruner="median", pruner_n_startup_trials=3)
    for v in (1.0, 2.0, 3.0):
        t = study.ask()
        t.report(v, 1)
        assert not t.should_prune() or v != 1.0  # startup guard while < 3 done
        study.tell(t, TrialState.COMPLETE, v)
    x = study.ask()
    x.report(2.5, 1)
    assert x.should_prune()
    study.tell(x, TrialState.PRUNED, None)
    y = study.ask()
    y.report(2.0, 1)
    assert not y.should_prune()


def test_median_pruner_startup_guard():
    study = create_study(pruner="median", pruner_n_startup_trials=5)
    for v in (1.0, 2.0):
        t = study.ask()
        t.report(v, 1)
        study.tell(t, TrialState.COMPLETE, v)
    x = study.ask()
    x.report(100.0, 1)
    assert not x.should_prune()  # only 2 < 5 completed trials


def test_objective_style_loop_still_converges():
    """The train.objective drive pattern (report+should_prune per epoch,
    TrialPruned raised) still completes and finds the minimum with the
    reference's hyperband config."""
    study = create_study(
        pruner="hyperband",
        sampler_seed=0,
        n_startup_trials=5,
        min_resource=15,
        max_resource=150,
        reduction_factor=3,
    )

    def objective(trial):
        x = trial.suggest_float("x", -5.0, 5.0)
        for epoch in range(1, 151):
            trial.report((x - 3.0) ** 2 + 100.0 / epoch, epoch)
            if trial.should_prune():
                raise TrialPruned
        return (x - 3.0) ** 2

    study.optimize(objective, n_trials=30)
    states = {t.state for t in study.trials}
    assert TrialState.COMPLETE in states
    assert study.best_value < 4.0
    assert abs(study.best_params["x"] - 3.0) < 2.0


def test_hpo_study_converges_and_prunes():
    study = create_study(direction="minimize", sampler_seed=0, n_startup_trials=5)

    def objective(trial):
        x = trial.suggest_float("x", -10.0, 10.0)
        lr = trial.suggest_float("lr", 1e-4, 2e-4, step=0.1e-4)
        for step in range(30):
            trial.report((x - 3.0) ** 2 + step * 0.0, step)
            if trial.should_prune():
                raise TrialPruned()
        return (x - 3.0) ** 2

    study.optimize(objective, n_trials=40)
    assert study.best_value < 2.0  # found the basin around x=3
    assert abs(study.best_params["x"] - 3.0) < 1.5
    # quantised param respects the grid
    lr = study.best_params["lr"]
    assert abs((lr - 1e-4) / 0.1e-4 - round((lr - 1e-4) / 0.1e-4)) < 1e-9


def test_hpo_sqlite_shared_storage(tmp_path):
    db = f"sqlite:///{tmp_path}/study.db"

    def objective(trial):
        return trial.suggest_float("x", 0.0, 1.0) ** 2

    s1 = create_study(storage=db, sampler_seed=1)
    s1.optimize(objective, n_trials=5)
    # a second process/studies object sees the first's trials
    s2 = create_study(storage=db, sampler_seed=2)
    assert len(s2.trials) == 5
    s2.optimize(objective, n_trials=3)
    s3 = create_study(storage=db)
    assert len(s3.trials) == 8
    assert s3.best_value <= s1.best_value


def test_hpo_concurrent_processes_lose_no_trials(tmp_path):
    """N worker processes optimizing one sqlite study concurrently must
    produce N*M distinct, consecutively-numbered COMPLETE trials — the
    reference's actual usage is 4 async GPU workers on one study
    (srgan_train.py:1725-1747); round-2 verdict found ask() minted duplicate
    numbers and INSERT OR REPLACE silently dropped the loser."""
    import subprocess
    import sys

    db_path = tmp_path / "study.db"
    n_procs, n_trials = 4, 6
    worker = (
        "import sys\n"
        "from deepbedmap_tpu_torch.hpo.engine import create_study\n"
        "seed = int(sys.argv[1])\n"
        f"study = create_study(storage='sqlite:///{db_path}', sampler_seed=seed)\n"
        "import time, random\n"
        "def objective(trial):\n"
        "    x = trial.suggest_float('x', 0.0, 1.0)\n"
        "    time.sleep(random.random() * 0.02)  # interleave asks/tells\n"
        "    return (x - 0.5) ** 2\n"
        f"study.optimize(objective, n_trials={n_trials})\n"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker, str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=dict(os.environ, PYTHONPATH=ROOT),
        )
        for i in range(n_procs)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()

    study = create_study(storage=f"sqlite:///{db_path}")
    total = n_procs * n_trials
    assert len(study.trials) == total  # nothing lost
    numbers = sorted(t.number for t in study.trials)
    assert numbers == list(range(total))  # distinct + consecutive
    assert all(t.state == "COMPLETE" for t in study.trials)
    assert all(t.value is not None and "x" in t.params for t in study.trials)


def test_hpo_stale_running_trials_reclaimed(tmp_path):
    """A worker that crashes after ask() leaves a RUNNING placeholder row;
    fail_stale_trials must reclaim it (as FAIL) once its heartbeat — claim or
    intermediate report — is older than the TTL, while live trials survive."""
    import time

    db = f"sqlite:///{tmp_path}/study.db"
    s1 = create_study(storage=db, sampler_seed=0)
    ghost = s1.ask()  # simulated crash: never told
    ghost.suggest_float("x", 0.0, 1.0)

    s2 = create_study(storage=db, sampler_seed=1)
    live = s2.ask()
    live.suggest_float("x", 0.0, 1.0)
    time.sleep(0.6)
    live.report(0.5, 0)  # heartbeat: report() advances the row's ts

    # only the ghost is stale at a TTL that postdates its claim but
    # predates the live trial's report
    s3 = create_study(storage=db)
    reclaimed = s3.fail_stale_trials(ttl_seconds=0.5)
    assert reclaimed == 1
    states = {t.number: t.state for t in s3.trials}
    assert states[ghost.number] == TrialState.FAIL
    assert states[live.number] == TrialState.RUNNING
    # the live trial's intermediate report is visible cross-process
    inter = next(t for t in s3.trials if t.number == live.number).intermediate
    assert inter == {0: 0.5}
    # the live trial can still complete
    s2.tell(live, TrialState.COMPLETE, 0.5)
    s4 = create_study(storage=db)
    assert {t.number: t.state for t in s4.trials}[live.number] == (
        TrialState.COMPLETE
    )


def test_hpo_suggest_int_and_fixed():
    study = create_study(sampler_seed=0)
    trial = study.ask(fixed={"blocks": 12})
    assert trial.suggest_int("blocks", 1, 12) == 12
    assert isinstance(trial.suggest_int("other", 1, 4), int)


def _analytic(trial, pruned):
    """An analytic objective the pruners act on: a bowl in (x, lr) plus a
    decaying per-epoch term, an integer and a log-scaled parameter, and NaN
    reports for some trials (pruned at their first rung). ``pruned`` is the
    engine's TrialPruned. (No ``suggest_categorical``: JAX's TPE fails on a
    categorical parameter once it leaves the random startup;
    ``test_categorical_study_completes_past_its_startup_trials``.)"""
    x = trial.suggest_float("x", -5.0, 5.0)
    lr = trial.suggest_float("lr", 1e-4, 2e-4, step=0.1e-4)
    blocks = trial.suggest_int("blocks", 1, 12)
    bias = trial.suggest_float("bias", 1e-3, 1.0, log=True)
    for epoch in range(1, 31):
        value = (x - 3.0) ** 2 + 1e4 * (lr - 1.5e-4) ** 2 + 0.1 * blocks + bias \
            + 10.0 / epoch
        if x < -4.0:
            value = float("nan")
        trial.report(value, epoch)
        if trial.should_prune():
            raise pruned()
    return (x - 3.0) ** 2 + 0.1 * blocks + bias


@pytest.mark.parametrize("pruner", ["hyperband", "halving", "median"])
def test_seeded_study_matches_jax(tmp_path, pruner):
    kw = dict(direction="minimize", sampler_seed=7, n_startup_trials=4, pruner=pruner,
              min_resource=2, max_resource=30, reduction_factor=3,
              study_name="parity")
    ours = create_study(storage=f"sqlite:///{tmp_path}/port.db", **kw)
    ours.optimize(lambda t: _analytic(t, TrialPruned), n_trials=40)
    theirs = jax_create_study(storage=f"sqlite:///{tmp_path}/jax.db", **kw)
    theirs.optimize(lambda t: _analytic(t, JaxTrialPruned), n_trials=40)

    def frozen(study):
        return [(t.number, t.state, t.value, t.params, t.intermediate) for t in study.trials]

    assert frozen(ours) == frozen(theirs)
    states = [t.state for t in ours.trials]
    assert states.count(TrialState.COMPLETE) >= 5, states
    assert TrialState.PRUNED in states, states
    assert (ours.best_params, ours.best_value) == (theirs.best_params, theirs.best_value)

    def rows(path):
        with sqlite3.connect(path) as db:
            return db.execute("SELECT study, number, state, value, params, intermediate "
                              "FROM trials ORDER BY number").fetchall()

    got, want = rows(f"{tmp_path}/port.db"), rows(f"{tmp_path}/jax.db")
    assert len(got) == 40 and got == want
    assert all(len(json.loads(r[4])) == 4 for r in got)


def _categorical(trial):
    # a string choice and a numeric one beside a float: the TPE phase models
    # each categorical parameter by its choice's index
    act = trial.suggest_categorical("activation", ["relu", "lrelu", "elu"])
    width = trial.suggest_categorical("width", [16, 32, 64])
    x = trial.suggest_float("x", -2.0, 2.0)
    return {"relu": 1.0, "lrelu": 0.0, "elu": 0.5}[act] + abs(width - 32) / 32 + x * x


def test_categorical_study_completes_past_its_startup_trials():
    # the port's TPE reads the choice's index, so a categorical study runs
    # past its 4 random startup trials and finds the best choices; JAX's
    # engine raises there (float() of a string choice), a stated deviation
    kw = dict(direction="minimize", sampler_seed=3, n_startup_trials=4)
    ours = create_study(**kw)
    ours.optimize(_categorical, n_trials=30)
    states = [t.state for t in ours.trials]
    assert states.count(TrialState.COMPLETE) == 30, states
    assert {t.params["activation"] for t in ours.trials} <= {"relu", "lrelu", "elu"}
    # the TPE phase exploits the best width's index (32: 24 of the 26)
    tpe_widths = [t.params["width"] for t in ours.trials[4:]]
    assert tpe_widths.count(32) > len(tpe_widths) // 2, tpe_widths
    assert ours.best_value <= min(t.value for t in ours.trials[:4])
    theirs = jax_create_study(**kw)
    with pytest.raises(ValueError):
        theirs.optimize(_categorical, n_trials=30)

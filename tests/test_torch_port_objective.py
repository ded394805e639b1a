"""PyTorch port: the search's training objective, its fixed-area evaluator
and the CLI's ``hpo``, against the JAX package on the CPU.

- Evaluator: ``evalx.make_fixed_evaluator`` and JAX's on bridged weights
  (2 RRDBs, init scale 1.0, an 11-px test area, 40 track points): RMSE
  within ``TOL_EVAL_RMSE`` relative, ``.predict`` within ``TOL_EVAL_GRID``
  of the grid's range, ``.bounds`` and ``.resolution`` equal.
- Objective: the port's ``objective`` and JAX's on the same 8 synthetic
  tiles, one fixed trial (1 RRDB, batch 2, 2 epochs, 3 steps an epoch), the
  port starting from JAX's ``create_gan_state`` bridged (the port module's
  ``create_gan_state`` is substituted). Both objectives' ``GeneratorConfig``
  draws at init scale 1.0 (and deformable clamp 1, which shortens JAX's
  compile): at the default 0.1 the generator's output is ~1e-5 m and D's
  train-mode BatchNorm normalises round-off, so the step's results move by
  O(1) with the summation order (``tests/test_torch_port_train.py``). Even
  at 1.0, six GAN steps of Adam (whose first moves are ~lr * sign(g)
  wherever a gradient is round-off-sized) amplify fp32 round-off: the port
  from weights perturbed by 1e-5 moves D's loss by 2.6e-4 and the dev loss
  by 1.4e-3 relative, more than the port differs from JAX (2.9e-4 and
  2.4e-4). So both remedies apply: init scale 1.0, and the perturbation
  tolerance of ``tests/test_torch_port_train.py``.
  The records agree epoch by epoch, key for key, each entry within the
  larger of ``RTOL_RECORD`` relative and ``NOISE_K`` times the largest move
  of the port's own run under ``PERTURB_DRAWS`` weight perturbations of
  ``PERTURB`` (the CPU's own change; JAX's would cost another compile).
- Pruning: with the epoch functions scripted (the same metric series in
  both), divergence (a NaN loss, PSNR <= 0) and ``should_prune`` raise
  ``TrialPruned`` at the same epoch, after the same records, in both; and
  the port really prunes a trial whose tiles hold a NaN.
- Tracker: the port's version of ``test_objective_tracker_roundtrip``
  (parameters, per-epoch metrics, one predicted image per epoch, the npz,
  the model graph equal to JAX's ``to_dot`` byte for byte), then
  ``DeepBedMap.from_experiment`` rebuilds the trial's best generator bit
  for bit (against the trial's checkpoint, saved at the same epoch).
- The CLI's ``hpo``: with both objectives replaced by one analytic function,
  the port's JSON and report (pandas unimportable) equal JAX's, which builds
  its report with pandas; and one real trial of ``hpo --tiny`` with the
  fixed-area evaluator wired from files.
"""

import dataclasses
import functools
import importlib
import json
import math
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from deepbedmap_tpu import cli as jax_cli
from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.config import TrainConfig as JaxTrainConfig
from deepbedmap_tpu.data.dataset import TileDataset as JaxTileDataset
from deepbedmap_tpu.evalx.fixed import make_fixed_evaluator as jax_make_fixed_evaluator
from deepbedmap_tpu.hpo import TrialPruned as JaxTrialPruned
from deepbedmap_tpu.hpo import create_study as jax_create_study
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.train.state import create_gan_state as jax_create_gan_state
from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.bridge import jax_d_vars_to_state_dict, jax_params_to_state_dict
from deepbedmap_tpu_torch.cli import main
from deepbedmap_tpu_torch.config import GeneratorConfig
from deepbedmap_tpu_torch.data.dataset import TileDataset, epoch_batches, train_dev_split
from deepbedmap_tpu_torch.evalx.fixed import make_fixed_evaluator
from deepbedmap_tpu_torch.hpo import TrialPruned, create_study
from deepbedmap_tpu_torch.models.api import build_generator
from deepbedmap_tpu_torch.train import objective as port_objective
from deepbedmap_tpu_torch.train.checkpoint import load_generator_state_dict
from deepbedmap_tpu_torch.train.state import create_gan_state
from deepbedmap_tpu_torch.train.steps import StepMetrics
from deepbedmap_tpu_torch.utils.tracking import LocalTracker

jax_objective = importlib.import_module("deepbedmap_tpu.train.objective")
jax_summary = importlib.import_module("deepbedmap_tpu.models.summary")

TOL_EVAL_RMSE = 1e-5  # relative
TOL_EVAL_GRID = 1e-4  # of the grid's range
RTOL_RECORD = 1e-4
# the port's own run again from weights multiplied by (1 + PERTURB * N(0, 1)),
# PERTURB_DRAWS times: a record entry that moves more than RTOL_RECORD under
# that is round-off-bound, and is held to NOISE_K times its largest move
PERTURB, PERTURB_DRAWS, NOISE_K = 1e-5, 2, 3
G_FLAGS = dict(init_scale=1.0, deform_clamp=1)
FIXED = dict(batch_size_exponent=1, learning_rate=1.5e-4, num_residual_blocks=1,
             residual_scaling=0.2, num_epochs=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_space(trial):
    """tests/test_objective.py's space."""
    return dict(
        batch_size_exponent=trial.suggest_int("batch_size_exponent", 1, 1),
        learning_rate=trial.suggest_float("learning_rate", 1e-4, 2e-4, step=0.5e-4),
        num_residual_blocks=trial.suggest_int("num_residual_blocks", 1, 1),
        residual_scaling=trial.suggest_float("residual_scaling", 0.1, 0.3, step=0.1),
        num_epochs=trial.suggest_int("num_epochs", 2, 2),
    )


def _test_area(seed=0, points=40):
    """tests/test_objective.py's fixed test area: an 11-px conditioning
    stack (36^2 output over 9 km) and a track inside it."""
    rs = np.random.RandomState(seed)
    inputs = {
        "X": rs.rand(1, 1, 11, 11).astype(np.float32),
        "W1": rs.rand(1, 1, 110, 110).astype(np.float32),
        "W2": rs.rand(1, 2, 22, 22).astype(np.float32),
        "W3": rs.rand(1, 1, 11, 11).astype(np.float32),
    }
    bounds = (0.0, 0.0, 36 * 250.0, 36 * 250.0)
    track = (rs.uniform(1000, 8000, points).astype(np.float32),
             rs.uniform(1000, 8000, points).astype(np.float32),
             rs.randn(points).astype(np.float32) * 50)
    return inputs, track, bounds


def test_fixed_evaluator_matches_jax():
    inputs, track, bounds = _test_area()
    j_model, params = jax_build_generator(JaxGeneratorConfig(num_residual_blocks=2,
                                                             init_scale=1.0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = build_generator(GeneratorConfig(num_residual_blocks=2), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(tree))

    theirs = jax_make_fixed_evaluator(j_model, inputs, track, bounds)
    ours = make_fixed_evaluator(model, inputs, track, bounds, device="cpu")
    want_grid = theirs.predict(params)
    got_grid = ours.predict()
    assert got_grid.shape == want_grid.shape == (36, 36)
    span = float(want_grid.max() - want_grid.min())
    assert span > 1.0
    assert np.abs(got_grid - want_grid).max() <= TOL_EVAL_GRID * span
    want, got = theirs(params), ours(model)
    assert np.isfinite(got) and got > 1.0
    assert abs(got - want) <= TOL_EVAL_RMSE * abs(want)
    assert ours() == got  # None scores g_model
    assert (ours.bounds, ours.resolution) == (theirs.bounds, theirs.resolution)


def _bridged_create_gan_state(g_cfg, d_cfg=None, t_cfg=None, seed=None, device="cuda"):
    """The port's create_gan_state, holding JAX's initial weights for the same
    configurations (JAX's objective draws them with its own seeds)."""
    j_state = jax_create_gan_state(JaxGeneratorConfig(**dataclasses.asdict(g_cfg)),
                                   t_cfg=JaxTrainConfig(**dataclasses.asdict(t_cfg)))
    state = create_gan_state(g_cfg, t_cfg=t_cfg, device=device)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    state.g.load_state_dict(jax_params_to_state_dict(np_tree(j_state.g_params)))
    state.d.load_state_dict(jax_d_vars_to_state_dict(
        {"params": np_tree(j_state.d_params), "batch_stats": np_tree(j_state.d_batch_stats)}))
    return state


def _run(module, study_fn, dataset, **kw):
    """One objective call of ``module`` on a fixed trial; (value or
    'pruned', the records handed to ``log``)."""
    records = []
    study = study_fn(direction="minimize", sampler_seed=0, pruner="none")
    try:
        value = module.objective(study.ask(fixed=dict(FIXED)), dataset, suggest=tiny_space,
                                 log=lambda epoch, rec: records.append((epoch, rec)), **kw)
    except (TrialPruned, JaxTrialPruned):
        value = "pruned"
    return value, records


@pytest.fixture(scope="module")
def jax_run():
    """JAX's objective once (its epoch functions take the longest compile of
    this file)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_objective, "GeneratorConfig",
                   functools.partial(JaxGeneratorConfig, **G_FLAGS))
        return _run(jax_objective, jax_create_study, JaxTileDataset.synthetic(8, seed=0))


def _perturbed(draw):
    def create(*args, **kwargs):
        state = _bridged_create_gan_state(*args, **kwargs)
        gen = torch.Generator().manual_seed(draw)
        with torch.no_grad():
            for model in (state.g, state.d):
                for p in model.parameters():
                    p.mul_(1 + PERTURB * torch.randn(p.shape, generator=gen))
        return state

    return create


def test_objective_matches_jax(jax_run, monkeypatch):
    monkeypatch.setattr(port_objective, "GeneratorConfig",
                        functools.partial(GeneratorConfig, **G_FLAGS))
    runs = []
    for create in [_bridged_create_gan_state] + [_perturbed(d) for d in range(PERTURB_DRAWS)]:
        monkeypatch.setattr(port_objective, "create_gan_state", create)
        runs.append(_run(port_objective, create_study,
                         TileDataset.synthetic(8, seed=0, device="cpu")))
    (value, records), perturbed = runs[0], runs[1:]
    want_value, want_records = jax_run
    assert [e for e, _ in records] == [e for e, _ in want_records] == [0, 1]
    for epoch, ((_, got), (_, want)) in enumerate(zip(records, want_records)):
        assert list(got) == list(want)
        assert got["rmse_is_proxy"] is want["rmse_is_proxy"] is True
        for k, v in want.items():
            if k == "rmse_is_proxy":
                continue
            assert np.isfinite(v) and np.isfinite(got[k]), (k, v, got[k])
            noise = max(abs(run[1][epoch][1][k] - got[k]) for run in perturbed)
            tol = max(RTOL_RECORD * abs(v), NOISE_K * noise)
            print(f"epoch {epoch} {k}: |port - JAX| {abs(got[k] - v):.2e}, tolerance "
                  f"{tol:.2e} (perturbed run moved {noise:.2e})")
            assert abs(got[k] - v) <= tol, (epoch, k, got[k], v, tol)
    assert value == min(rec["rmse_test"] for _, rec in records)
    noise = max(abs(run[0] - value) for run in perturbed)
    assert abs(value - want_value) <= max(RTOL_RECORD * abs(want_value), NOISE_K * noise)


# the epoch functions scripted: per epoch, one value of each metric for the
# train epoch and one for the dev epoch; each case ends its script where it
# should be pruned
def _series(epochs, nan_at=None, psnr_neg_at=None):
    out = []
    for e in range(epochs):
        train = dict(discriminator_loss=1.0 - 0.1 * e, discriminator_accu=0.5,
                     generator_loss=2.0 - 0.2 * e, generator_psnr=30.0 + e,
                     generator_ssim=0.5)
        dev = {k: v * 1.1 for k, v in train.items()}
        if e == nan_at:
            train["generator_loss"] = float("nan")
        if e == psnr_neg_at:
            train["generator_psnr"] = -1.0
        out.append((train, dev))
    return out


def _scripted_epoch_fns(series, as_port: bool):
    calls = []

    def metrics(values, n):
        if as_port:
            return [StepMetrics(**{k: torch.tensor(v) for k, v in values.items()})] * n
        return SimpleNamespace(**{k: np.full(n, v, np.float32) for k, v in values.items()})

    def make_epoch_fns(*args, **kwargs):
        def train_fn(state, batches):
            calls.append(len(calls))
            return state, metrics(series[len(calls) - 1][0], len(batches))

        def eval_fn(state, batches):
            return metrics(series[len(calls) - 1][1], len(batches))

        return train_fn, eval_fn

    return make_epoch_fns, calls


def _pruning_study(create):
    """A study whose halving pruner (min_resource 1, eta 2) has a completed
    trial that reported 0.1 at each of epochs 0-3: a trial reporting more at
    epoch 1 is pruned there."""
    study = create(direction="minimize", sampler_seed=0, pruner="halving",
                   min_resource=1, reduction_factor=2, max_resource=None)
    t = study.ask()
    for e in range(4):
        t.report(0.1, e)
    study.tell(t, "COMPLETE", 0.1)
    return study


@pytest.mark.parametrize("case,epochs,pruned_at", [
    ("nan_loss", 4, 2), ("psnr_not_positive", 4, 1), ("should_prune", 4, 1),
    ("completes", 3, None)])
def test_pruning_epoch_matches_jax(monkeypatch, case, epochs, pruned_at):
    series = _series(epochs, nan_at=2 if case == "nan_loss" else None,
                     psnr_neg_at=1 if case == "psnr_not_positive" else None)
    fixed = dict(FIXED, num_epochs=epochs)

    def space(trial):  # tiny_space with room for the fixed epochs
        return dict(tiny_space(trial),
                    num_epochs=trial.suggest_int("scripted_epochs", 1, 9))

    fixed["scripted_epochs"] = epochs
    out = {}
    for tag, module, create, pruned, data in (
            ("jax", jax_objective, jax_create_study, JaxTrialPruned,
             JaxTileDataset.synthetic(8, seed=0)),
            ("port", port_objective, create_study, TrialPruned,
             TileDataset.synthetic(8, seed=0, device="cpu"))):
        fns, calls = _scripted_epoch_fns(series, tag == "port")
        monkeypatch.setattr(module, "make_epoch_fns", fns)
        if case == "should_prune":
            study = _pruning_study(create)
        else:
            study = create(direction="minimize", sampler_seed=0, pruner="none")
        records = []
        trial = study.ask(fixed=fixed)
        try:
            value = module.objective(trial, data, suggest=space,
                                     log=lambda e, r: records.append((e, r)))
        except pruned:
            value = "pruned"
        out[tag] = (value, len(calls), records, trial.intermediate)
    assert out["port"] == out["jax"] or _nan_equal(out["port"], out["jax"])
    value, n_epochs, records, _ = out["port"]
    if pruned_at is None:
        assert value == min(r["rmse_test"] for _, r in records) and n_epochs == epochs
    else:
        assert value == "pruned" and n_epochs == pruned_at + 1


def _nan_equal(a, b) -> bool:
    """Equality with NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_nan_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_nan_equal(a[k], b[k]) for k in a)
    return a == b


def test_a_nan_tile_prunes_the_trial():
    dataset = TileDataset.synthetic(8, seed=0, device="cpu")
    # the first tile of epoch 0's first batch (the split and the shuffle are
    # the objective's: train_dev_split at seed 42, a RandomState(42) shuffle)
    train_idx, _ = train_dev_split(8, 0.95, 42)
    first = epoch_batches(train_idx, 2, np.random.RandomState(42))[0, 0]
    dataset.arrays["Y"][first, 5, 5, 0] = float("nan")
    value, records = _run(port_objective, create_study, dataset)
    assert value == "pruned"
    assert [e for e, _ in records] == [0]
    assert math.isnan(records[0][1]["generator_loss"])


def test_objective_tracker_roundtrip(tmp_path):
    """The port's objective -> tracker -> DeepBedMap.from_experiment: params
    and per-epoch metrics logged, one predicted image per epoch, the best
    weights as the reference-named npz, the model graph set, and the trained
    generator rebuilt by key."""
    dataset = TileDataset.synthetic(8, seed=0, device="cpu")
    study = create_study(direction="minimize", sampler_seed=0, pruner="none")
    root = str(tmp_path / "experiments")
    tracker = LocalTracker(root)
    inputs, track, bounds = _test_area()
    ckpt_dir = str(tmp_path / "ckpt")

    value = port_objective.objective(
        study.ask(), dataset, suggest=tiny_space, tracker=tracker,
        checkpoint_dir=ckpt_dir,
        rmse_save_threshold=float("inf"), rmse_upload_threshold=float("inf"),
        make_evaluator=lambda g_model: make_fixed_evaluator(
            g_model, inputs, track, bounds, device="cpu"),
    )
    tracker.end()
    assert np.isfinite(value)

    assets = tracker.asset_list()
    for epoch in (0, 1):
        assert f"epoch_{epoch:03d}_predicted_test_image.png" in assets
    assert "srgan_generator_model_weights.npz" in assets
    metrics = tracker.metrics()
    assert len(metrics) == 2
    assert metrics[0]["metrics"]["rmse_is_proxy"] is False
    assert value == min(m["metrics"]["rmse_test"] for m in metrics)
    params = tracker.params()
    assert params["num_residual_blocks"] == 1 and params["batch_size"] == 2
    assert "residual_scaling" in params

    _, j_params = jax_build_generator(JaxGeneratorConfig(num_residual_blocks=1))
    with open(os.path.join(tracker.dir, "graph.txt")) as f:
        assert f.read() == jax_summary.to_dot(j_params, title="generator")

    dbm = DeepBedMap.from_experiment(
        root, "latest", download_path=str(tmp_path / "fetched" / "weights.npz"),
        device="cpu")
    assert dbm.cfg.num_residual_blocks == 1
    assert dbm.cfg.residual_scaling == params["residual_scaling"]
    best = load_generator_state_dict(os.path.join(ckpt_dir, "trial_0"), use_ema=False)
    got = dbm.model.state_dict()
    assert got.keys() == best.keys()
    assert all(torch.equal(got[k], best[k]) for k in best)
    x = torch.zeros(1, 4, 4, 1)
    out = dbm.forward_fn()(x, torch.zeros(1, 40, 40, 1), torch.zeros(1, 8, 8, 2), x)
    assert out.shape == (1, 8, 8, 1) and torch.isfinite(out).all()


def _analytic_objective(pruned):
    """Both CLIs' objective replaced by one analytic function of the
    suggested parameters (with pruned trials), recording what it was given."""
    seen = []

    def objective(trial, dataset, suggest=None, **kwargs):
        hp = suggest(trial)
        seen.append((len(dataset), sorted(kwargs)))
        if hp["residual_scaling"] > 0.25:
            raise pruned()
        return (hp["learning_rate"] * 1e4 - 1.5) ** 2 + hp["batch_size_exponent"] \
            + hp["residual_scaling"]

    return objective, seen


def test_cli_hpo_report_equals_jax(tmp_path, capsys, monkeypatch):
    inputs, track, bounds = _test_area()
    os.makedirs(tmp_path / "inputs")
    for k, v in inputs.items():
        np.save(tmp_path / "inputs" / f"{k}.npy", v)
    with open(tmp_path / "track.csv", "w") as f:
        f.write("x,y,z\n" + "".join(f"{x!r},{y!r},{z!r}\n" for x, y, z in
                                    zip(*(a.tolist() for a in track))))
    argv = ["hpo", "--tiny", "--trials", "9", "--synthetic-tiles", "8", "--seed", "3",
            "--top-n", "4", "--eval-inputs", str(tmp_path / "inputs"),
            "--eval-track", str(tmp_path / "track.csv"),
            "--eval-bounds", ",".join(str(v) for v in bounds)]
    out = {}
    for tag, module, run, pruned in (("jax", jax_objective, jax_cli.main, JaxTrialPruned),
                                     ("port", port_objective, main, TrialPruned)):
        fake, seen = _analytic_objective(pruned)
        monkeypatch.setattr(module, "objective", fake)
        if tag == "port":
            monkeypatch.setitem(sys.modules, "pandas", None)
        report = str(tmp_path / f"report_{tag}.json")
        args = argv + ["--storage", f"sqlite:///{tmp_path}/{tag}.db", "--report", report]
        assert run(args + (["--device", "cpu"] if tag == "port" else [])) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with open(report) as f:
            out[tag] = (res, json.load(f), seen)
    assert out["port"] == out["jax"]
    res, report, seen = out["port"]
    assert seen == [(8, ["make_evaluator"])] * 9
    assert res["value_metric"] == "rmse_test_m" and res["trials"] == 9
    assert 0 < len(res["top_trials"]) <= 4 and report["n_trials"] == 9
    values = [r["value"] for r in res["top_trials"]]
    assert values == sorted(values) and res["best_value"] == round(values[0], 4)


def test_cli_hpo_runs_a_trial_with_the_fixed_evaluator(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    inputs, track, bounds = _test_area()
    os.makedirs(tmp_path / "inputs")
    for k, v in inputs.items():
        np.save(tmp_path / "inputs" / f"{k}.npy", v)
    os.makedirs(tmp_path / "tiles")
    ds = TileDataset.synthetic(8, seed=1, device="cpu")
    for k, v in ds.arrays.items():
        np.save(tmp_path / "tiles" / f"{k}_data.npy", v.numpy().transpose(0, 3, 1, 2))
    with open(tmp_path / "track.csv", "w") as f:
        f.write("x,y,z\n" + "".join(f"{x!r},{y!r},{z!r}\n" for x, y, z in
                                    zip(*(a.tolist() for a in track))))
    assert main(["hpo", "--tiny", "--trials", "1", "--tiles", str(tmp_path / "tiles"),
                 "--eval-inputs", str(tmp_path / "inputs"),
                 "--eval-track", str(tmp_path / "track.csv"),
                 "--eval-bounds", ",".join(str(v) for v in bounds),
                 "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["trials"] == 1 and res["value_metric"] == "rmse_test_m"
    assert np.isfinite(res["best_value"]) and res["best_value"] > 1.0
    assert res["top_trials"][0]["state"] == "COMPLETE"
    assert os.path.exists(tmp_path / "ck" / "trial_0")


def test_top_trials_match_pandas():
    """The report's records where trials lack parameters (a failed trial, a
    running one from another process): pandas gives NaN and reads the
    integer column as float; so does ``top_trials``, without pandas."""
    from deepbedmap_tpu_torch.cli import top_trials

    studies = []
    for create in (create_study, jax_create_study):
        study = create(sampler_seed=0)
        for i in range(6):
            t = study.ask()
            if i == 1:
                study.tell(t, "FAIL", None)
                continue
            x, n = t.suggest_float("x", 0.0, 1.0), t.suggest_int("n", 1, 4)
            study.tell(t, "PRUNED" if i == 3 else "COMPLETE", None if i == 3 else x + n)
        study.ask()  # left RUNNING
        studies.append(study)
    df = studies[1].trials_dataframe()  # JAX's report (deepbedmap_tpu/cli.py:cmd_hpo)
    want = df[df.state == "COMPLETE"].sort_values("value").head(3).to_dict(orient="records")
    got = top_trials(studies[0], 3)
    assert json.dumps(got) == json.dumps(want)
    assert [type(r["params_n"]) for r in got] == [float] * 3

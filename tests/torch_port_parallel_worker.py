"""One rank of a multi-process run of the port's parallel layer on the CPU.

Run by ``tests/test_torch_port_{parallel,multihost,tp}.py`` as

    python tests/torch_port_parallel_worker.py CONTRACTS RANK WORLD OUT_DIR

with the repository root on ``PYTHONPATH``: every rank starts a Gloo group
over a ``file://`` store in ``OUT_DIR`` (no port to race for) whose
collectives time out after ``GROUP_TIMEOUT_S``, runs the contracts named in
``CONTRACTS`` (comma-separated) and saves what it computed under ``OUT_DIR``
for the tests, which hold it against the single-process port and against
JAX. The CLI contracts start and destroy their own groups through the CLI's
``--coordinator`` / ``--num-processes`` / ``--process-id``. It imports no
JAX; the tests import its seeded inputs.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import torch

GROUP_TIMEOUT_S = 120.0
WORKER_TIMEOUT_S = 300.0  # a whole worker's lifetime

# the inference contracts: a 1-RRDB generator at init scale 1.0 (O(1)
# outputs, so tolerances bite), a 96 x 96 region of 32-px tiles with a 3-px
# halo: three bands of three tiles, a count that no world size here divides
G_INFER = dict(num_residual_blocks=1, init_scale=1.0)
TILING = dict(tile_out=32, halo_lr=3)
REGION_LR = 24
BOUNDS = (0.0, 0.0, 96 * 250.0, 96 * 250.0)

# the training contracts: test_torch_port_train's generator (1 RRDB, clamp 1,
# init scale 1.0) and tiles, the JAX test's learning rate, a global batch of 8
G_TRAIN = dict(num_residual_blocks=1, deform_clamp=1, init_scale=1.0)
T_TRAIN = dict(batch_size=8, learning_rate=1e-3)
LOSS_CASES = {"default": {}, "noise": dict(d_instance_noise=0.5, instance_noise_seed=3)}


def launch(contracts: str, world: int, out: str):
    """Start the ``world`` ranks of a run (one process each)."""
    os.makedirs(out, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), contracts, str(r),
                              str(world), out],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
            for r in range(world)]


def finish(procs) -> None:
    """Wait for every rank (each within ``WORKER_TIMEOUT_S``; a rank that
    outlives it is killed) and raise with the stderr of any that failed."""
    failed = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            failed.append(f"rank {r} timed out after {WORKER_TIMEOUT_S} s")
            continue
        if p.returncode or f"WORKER_{r}_OK" not in out.decode():
            failed.append(f"rank {r} exited {p.returncode}:\n{err.decode()[-3000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))


def inputs_nchw(lh: int = REGION_LR, lw: int = REGION_LR, seed: int = 0) -> dict:
    """The region's seeded NCHW inputs; the conditioning goes below zero, so
    the clip runs."""
    rs = np.random.RandomState(seed)
    return {
        "X": rs.rand(1, 1, lh, lw).astype(np.float32),
        "W1": (rs.rand(1, 1, 10 * lh, 10 * lw) - 0.2).astype(np.float32),
        "W2": (rs.rand(1, 2, 2 * lh, 2 * lw) - 0.2).astype(np.float32),
        "W3": rs.rand(1, 1, lh, lw).astype(np.float32),
    }


def host_inputs(seed: int = 0) -> dict:
    return {k: v.transpose(0, 2, 3, 1) for k, v in inputs_nchw(seed=seed).items()}


def train_batch(n: int = 8, seed: int = 0) -> dict:
    """Seeded training tiles at the reference's shapes (NHWC)."""
    rs = np.random.RandomState(seed)
    shapes = dict(X=(11, 11, 1), W1=(110, 110, 1), W2=(22, 22, 2), W3=(11, 11, 1),
                  Y=(36, 36, 1))
    return {k: rs.rand(n, *s).astype(np.float32) for k, s in shapes.items()}


def tp_args(n: int = 4, seed: int = 0):
    """A batch of 11-px generator inputs (NHWC) for the TP forward."""
    rs = np.random.RandomState(seed)
    return [rs.rand(n, *s).astype(np.float32)
            for s in ((11, 11, 1), (110, 110, 1), (22, 22, 2), (11, 11, 1))]


def infer_model():
    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig

    return DeepBedMap(cfg=GeneratorConfig(**G_INFER), device="cpu")


def train_state():
    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.train.state import create_gan_state

    return create_gan_state(GeneratorConfig(**G_TRAIN), t_cfg=TrainConfig(**T_TRAIN),
                            seed=0, device="cpu")


def save_state(path: str, state, metrics=None) -> None:
    torch.save({
        "g": state.g.state_dict(), "d": state.d.state_dict(),
        "g_opt": state.g_opt.state_dict(), "d_opt": state.d_opt.state_dict(),
        "step": state.step,
        "metrics": None if metrics is None else {
            k: float(v) for k, v in vars(metrics).items()},
    }, path)


def _raises(fn, exc) -> str:
    """The message of the ``exc`` that ``fn()`` raises ('' if it does not)."""
    try:
        fn()
    except exc as e:
        return str(e) or type(e).__name__
    return ""


class Rank:
    def __init__(self, rank: int, world: int, out: str):
        self.rank, self.world, self.out = rank, world, out
        self.record = {}

    def path(self, name: str) -> str:
        return os.path.join(self.out, f"{name}_r{self.rank}")

    def cli(self, name: str, extra) -> None:
        """The CLI's continent command in this process, its group started by
        the CLI from explicit arguments; its stdout's last line is kept."""
        from deepbedmap_tpu_torch.cli import main

        d = os.path.join(self.out, "cli_inputs")
        os.makedirs(d, exist_ok=True)
        for k, v in inputs_nchw().items():
            np.save(os.path.join(d, f"{k}.npy"), v)
        argv = ["continent", "--inputs", d, "--bounds", ",".join(map(str, BOUNDS)),
                "-o", os.path.join(self.out, name), "--blocks", "1", "--device", "cpu",
                "--tile-out", str(TILING["tile_out"]), "--halo-lr", str(TILING["halo_lr"]),
                "--coordinator", "file://" + os.path.join(self.out, f"store_{name}"),
                "--num-processes", str(self.world), "--process-id", str(self.rank),
                "--backend", "gloo", *extra]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        lines = buf.getvalue().strip().splitlines()
        self.record[name] = {"rc": rc, "last_line": lines[-1] if lines else ""}

    # ---- data-parallel training -------------------------------------------
    def dp(self) -> None:
        from deepbedmap_tpu_torch.config import LossConfig, TrainConfig
        from deepbedmap_tpu_torch.parallel import (
            batch_sharding,
            make_mesh,
            make_sharded_train_step,
        )

        mesh = make_mesh(device="cpu")
        shard = batch_sharding(mesh)
        batch = {k: torch.from_numpy(v) for k, v in train_batch().items()}
        for case, l_kw in LOSS_CASES.items():
            if case != "default" and self.world != 2:
                continue
            state = train_state()
            if self.rank:  # the first call must broadcast rank 0's state
                with torch.no_grad():
                    for p in list(state.g.parameters()) + list(state.d.parameters()):
                        p.add_(1.0)
            step = make_sharded_train_step(mesh, TrainConfig(**T_TRAIN), LossConfig(**l_kw))
            state, metrics = step(state, shard(batch))
            save_state(self.path(f"dp_{case}") + ".pt", state, metrics)
        # ranks holding different row counts: every rank refuses
        step = make_sharded_train_step(mesh, TrainConfig(**T_TRAIN))
        rows = 4 if self.rank == 0 else 3
        self.record["dp_uneven"] = _raises(
            lambda: step(train_state(), {k: v[:rows] for k, v in batch.items()}), ValueError)

    # ---- tile-sharded inference -------------------------------------------
    def tiles(self) -> None:
        from deepbedmap_tpu_torch.inference import TilePlan
        from deepbedmap_tpu_torch.parallel import (
            make_mesh,
            sharded_predict_tiles,
            stitch_tiles,
        )

        mesh = make_mesh(device="cpu")
        dbm = infer_model()
        plan = TilePlan(out_h=32, out_w=96, **TILING)  # 3 tiles
        inputs = {k: torch.from_numpy(np.ascontiguousarray(v[:, : 8 * r]))
                  for (k, v), r in zip(host_inputs(1).items(), (1, 10, 2, 1))}
        out = {}
        with torch.no_grad():
            for b in (1, 2):
                t = sharded_predict_tiles(dbm.forward_fn(), inputs, plan, mesh,
                                          tiles_per_dispatch=b)
                out[f"tiles_b{b}"] = t.numpy()
            out["stitched"] = stitch_tiles(t, plan).numpy()
        canvas = dbm.predict_continent(inputs_nchw(), BOUNDS, mesh=mesh, **TILING).data
        out["canvas"] = canvas
        product = os.path.join(self.out, "mesh_product")
        ret = dbm.predict_continent(inputs_nchw(), BOUNDS, mesh=mesh, outfilepath=product,
                                    stream_product=True, **TILING)
        self.record["mesh_stream_returned"] = ret
        np.savez(self.path("tiles") + ".npz", **out)
        self.record["mesh_too_large"] = _raises(lambda: make_mesh(self.world + 1, device="cpu"),
                                                ValueError)
        first = make_mesh(1, device="cpu")
        self.record["outside_mesh"] = _raises(
            lambda: sharded_predict_tiles(dbm.forward_fn(), inputs, plan, first), ValueError)

    # ---- band-distributed inference ---------------------------------------
    def multihost(self) -> None:
        from deepbedmap_tpu_torch.inference import TilePlan
        from deepbedmap_tpu_torch.inference.continent import _band_inputs
        from deepbedmap_tpu_torch.inference.multihost import (
            predict_continent_multihost,
            predict_continent_multihost_to_geotiff,
        )
        from deepbedmap_tpu_torch.parallel import make_mesh

        dbm = infer_model()
        plan = TilePlan(out_h=96, out_w=96, **TILING)
        host = host_inputs()
        loaded, progress = [], []

        def source(band):
            loaded.append(band)
            return {k: v.numpy() for k, v in _band_inputs(host, plan, band, "cpu").items()}

        canvas = predict_continent_multihost(dbm.forward_fn(), source, plan, device="cpu",
                                             progress=lambda i, n: progress.append([i, n]))
        self.record.update(loaded=loaded, progress=progress,
                           canvas_is_none=canvas is None)
        if canvas is not None:
            np.save(self.path("mh_canvas") + ".npy", canvas)
        self.record["mh_product"] = predict_continent_multihost_to_geotiff(
            dbm.forward_fn(), host, plan, BOUNDS, os.path.join(self.out, "mh_product"),
            overviews=1, predictor=True, device="cpu")
        raster = dbm.predict_continent(inputs_nchw(), BOUNDS, multihost=True, **TILING)
        self.record["api_is_none"] = raster is None
        if raster is not None:
            np.save(self.path("mh_api") + ".npy", raster.data)
        self.record["api_stream"] = dbm.predict_continent(
            inputs_nchw(), BOUNDS, outfilepath=os.path.join(self.out, "mh_api_product"),
            multihost=True, stream_product=True, **TILING)
        mesh = make_mesh(device="cpu")
        self.record["mh_wide_mesh"] = _raises(
            lambda: predict_continent_multihost(dbm.forward_fn(), host, plan, mesh=mesh),
            ValueError)

    # ---- channel parallelism ----------------------------------------------
    def tp(self) -> None:
        from torch.distributed.tensor import Shard

        from deepbedmap_tpu_torch.parallel.tp import (
            make_mesh_2d,
            make_tp_forward,
            reduce_tp_grads,
            shard_params_tp,
            tp_param_shardings,
            tp_state_shardings,
        )

        dbm = infer_model()
        args = [torch.from_numpy(a) for a in tp_args()]
        shapes = [(1, self.world)] + ([(2, 2)] if self.world == 4 else [])
        sets = {}
        for n_data, n_model in shapes:
            mesh = make_mesh_2d(n_data, n_model, device="cpu")
            key = f"{n_data}x{n_model}"
            sets[key] = sorted(k for k, p in tp_param_shardings(
                mesh, dbm.model.state_dict()).items() if isinstance(p, Shard))
            shards = shard_params_tp(mesh, dbm.model.state_dict())
            with torch.no_grad():
                out = make_tp_forward(mesh, dbm.model, shards)(*args)
            for t in shards.values():
                t.requires_grad_(True)
            loss = make_tp_forward(mesh, dbm.model, shards)(*args).square().mean()
            loss.backward()
            reduce_tp_grads(mesh, shards)
            np.savez(self.path(f"tp_{key}") + ".npz", out=out.numpy(),
                     **{f"grad/{k}": t.grad.numpy() for k, t in shards.items()})
        self.record["tp_sharded"] = sets
        if self.world == 4:  # Adam's moments follow their parameters
            from deepbedmap_tpu_torch.config import TrainConfig
            from deepbedmap_tpu_torch.train.steps import make_train_step

            mesh = make_mesh_2d(1, 4, device="cpu")
            state, _ = make_train_step(TrainConfig(**T_TRAIN))(
                train_state(), {k: torch.from_numpy(v[:2]) for k, v in train_batch().items()})
            self.record["tp_state_sharded"] = sorted(
                k for k, p in tp_state_shardings(mesh, state).items() if isinstance(p, Shard))


def main() -> int:
    contracts, rank, world, out = sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    torch.set_num_threads(1)
    from deepbedmap_tpu_torch.parallel.distributed import initialize

    r = Rank(rank, world, out)
    if "cli_mesh" in contracts:
        r.cli("cli_mesh", ["--mesh-devices", str(world), "--stream"])
    if "cli_multihost" in contracts:
        r.cli("cli_multihost", ["--multihost", "--stream"])
    initialize("file://" + os.path.join(out, "store"), world, rank, device="cpu",
               timeout_s=GROUP_TIMEOUT_S)
    for name in ("dp", "tiles", "multihost", "tp"):
        if name in contracts:
            getattr(r, name)()
    with open(r.path("record") + ".json", "w") as f:
        json.dump(r.record, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"WORKER_{rank}_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

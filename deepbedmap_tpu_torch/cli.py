"""Command-line interface of the port: data packages, data prep, training,
search, inference, serving and the figures, on the card.

Counterpart of ``deepbedmap_tpu/cli.py``:

    python -m deepbedmap_tpu_torch verify-data [--datalist FILE]
    python -m deepbedmap_tpu_torch package-data {push,install,list} --registry DIR
    python -m deepbedmap_tpu_torch catalog [--root DIR]
    python -m deepbedmap_tpu_torch grid SURVEY.json -o out.tif [--data-dir DIR]
    python -m deepbedmap_tpu_torch build --surveys DIR --lowres BED ... -o DIR
    python -m deepbedmap_tpu_torch train [--tiles DIR | --synthetic-tiles N] --out CK
    python -m deepbedmap_tpu_torch hpo --tiles DIR --trials N --storage sqlite:///db
    python -m deepbedmap_tpu_torch predict --npz W.npz --bounds xmin,ymin,xmax,ymax ...
    python -m deepbedmap_tpu_torch evaluate --dem FILE --track FILE.csv
    python -m deepbedmap_tpu_torch continent --inputs DIR --bounds ... -o OUT [--stream]
    python -m deepbedmap_tpu_torch verify-weights --npz W.npz --inputs DIR --expected GRID
    python -m deepbedmap_tpu_torch serve --npz W.npz [--port 8500]
    python -m deepbedmap_tpu_torch figures -o OUTDIR

Every command that computes takes ``--device`` (default ``cuda``: without a
card it raises; ``--device cpu`` runs the plain versions on the CPU), runs in fp32
(TF32 off, see ``device.disable_tf32``) and prints a one-line JSON result to
stdout; human logs go to stderr. ``--checkpoint`` reads the port's own
train-state checkpoints (``train``'s ``--out``; a JAX Orbax directory raises
``ValueError``). ``--mesh-devices`` and ``--multihost`` raise
``NotImplementedError``. ``grid`` writes a GeoTIFF for ``-o *.tif`` and
NetCDF otherwise; ``build`` reads ``*.nc`` and ``*.tif`` surveys.
``--telemetry PATH``, before the command, records the port's spans and
counters (``utils.profiling``) and writes them when the command ends: PATH
(a Chrome trace) and PATH.summary.json (``snapshot()``). ``train
--live-term`` prints sparklines of the metrics after each epoch and
``--live-png`` redraws their curves into a PNG (``viz.live.LiveCurves``;
JAX's ``--live-term`` acts only beside ``--live-png``); ``figures`` writes
the paper's figure set (``viz.figure_set``, in this process, where JAX runs
``examples/figure_set.py`` in a new one). Drawing
needs matplotlib: without it ``figures`` and ``train --live-png`` exit with
an error that names it, ``train`` before its first step.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _model(args):
    """The DeepBedMap that ``--checkpoint`` (the EMA weights when the run kept
    them), ``--npz`` or seeded random weights give on ``--device``."""
    from deepbedmap_tpu_torch.api import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig

    cfg = GeneratorConfig(num_residual_blocks=args.blocks)
    if args.checkpoint:
        return DeepBedMap.from_checkpoint(args.checkpoint, cfg, device=args.device)
    if args.npz:
        return DeepBedMap.from_chainer_npz(args.npz, cfg, device=args.device)
    _log("untrained generator (no --checkpoint/--npz)")
    return DeepBedMap(cfg=cfg, device=args.device)


def _matplotlib_missing(command: str, what: str) -> bool:
    """Whether matplotlib cannot be imported; if so, print ``command``'s JSON
    error line saying that ``what`` needs it."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        _emit({"command": command, "error": f"{what} needs matplotlib, which cannot be "
               f"imported here ({e})"})
        return True
    return False


def _load_inputs(path: str) -> dict:
    return {k: np.load(f"{path}/{k}.npy") for k in ("X", "W1", "W2", "W3")}


def cmd_verify_data(args) -> int:
    import os

    from deepbedmap_tpu_torch.data.manifest import (
        DEFAULT_MANIFEST,
        download_to_path,
        parse_datalist,
        verify_datalist,
    )

    datalist = args.datalist or DEFAULT_MANIFEST
    records = parse_datalist(datalist)
    _log(f"{len(records)} files in manifest")
    if args.download:
        for rec in records:
            if "filename" not in rec or "url" not in rec:
                continue
            path = os.path.join(args.root, rec.get("folder", ""), rec["filename"])
            download_to_path(path, rec["url"])
    # strict=False: report mismatches instead of raising; absent files are
    # simply not in the result (an offline machine verifies what it has)
    results = verify_datalist(datalist, root=args.root, strict=False)
    bad = sorted(k for k, ok in results.items() if not ok)
    _emit(
        {
            "command": "verify-data",
            "manifest_files": len(records),
            "present": len(results),
            "ok": sum(1 for ok in results.values() if ok),
            "bad": bad,
        }
    )
    return 1 if bad else 0


def cmd_package_data(args) -> int:
    """Content-addressed dataset packaging (reference quilt build/push/
    install/load, data_prep.py:938-970, srgan_train.py:87-125)."""
    import os

    from deepbedmap_tpu_torch.data import packaging

    if args.action == "push":
        if args.files:
            # arbitrary-member package (the reference also packaged its
            # prediction rasters, data_prep.py:950-967)
            files = {os.path.basename(f): f for f in args.files}
            pkg_hash = packaging.push(args.name, files, args.registry)
        else:
            pkg_hash = packaging.push_training_arrays(
                args.model_dir, args.registry, name=args.name
            )
        _emit({"command": "package-data", "action": "push", "hash": pkg_hash})
    elif args.action == "install":
        manifest = packaging.install(
            args.registry, args.name, args.dest, pkg_hash=args.hash,
            force=args.force,
        )
        _emit(
            {
                "command": "package-data",
                "action": "install",
                "hash": manifest["hash"],
                "members": sorted(manifest["members"]),
            }
        )
    elif args.action == "list":
        vs = packaging.versions(args.registry, args.name)
        _emit(
            {
                "command": "package-data",
                "action": "list",
                "versions": [
                    {"hash": m["hash"], "created": m.get("created", "")}
                    for m in vs
                ],
            }
        )
    return 0


def cmd_catalog(args) -> int:
    """Autogenerate per-folder README.md files from the dataset manifest
    (reference data_prep.py:168-205)."""
    from deepbedmap_tpu_torch.data.manifest import (
        DEFAULT_MANIFEST,
        write_catalog_markdown,
        write_folder_readmes,
    )

    datalist = args.datalist or DEFAULT_MANIFEST
    written = write_folder_readmes(args.root, yaml_file=datalist)
    if args.catalog:
        write_catalog_markdown(datalist, out_path=args.catalog)
        written.append(args.catalog)
    _emit({"command": "catalog", "written": written})
    return 0


def _write_grid(raster, path: str) -> None:
    """``.tif``/``.tiff``: a float32 LZW GeoTIFF, NaN kept (the card's
    machine has no h5py); anything else NetCDF, as the JAX CLI writes."""
    if path.endswith((".tif", ".tiff")):
        from deepbedmap_tpu_torch.data import geotiff

        geotiff.write_geotiff(path, raster.data.astype(np.float32), raster.left,
                              raster.top, raster.res, compress=True)
    else:
        from deepbedmap_tpu_torch.data.raster import write_netcdf

        write_netcdf(raster, path)


def cmd_grid(args) -> int:
    from deepbedmap_tpu_torch.data.gridder import get_region, xyz_to_grid
    from deepbedmap_tpu_torch.data.pipeline import ascii_to_xyz

    xyz = ascii_to_xyz(args.survey, data_dir=args.data_dir)
    _log(f"{len(xyz)} points from {args.survey}")
    region = get_region(xyz, args.spacing, mode=args.region_mode)
    raster = xyz_to_grid(xyz, region, spacing=args.spacing, device=args.device)
    _write_grid(raster, args.out)
    _emit(
        {
            "command": "grid",
            "points": int(len(xyz)),
            "region": list(region),
            "shape": list(raster.data.shape),
            "out": args.out,
        }
    )
    return 0


def cmd_build(args) -> int:
    """Gridded surveys + conditioning rasters -> X/W1/W2/W3/Y training arrays
    (reference data_prep.py:745-930: window proposal over each high-res grid,
    selective tiling of every input on the card, .npy stack with content-hash
    pin). Surveys and rasters are NetCDF or GeoTIFF (``read_raster``)."""
    import glob as _glob
    import os

    from deepbedmap_tpu_torch.data.builder import build_training_arrays
    from deepbedmap_tpu_torch.data.raster import read_raster
    from deepbedmap_tpu_torch.data.windows import get_window_bounds

    survey_paths = sorted(p for ext in ("*.nc", "*.tif")
                          for p in _glob.glob(os.path.join(args.surveys, ext)))
    if not survey_paths:
        raise ValueError(f"no gridded surveys (*.nc, *.tif) under {args.surveys}")
    names = [os.path.splitext(os.path.basename(p))[0] for p in survey_paths]
    if len(set(names)) != len(names):
        raise ValueError(f"a survey is under {args.surveys} twice: {names}")
    highres = {name: read_raster(p) for name, p in zip(names, survey_paths)}
    window_bounds = {
        name: get_window_bounds(r, step=args.window_step)
        for name, r in highres.items()
    }
    dataset = build_training_arrays(
        highres,
        window_bounds,
        lowres=read_raster(args.lowres),
        surface=read_raster(args.surface),
        velocity=(read_raster(args.velocity_x), read_raster(args.velocity_y)),
        accumulation=read_raster(args.accumulation),
        lowres_gapfiller=args.gapfiller,
        out_dir=args.out,
        device=args.device,
    )
    _emit(
        {
            "command": "build",
            "surveys": sorted(highres),
            "windows": {k: len(v) for k, v in window_bounds.items()},
            "tiles": len(dataset),
            "out": args.out,
        }
    )
    return 0


def cmd_train(args) -> int:
    """Train the GAN on tile arrays (the X/W1/W2/W3/Y_data.npy of ``build``)
    or on synthetic tiles, and save the train state to ``--out``."""
    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.data.dataset import TileDataset
    from deepbedmap_tpu_torch.train.checkpoint import save_checkpoint
    from deepbedmap_tpu_torch.train.loop import fit
    from deepbedmap_tpu_torch.train.state import create_gan_state

    from deepbedmap_tpu_torch.viz.live import LiveCurves

    if args.live_png and _matplotlib_missing("train", "--live-png"):
        return 1
    callback = None
    if args.live_png or args.live_term:
        callback = LiveCurves(out_png=args.live_png, terminal=args.live_term)
    if args.tiles:
        dataset = TileDataset.load_npy_dir(args.tiles, device=args.device, suffix="_data")
    else:
        dataset = TileDataset.synthetic(args.synthetic_tiles, seed=0, device=args.device)
    g_cfg = GeneratorConfig(num_residual_blocks=args.blocks)
    t_cfg = TrainConfig(
        batch_size=min(args.batch_size, max(1, int(len(dataset) * 0.9))),
        learning_rate=args.learning_rate,
    )
    state = create_gan_state(g_cfg, t_cfg=t_cfg, device=args.device)
    state, history = fit(state, dataset, t_cfg=t_cfg, epochs=args.epochs, callback=callback)
    if args.out:
        save_checkpoint(state, args.out)
    _emit(
        {
            "command": "train",
            "tiles": len(dataset),
            "epochs": args.epochs,
            "first_g_loss": round(history[0]["generator_loss"], 4),
            "final_g_loss": round(history[-1]["generator_loss"], 4),
            "checkpoint": args.out,
        }
    )
    return 0


def top_trials(study, n: int) -> list:
    """The ``n`` best completed trials as the JAX CLI reports them, without
    pandas: the records of ``study.trials_dataframe()`` (``number``,
    ``state``, ``value``, ``params_<name>``; a column missing from a trial is
    NaN, and an integer column with a gap is read as float, as pandas types
    it), completed trials only, by value."""
    rows = [{"number": t.number, "state": t.state, "value": t.value,
             **{f"params_{k}": v for k, v in t.params.items()}} for t in study.trials]
    columns = list(dict.fromkeys(k for row in rows for k in row))
    gaps = {c for c in columns if any(row.get(c) is None for row in rows)}
    records = []
    for row in rows:
        if row["state"] != "COMPLETE":
            continue
        rec = {}
        for c in columns:
            v = row.get(c)
            if v is None:
                v = float("nan")
            elif c in gaps and type(v) is int:
                v = float(v)
            rec[c] = v
        records.append(rec)
    return sorted(records, key=lambda r: r["value"])[:n]


def tiny_space(trial) -> dict:
    """``hpo --tiny``'s search space (a smoke run): batch 4 or 8, 1 RRDB,
    1 or 2 epochs."""
    return dict(
        batch_size_exponent=trial.suggest_int("batch_size_exponent", 2, 3),
        learning_rate=trial.suggest_float("learning_rate", 1e-4, 2e-4, step=0.1e-4),
        num_residual_blocks=trial.suggest_int("num_residual_blocks", 1, 1),
        residual_scaling=trial.suggest_float("residual_scaling", 0.1, 0.3, step=0.05),
        num_epochs=trial.suggest_int("num_epochs", 1, 2),
    )


def cmd_hpo(args) -> int:
    """HPO over real tile arrays with a real fixed-test-area RMSE objective —
    the reference's actual workflow (srgan_train.py:1725-1757: a study over
    the built dataset, per-epoch Pine-Island RMSE, top-10 report), on
    ``--device``."""
    from deepbedmap_tpu_torch.data.dataset import TileDataset
    from deepbedmap_tpu_torch.hpo import create_study
    from deepbedmap_tpu_torch.train.objective import objective

    if args.tiles:
        dataset = TileDataset.load_npy_dir(args.tiles, device=args.device, suffix="_data")
    else:
        dataset = TileDataset.synthetic(args.synthetic_tiles, seed=0, device=args.device)

    # fixed-test-area evaluator (reference get_deepbedmap_test_result): the
    # optimised value is then real metres, not the dev-loss proxy. Built per
    # trial (residual_scaling changes the forward pass).
    make_evaluator = None
    if args.eval_inputs:
        from deepbedmap_tpu_torch.evalx.fixed import make_fixed_evaluator
        from deepbedmap_tpu_torch.evalx.track import read_track_csv

        if not (args.eval_track and args.eval_bounds):
            raise ValueError("--eval-inputs requires --eval-track and --eval-bounds")
        eval_inputs = _load_inputs(args.eval_inputs)
        track = read_track_csv(args.eval_track)
        bounds = tuple(float(v) for v in args.eval_bounds.split(","))
        make_evaluator = lambda g_model: make_fixed_evaluator(  # noqa: E731
            g_model, eval_inputs, track, bounds, resolution=args.eval_resolution,
            device=args.device,
        )

    study = create_study(
        direction="minimize",
        storage=args.storage,
        sampler_seed=args.seed,
        pruner="hyperband",
        min_resource=15,
        max_resource=150,
        reduction_factor=3,
    )
    kwargs = {}
    if args.tiny:
        kwargs["suggest"] = tiny_space
    if make_evaluator is not None:
        kwargs["make_evaluator"] = make_evaluator
    if args.checkpoint_dir:
        kwargs["checkpoint_dir"] = args.checkpoint_dir
    study.optimize(lambda t: objective(t, dataset, **kwargs), n_trials=args.trials)

    # top-N trials report (reference: top-10 dataframe, srgan_train.py:1751-1757)
    top_records = top_trials(study, args.top_n)
    for rec in top_records:
        _log("  ".join(f"{k}={v}" for k, v in rec.items()))
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"top_trials": top_records,
                       "n_trials": len(study.trials)}, f, indent=2)
    _emit(
        {
            "command": "hpo",
            "trials": len(study.trials),
            "best_value": round(study.best_value, 4),
            # with a wired evaluator the value is metres; otherwise the
            # dev-set generator loss stands in (train/objective.py)
            "value_metric": (
                "rmse_test_m" if make_evaluator is not None
                else "val_generator_loss_proxy"
            ),
            "best_params": study.best_params,
            "top_trials": top_records,
        }
    )
    return 0


def cmd_predict(args) -> int:
    from deepbedmap_tpu_torch.data.raster import read_raster, write_netcdf

    dbm = _model(args)
    rasters = {
        "bed_lowres": read_raster(args.bed),
        "surface": read_raster(args.surface),
        "velocity_x": read_raster(args.velocity_x),
        "velocity_y": read_raster(args.velocity_y),
        "accumulation": read_raster(args.accumulation),
    }
    bounds = tuple(float(v) for v in args.bounds.split(","))
    dem = dbm.predict(bounds, rasters)
    if args.out.endswith((".tif", ".tiff")):
        from deepbedmap_tpu_torch.data import geotiff

        geotiff.write_geotiff(args.out, dem.data, dem.left, dem.top, dem.res,
                              nodata=-2000.0, compress=True)
    else:
        write_netcdf(dem, args.out)
    _emit(
        {
            "command": "predict",
            "bounds": list(bounds),
            "shape": list(dem.data.shape),
            "out": args.out,
        }
    )
    return 0


def cmd_evaluate(args) -> int:
    from deepbedmap_tpu_torch.data.raster import read_raster
    from deepbedmap_tpu_torch.evalx.track import read_track_csv, track_rmse

    x, y, z = read_track_csv(args.track)
    # windowed read: only the track's bounding box (plus a bicubic-stencil
    # margin) is decoded from the DEM product; NaN coordinates are skipped,
    # as pandas' Series.min / max skip them in the JAX CLI
    dem = read_raster(
        args.dem,
        bounds=(
            float(np.nanmin(x)) - 2000.0, float(np.nanmin(y)) - 2000.0,
            float(np.nanmax(x)) + 2000.0, float(np.nanmax(y)) + 2000.0,
        ),
    )
    rmse = track_rmse(dem, x, y, z, method=args.method, device=args.device)
    _emit(
        {
            "command": "evaluate",
            "points": int(len(x)),
            "rmse_m": round(float(rmse), 4),
            "method": args.method,
        }
    )
    return 0


def cmd_figures(args) -> int:
    """The paper's figure set (``viz.figure_set.main``), in this process."""
    from deepbedmap_tpu_torch.viz import figure_set

    if _matplotlib_missing("figures", "the figure set"):
        return 1
    figure_set.main(args.out, device=args.device)
    _emit({"command": "figures", "out": args.out, "rc": 0})
    return 0


def cmd_continent(args) -> int:
    """The continent product on one card, with the tiles split over
    ``--mesh-devices`` ranks, or with the bands split over the processes
    (``--multihost``). Either starts the process group first: torchrun's
    variables, or ``--coordinator``/``--num-processes``/``--process-id``
    (one process per card; ``--backend gloo`` for processes that share one
    card). Only rank 0 prints the JSON line."""
    import torch.distributed as dist

    from deepbedmap_tpu_torch.parallel import distributed

    started = False
    if args.multihost or args.mesh_devices:
        started = distributed.initialize(
            args.coordinator or None,
            args.num_processes or None,
            args.process_id if args.process_id >= 0 else None,
            backend=args.backend,
            device=args.device,
        )
    try:
        mesh = None
        if args.mesh_devices:
            from deepbedmap_tpu_torch.parallel import make_mesh

            mesh = make_mesh(args.mesh_devices, device=args.device)
        dbm = _model(args)
        bounds = tuple(float(v) for v in args.bounds.split(","))
        dbm.predict_continent(
            _load_inputs(args.inputs),
            bounds,
            outfilepath=args.out,
            tile_out=args.tile_out,
            halo_lr=args.halo_lr,
            mesh=mesh,
            stream_product=args.stream,
            prefetch=args.prefetch,
            tiles_per_dispatch=args.tiles_per_dispatch,
            overviews=args.overviews,
            predictor=args.predictor,
            multihost=args.multihost,
        )
        if distributed.is_primary():
            _emit(
                {
                    "command": "continent",
                    "bounds": list(bounds),
                    "out": args.out + ".tif",
                    "sharded": mesh is not None,
                    "streamed": bool(args.stream),
                    "processes": distributed.process_count(),
                }
            )
    finally:
        if started:
            dist.destroy_process_group()
    return 0


def cmd_verify_weights(args) -> int:
    """Real-weight numerical parity harness: given a reference-released
    Chainer npz (srgan_train.py:506-523) and a reference-produced output
    grid, run from_chainer_npz -> forward -> compare in ONE command. Inputs
    are the X/W1/W2/W3 .npy stacks (NCHW, the deepbedmap.py:381-447
    test-region crops):

        python -m deepbedmap_tpu_torch verify-weights --npz weights.npz \\
            --inputs arrays/ --expected reference_grid.nc --atol 0.5
    """
    import torch

    from deepbedmap_tpu_torch.api import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig

    cfg = GeneratorConfig(
        num_residual_blocks=args.blocks, residual_scaling=args.scaling
    )
    dbm = DeepBedMap.from_chainer_npz(
        args.npz, cfg, offset_order=args.offset_order, device=args.device
    )
    inputs = _load_inputs(args.inputs)
    pred = dbm.forward_fn()(
        *(torch.from_numpy(np.ascontiguousarray(inputs[k].transpose(0, 2, 3, 1)))
          .to(dbm.device) for k in ("X", "W1", "W2", "W3"))
    )[0, :, :, 0].cpu().numpy()

    if args.expected.endswith(".nc"):
        from deepbedmap_tpu_torch.data.raster import read_netcdf

        expected = read_netcdf(args.expected).data
    elif args.expected.endswith((".tif", ".tiff")):
        from deepbedmap_tpu_torch.data.geotiff import read_geotiff

        expected, _ = read_geotiff(args.expected)
    else:
        expected = np.load(args.expected)
    expected = np.asarray(expected, np.float32)
    if expected.shape != pred.shape:
        _emit(
            {
                "command": "verify-weights",
                "pass": False,
                "error": f"shape mismatch: predicted {list(pred.shape)} vs "
                f"expected {list(expected.shape)}",
            }
        )
        return 1

    finite = np.isfinite(expected)
    if not finite.any():
        # an all-nodata/NaN expected grid compares nothing — that is a
        # failed verification, not a vacuous pass
        _emit(
            {
                "command": "verify-weights",
                "pass": False,
                "error": "expected grid has zero finite pixels over the "
                "predicted region (wrong crop or nodata handling?)",
                "pixels_compared": 0,
            }
        )
        return 1
    diff = np.abs(pred[finite] - expected[finite])
    max_abs = float(diff.max())
    rmse = float(np.sqrt(np.mean(diff**2)))
    ok = max_abs <= args.atol
    _emit(
        {
            "command": "verify-weights",
            "pass": bool(ok),
            "max_abs_err": max_abs,
            "rmse": rmse,
            "atol": args.atol,
            "pixels_compared": int(finite.sum()),
        }
    )
    return 0 if ok else 1


def cmd_serve(args) -> int:
    from deepbedmap_tpu_torch.serve import serve_forever

    serve_forever(
        _model(args),
        host=args.host,
        port=args.port,
        data_root=args.data_root,
        token=args.token,
        bucket_px=args.bucket_px,
    )
    return 0


def _weights(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint", default=None,
                   help="train-state checkpoint of the port (train --out)")
    p.add_argument("--npz", default=None, help="reference-format (Chainer) weights")
    p.add_argument("--blocks", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepbedmap_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument(
        "--telemetry", default=None, metavar="PATH",
        help="record the port's spans and counters (utils.profiling) and write them "
        "when the command ends: PATH, a Chrome trace for Perfetto, and "
        "PATH.summary.json, the per-span totals and counters",
    )
    sub = p.add_subparsers(dest="command", required=True)

    v = sub.add_parser("verify-data", help="check manifest files against sha256")
    v.add_argument("--datalist", default=None, help="datasets.yml (default: bundled)")
    v.add_argument("--root", default=".", help="directory holding the files")
    v.add_argument("--download", action="store_true", help="fetch missing files first")
    v.set_defaults(fn=cmd_verify_data)

    pk = sub.add_parser(
        "package-data",
        help="content-addressed dataset packages (quilt build/push/install)",
    )
    pk.add_argument("action", choices=("push", "install", "list"))
    pk.add_argument("--registry", required=True, help="registry directory")
    pk.add_argument("--name", default="deepbedmap/model/train")
    pk.add_argument("--model-dir", default="model", help="push: dir of *_data.npy")
    pk.add_argument(
        "--files", nargs="*", default=None,
        help="push: explicit member files instead of the training-array dir",
    )
    pk.add_argument("--dest", default="model", help="install: output dir")
    pk.add_argument("--hash", default=None, help="install: pin a version")
    pk.add_argument("--force", action="store_true")
    pk.set_defaults(fn=cmd_package_data)

    cat = sub.add_parser(
        "catalog", help="autogenerate per-folder data README.md files"
    )
    cat.add_argument("--root", default=".", help="data root (lowres/ highres/ ...)")
    cat.add_argument("--datalist", default=None)
    cat.add_argument("--catalog", default=None, help="also write a full catalog table")
    cat.set_defaults(fn=cmd_catalog)

    g = sub.add_parser("grid", help="survey config -> gridded NetCDF or GeoTIFF")
    g.add_argument("survey", help="per-survey pipeline JSON (highres/*.json format)")
    g.add_argument("-o", "--out", required=True,
                   help="output grid: .tif/.tiff for GeoTIFF, else NetCDF")
    g.add_argument("--data-dir", default=None)
    g.add_argument("--spacing", type=float, default=250.0)
    g.add_argument("--region-mode", choices=("round", "surface"), default="round")
    g.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the CPU)")
    g.set_defaults(fn=cmd_grid)

    b = sub.add_parser(
        "build", help="gridded surveys + conditioning rasters -> training arrays"
    )
    b.add_argument(
        "--surveys", required=True,
        help="dir of gridded surveys (*.nc NetCDF or *.tif GeoTIFF)",
    )
    b.add_argument("--lowres", required=True, help="BEDMAP2-style bed (NetCDF or GeoTIFF)")
    b.add_argument("--surface", required=True, help="REMA-style surface")
    b.add_argument("--velocity-x", required=True)
    b.add_argument("--velocity-y", required=True)
    b.add_argument("--accumulation", required=True)
    b.add_argument("-o", "--out", required=True, help="output dir for *_data.npy")
    b.add_argument("--window-step", type=int, default=3)
    b.add_argument(
        "--gapfiller", type=float, default=None,
        help="nodata fill for the lowres bed (reference inference uses -5000)",
    )
    b.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the CPU)")
    b.set_defaults(fn=cmd_build)

    t = sub.add_parser("train", help="train the GAN on tile arrays")
    t.add_argument("--tiles", default=None, help="dir with X/W1/W2/W3/Y_data.npy")
    t.add_argument("--synthetic-tiles", type=int, default=16)
    t.add_argument("--epochs", type=int, default=2)
    t.add_argument("--blocks", type=int, default=12)
    t.add_argument("--batch-size", type=int, default=128)
    t.add_argument("--learning-rate", type=float, default=1.6e-4)
    t.add_argument("--out", default=None, help="checkpoint path")
    t.add_argument("--live-png", default=None,
                   help="redraw training curves to this PNG every epoch (livelossplot "
                   "role; needs matplotlib)")
    t.add_argument("--live-term", action="store_true",
                   help="print a sparkline of each metric after every epoch")
    t.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    t.set_defaults(fn=cmd_train)

    h = sub.add_parser("hpo", help="hyperparameter search (reference pruner config)")
    h.add_argument("--trials", type=int, default=3)
    h.add_argument("--storage", default=None, help="sqlite:///path.db")
    h.add_argument("--seed", type=int, default=42)
    h.add_argument(
        "--tiles", default=None,
        help="dir with X/W1/W2/W3/Y_data.npy (the `build` output); default "
        "falls back to synthetic tiles",
    )
    h.add_argument("--synthetic-tiles", type=int, default=16)
    h.add_argument("--tiny", action="store_true", help="tiny search space (smoke)")
    h.add_argument(
        "--eval-inputs", default=None,
        help="dir with X/W1/W2/W3.npy (NCHW) covering the fixed test area — "
        "wires the real RMSE objective (reference Pine Island evaluator)",
    )
    h.add_argument("--eval-track", default=None, help="csv with x,y,z columns")
    h.add_argument("--eval-bounds", default=None, help="xmin,ymin,xmax,ymax")
    h.add_argument("--eval-resolution", type=float, default=250.0)
    h.add_argument("--checkpoint-dir", default=None,
                   help="save per-trial best checkpoints here")
    h.add_argument("--top-n", type=int, default=10,
                   help="trials in the report (reference prints top 10)")
    h.add_argument("--report", default=None, help="write the top-N report JSON here")
    h.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    h.set_defaults(fn=cmd_hpo)

    pr = sub.add_parser("predict", help="super-resolve one region")
    _weights(pr)
    pr.add_argument("--bounds", required=True, help="xmin,ymin,xmax,ymax (EPSG:3031 m)")
    pr.add_argument("--bed", required=True, help="lowres bed (NetCDF or GeoTIFF)")
    pr.add_argument("--surface", required=True)
    pr.add_argument("--velocity-x", required=True)
    pr.add_argument("--velocity-y", required=True)
    pr.add_argument("--accumulation", required=True)
    pr.add_argument("-o", "--out", required=True,
                    help="output grid: .tif/.tiff for GeoTIFF, else NetCDF")
    pr.set_defaults(fn=cmd_predict)

    e = sub.add_parser("evaluate", help="track RMSE of a DEM vs survey xyz csv")
    e.add_argument("--dem", required=True)
    e.add_argument("--track", required=True, help="csv with x,y,z columns")
    e.add_argument("--method", default="bicubic", choices=("bicubic", "bilinear", "nearest"))
    e.add_argument("--device", default="cuda", help="torch device (default cuda)")
    e.set_defaults(fn=cmd_evaluate)

    c = sub.add_parser(
        "continent", help="whole-region band-streamed DEM -> GeoTIFF product"
    )
    c.add_argument("--inputs", required=True, help="dir with X/W1/W2/W3.npy (NCHW)")
    c.add_argument("--bounds", required=True, help="xmin,ymin,xmax,ymax (EPSG:3031 m)")
    c.add_argument("-o", "--out", required=True, help="output path (without .tif)")
    _weights(c)
    c.add_argument("--tile-out", type=int, default=1000)
    c.add_argument("--halo-lr", type=int, default=18)
    c.add_argument("--mesh-devices", type=int, default=0,
                   help="split each band's tiles over the first N ranks of the "
                   "process group (one process per card, all with the same inputs)")
    c.add_argument("--multihost", action="store_true",
                   help="distribute the row bands over the processes; rank 0 "
                   "writes the product (a --mesh-devices mesh must then hold "
                   "the caller alone)")
    c.add_argument("--coordinator", default="",
                   help="process group address, tcp://host:port or file://path "
                   "(default: torchrun's MASTER_ADDR/MASTER_PORT, else one process)")
    c.add_argument("--num-processes", type=int, default=0,
                   help="process count (default: torchrun's WORLD_SIZE)")
    c.add_argument("--process-id", type=int, default=-1,
                   help="this process's rank (default: torchrun's RANK)")
    c.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="collective backend (default: nccl on the card, gloo on "
                   "the CPU; gloo for processes that share one card)")
    c.add_argument("--stream", action="store_true",
                   help="pipe strips into the GeoTIFF through a writer thread "
                   "(no full canvas in host memory)")
    c.add_argument(
        "--prefetch", type=int, default=1,
        help="bands dispatched ahead of the blocking fetch (0 = serial)",
    )
    c.add_argument("--tiles-per-dispatch", type=int, default=2,
                   help="tiles batched per forward")
    c.add_argument(
        "--predictor", action="store_true",
        help="with --stream: TIFF horizontal differencing before the LZW "
        "(data-dependent: smaller on smooth beds, larger near white-noise "
        "roughness)",
    )
    c.add_argument(
        "--overviews", type=int, default=0,
        help="with --stream: append N 2x overview pyramid levels as chained "
        "TIFF pages (nodata-aware average, built incrementally)",
    )
    c.set_defaults(fn=cmd_continent)

    vw = sub.add_parser(
        "verify-weights",
        help="prove numerical parity of a reference Chainer npz artifact "
        "against a reference-produced output grid (one command)",
    )
    vw.add_argument("--npz", required=True, help="Chainer-format generator npz")
    vw.add_argument(
        "--inputs", required=True,
        help="dir with X/W1/W2/W3.npy (NCHW) covering the expected grid",
    )
    vw.add_argument(
        "--expected", required=True,
        help="reference-produced grid (.nc, .tif, or .npy)",
    )
    vw.add_argument("--blocks", type=int, default=12)
    vw.add_argument("--scaling", type=float, default=0.1)
    vw.add_argument("--offset-order", default="xy", choices=("xy", "yx"))
    vw.add_argument(
        "--atol", type=float, default=0.5,
        help="max abs error tolerated (0.5 m covers int16 product rounding)",
    )
    vw.add_argument("--device", default="cuda", help="torch device (default cuda)")
    vw.set_defaults(fn=cmd_verify_weights)

    s = sub.add_parser("serve", help="HTTP inference service (see serve.py)")
    _weights(s)
    s.add_argument(
        "--host", default="127.0.0.1",
        help="bind address (non-loopback should also set --token)",
    )
    s.add_argument("--port", type=int, default=8500)
    s.add_argument(
        "--data-root", default=None,
        help="directory request paths are confined to (default: cwd)",
    )
    s.add_argument(
        "--token", default=None,
        help="require 'Authorization: Bearer TOKEN' on predict/evaluate/dem",
    )
    s.add_argument(
        "--bucket-px", type=int, default=0,
        help="round predict windows up to power-of-two buckets of this many "
        "output px (multiple of 4)",
    )
    s.set_defaults(fn=cmd_serve)

    f = sub.add_parser("figures", help="regenerate the paper figure set")
    f.add_argument("-o", "--out", default="figures")
    f.add_argument("--device", default="cuda",
                   help="torch device of the analysis (default cuda; 'cpu' runs on the CPU)")
    f.set_defaults(fn=cmd_figures)

    return p


def main(argv=None) -> int:
    from deepbedmap_tpu_torch.device import disable_tf32

    args = build_parser().parse_args(argv)
    disable_tf32()
    if args.telemetry is None:
        return args.fn(args)
    from deepbedmap_tpu_torch.utils import profiling

    profiling.enable()
    try:
        return args.fn(args)
    finally:
        profiling.export(args.telemetry)
        with open(args.telemetry + ".summary.json", "w") as f:
            json.dump(profiling.snapshot(), f, indent=1)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``deepbedmap_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

0. setup: print the card's name and power limit (nvidia-smi), turn TF32 off
   (the JAX reference computes in fp32);
1. build the CUDA kernels from ``deepbedmap_tpu_torch/csrc`` with nvcc;
2. K1 ``rdb_forward`` vs ``rdb_reference`` at (1,13,14,64), (3,37,9,64) and
   (2,286,286,64), and the precision check: K1 at (2,286,286,64) with scaling
   1.0 against ``rdb_reference`` in float64 on the card, within 1e-5 of the
   reference's range (a single TF32 pass misses it; see ``TOL_TF32X3``);
3. K2 ``deform64_lrelu`` vs the plain masked-shift sampler + LeakyReLU at
   (1,20,130,64), a ragged (2,37,45,64), (1,5,7,64) (smaller than a tile),
   (1,20,130,64) at clamp 1 and (2,1144,1144,64), and the precision check:
   K2 at (2,1144,1144,64) against the plain version in float64 on the card,
   within 1e-5 of the range (``TOL_TF32X3``: K2 runs on the tensor cores);
4. K3 ``deform_zproj1`` vs its plain version at the same shapes;
5. the whole 12-RRDB generator at full width on a 64-px crop: the card
   (kernels) against the same port on the CPU (plain versions);
6. the main path: ``DeepBedMap.predict_continent`` on a 2 x 2-tile region
   (2000^2 output, 1000-px tiles, 18-px halo, 288-px crops, 2 tiles per
   forward), with every kernel's launch count checked, the output held
   against the untiled ``predict_region``, and the warm per-tile time;
7. K4 ``rrdb_forward`` vs ``rrdb_reference`` at (1,13,14,64), (3,37,9,64) and
   (2,286,286,64), and phase 2's precision check for K4;
8. K10 ``conv3x3_forward`` vs ``conv3x3_reference`` at two small odd shapes
   and at the four shapes and epilogues of one main-path forward, with
   ``F.conv2d`` (cuDNN) timed beside it, and at each of them the precision
   check against ``conv3x3_reference`` in float64 (both C_in, with and
   without the residual; K10 runs on the tensor cores);
9. K7 ``deform_conv`` vs the plain ``deform_conv_shifts`` at phase 3's
   shapes, and phase 3's precision check for K7;
10. K8 ``deform_conv_zproj1`` (tap projection + K3's kernel) vs the plain
    ``deform_conv_shifts_zproj`` at phase 3's shapes;
11. phase 5 for the opt-in kernel configuration ``GeneratorConfig(
    rrdb_fused=True, fused_conv="always", tail_fused=False)``;
12. the second main path: phase 6 in that configuration, with phase 6's
    weights: its launch counts, tiled vs untiled, and its output against
    phase 6's (the two configurations compute one function);
13. K6 ``rdb_banded_forward`` vs ``rdb_reference`` at (1,13,14,64),
    (3,37,9,64) and (2,286,286,64) (none a multiple of its 8 x 16 tile), and
    phase 2's precision check for K6;
14. K5 ``rrdb_sweep_forward`` vs ``rrdb_reference`` at (1,13,14,64),
    (2,22,14,64), (3,37,9,64) and (2,286,286,64) (heights of 2, 3, 5 and 36
    bands, none a multiple of the 8-row band; the 5-band case wraps the
    4-slot rings), and phase 7's precision check for K5;
15. K9 ``deform_zform`` vs ``deform_conv_shifts_zproj`` at (1,9,13,8->16)
    and (1,20,130,64->64); its own path, ``deform_conv2d_zform`` at the
    tail's two shapes (2,1144,1144,64)->64 and ->1, counted and then held
    against the plain version; at every shape with 64 or 16 outputs the
    precision check against the deformable conv in float64 (K9 projects on
    the tensor cores);
16. phase 5 for ``GeneratorConfig(rdb_resident="never")`` (K6 per dense
    block) and ``GeneratorConfig(rrdb_sweep=True)`` (K5 per RRDB);
17. and 18. phase 12 in those two configurations, with phase 6's weights;
19. the single-region path on synthetic rasters near Pine Island Glacier
    (EPSG:3031; bed 1000 m and velocity 450 m with voids, surface 100 m,
    accumulation 1000 m): phase 6's weights through an npz written by
    ``export_generator_npz`` into ``DeepBedMap.from_chainer_npz`` and through
    a local tracker into ``DeepBedMap.from_experiment`` (bit for bit, the
    config rebuilt from the logged parameters); ``DeepBedMap.predict`` on a
    286 km window (X 288^2, output 1144^2) with its launch counts, bounds and
    output against ``forward_fn`` on ``get_model_inputs``' tensors; K1, K2
    and K3 on the inputs that prediction gives them, (1,286,286,64),
    (1,1144,1144,64) and (1,1144,1144,9), against their plain versions on the
    card, K1 and K2 also in float64 (precision check); those inputs on the
    card against the CPU; ``predict`` on the card against the
    CPU on a 48 km window; ``track_rmse`` on 10^5 points on the card against
    the CPU and against the DEM's own bicubic samples; and the times of each
    step;
20. the continent product on a 3 x 3-tile region (3000^2 output, 750^2
    low-res; phase 19's kind of smooth seeded fields at bed, surface,
    velocity and accumulation scale, W1 partly below zero; three bands so
    one is interior) with the seeded 12-RRDB generator at init scale 1.0
    (phase 6's weights give an all-zero int16 product; these give a bed's
    magnitudes): ``predict_continent(outfilepath=...)`` (buffered,
    ``save_continent_dem``) must decode to the int16 of its canvas bit for
    bit, tiled, nodata -2000, EPSG:3031; ``stream_product=True`` with two
    overview pages and PREDICTOR=2 must equal byte for byte a
    ``GeoTiffStripWriter`` fed the canvas on the host in the band loop's
    strips, with page 0 equal to the buffered product and pages 1 and 2 the
    block means; the native LZW against the pure-Python codec on rows of the
    interior band; the codec loaded from the build directory; launch counts
    of both calls; warm s/tile of both paths and of the streamed path
    without overviews and predictor (interleaved), each split at the band
    loop's last band, the host writer's time alone, the time of
    ``save_continent_dem``, the products' sizes and the native encode rate;
21. the HTTP server (``serve.make_server`` on 127.0.0.1 in a thread, phase
    19's rasters preloaded): /healthz; /predict on phase 19's window as
    GeoTIFF equal to ``dbm.predict`` bit for bit, alone and as four
    concurrent requests, with launch counts; ``python -m deepbedmap_tpu_torch
    predict`` in a new process on GeoTIFF copies of the rasters equal to
    ``dbm.predict`` bit for bit (so the CLI runs in fp32, TF32 off); /predict with ``bucket_px``
    equal to ``dbm.predict`` on the bucketed window sliced back; /dem on
    phase 20's streamed product, pages 0 and 1, equal to its crops;
    /evaluate on 10^4 track points equal to ``dbm.track_rmse``; and median
    warm latencies of /predict (beside ``dbm.predict``), /dem and /evaluate;
22. training: each kernel wrapper of a generator path (K1, K4, K5, K6 at
    (3,37,9,64); K7, K8, K10 at (2,37,45,64); K1, K2, K3 at a batch-128
    training step's shapes (128,9,9,64), (128,36,36,64) and (128,36,36,9),
    their forward and backward timed; K2 and K3 also with the backward route
    they replaced, autograd of the plain version) against autograd of its
    plain version on the card, output and every input's gradient; K2, K3, K7
    and K8 must launch their backward kernels; K9 refuses a gradient;
    every generator parameter gets a nonzero gradient on the card; one
    ``make_train_step`` step at 12 RRDBs and batch 16 of seeded reference
    tiles (X 11^2, W1 110^2, W2 22^2, W3 11^2, Y 36^2), card vs CPU from the
    same weights: the five metrics, every gradient, the BatchNorm statistics
    and the updated parameters, with its launch counts (K1 72, K2 2, K3 2:
    two generator forwards; the backward one each of K2's and K3's backward
    kernels and recomputes K1's plain version); the
    same at 2 RRDBs and batch 8 in the kernel, banded and sweep
    configurations; ``fit`` on 3826 synthetic tiles (3634 / 192 at 95/5, 28
    batches of 128 and one dev batch) for 2 epochs at 12 RRDBs with its launch
    counts, s/epoch, the median of 10 warm steps, tiles/s, peak memory and a
    breakdown of one step by CUDA events; ``remat=True``'s launches (K1 108)
    and step time; ``save_checkpoint`` then ``DeepBedMap.from_checkpoint``,
    whose forward equals the EMA weights' bit for bit; and ``python -m
    deepbedmap_tpu_torch train`` in a new process, then ``predict
    --checkpoint`` on phase 19's rasters, equal to
    ``DeepBedMap.from_checkpoint(...).predict`` bit for bit;
23. the hyperparameter search: ``deform_conv2d(method='auto')`` on a layer
    K7 / K8 do not take (32 -> 16 channels, 5x5, padding 2) launches no
    kernel and equals the CPU; 640 seeded reference tiles pushed into a
    package in a temporary registry and read back onto the card by
    ``TileDataset.from_package``, exactly; study 1, two trials of the
    reference space (batch 128, 12 RRDBs, 64 channels) with ``num_epochs``
    cut to 3, the reference's Hyperband pruner, sqlite storage and a
    ``LocalTracker`` each, scored every epoch by ``make_fixed_evaluator``
    on phase 19's 286 km window and 10^5 track points: launch counts per
    trial (K1/K2/K3 72/2/2 per step and 36/1/1 per evaluation), each
    epoch's ``rmse_test`` against the evaluation recomputed, the tracker's
    metrics, ``best_value`` the smallest completed value,
    ``DeepBedMap.from_experiment`` on the best trial bit for bit against
    the best epoch's weights and its checkpoint, the evaluator card vs CPU
    with those weights on the 48 km window; study 2, one trial on the tiles
    with a NaN in epoch 0's first tile, which ends PRUNED by the divergence
    rule; ``python -m deepbedmap_tpu_torch hpo --tiny`` in a new process
    on the first 160 tiles with ``--eval-inputs/--eval-track/--eval-bounds``
    written from phase 19's inputs, against the same trial run in this
    process (within 3x the trial's own change when run again or from
    weights perturbed by 1e-5), and the same trial twice in each of two
    more new processes (``library_trials``), logged beside it; s per trial
    epoch, ms per evaluation (CUDA events) and the study's wall time without
    the check's own recomputed evaluations;
24. data prep, which launches none of the kernels: (a) the 11 packaged
    survey formats at reference cardinality (12,000 points each on a 4 x 3
    mosaic, written by ``write_survey``, a pandas-free copy of
    ``tests/survey_fixtures.make_survey_miniature``): ``ascii_to_xyz``, each
    table against the written one; ``get_region``; ``xyz_to_grid`` (exact
    backend, blockmedian on the card) equal to the same call on the CPU bit
    for bit; ``get_window_bounds`` and ``filter_within_polygon`` with a
    notched polygon, the counts the CPU's; ``build_training_arrays`` on the
    card against the CPU's within 1e-6 of each array's range, the shape
    contract, finite arrays, ``CONTENT_HASH`` against the saved files and
    ``TileDataset.load_npy_dir`` against the returned dataset; (b) one
    survey of ~2e6 points on flight lines over 801^2 gridline nodes through
    the relax backend on the card: ``blockmedian`` card vs CPU exactly, the
    solve's constrained nodes equal to their constraints, the grid's NaN
    cells those of scipy's dilation, a 257^2 cut card vs CPU within 1e-4 of
    the range; (c) ``python -m deepbedmap_tpu_torch grid`` (``.tif`` out)
    and ``build`` (``.tif`` surveys and rasters) in new processes, equal to
    the library's grid and arrays bit for bit, with equal JSON lines; the
    time of each stage (parse, exact grids, windows + filter, build, relax
    blockmedian and solve by CUDA events and host clock, the CLI calls);
25. evaluation and figures, on phase 19's window, rasters, npz weights and
    10^5 track points: (a) ``dbm.predict`` with its launch counts (K1 36,
    K2 1, K3 1); the 'cubicbedmap' baseline, ``bicubic_upsample`` x4 of the
    gapfilled BEDMAP2 input the model saw (``get_model_inputs``' X as a
    ``Raster``), and the synthetic-HRES one, ``bilinear_resample`` x1/2.5 of
    the 100 m surface; ``track_rmse`` of DeepBedMap and of cubicbedmap
    (deepbedmap.py:577-626); ``standard_deviation_2d`` (window 5) and
    ``hillshade`` of both grids; elevation and roughness transects of both on
    400 points; each card vs CPU (``TOL_BASELINE`` and the rest) and each
    stage timed warm by CUDA events; (b) the figure set: with matplotlib,
    ``viz.figure_set.main`` and the CLI's ``figures`` in a new process (seven
    non-empty PNGs each); without it (the card's machine), the figure set's
    hillshades, roughness grids and transects card vs CPU and the CLI's
    ``figures`` refusing with an error that names matplotlib; (c) the CLI's
    ``train --live-term`` (and ``--live-png`` with matplotlib) in a new
    process, 256 synthetic tiles, 2 epochs, 12 RRDBs, batch 128: one
    sparkline line per metric after each epoch, then the JSON line; (d) a
    ``utils.profiling.trace`` of one warm default ``predict_continent`` on
    phase 6's region: K1's, K2's and K3's kernel symbols among the trace's
    CUDA kernel events, the five device operations with the most time, the
    longest idle gaps and the device's idle share (``trace_summary``), not
    timed; (e) the analytic FLOPs (``utils.flops``) of the forwards of phases
    6, 12, 17 and 18 and of phase 22's step over their CUDA-event times, as
    a share of the TF32 tensor-core peak (log lines);
26. the parallel layer (``parallel_phase``): (a) world size 1 on NCCL in this
    process: ``distributed.initialize``, ``make_mesh(1)``,
    ``predict_continent(mesh=)`` on phase 6's region and weights against phase
    6's canvas (``TOL_SEAM``) with its launch counts, one
    ``make_sharded_train_step`` step at batch 128 against the one-device step
    at phase 22's tolerances (``hold_step``); (b) world size 2 on the one
    card, two processes of this script (``parallel_worker``) on NCCL if a
    two-rank NCCL all-reduce on one GPU succeeds (``parallel_probe``), else
    on Gloo: the tile-sharded continent against phase 6's canvas, the
    band-distributed streamed product on phase 20's region against the same
    options in one process (largest int16 difference and differing pixels),
    the data-parallel step at 64 rows per rank against the one-device step at
    128, ``make_tp_forward`` on a (1, 2) mesh against the one-device forward
    (``TOL_GENERATOR``), and the CLI's ``continent --mesh-devices 2`` and
    ``--multihost`` in two processes each, rank 0's JSON line checked; every
    process of (b) ends within ``PARALLEL_TIMEOUT_S`` or the phase fails;
27. the generator options (``generator_options``): ``compute_dtype=
    'bfloat16'`` (K2 1, K3 1, the trunk plain bf16), ``upsample_phase_conv``
    (K1 36, K2 1, K3 1), ``tail_hcw, tail_fused=False`` (K1 36, K7 1, K8 1),
    ``fused_rdb='never'`` (K2 1, K3 1, the trunk plain fp32) and the same at
    ``growth_channels=16``, each at 12 RRDBs and full width through phase 6's
    ``main_path`` (exact launches, tiled vs untiled, the canvas against phase
    6's within ``TOL_GENERATOR``, bf16's within ``TOL_BF16``; the growth-16
    trunk on seeded weights of its own), the generator card vs CPU (bf16 by
    ``hold_bf16``: nearer the CPU's bf16 forward than that lies to its
    float32 one), K1, K2, K3, K7 and K8 on the path's own inputs against
    their plain versions (``option_kernels``), warm ms/tile, the forward's
    stages and its FLOP share (bf16 against the bf16 peak, float32 against
    the TF32 peak); then a bf16 train step card vs CPU (2 RRDBs, batch 128,
    ``hold_step`` against bf16's own distance from the float32 step,
    ``bf16_step_card_vs_cpu``), ``fit`` at 12 RRDBs and batch 128 with its
    launch counts, and warm bf16 steps timed;
28. the kernels' bf16-multiplicand mode and the last surfaces
    (``bf16_routes_phase``): (a) the bf16 routes of K1, K4, K6 and K5 at the
    ragged (3,37,9,64) and at (2,286,286,64), and of K10 at (3,37,9) with
    both C_in and at its four main-path shapes, each against its plain
    version on bf16-rounded operands on the card (``hold_mxu``: largest
    difference within ``TOL_MXU_MAX`` and mean within ``TOL_MXU_MEAN`` of the
    range, the 3xTF32 kernel beyond both), timed beside the 3xTF32 route and
    the rounded plain version, K10 also beside cuDNN's bare ``F.conv2d`` on
    bf16 inputs and beside the whole function in PyTorch calls; (b) the
    four forced trunks in the mode (``k1_mxu`` ``rdb_resident='always'``,
    ``k4_mxu`` with K10's mode, ``k6_mxu``, ``k5_mxu``) through phase 6's
    ``main_path`` with phase 6's weights: exact launches of the bf16 routes,
    tiled vs untiled, the canvas against phase 6's within ``TOL_BF16``, the
    trunk's device time per forward; ``k1_mxu`` is the default
    configuration with the mode honoured, the decision measurement (its
    canvas's distance from float32 as a share of the range); ``k1_mxu``,
    ``k6_mxu`` and ``k5_mxu`` are timed in ms/tile in turns with the default
    (``mode_tile_ms``); (c) each forced trunk at 12
    RRDBs and init scale 1.0 card vs CPU (``hold_mxu_generator``); (d)
    growth 16 under 'auto' (the plain trunk), ``out_channels=2`` on the
    unfused tail and ``compute_dtype='float16'``, card vs CPU with their
    launches; (e) ``save_checkpoint`` of a 12-RRDB train state blocking and
    with ``block=False`` (the time to return, a train step during the write,
    the commit), the restore bit for bit; (f) the determinism finding
    (``determinism_worker`` in a new process with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: a 12-RRDB step twice by default,
    with ``cudnn.deterministic`` and with ``use_deterministic_algorithms``,
    what differs, what PyTorch names as nondeterministic, the step's time);
29. SwinIR-M x4 (``SwinIRConfig()``, ``swinir_phase``): the window-attention
    kernel ``window_attn`` against its plain version at (1,16,24,540),
    (2,8,16,192) and (1,24,8,36) with 6, 2 and 6 heads and at the continent
    cell's (2,288,288,540) with 6 heads of 30 channels, each at shift 0 and
    4, one launch a call, and at the cell's shape the precision check
    against the plain version in float64 (``TOL_TF32X3``: the kernel's
    products are fp32, a TF32 pass fails it), timed beside the plain version
    and ``F.scaled_dot_product_attention`` with the bias plus the mask as
    ``attn_mask`` over the partitioned windows; the whole model at full
    width and depth on a 36-px crop, card vs CPU, with bias tables at std 1;
    one forward at the cell's shapes (2 tiles of 288-px crops) launching
    the kernel 36 times and nothing else (``PER_FORWARD['swinir']``);
    ``predict_continent`` on phase 6's region with its launch counts and
    warm per-tile time; the forward's stages by CUDA events.
    ``python3 chip_smoke.py --swinir`` runs phases 0, 1 and 29 alone.
``python3 chip_smoke.py --training`` runs phases 0, 1 and 22 alone (phase
19's rasters built as phase 19 builds them).

Each main path checks its own configuration's launch counts (``PER_FORWARD``).
It prints the script's wall time, one JSON line of phase 22's training
numbers, one of phase 23's search numbers, one of phase 24's data-prep
numbers, one of phase 25's evaluation numbers, one of phase 26's parallel
numbers, one of phase 27's options numbers, one of phase 28's
(``bf16_routes``), one of phase 29's (``swinir``), one JSON line with each
kernel's launches (from the main path that runs it; the five bf16 routes
from phase 28's, ``window_attn`` from phase 29's), error, times and bound,
and ends with
``{"ok": true, "device": {...}}``. It refuses to run without a CUDA device and
imports nothing of JAX.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# tolerances, relative to the reference output's largest magnitude: every
# comparison is fp32 against fp32 with the sums taken in another order
# (cuDNN / cuBLAS / CPU kernels vs the hand-written ones), which costs a few
# units of 1e-7 per term; 1e-4 leaves room for the longest chains (1728-term
# conv sums, 36 chained dense blocks) while any indexing or layout fault
# gives errors of the order of the output itself
TOL_KERNEL = 1e-4
TOL_GENERATOR = 1e-4
# tiled vs untiled region: the same, plus the generator's far field beyond
# the 18-px halo, which the seeded weights (init scale 0.1) damp far below it
TOL_SEAM = 1e-4
# K1, K4, K5, K6, K2, K7, K10 and K9 (64 and 16 outputs) run their
# contractions on the tensor cores in 3xTF32,
# which is as accurate as fp32 FMAs; one TF32 pass (10 mantissa bits) gives
# errors of ~1e-4 to 4e-4 of the output's range, at or above TOL_KERNEL, so
# TOL_KERNEL alone would not catch a kernel that lost the lo terms. The
# precision check holds them (the dense blocks at scaling 1.0: 0.1 would damp
# the conv's error tenfold under the residual) against the plain version in
# float64: 3xTF32's error is a few 1e-7 of the
# range, fp32 round-off of 1728-term sums, well below 1e-5, and a single pass's
# is tens of times above it (tests/test_torch_port_rdb_tc.py and
# tests/test_torch_port_tail_tc.py show both with the numpy emulations of the
# kernels)
TOL_TF32X3 = 1e-5

DEVICE = "cuda"
SMALL_RDB, MAIN_RDB = (1, 13, 14, 64), (2, 286, 286, 64)
# H and W not multiples of K1's and K4's 16 x 16 tile nor of K5's and K6's
# 8 x 16, W narrower than both; five of K5's bands, more than its rings' slots
RAGGED_RDB = (3, 37, 9, 64)
SWEEP_RDB = (2, 22, 14, 64)  # three bands of K5's 8 rows, the last one short
MAIN_TAIL = (2, 1144, 1144, 64)
# the tail kernels' small cases, (N, H, W, C[, clamp]) with clamp 2 unless
# given: one shape, a ragged one (H and W multiples of neither K2's 16 x 16
# nor K3's 8 x 32 tile, batch > 1), one smaller than both tiles, and clamp 1
SMALL_TAILS = [(1, 20, 130, 64), (2, 37, 45, 64), (1, 5, 7, 64), (1, 20, 130, 64, 1)]
# K10's small cases (N, H, W, C_in, leaky, residual): both C_in, with and
# without the residual across them and the main calls
SMALL_CONVS = [(1, 13, 21, 128, True, False), (1, 13, 21, 128, False, True)]
# K9 (N, H, W, C_in, C_out): the JAX test's shape, a 64-channel one, and the
# tail's two layers at the main-path shape
SMALL_ZFORM = [(1, 9, 13, 8, 16), (1, 20, 130, 64, 64)]
MAIN_ZFORM = [(2, 1144, 1144, 64, 64), (2, 1144, 1144, 64, 1)]
# K10's four calls in one main-path forward: pre-residual, post-residual,
# post-upsample 1 and 2
MAIN_CONVS = [(2, 286, 286, 128, True, False), (2, 286, 286, 64, False, True),
              (2, 572, 572, 64, True, False), (2, 1144, 1144, 64, True, False)]
# phase 28's K10 bf16 route also at RAGGED_RDB's (N, H, W), both C_in
RAGGED_CONVS = [(3, 37, 9, 128, True, False), (3, 37, 9, 64, False, True)]
GEN_LR = 64  # phase 5 crop: latent 62, output 248^2
TILE_OUT, HALO_LR, TILES_PER_DISPATCH = 1000, 18, 2  # phase 6, 288-px crops

# phase 19: a window near Pine Island Glacier in EPSG:3031 metres, (xmin,
# ymin); 286 km gives X 288^2 with the 1 km padding and a 1144^2 output, so
# K1 runs at (1,286,286,64) and K2/K3 at (1,1144,1144); the card-vs-CPU
# predict runs on 48 km (X 50^2, output 192^2), since the CPU's plain
# deformable tail at 1144^2 would take minutes
REGION_ORIGIN = (-1_600_000.0, -250_000.0)
REGION_KM, REGION_CPU_KM = 286, 48
REGION_CPU_AT = (100_000.0, 120_000.0)  # the 48 km window's offset in the 286 km one
REGION_MARGIN = 10_000.0  # the source rasters reach this far beyond the padding
# each source: resolution, its grid's offset from the window's, voids or not
REGION_SOURCES = {
    "bed_lowres": (1000.0, 0.0, True),
    "surface": (100.0, 0.0, False),
    "velocity_x": (450.0, 137.0, True),  # not aligned to the 500 m it becomes
    "velocity_y": (450.0, 137.0, True),
    "accumulation": (1000.0, 250.0, False),
}
TRACK_POINTS, TRACK_NOISE_M = 100_000, 10.0
TOL_INPUTS = 1e-6  # get_model_inputs card vs CPU: the same float32 operations

# phase 20: the continent product on a 3 x 3-tile region (3000^2 output, 750^2
# low-res), phase 6's tiles; three bands, so the middle one is interior
PRODUCT_TILES, PRODUCT_OVERVIEWS, PRODUCT_REPS = 3, 2, 3
# phase 6's weights (init scale 0.1) give outputs under 0.01 m in magnitude,
# whose int16 product is all zeros: a writer that wrote zeros would pass.
# Phase 20 draws the same seeded generator at init scale 1.0 (phase 5's second
# check); on phase 19's kind of smooth fields at bed, surface, velocity and
# accumulation scale its outputs span hundreds to thousands of metres, a
# bed's magnitudes, so the encode rates and sizes are a DEM's, not noise's
PRODUCT_INIT_SCALE = 1.0
# (base, amplitude) of each input's smooth field: X the bed at 1000 m, W1 the
# surface at 100 m (low enough that part of it is below zero, so the clip
# runs), W2 the two velocity components at 500 m, W3 the accumulation
PRODUCT_FIELDS = {"X": (1, (-500.0, 800.0)), "W1": (10, (300.0, 800.0)),
                  "W2": (2, (0.0, 300.0), (0.0, 300.0)), "W3": (1, (0.3, 0.2))}
# rows of the interior band's first TIFF strip on which the native LZW is
# held against the pure-Python codec (that one runs at tens of KB/s)
CODEC_ROWS = 16
# phase 21: the server, on phase 19's window and rasters
SERVE_CONCURRENT, SERVE_REPS = 4, 10
SERVE_BUCKET_PX, SERVE_BUCKET_KM = 1024, 200  # a 200 km window buckets to 256 km
SERVE_CROP_AT, SERVE_CROP_PX = (300, 700), 1000  # /dem's crop of the 3000^2 product
SERVE_TRACK_POINTS = 10_000
CLI_FLAGS = {"bed_lowres": "--bed", "surface": "--surface", "velocity_x": "--velocity-x",
             "velocity_y": "--velocity-y", "accumulation": "--accumulation"}

# the H100 SXM's published peaks (NVIDIA's data sheet, dense rates, at its
# 700 W limit), kept in the port's utils/flops.py: fp32 outside the tensor
# cores, TF32 on the tensor cores, HBM bandwidth. See bound().
from deepbedmap_tpu_torch.utils.flops import (  # noqa: E402
    H100_BF16_TC_PEAK_FLOPS as PEAK_BF16_TC,
    H100_FP32_PEAK_FLOPS as PEAK_FP32_FLOPS,
    H100_HBM_BYTES_PER_S as PEAK_HBM_BYTES,
    H100_TF32_TC_PEAK_FLOPS as PEAK_TF32_TC,
)

# the generator configurations the main paths run and the kernels one
# forward of each launches (every other counter must stay 0): the four
# trunk/tail configurations (phases 6, 12, 17, 18) and phase 27's options
CONFIGS = {
    "default": {},
    "kernel": dict(rrdb_fused=True, fused_conv="always", tail_fused=False),
    "banded": dict(rdb_resident="never"),
    "sweep": dict(rrdb_sweep=True),
    "bf16": dict(compute_dtype="bfloat16"),
    "phase": dict(upsample_phase_conv=True),
    "hcw": dict(tail_hcw=True, tail_fused=False),
    "plain": dict(fused_rdb="never"),
    "plain16": dict(fused_rdb="never", growth_channels=16),
    # phase 28: the forced trunks with rdb_mxu_bf16 at its default (on), K10
    # with conv_mxu_bf16 beside K4; and three configurations JAX builds that
    # the port refused before
    "k1_mxu": dict(rdb_resident="always"),
    "k4_mxu": dict(rdb_resident="always", rrdb_fused=True, fused_conv="always",
                   conv_mxu_bf16=True, tail_fused=False),
    "k6_mxu": dict(rdb_resident="never", fused_rdb="always"),
    "k5_mxu": dict(rdb_resident="always", rrdb_sweep=True),
    "growth16": dict(growth_channels=16),
    "out2": dict(out_channels=2, tail_fused=False),
    "fp16": dict(compute_dtype="float16"),
}
PER_FORWARD = {
    "default": {"rdb_forward": 36, "deform64_lrelu": 1, "deform_zproj1": 1},
    "kernel": {"rrdb_forward": 12, "conv3x3_forward": 4, "deform_conv": 1,
               "deform_conv_zproj1": 1},
    "banded": {"rdb_banded_forward": 36, "deform64_lrelu": 1, "deform_zproj1": 1},
    "sweep": {"rrdb_sweep_forward": 12, "deform64_lrelu": 1, "deform_zproj1": 1},
    "bf16": {"deform64_lrelu": 1, "deform_zproj1": 1},
    "phase": {"rdb_forward": 36, "deform64_lrelu": 1, "deform_zproj1": 1},
    "hcw": {"rdb_forward": 36, "deform_conv": 1, "deform_conv_zproj1": 1},
    "plain": {"deform64_lrelu": 1, "deform_zproj1": 1},
    "plain16": {"deform64_lrelu": 1, "deform_zproj1": 1},
    "k1_mxu": {"rdb_forward_bf16": 36, "deform64_lrelu": 1, "deform_zproj1": 1},
    "k4_mxu": {"rrdb_forward_bf16": 12, "conv3x3_forward_bf16": 4, "deform_conv": 1,
               "deform_conv_zproj1": 1},
    "k6_mxu": {"rdb_banded_forward_bf16": 36, "deform64_lrelu": 1, "deform_zproj1": 1},
    "k5_mxu": {"rrdb_sweep_forward_bf16": 12, "deform64_lrelu": 1, "deform_zproj1": 1},
    # 'auto' at growth 16: the plain trunk; the second layer of 64 -> 2 runs
    # the plain samplers
    "growth16": {"deform64_lrelu": 1, "deform_zproj1": 1},
    "out2": {"rdb_forward": 36, "deform_conv": 1},
    "fp16": {"deform64_lrelu": 1, "deform_zproj1": 1},
    # phase 29's SwinIR-M x4 (SwinIRConfig(), not a GeneratorConfig): one
    # window-attention launch a Swin layer, its convs and linears on cuDNN
    # and cuBLAS
    "swinir": {"window_attn": 36},
}

# operations per pixel: a 3x3 conv with C_in -> C_out channels does
# 2 * 9 * C_in * C_out; a bilinear sample of one channel 8 (4 FMAs)
RDB_MACS = 9 * sum((64 + 32 * j) * (32 if j < 4 else 64) for j in range(5))


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare(label: str, got, want, rel_tol: float) -> float:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite values")
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    tol = rel_tol * scale
    log(f"  {label}: max_abs_err {err:.3e} (tolerance {tol:.3e} = {rel_tol:g} x "
        f"max|ref| {scale:.3e})")
    if not err <= tol:
        raise AssertionError(f"{label}: error {err:.3e} above tolerance {tol:.3e}")
    return err


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(mm_flops: float, nbytes: float, fp32_flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations time
    and the bytes time (inputs read once, outputs written once, at the HBM
    rate). Operations come in two kinds. ``mm_flops`` are matrix products:
    the 3x3 convs' and the deformable convs' channel contractions (K1, K4,
    K5, K6, K10, the 64 -> 64 sums of K2, K7 and K9, and K8's and K9's tap
    projections); they run at fp32 accuracy fastest on the tensor cores as
    3xTF32, three TF32 passes (3 / 495 < 1 / 67 TFLOP/s on the fp32 units).
    ``fp32_flops`` are the rest, the bilinear sampling of K2, K3, K7, K8 and
    K9 (8 per sample), which only the fp32 units do. The route of the winning
    term is named in ``bound_route``; ``bound_fp32_ms`` is the bound with
    every operation on the fp32 units, the earlier definition, for the log
    lines only."""
    t_mm = 1e3 * 3 * mm_flops / PEAK_TF32_TC  # 3xTF32: three TF32 products
    t_ops = t_mm + 1e3 * fp32_flops / PEAK_FP32_FLOPS
    t_bytes = 1e3 * nbytes / PEAK_HBM_BYTES
    if t_bytes > t_ops:
        route = "HBM bytes"
    elif mm_flops and fp32_flops:
        route = "3xTF32 tensor cores + fp32 sampling"
    else:
        route = "3xTF32 tensor cores" if mm_flops else "fp32 units"
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_route": route,
            "bound_fp32_ms": max(1e3 * (mm_flops + fp32_flops) / PEAK_FP32_FLOPS, t_bytes)}


def summed_bound(bounds) -> dict:
    """The bound of an entry that sums several calls (K10's four, K9's two):
    the sum of each call's own bound. ``bound()`` of the summed work would
    take the larger of the summed operations and the summed bytes, which
    under-counts calls bound by different terms. ``bound_by`` is the term
    of the call with the largest bound; ``bound_route`` names each call's."""
    top = max(bounds, key=lambda b: b["bound_ms"])
    return {"bound_ms": sum(b["bound_ms"] for b in bounds), "bound_by": top["bound_by"],
            "bound_route": " / ".join(dict.fromkeys(b["bound_route"] for b in bounds)),
            "bound_fp32_ms": sum(b["bound_fp32_ms"] for b in bounds)}


def _numel(*tensors) -> int:
    return sum(t.numel() for t in tensors)


def _randn(shape, gen, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen) * scale).to(DEVICE)


def _offsets(shape, gen):
    """std-1.5 offsets, some beyond the +/-2 clamp, some exact integers."""
    import torch

    off = torch.randn(shape, generator=gen) * 1.5
    flat = off.view(-1)
    idx = torch.randperm(flat.numel(), generator=gen)[: flat.numel() // 20]
    vals = torch.tensor([-3.7, -2.0, -1.0, 0.0, 1.0, 2.0, 4.2])
    flat[idx] = vals[torch.randint(len(vals), (len(idx),), generator=gen)]
    return off.to(DEVICE)


def _double(ts):
    return [_double(t) for t in ts] if isinstance(ts, (list, tuple)) else ts.double()


def check_precision(label: str, fn, reference, x, kernels, biases) -> float:
    """Phases 2, 7, 13 and 14: the kernel at scaling 1.0 against its plain
    version run in float64 on the card, within ``TOL_TF32X3`` of the range."""
    import torch

    got = fn(x, kernels, biases, 1.0)
    want = reference(x.double(), _double(kernels), _double(biases), 1.0)
    torch.cuda.synchronize()
    return compare(f"{label} {tuple(x.shape)}, scaling 1.0, vs float64 (precision check)",
                   got, want, TOL_TF32X3)


def check_rdb(shape, gen, timed: bool, kernel: str = "rdb_fused") -> dict:
    """K1 (``rdb_fused``) or K6 (``rdb_banded``): one dense block."""
    import torch

    from deepbedmap_tpu_torch.ops import rdb
    from deepbedmap_tpu_torch.ops.rdb import rdb_reference

    fn = getattr(rdb, kernel)
    label = {"rdb_fused": "K1 rdb_forward", "rdb_banded": "K6 rdb_banded_forward"}[kernel]

    f, g = 64, 32
    cins, couts = [f + g * j for j in range(5)], [g, g, g, g, f]
    kernels = [_randn((co, ci, 3, 3), gen, 0.05) for ci, co in zip(cins, couts)]
    biases = [_randn((co,), gen, 0.1) for co in couts]
    x = _randn(shape, gen)
    got = fn(x, kernels, biases, 0.1)
    want = rdb_reference(x, kernels, biases, 0.1)
    torch.cuda.synchronize()
    res = {"max_abs_err": compare(f"{label} {shape}", got, want, TOL_KERNEL)}
    del want
    if timed:
        check_precision(label, fn, rdb_reference, x, kernels, biases)
        res["ms"] = time_ms(lambda: fn(x, kernels, biases, 0.1), 10)
        res["plain_ms"] = time_ms(lambda: rdb_reference(x, kernels, biases, 0.1), 10)
        pix = x.numel() // 64
        # the function's own inputs: x and the unsplit weights and biases
        res.update(bound(2 * pix * RDB_MACS, 4 * (2 * x.numel() + _numel(*kernels, *biases))),
                   library_ms=None)
    return res


def _tail_case(shape):
    """(N, H, W, C) and the clamp of a tail kernel's case."""
    n, h, w, c, *rest = shape
    return (n, h, w, c), (rest[0] if rest else 2)


def check_deform_precision(label: str, got, x, off, wt, b, clamp, lrelu: bool) -> float:
    """Phases 3, 9 and 15: the tensor-core deformable conv against its plain
    version run in float64 on the card, within ``TOL_TF32X3`` of the range."""
    import torch

    from deepbedmap_tpu_torch.ops.deform_conv import deform_conv_shifts

    want = deform_conv_shifts(*_double((x, off, wt, b)), 1, clamp)
    if lrelu:
        want = torch.where(want >= 0, want, 0.2 * want)
    torch.cuda.synchronize()
    return compare(f"{label} {tuple(x.shape)} vs float64 (precision check)", got, want,
                   TOL_TF32X3)


def check_deform64(shape, gen, timed: bool) -> dict:
    import torch

    from deepbedmap_tpu_torch.ops.deform_conv import deform_conv_shifts
    from deepbedmap_tpu_torch.ops.tail import deform64_lrelu

    (n, h, w, c), clamp = _tail_case(shape)
    x = _randn((n, h, w, c), gen)
    off = _offsets((n, h, w, 18), gen)
    w1, b1 = _randn((c, c, 3, 3), gen, 0.05), _randn((c,), gen, 0.1)

    def plain():
        y = deform_conv_shifts(x, off, w1, b1, 1, clamp)
        return torch.where(y >= 0, y, 0.2 * y)

    got = deform64_lrelu(x, off, w1, b1, clamp)
    want = plain()
    torch.cuda.synchronize()
    res = {"max_abs_err": compare(f"K2 deform64_lrelu {shape}", got, want, TOL_KERNEL)}
    del want
    if timed:
        check_deform_precision("K2 deform64_lrelu", got, x, off, w1, b1, clamp, True)
        res["ms"] = time_ms(lambda: deform64_lrelu(x, off, w1, b1, clamp), 5)
        res["plain_ms"] = time_ms(plain, 2)
        res.update(_deform64_bound(x, off, w1, b1), library_ms=None)
    return res


def _deform64_bound(x, off, weight, bias) -> dict:
    """64 -> 64 deformable conv: the 576 -> 64 contraction and 9 x 64 bilinear
    samples per pixel; x, the offsets and the weights read (once, unsplit),
    the output written."""
    pix = x.numel() // 64
    return bound(pix * 2 * 576 * 64,
                 4 * (2 * x.numel() + off.numel() + _numel(weight, bias)),
                 fp32_flops=pix * 9 * 64 * 8)


def check_zproj1(shape, gen, timed: bool) -> dict:
    import torch

    from deepbedmap_tpu_torch.ops.deform_conv import sample_tap_fields
    from deepbedmap_tpu_torch.ops.tail import deform_zproj1

    (n, h, w, _), clamp = _tail_case(shape)
    z = _randn((n, h, w, 9), gen)
    off = _offsets((n, h, w, 18), gen)
    b2 = _randn((1,), gen, 0.1)
    got = deform_zproj1(z, off, b2, clamp)
    want = sample_tap_fields(z[..., None], off, b2, 1, clamp)
    torch.cuda.synchronize()
    res = {"max_abs_err": compare(f"K3 deform_zproj1 {(n, h, w, 9)}, clamp {clamp}", got,
                                  want, TOL_KERNEL)}
    if timed:
        res["ms"] = time_ms(lambda: deform_zproj1(z, off, b2, clamp), 20)
        res["plain_ms"] = time_ms(lambda: sample_tap_fields(z[..., None], off, b2, 1, clamp),
                                  3)
        res.update(bound(0, 4 * (z.numel() + off.numel() + n * h * w + 1),
                         fp32_flops=n * h * w * 9 * 8),
                   library_ms=None)
    return res


def check_rrdb(shape, gen, timed: bool, kernel: str = "rrdb_fused") -> dict:
    """K4 (``rrdb_fused``) or K5 (``rrdb_sweep``): one whole RRDB."""
    import torch

    from deepbedmap_tpu_torch.ops import rdb
    from deepbedmap_tpu_torch.ops.rdb import rrdb_reference

    fn = getattr(rdb, kernel)
    label = {"rrdb_fused": "K4 rrdb_forward", "rrdb_sweep": "K5 rrdb_sweep_forward"}[kernel]

    f, g = 64, 32
    cins, couts = [f + g * j for j in range(5)], [g, g, g, g, f]
    kernels = [[_randn((co, ci, 3, 3), gen, 0.05) for ci, co in zip(cins, couts)]
               for _ in range(3)]
    biases = [[_randn((co,), gen, 0.1) for co in couts] for _ in range(3)]
    x = _randn(shape, gen)
    got = fn(x, kernels, biases, 0.1)
    want = rrdb_reference(x, kernels, biases, 0.1)
    torch.cuda.synchronize()
    res = {"max_abs_err": compare(f"{label} {shape}", got, want, TOL_KERNEL)}
    del want
    if timed:
        check_precision(label, fn, rrdb_reference, x, kernels, biases)
        res["ms"] = time_ms(lambda: fn(x, kernels, biases, 0.1), 10)
        res["plain_ms"] = time_ms(lambda: rrdb_reference(x, kernels, biases, 0.1), 10)
        pix = x.numel() // 64
        res.update(bound(3 * 2 * pix * RDB_MACS,
                         4 * (2 * x.numel() + _numel(*sum(kernels + biases, [])))),
                   library_ms=None)
    return res


def _check_conv(shape, gen, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from deepbedmap_tpu_torch.ops.conv3x3 import conv3x3_fused, conv3x3_reference

    n, h, w, cin, leaky, residual = shape
    x = _randn((n, h, w, cin), gen)
    wt, b = _randn((64, cin, 3, 3), gen, 0.05), _randn((64,), gen, 0.1)
    r = _randn((n, h, w, 64), gen) if residual else None
    got = conv3x3_fused(x, wt, b, leaky, r)
    want = conv3x3_reference(x, wt, b, leaky, r)
    torch.cuda.synchronize()
    label = f"K10 conv3x3_forward {(n, h, w, cin)} -> 64, leaky {leaky}, residual {residual}"
    res = {"max_abs_err": compare(label, got, want, TOL_KERNEL)}
    del want
    want = conv3x3_reference(*_double((x, wt, b)), leaky, None if r is None else r.double())
    torch.cuda.synchronize()
    compare(f"{label} vs float64 (precision check)", got, want, TOL_TF32X3)
    del want
    if timed:
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last, as the port keeps it
        res["ms"] = time_ms(lambda: conv3x3_fused(x, wt, b, leaky, r), 10)
        res["plain_ms"] = time_ms(lambda: conv3x3_reference(x, wt, b, leaky, r), 10)
        res["library_ms"] = time_ms(lambda: F.conv2d(x_nchw, wt, b, padding=1), 10)
        res["flops"] = 2 * n * h * w * 9 * cin * 64
        res["bytes"] = 4 * (x.numel() + n * h * w * 64 * (2 if residual else 1)
                            + _numel(wt, b))
    return res


def check_conv3x3(shapes, gen, timed: bool) -> dict:
    """K10 at each shape; timed, the entry is one main-path forward's four
    calls: their summed times and bounds, and the largest error."""
    if not timed:
        return _check_conv(shapes, gen, False)
    parts = [_check_conv(s, gen, True) for s in shapes]
    bounds = [bound(p["flops"], p["bytes"]) for p in parts]
    for s, p, b in zip(shapes, parts, bounds):
        log(f"  K10 at {s}: kernel {p['ms']:.3f} ms, plain {p['plain_ms']:.3f} ms, "
            f"F.conv2d {p['library_ms']:.3f} ms, bound {b['bound_ms']:.3f} ms = "
            f"{100 * b['bound_ms'] / p['ms']:.0f}% of the bound (fp32 "
            f"{b['bound_fp32_ms']:.3f} ms)")
    res = {"max_abs_err": max(p["max_abs_err"] for p in parts)}
    for key in ("ms", "plain_ms", "library_ms"):
        res[key] = sum(p[key] for p in parts)
    res.update(summed_bound(bounds))
    return res


def check_deform_conv(shape, gen, timed: bool) -> dict:
    import torch

    from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv_shifts

    (n, h, w, c), clamp = _tail_case(shape)
    x = _randn((n, h, w, c), gen)
    off = _offsets((n, h, w, 18), gen)
    wt, b = _randn((c, c, 3, 3), gen, 0.05), _randn((c,), gen, 0.1)
    got = deform_conv2d(x, off, wt, b, 1, clamp)
    want = deform_conv_shifts(x, off, wt, b, 1, clamp)
    torch.cuda.synchronize()
    res = {"max_abs_err": compare(f"K7 deform_conv {shape}", got, want, TOL_KERNEL)}
    del want
    if timed:
        check_deform_precision("K7 deform_conv", got, x, off, wt, b, clamp, False)
        res["ms"] = time_ms(lambda: deform_conv2d(x, off, wt, b, 1, 2), 5)
        res["plain_ms"] = time_ms(lambda: deform_conv_shifts(x, off, wt, b, 1, 2), 2)
        res.update(_deform64_bound(x, off, wt, b), library_ms=None)
    return res


def check_deform_conv_zproj1(shape, gen, timed: bool) -> dict:
    import torch

    from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv_shifts_zproj

    (n, h, w, c), clamp = _tail_case(shape)
    x = _randn((n, h, w, c), gen)
    off = _offsets((n, h, w, 18), gen)
    wt, b = _randn((1, c, 3, 3), gen, 0.05), _randn((1,), gen, 0.1)
    got = deform_conv2d(x, off, wt, b, 1, clamp)
    want = deform_conv_shifts_zproj(x, off, wt, b, 1, clamp)
    torch.cuda.synchronize()
    res = {"max_abs_err": compare(f"K8 deform_conv_zproj1 {shape} -> 1", got, want,
                                  TOL_KERNEL)}
    if timed:
        res["ms"] = time_ms(lambda: deform_conv2d(x, off, wt, b, 1, 2), 20)
        res["plain_ms"] = time_ms(lambda: deform_conv_shifts_zproj(x, off, wt, b, 1, 2), 3)
        # the whole layer: the 64 -> 9 projection and 9 bilinear samples per
        # pixel; x and the offsets read, the one-channel output written
        pix = n * h * w
        res.update(bound(pix * 2 * 64 * 9,
                         4 * (x.numel() + off.numel() + pix + _numel(wt, b)),
                         fp32_flops=pix * 9 * 8),
                   library_ms=None)
    return res


def _zform_case(shape, gen):
    n, h, w, cin, cout = shape
    return (_randn((n, h, w, cin), gen), _offsets((n, h, w, 18), gen),
            _randn((cout, cin, 3, 3), gen, 0.05), _randn((cout,), gen, 0.1))


def _check_zform(shape, case, timed: bool) -> dict:
    import torch

    from deepbedmap_tpu_torch.ops.deform_conv import (
        deform_conv2d_zform,
        deform_conv_shifts_zproj,
    )

    n, h, w, cin, cout = shape
    x, off, wt, b = case
    got = deform_conv2d_zform(x, off, wt, b, 1, 2)
    want = deform_conv_shifts_zproj(x, off, wt, b, 1, 2)
    torch.cuda.synchronize()
    res = {"max_abs_err": compare(f"K9 deform_zform {(n, h, w, cin)} -> {cout}", got,
                                  want, TOL_KERNEL)}
    del want
    if cout > 1:
        check_deform_precision(f"K9 deform_zform -> {cout}", got, x, off, wt, b, 2, False)
    if timed:
        res["ms"] = time_ms(lambda: deform_conv2d_zform(x, off, wt, b, 1, 2), 5)
        res["plain_ms"] = time_ms(lambda: deform_conv_shifts_zproj(x, off, wt, b, 1, 2), 2)
        # the deformable conv's own work, as K7's and K8's: the C_in*9 -> C_out
        # contraction and 9 x C_out bilinear samples per pixel; x and the
        # offsets read, the output written
        pix = n * h * w
        res["flops"] = pix * 2 * 9 * cin * cout
        res["fp32_flops"] = pix * 9 * cout * 8
        res["bytes"] = 4 * (x.numel() + off.numel() + pix * cout + _numel(wt, b))
    return res


def check_zform(shapes, gen, timed: bool) -> dict:
    """K9 at one shape; timed, its own path first: ``deform_conv2d_zform``
    once at each main shape (the tail's two layers), its launches counted,
    then each shape against the plain version (and, with 64 outputs, the
    precision check). The entry sums the two calls' times and bounds, as
    K10's sums one forward's four."""
    import torch

    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d_zform

    if not timed:
        return _check_zform(shapes, _zform_case(shapes, gen), False)
    cases = [_zform_case(s, gen) for s in shapes]
    _kernels.reset_launches()
    for case in cases:
        deform_conv2d_zform(*case, 1, 2)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    log(f"  launches on deform_conv2d_zform's path: {launches}")
    check_launches(launches, {k: len(shapes) if k == "deform_zform" else 0
                              for k in launches})
    parts = [_check_zform(s, c, True) for s, c in zip(shapes, cases)]
    bounds = [bound(p["flops"], p["bytes"], p["fp32_flops"]) for p in parts]
    for s, p, b in zip(shapes, parts, bounds):
        log(f"  K9 at {s}: kernel {p['ms']:.3f} ms, plain {p['plain_ms']:.3f} ms, "
            f"bound {b['bound_ms']:.3f} ms = {100 * b['bound_ms'] / p['ms']:.0f}% of the "
            f"bound ({b['bound_route']}; fp32 {b['bound_fp32_ms']:.3f} ms)")
    res = {"max_abs_err": max(p["max_abs_err"] for p in parts),
           "launches": launches["deform_zform"], "library_ms": None}
    for key in ("ms", "plain_ms"):
        res[key] = sum(p[key] for p in parts)
    res.update(summed_bound(bounds))
    return res


def _crop_inputs(lr: int, batch: int, seed: int):
    rs = np.random.RandomState(seed)
    shapes = [(batch, lr, lr, 1), (batch, 10 * lr, 10 * lr, 1),
              (batch, 2 * lr, 2 * lr, 2), (batch, lr, lr, 1)]
    return [rs.rand(*s).astype(np.float32) for s in shapes]


def check_generator(init_scale: float, flags: dict) -> float:
    """Phases 5, 11 and 16: full-width, full-depth generator, card kernels vs
    CPU plain versions."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.models import build_generator

    cfg = GeneratorConfig(init_scale=init_scale, **flags)
    cpu_model = build_generator(cfg, seed=0, device="cpu").eval()
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    xs = [torch.from_numpy(a) for a in _crop_inputs(GEN_LR, 1, seed=1)]
    with torch.inference_mode():
        want = cpu_model(*xs)
        got = gpu_model(*[a.to(DEVICE) for a in xs])
        torch.cuda.synchronize()
    return compare(
        f"generator 12 RRDB {flags or 'defaults'}, init_scale {init_scale}, "
        f"{GEN_LR}-px crop -> {tuple(got.shape)}",
        got.cpu(), want, TOL_GENERATOR,
    )


def forward_breakdown(model, xs, reps: int = 3) -> dict:
    """Device time of each stage of one forward (``Generator``'s ``head``,
    ``trunk``, ``upsample`` and ``tail``), by CUDA events."""
    import torch

    from deepbedmap_tpu_torch.config import conv_kernel, trunk_kernel

    cfg = model.cfg
    dt = "bf16" if cfg.compute_dtype == "bfloat16" else "fp32"
    conv = "K10" if conv_kernel(cfg) else f"cuDNN {dt}"
    blocks = cfg.num_residual_blocks
    trunk = {"rdb": f"{3 * blocks} x K1 + RRDB skips",
             "rdb_banded": f"{3 * blocks} x K6 + RRDB skips",
             "rrdb_fused": f"{blocks} x K4", "rrdb_sweep": f"{blocks} x K5",
             "plain": f"{3 * blocks} plain dense blocks (cuDNN {dt}) + RRDB skips"}[
                 trunk_kernel(cfg)]
    if cfg.upsample_phase_conv:
        upsample = f"2 x phase conv (cuDNN {dt})"
    elif cfg.tail_hcw:
        upsample = f"2 x (upsample + conv) ({conv}, then cuDNN {dt} to HCW)"
    else:
        upsample = f"2 x (upsample + conv) ({conv})"
    tail = ("offset convs + K2 + projection + K3" if cfg.tail_fused else
            "offset conv + K7 + LeakyReLU + offset conv + projection + K8"
            + (", HCW views" if cfg.tail_hcw else ""))

    return _timed_stages(model, xs, [
        f"input block + pre-residual conv ({conv})", f"trunk: {trunk}",
        f"post-residual conv ({conv}) + {upsample}", f"tail: {tail}"], reps)


def check_launches(launches: dict, expected: dict) -> None:
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")


def continent_region():
    """Phase 6's region: (NCHW inputs of a 2 x 2-tile region at 250 m, its
    bounds, ``predict_continent``'s tiling keywords)."""
    out = 2 * TILE_OUT
    lh = out // 4
    rng = np.random.default_rng(2)
    inputs = {
        "X": rng.random((1, 1, lh, lh), dtype=np.float32),
        "W1": rng.random((1, 1, 10 * lh, 10 * lh), dtype=np.float32),
        "W2": rng.random((1, 2, 2 * lh, 2 * lh), dtype=np.float32),
        "W3": rng.random((1, 1, lh, lh), dtype=np.float32),
    }
    kw = dict(tile_out=TILE_OUT, halo_lr=HALO_LR, tiles_per_dispatch=TILES_PER_DISPATCH)
    return inputs, (0.0, 0.0, out * 250.0, out * 250.0), kw


def main_path(card_name: str, config: str, params=None, want=None, tol=TOL_GENERATOR):
    """Phases 6, 12, 17, 18 and 27: DeepBedMap.predict_continent in the
    configuration ``CONFIGS[config]`` on a 2 x 2-tile region, with ``params``
    (a state_dict) or the seeded weights; its launch counts are held against
    ``PER_FORWARD[config]``, its output against ``want`` when given and
    against the untiled ``predict_region``, each within ``tol`` of the range.
    Returns the kernels' launch counts in that run (``launches``), the model,
    the output (``out``), the device time of one forward at batch 2 (CUDA
    events; ``forward_ms``, by stage ``stages_ms``) and the warm
    ``tile_ms``."""
    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.inference import TilePlan, predict_region
    from deepbedmap_tpu_torch.ops import _kernels

    tile_out, halo_lr, tpd = TILE_OUT, HALO_LR, TILES_PER_DISPATCH
    out = 2 * tile_out
    inputs, bounds, kw = continent_region()
    flags = CONFIGS[config]
    dbm = DeepBedMap(params, cfg=GeneratorConfig(**flags), device=DEVICE)

    _kernels.reset_launches()
    t0 = time.perf_counter()
    raster = dbm.predict_continent(inputs, bounds, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)

    plan = TilePlan(out_h=out, out_w=out, tile_out=tile_out, halo_lr=halo_lr)
    forwards = plan.grid[0] * -(-plan.grid[1] // tpd)
    expected = {k: forwards * PER_FORWARD[config].get(k, 0) for k in _kernels.launches}
    log(f"  launches in predict_continent ({forwards} forwards): {launches}")
    check_launches(launches, expected)
    got = torch.from_numpy(raster.data)
    if raster.data.shape != (out, out) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"bad continent output {raster.data.shape}")
    if want is not None:
        compare(f"continent {out}x{out} in {flags} vs the default configuration",
                got, want, tol)

    dev = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 2, 3, 1))).to(DEVICE)
           for k, v in inputs.items()}
    whole = predict_region(dbm.forward_fn(), dev, plan)[0, :, :, 0].cpu()
    compare(f"continent {out}x{out} tiled vs untiled predict_region", got, whole,
            max(tol, TOL_SEAM))

    t0 = time.perf_counter()
    dbm.predict_continent(inputs, bounds, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    per_tile_ms = 1e3 * warm_s / plan.num_tiles
    log(f"  predict_continent {plan.num_tiles} tiles: cold {cold_s:.3f} s, warm "
        f"{warm_s:.3f} s = {per_tile_ms:.1f} ms/tile  [{card_name}]")

    xs = [torch.from_numpy(a).to(DEVICE) for a in _crop_inputs(plan.crop_lr, tpd, seed=3)]
    stage_ms = forward_breakdown(dbm.model, xs)
    for name, ms in stage_ms.items():
        log(f"  forward at batch {tpd} x {plan.crop_lr} px, {name}: {ms:.2f} ms  "
            f"[{card_name}]")
    log(f"  forward total: {sum(stage_ms.values()):.2f} ms  [{card_name}]")
    return {"launches": launches, "model": dbm.model, "out": got,
            "forward_ms": sum(stage_ms.values()), "stages_ms": stage_ms,
            "tile_ms": per_tile_ms}


def _smooth_field(rs, xc, yc, base: float, amp: float, terms: int = 6) -> np.ndarray:
    """A seeded sum of separable sines with 20-150 km wavelengths on the cell
    centers ``xc`` x ``yc``: smooth, so a bicubic track RMSE means something."""
    out = np.full((len(yc), len(xc)), base)
    for _ in range(terms):
        lx, ly = rs.uniform(20e3, 150e3, 2)
        px, py = rs.uniform(0, 2 * np.pi, 2)
        out += (amp / terms) * np.outer(np.cos(2 * np.pi * yc / ly + py),
                                        np.sin(2 * np.pi * xc / lx + px))
    return out.astype(np.float32)


def region_rasters(window, cpu_window, seed: int) -> dict:
    """Phase 19's five source rasters, covering the 1 km-padded ``window``
    with ``REGION_MARGIN`` to spare. The bed and the velocity get NaN voids
    (discs 3-12 km across) inside the padded window, one of each inside
    ``cpu_window``; the surface none."""
    from deepbedmap_tpu_torch.data.raster import Raster

    rs = np.random.RandomState(seed)
    xmin, ymin, xmax, ymax = window
    reach = 1000.0 + REGION_MARGIN
    fields = {"bed_lowres": (-500.0, 800.0), "surface": (1200.0, 600.0),
              "velocity_x": (0.0, 300.0), "velocity_y": (0.0, 300.0),
              "accumulation": (0.3, 0.2)}
    cx = (cpu_window[0] + cpu_window[2]) / 2
    cy = (cpu_window[1] + cpu_window[3]) / 2
    out = {}
    for name, (res, offset, voids) in REGION_SOURCES.items():
        left, top = xmin - reach - offset, ymax + reach + offset
        n = int(np.ceil((xmax - xmin + 2 * (reach + offset)) / res))
        xc = left + res * (np.arange(n) + 0.5)
        yc = top - res * (np.arange(n) + 0.5)
        data = _smooth_field(rs, xc, yc, *fields[name])
        if voids:
            centers = [(cx, cy)] + [(rs.uniform(xmin, xmax), rs.uniform(ymin, ymax))
                                    for _ in range(4)]
            for vx, vy in centers:
                r = rs.uniform(1500.0, 6000.0)
                data[np.add.outer((yc - vy) ** 2, (xc - vx) ** 2) < r * r] = np.nan
        out[name] = Raster(data, left=left, top=top, res=res)
    return out


def _host_ms(fn, reps: int) -> float:
    """Mean host-clock time of ``fn()`` over ``reps`` warm calls, each ended
    by a synchronise (these calls copy from and to the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def region_kernels(model, nhwc, dem: np.ndarray) -> None:
    """Phase 19: K1, K2 and K3 on the inputs ``predict`` gives them (K1 the
    first dense block's), each held against its plain version on the card
    within ``TOL_KERNEL``, K1 and K2 also in float64 within ``TOL_TF32X3``.
    The forward is replayed stage by stage; its output equals ``dem``, the
    prediction, bit for bit, so these are the prediction's own inputs."""
    import torch

    from deepbedmap_tpu_torch.ops.conv import conv_nhwc
    from deepbedmap_tpu_torch.ops.deform_conv import (
        deform_conv_shifts,
        sample_tap_fields,
        tap_projection,
    )
    from deepbedmap_tpu_torch.ops.rdb import rdb_fused, rdb_reference
    from deepbedmap_tpu_torch.ops.tail import deform64_lrelu, deform_zproj1

    clamp = model.cfg.deform_clamp
    with torch.inference_mode():
        a1 = model.head(*nhwc)
        rdb_in = a1.contiguous()
        a4 = model.upsample(model.trunk(a1), a1)
        l1, l2 = model.final_conv_layer1, model.final_conv_layer2
        o1k, o1b, w1, b1 = l1.tensors()
        o2k, o2b, w2, b2 = l2.tensors()
        # ops.tail.fused_deform_tail's steps, in its order and layouts
        off1 = conv_nhwc(a4, o1k, o1b).contiguous()
        x = a4.contiguous()
        a5 = deform64_lrelu(x, off1, w1, b1, clamp)
        off2 = conv_nhwc(a5, o2k, o2b).contiguous()
        z = tap_projection(a5, w2)
        out = deform_zproj1(z, off2, b2, clamp)
        if not np.array_equal(out[0, :, :, 0].cpu().numpy(), dem):
            raise AssertionError("the replayed forward differs from predict's output")
        log(f"  replayed forward equal to predict's output; K1 input {tuple(rdb_in.shape)}, "
            f"K2 {tuple(x.shape)}, K3 {tuple(z.shape)}")

        rdb = model.residual_network[0].residual_dense_block1
        kernels = [c.weight for c in rdb.convs()]
        biases = [c.bias for c in rdb.convs()]
        compare(f"K1 rdb_forward {tuple(rdb_in.shape)} (predict's input)",
                rdb_fused(rdb_in, kernels, biases, rdb.residual_scaling),
                rdb_reference(rdb_in, kernels, biases, rdb.residual_scaling), TOL_KERNEL)
        check_precision("K1 rdb_forward (predict's input)", rdb_fused, rdb_reference, rdb_in,
                        kernels, biases)

        plain = deform_conv_shifts(x, off1, w1, b1, 1, clamp)
        compare(f"K2 deform64_lrelu {tuple(x.shape)} (predict's input)", a5,
                torch.where(plain >= 0, plain, 0.2 * plain), TOL_KERNEL)
        del plain
        check_deform_precision("K2 deform64_lrelu (predict's input)", a5, x, off1, w1, b1,
                               clamp, True)
        compare(f"K3 deform_zproj1 {tuple(z.shape)} (predict's input)", out,
                sample_tap_fields(z[..., None], off2, b2, 1, clamp), TOL_KERNEL)


def region_windows():
    """Phase 19's 286 km window and the 48 km window inside it that the CPU
    also predicts, as (xmin, ymin, xmax, ymax)."""
    x0, y0 = REGION_ORIGIN
    side, cpu_side = 1e3 * REGION_KM, 1e3 * REGION_CPU_KM
    cx, cy = x0 + REGION_CPU_AT[0], y0 + REGION_CPU_AT[1]
    return (x0, y0, x0 + side, y0 + side), (cx, cy, cx + cpu_side, cy + cpu_side)


def single_region(card_name: str, params) -> dict:
    """Phase 19: the reference's single-region workflow with phase 6's
    weights (``params``, a state_dict on the card). Returns the five source
    ``rasters`` and the 286 km ``window``, which phase 21 serves, the
    ``dbm`` loaded from the npz and the ``track`` (x, y, z), which phase 25
    evaluates."""
    import tempfile

    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.bridge import state_dict_to_jax_params
    from deepbedmap_tpu_torch.data.groundtruth import get_model_inputs
    from deepbedmap_tpu_torch.evalx.track import grdtrack, track_rmse
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops.interp import as_f32
    from deepbedmap_tpu_torch.train.checkpoint import export_generator_npz
    from deepbedmap_tpu_torch.utils.tracking import LocalTracker

    def same_weights(label, dbm):
        sd = dbm.model.state_dict()
        if sd.keys() != params.keys() or not all(torch.equal(sd[k], params[k])
                                                 for k in params):
            raise AssertionError(f"{label}: weights differ from phase 6's")
        log(f"  {label}: {len(sd)} tensors equal to phase 6's bit for bit")

    with tempfile.TemporaryDirectory() as tmp:
        npz = f"{tmp}/srgan_generator_model_weights.npz"
        export_generator_npz(state_dict_to_jax_params(params), npz)
        t0 = time.perf_counter()
        dbm = DeepBedMap.from_chainer_npz(npz, device=DEVICE)
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        same_weights("from_chainer_npz", dbm)
        run = LocalTracker(f"{tmp}/experiments")
        run.log_params({"num_residual_blocks": 12, "residual_scaling": 0.2,
                        "generator_lr": 1.7e-4})
        run.log_asset(npz)
        tracked = DeepBedMap.from_experiment(f"{tmp}/experiments",
                                             download_path=f"{tmp}/dl/w.npz", device=DEVICE)
        got_cfg = (tracked.cfg.num_residual_blocks, tracked.cfg.residual_scaling)
        if got_cfg != (12, 0.2):
            raise AssertionError(f"from_experiment config {got_cfg}, logged (12, 0.2)")
        log(f"  from_experiment: config rebuilt from the logged parameters {got_cfg}")
        same_weights("from_experiment", tracked)
        del tracked

    x0, y0 = REGION_ORIGIN
    side = 1e3 * REGION_KM
    window, cpu_window = region_windows()
    rasters = region_rasters(window, cpu_window, seed=19)
    names = ("bed_lowres", "surface", "velocity_x", "velocity_y", "accumulation")
    sources = [rasters[k] for k in names]
    log(f"  {REGION_KM} km window {window}: sources "
        + ", ".join(f"{k} {r.data.shape} @ {r.res:g} m" for k, r in rasters.items()))

    _kernels.reset_launches()
    dem = dbm.predict(window, rasters)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    log(f"  launches in predict: {launches}")
    check_launches(launches, {k: PER_FORWARD["default"].get(k, 0) for k in launches})
    out = int(round(side / dbm.resolution))
    if dem.data.shape != (out, out) or dem.bounds != window:
        raise AssertionError(f"predict gave {dem.data.shape} over {dem.bounds}, want "
                             f"({out}, {out}) over {window}")
    if not np.isfinite(dem.data).all():
        raise AssertionError("predict: non-finite values")

    inputs = get_model_inputs(window, *sources, device=DEVICE)
    log("  inputs: " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in inputs.items()))
    nhwc = [inputs[k].permute(0, 2, 3, 1).contiguous() for k in ("X", "W1", "W2", "W3")]
    fwd = dbm.forward_fn()
    direct = fwd(*nhwc)[0, :, :, 0].cpu().numpy()
    if not np.array_equal(direct, dem.data):
        raise AssertionError("predict differs from forward_fn on get_model_inputs' tensors")
    log(f"  predict {dem.data.shape} over {dem.bounds}: finite, equal to forward_fn on "
        "get_model_inputs' tensors bit for bit")
    region_kernels(dbm.model, nhwc, dem.data)

    cpu_inputs = get_model_inputs(window, *sources, device="cpu")
    for k, want in cpu_inputs.items():
        got = inputs[k].cpu()
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"get_model_inputs {k}: NaN masks differ card vs CPU")
        compare(f"get_model_inputs {k} {tuple(want.shape)} card vs CPU",
                torch.nan_to_num(got), torch.nan_to_num(want), TOL_INPUTS)
    gapfilled = int((cpu_inputs["X"] == -5000.0).sum())
    if not gapfilled:
        raise AssertionError("no bed void reached X: the gapfill went unchecked")
    log(f"  X holds {gapfilled} gapfilled (-5000) cells, W2 "
        f"{int((cpu_inputs['W2'] == 0.0).sum())} (0)")

    cpu_dbm = DeepBedMap({k: v.cpu() for k, v in params.items()}, device="cpu")
    small_card = dbm.predict(cpu_window, rasters)
    small_cpu = cpu_dbm.predict(cpu_window, rasters)
    compare(f"predict {REGION_CPU_KM} km {small_card.data.shape} card vs CPU",
            torch.from_numpy(small_card.data), torch.from_numpy(small_cpu.data),
            TOL_GENERATOR)

    rs = np.random.RandomState(20)
    tx = rs.uniform(x0 + 1000.0, x0 + side - 1000.0, TRACK_POINTS)
    ty = rs.uniform(y0 + 1000.0, y0 + side - 1000.0, TRACK_POINTS)
    own = grdtrack(as_f32(dem.data, DEVICE), as_f32(tx, DEVICE), as_f32(ty, DEVICE),
                   dem.left, dem.top, dem.res).cpu().numpy()
    self_rmse = track_rmse(dem, tx, ty, own, device=DEVICE)
    if not self_rmse < 1e-5:
        raise AssertionError(f"track_rmse of the DEM vs its own samples {self_rmse:.3e}")
    tz = own + rs.randn(TRACK_POINTS) * TRACK_NOISE_M
    card_rmse = track_rmse(dem, tx, ty, tz, device=DEVICE)
    cpu_rmse = track_rmse(dem, tx, ty, tz, device="cpu")
    if not abs(card_rmse - cpu_rmse) <= 1e-6 * abs(cpu_rmse):
        raise AssertionError(f"track_rmse card {card_rmse!r} vs CPU {cpu_rmse!r}")
    if not abs(card_rmse - TRACK_NOISE_M) < 0.1:
        raise AssertionError(f"track_rmse {card_rmse} against {TRACK_NOISE_M} m of noise")
    log(f"  track_rmse on {TRACK_POINTS} points: vs own bicubic samples {self_rmse:.3e}; "
        f"with {TRACK_NOISE_M:g} m noise card {card_rmse!r}, CPU {cpu_rmse!r}")

    inputs_ms = _host_ms(lambda: get_model_inputs(window, *sources, device=DEVICE), 5)
    forward_ms = time_ms(lambda: fwd(*nhwc), 5)
    predict_ms = _host_ms(lambda: dbm.predict(window, rasters), 3)
    rmse_ms = _host_ms(lambda: track_rmse(dem, tx, ty, tz, device=DEVICE), 5)
    log(f"  npz load (from_chainer_npz, 12 RRDB): {load_ms:.1f} ms  [{card_name}]")
    log(f"  get_model_inputs {REGION_KM} km on the card, warm: {inputs_ms:.2f} ms  "
        f"[{card_name}]")
    log(f"  forward at (1,{REGION_KM + 2},{REGION_KM + 2}) -> {out}^2: {forward_ms:.2f} ms "
        f"(device time)  [{card_name}]")
    log(f"  predict {REGION_KM} km, warm: {predict_ms:.2f} ms  [{card_name}]")
    log(f"  track_rmse {TRACK_POINTS} points, warm: {rmse_ms:.2f} ms  [{card_name}]")
    for name, ms in forward_breakdown(dbm.model, nhwc).items():
        log(f"  forward at batch 1 x {REGION_KM + 2} px, {name}: {ms:.2f} ms  [{card_name}]")
    return {"rasters": rasters, "window": window, "dbm": dbm, "track": (tx, ty, tz)}


def _expected_launches(forwards: int) -> dict:
    from deepbedmap_tpu_torch.ops import _kernels

    return {k: forwards * PER_FORWARD["default"].get(k, 0) for k in _kernels.launches}


def _mb(path: str) -> float:
    return os.path.getsize(path) / 1e6


def product_inputs(bounds, lh: int, seed: int) -> dict:
    """Phase 20's NCHW inputs over ``bounds`` (``lh`` low-res px a side):
    phase 19's smooth seeded fields at each input's resolution and scale
    (``PRODUCT_FIELDS``)."""
    rs = np.random.RandomState(seed)
    xmin, _, xmax, ymax = bounds
    out = {}
    for key, (ratio, *channels) in PRODUCT_FIELDS.items():
        n = ratio * lh
        res = (xmax - xmin) / n
        xc = xmin + res * (np.arange(n) + 0.5)
        yc = ymax - res * (np.arange(n) + 0.5)
        out[key] = np.stack([_smooth_field(rs, xc, yc, *c) for c in channels])[None]
    return out


def product_region():
    """Phase 20's region: (NCHW inputs, bounds) of PRODUCT_TILES x
    PRODUCT_TILES tiles at 250 m from REGION_ORIGIN."""
    out = PRODUCT_TILES * TILE_OUT
    x0, y0 = REGION_ORIGIN
    bounds = (x0, y0, x0 + out * 250.0, y0 + out * 250.0)
    return product_inputs(bounds, out // 4, seed=20), bounds


def continent_product(card_name: str, tmp: str) -> str:
    """Phase 20: ``DeepBedMap.predict_continent`` writing the int16 LZW
    GeoTIFF, buffered (``save_continent_dem``) and streamed (writer thread,
    overviews, PREDICTOR=2), on a 3 x 3-tile region, with the seeded
    generator at ``PRODUCT_INIT_SCALE``. Returns the streamed product's path."""
    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.data import _tiffnative, geotiff
    from deepbedmap_tpu_torch.inference import (TilePlan, predict_continent,
                                                predict_continent_to_geotiff,
                                                save_continent_dem)
    from deepbedmap_tpu_torch.ops import _kernels

    res_m, tpd = 250.0, TILES_PER_DISPATCH
    out = PRODUCT_TILES * TILE_OUT
    inputs, bounds = product_region()
    plan = TilePlan(out_h=out, out_w=out, tile_out=TILE_OUT, halo_lr=HALO_LR)
    forwards = plan.grid[0] * -(-plan.grid[1] // tpd)
    log(f"  region {out}^2 output ({plan.grid[0]} x {plan.grid[1]} tiles, {forwards} "
        "forwards), inputs " + ", ".join(
            f"{k} {v.shape} {float(v.min()):.1f}..{float(v.max()):.1f}"
            for k, v in inputs.items())
        + f", W1 below zero {float((inputs['W1'] < 0).mean()):.3f}")
    dbm = DeepBedMap(cfg=GeneratorConfig(init_scale=PRODUCT_INIT_SCALE), device=DEVICE)
    kw = dict(tile_out=TILE_OUT, halo_lr=HALO_LR, tiles_per_dispatch=tpd)
    buffered, streamed = f"{tmp}/buffered", f"{tmp}/streamed"
    stream_kw = dict(stream_product=True, overviews=PRODUCT_OVERVIEWS, predictor=True)

    _kernels.reset_launches()
    raster = dbm.predict_continent(inputs, bounds, outfilepath=buffered, **kw)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    log(f"  launches in the buffered product ({forwards} forwards): {launches}")
    check_launches(launches, _expected_launches(forwards))
    canvas = raster.data
    if canvas.shape != (out, out) or not np.isfinite(canvas).all():
        raise AssertionError(f"bad continent canvas {canvas.shape}")
    if not np.abs(canvas).max() < 32000:
        raise AssertionError(f"canvas {canvas.min()}..{canvas.max()} m: beyond int16")
    want = np.where(np.isfinite(canvas), canvas, -2000.0).astype(np.int16)
    a, meta = geotiff.read_geotiff(buffered + ".tif")
    if not np.array_equal(a, want):
        raise AssertionError("the buffered product differs from the int16 canvas")
    with open(buffered + ".tif", "rb") as f:
        _, tags = geotiff._read_ifd_tags(f, 0)
    if (geotiff._T_TILE_OFFSETS not in tags or meta["nodata"] != -2000.0
            or meta["crs_epsg"] != 3031 or meta["res"] != res_m
            or (meta["left"], meta["top"]) != (bounds[0], bounds[3])):
        raise AssertionError(f"buffered product: tiled {geotiff._T_TILE_OFFSETS in tags}, "
                             f"meta {meta}")
    distinct = len(np.unique(a))
    if distinct < 10:
        raise AssertionError(f"the int16 product holds {distinct} values: the check is void")
    log(f"  buffered product {a.shape} int16: equal to the canvas bit for bit, tiled, "
        f"{meta}; values {int(a.min())}..{int(a.max())} m ({distinct} distinct), mean "
        f"|step| between neighbours {float(np.abs(np.diff(a.astype(np.float32))).mean()):.1f} m")

    _kernels.reset_launches()
    if dbm.predict_continent(inputs, bounds, outfilepath=streamed, **stream_kw, **kw) \
            is not None:
        raise AssertionError("the streamed product returned a canvas")
    launches = dict(_kernels.launches)
    log(f"  launches in the streamed product ({forwards} forwards): {launches}")
    check_launches(launches, _expected_launches(forwards))
    b, _ = geotiff.read_geotiff(streamed + ".tif")
    if not np.array_equal(b, a):
        raise AssertionError("the streamed product's page 0 differs from the buffered one")
    rps = TILE_OUT // 8  # predict_continent_to_geotiff's default strip height

    def host_writer(path, **opts):
        """The product's writer fed the canvas in the band loop's strips on
        this thread; returns the wall time in s of each band's
        ``write_strip`` and of ``close``."""
        marks = [time.perf_counter()]
        w = geotiff.GeoTiffStripWriter(
            path, out, out, left=bounds[0], top=bounds[3], res=res_m, dtype=np.int16,
            nodata=-2000.0, compress=True, rows_per_strip=rps, **opts)
        for r0 in range(0, out, TILE_OUT):
            w.write_strip(canvas[r0 : r0 + TILE_OUT])
            marks.append(time.perf_counter())
        w.close()
        marks.append(time.perf_counter())
        return np.diff(marks)

    writer_s = {"overviews 2, predictor": host_writer(
        f"{tmp}/host.tif", overviews=PRODUCT_OVERVIEWS, predictor=True)}
    with open(streamed + ".tif", "rb") as f, open(f"{tmp}/host.tif", "rb") as g:
        if f.read() != g.read():
            raise AssertionError("the streamed product differs from the host writer's bytes")
    # page L is the mean of 2^L x 2^L blocks of the float strips the writer
    # was fed, summed in the writer's order (2 x 2 sums of 2 x 2 sums)
    s = canvas.astype(np.float64)
    for level in range(1, PRODUCT_OVERVIEWS + 1):
        s = s[0::2] + s[1::2]
        s = s[:, 0::2] + s[:, 1::2]
        page, meta_l = geotiff.read_geotiff(streamed + ".tif", page=level)
        if not np.array_equal(page, np.rint(s / 4 ** level).astype(np.int16)):
            raise AssertionError(f"overview page {level} is not the block mean")
        if meta_l["res"] != res_m * 2 ** level:
            raise AssertionError(f"overview page {level}: res {meta_l['res']}")
    log(f"  streamed product: page 0 equal to the buffered product, the file equal byte "
        f"for byte to GeoTiffStripWriter fed the canvas in {TILE_OUT}-row strips "
        f"(rows_per_strip {rps}, overviews {PRODUCT_OVERVIEWS}, predictor), pages "
        f"1..{PRODUCT_OVERVIEWS} the {2}^L block means")

    strip = geotiff._hdiff(want[TILE_OUT : TILE_OUT + CODEC_ROWS]).tobytes()
    native, plain = _tiffnative.lzw_encode(strip), geotiff._lzw_encode_py(strip)
    if native != plain or _tiffnative.lzw_decode(plain) != strip \
            or geotiff._lzw_decode_py(native) != strip:
        raise AssertionError("the native LZW differs from the pure-Python codec")
    so_dir = str(_tiffnative._build_dir().resolve())
    if not (_tiffnative.path and _tiffnative.path.startswith(so_dir)
            and os.path.exists(_tiffnative.path)):
        raise AssertionError(f"native codec {_tiffnative.path} not from {so_dir}")
    log(f"  native LZW on {CODEC_ROWS} rows of the interior band ({len(strip)} B -> "
        f"{len(native)} B) equal to the pure-Python codec, both round trips exact; "
        f"loaded {_tiffnative.path}")

    # the warm products by the functions DeepBedMap.predict_continent calls
    # (it adds a transposed view of the inputs and the plan), with a progress
    # mark when the band loop hands on its last band: the split says whether
    # the streamed path's time goes to the loop (the writer thread slowing
    # the launches) or to what is left after it (the last band's encode,
    # the overview pages, the buffered path's save_continent_dem)
    fwd = dbm.forward_fn()
    host = {k: v.transpose(0, 2, 3, 1) for k, v in inputs.items()}
    variants = {"buffered": None, "streamed, no overviews or predictor": {},
                "streamed": {"overviews": PRODUCT_OVERVIEWS, "predictor": True}}

    def product(opts):
        marks = []
        path = f"{tmp}/timed"
        t0 = time.perf_counter()
        if opts is None:
            c = predict_continent(fwd, host, plan, progress=lambda *_: marks.append(
                time.perf_counter()), tiles_per_dispatch=tpd, device=DEVICE)
            save_continent_dem(c, bounds, path)
        else:
            predict_continent_to_geotiff(fwd, host, plan, bounds, path, progress=lambda *_:
                                         marks.append(time.perf_counter()),
                                         tiles_per_dispatch=tpd, device=DEVICE, **opts)
        t1 = time.perf_counter()
        return t1 - t0, marks[-1] - t0, t1 - marks[-1]

    times = {name: [] for name in variants}
    for _ in range(PRODUCT_REPS):  # interleaved
        for name, opts in variants.items():
            times[name].append(product(opts))
    for name, ts in times.items():
        log(f"  warm {name} product: " + ", ".join(f"{t[0] / plan.num_tiles:.4f}" for t in ts)
            + f" s/tile ({plan.num_tiles} tiles); band loop " + ", ".join(
                f"{t[1]:.3f}" for t in ts) + " s, after it " + ", ".join(
                f"{t[2]:.3f}" for t in ts) + f" s  [{card_name}]")
    writer_s["no overviews or predictor"] = host_writer(f"{tmp}/host_plain.tif")
    for opts, t in writer_s.items():
        log(f"  GeoTiffStripWriter alone on this thread, {opts}: {t.sum():.3f} s = "
            + " + ".join(f"{v:.3f}" for v in t[:-1]) + f" (each band's write_strip) + "
            f"{t[-1]:.3f} (close)  [{card_name}]")
    t0 = time.perf_counter()
    save_continent_dem(canvas, bounds, f"{tmp}/saved")
    save_s = time.perf_counter() - t0
    log(f"  save_continent_dem {out}^2: {save_s:.3f} s  [{card_name}]")
    log(f"  sizes: buffered {_mb(buffered + '.tif'):.2f} MB, streamed "
        f"{_mb(streamed + '.tif'):.2f} MB (with {PRODUCT_OVERVIEWS} overviews, "
        f"predictor), streamed without them {_mb(f'{tmp}/host_plain.tif'):.2f} MB, raw "
        f"int16 {want.nbytes / 1e6:.2f} MB")
    band = geotiff._hdiff(want[TILE_OUT : 2 * TILE_OUT]).tobytes()
    t0 = time.perf_counter()
    _tiffnative.lzw_encode(band)
    one_s = time.perf_counter() - t0
    blocks = [geotiff._hdiff(want[r : r + rps]).tobytes() for r in range(0, out, rps)]
    t0 = time.perf_counter()
    _tiffnative.lzw_encode_blocks(blocks)
    all_s = time.perf_counter() - t0
    log(f"  native LZW encode on this host ({os.cpu_count()} cores), predictor "
        f"applied: one thread {len(band) / 1e6 / one_s:.1f} MB/s (one band), all "
        f"threads {want.nbytes / 1e6 / all_s:.1f} MB/s ({len(blocks)} strips)  "
        f"[{card_name}]")
    return streamed + ".tif"


def _post(base: str, path: str, payload: dict):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_ok(base: str, path: str, payload: dict) -> dict:
    status, body = _post(base, path, payload)
    if status != 200:
        raise AssertionError(f"{path} answered {status}: {body}")
    return body


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def cli_predict(card_name: str, params, rasters: dict, window, want: np.ndarray,
                tmp: str) -> None:
    """Phase 21: ``python -m deepbedmap_tpu_torch predict`` in a process of
    its own, on phase 6's weights (an npz) and phase 19's rasters (GeoTIFF
    files), must give ``want`` (``dbm.predict`` in this process, TF32 off)
    bit for bit. The new process starts with PyTorch's defaults, cuDNN's
    convs in TF32, so this holds only if the CLI turns TF32 off; the same
    predict with TF32 on shows how far apart the two would be."""
    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.bridge import state_dict_to_jax_params
    from deepbedmap_tpu_torch.data import geotiff
    from deepbedmap_tpu_torch.train.checkpoint import export_generator_npz

    dbm = DeepBedMap(params, device=DEVICE)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = dbm.predict(tuple(window), rasters).data
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    npz = f"{tmp}/cli_weights.npz"
    export_generator_npz(state_dict_to_jax_params(params), npz)
    argv = [sys.executable, "-m", "deepbedmap_tpu_torch", "predict", "--npz", npz,
            "--device", DEVICE,
            "--bounds=" + ",".join(repr(float(v)) for v in window), "-o", f"{tmp}/cli.tif"]
    for name, r in rasters.items():
        path = f"{tmp}/{name}.tif"
        geotiff.write_geotiff(path, r.data, r.left, r.top, r.res, compress=True)
        argv += [CLI_FLAGS[name], path]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI's predict failed ({proc.returncode}):\n"
                             + proc.stdout[-4000:] + proc.stderr[-4000:])
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    got = geotiff.read_geotiff(f"{tmp}/cli.tif")[0]
    if res["shape"] != list(want.shape) or not np.array_equal(got, want):
        raise AssertionError(f"the CLI's predict {res} differs from dbm.predict")
    log(f"  CLI predict in a new process (GeoTIFF rasters and out): equal to "
        f"dbm.predict bit for bit; with TF32 on, dbm.predict would differ by up to "
        f"{float(np.abs(tf32 - want).max()):.3e} m (range {float(np.ptp(want)):.3e}); "
        f"{wall:.1f} s wall, process start and library loads included  [{card_name}]")


def serving(card_name: str, params, rasters: dict, window, product: str, tmp: str) -> None:
    """Phase 21: ``serve.make_server`` on 127.0.0.1 with phase 19's rasters
    preloaded (the card's machine has no h5py), answering /healthz,
    /predict (alone, four at once, bucketed), /dem on phase 20's product and
    /evaluate, each held against the library call it wraps."""
    import threading
    import urllib.request

    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.data import geotiff
    from deepbedmap_tpu_torch.data.raster import Raster
    from deepbedmap_tpu_torch.evalx.track import grdtrack
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops.interp import as_f32
    from deepbedmap_tpu_torch.serve import make_server

    dbm = DeepBedMap(params, device=DEVICE)
    names = {k: k for k in rasters}
    servers = []

    def start(**kw):
        srv = make_server(dbm, raster_cache=rasters, data_root=tmp, **kw)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        servers.append((srv, thread))
        return f"http://127.0.0.1:{srv.server_port}"

    def decode(name):
        return geotiff.read_geotiff(f"{tmp}/{name}")[0]

    try:
        base = start()
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health.get("status") != "ok" or health["model"]["num_residual_blocks"] != 12:
            raise AssertionError(f"/healthz: {health}")
        log(f"  /healthz: {health}")

        predict = {"bounds": list(window), "rasters": names, "format": "geotiff"}
        _kernels.reset_launches()
        body = _post_ok(base, "/predict", {**predict, "out": "p.tif"})
        torch.cuda.synchronize()
        launches = dict(_kernels.launches)
        log(f"  launches in one /predict: {launches}")
        check_launches(launches, _expected_launches(1))
        one = decode("p.tif")
        direct = dbm.predict(tuple(window), rasters)
        if not np.array_equal(one, direct.data):
            raise AssertionError("/predict differs from dbm.predict")
        log(f"  /predict {body['shape']}: equal to dbm.predict bit for bit")
        cli_predict(card_name, params, rasters, window, direct.data, tmp)

        results = [None] * SERVE_CONCURRENT

        def request(i):
            results[i] = _post(base, "/predict", {**predict, "out": f"p{i}.tif"})

        _kernels.reset_launches()
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(SERVE_CONCURRENT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        launches = dict(_kernels.launches)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a concurrent /predict did not finish")
        check_launches(launches, _expected_launches(SERVE_CONCURRENT))
        for i, (status, body) in enumerate(results):
            if status != 200 or not np.array_equal(decode(f"p{i}.tif"), one):
                raise AssertionError(f"concurrent /predict {i}: {status} {body}")
        log(f"  {SERVE_CONCURRENT} concurrent /predict: each equal to the single one bit "
            f"for bit; launches {launches}")

        bucketed_base = start(bucket_px=SERVE_BUCKET_PX)
        xmin, ymax = window[0], window[3]
        side = 1e3 * SERVE_BUCKET_KM
        small = (xmin, ymax - side, xmin + side, ymax)
        body = _post_ok(bucketed_base, "/predict",
                        {**predict, "bounds": list(small), "out": "b.tif"})
        px = int(round(side / dbm.resolution))
        big_px = SERVE_BUCKET_PX
        while big_px < px:
            big_px *= 2
        big = dbm.predict((xmin, ymax - big_px * dbm.resolution,
                           xmin + big_px * dbm.resolution, ymax), rasters)
        if body["shape"] != [px, px] or not np.array_equal(decode("b.tif"),
                                                           big.data[:px, :px]):
            raise AssertionError(f"bucketed /predict {body}: differs from dbm.predict "
                                 f"on the {big_px}-px window, sliced back")
        log(f"  /predict with bucket_px {SERVE_BUCKET_PX}, {px} px: equal to dbm.predict "
            f"on the {big_px}-px window sliced back, bit for bit")

        info = geotiff.read_geotiff_meta(product)
        name = os.path.relpath(product, tmp)
        for page in (0, 1):
            full = geotiff.read_geotiff(product, page=page)[0]
            res = info["res"] * 2 ** page
            r0, c0 = (v // 2 ** page for v in SERVE_CROP_AT)
            n = SERVE_CROP_PX // 2 ** page
            crop = [info["left"] + c0 * res, info["top"] - (r0 + n) * res,
                    info["left"] + (c0 + n) * res, info["top"] - r0 * res]
            body = _post_ok(base, "/dem", {"product": name, "bounds": crop, "page": page,
                                           "out": f"crop{page}.tif", "format": "geotiff"})
            if not np.array_equal(decode(f"crop{page}.tif"), full[r0 : r0 + n, c0 : c0 + n]):
                raise AssertionError(f"/dem page {page} differs from the product's crop")
            log(f"  /dem page {page} {body['shape']} at {res:g} m: equal to the product's "
                f"crop; stats {body['stats']}")

        dem = Raster(one, left=window[0], top=window[3], res=dbm.resolution)
        rs = np.random.RandomState(21)
        tx = rs.uniform(window[0] + 1000.0, window[2] - 1000.0, SERVE_TRACK_POINTS)
        ty = rs.uniform(window[1] + 1000.0, window[3] - 1000.0, SERVE_TRACK_POINTS)
        tz = grdtrack(as_f32(one, DEVICE), as_f32(tx, DEVICE), as_f32(ty, DEVICE),
                      dem.left, dem.top, dem.res).cpu().numpy()
        tz = tz + rs.randn(SERVE_TRACK_POINTS) * TRACK_NOISE_M
        np.savetxt(f"{tmp}/track.csv", np.column_stack([tx, ty, tz]), delimiter=",",
                   header="x,y,z", comments="", fmt="%.17g")
        evaluate = {"dem": "p.tif", "track": "track.csv"}
        body = _post_ok(base, "/evaluate", evaluate)
        want = dbm.track_rmse(dem, tx, ty, tz)
        if body["rmse_m"] != want or body["points"] != SERVE_TRACK_POINTS:
            raise AssertionError(f"/evaluate {body} vs dbm.track_rmse {want!r}")
        log(f"  /evaluate on {SERVE_TRACK_POINTS} points: rmse {body['rmse_m']!r} m, equal "
            "to dbm.track_rmse")

        r0, c0 = SERVE_CROP_AT
        crop0 = {"product": name, "rows": [r0, r0 + SERVE_CROP_PX],
                 "cols": [c0, c0 + SERVE_CROP_PX]}
        def predict_in_a_new_thread():
            # what the server adds to dbm.predict besides HTTP and JSON: each
            # request runs on a thread of its own
            t = threading.Thread(target=dbm.predict, args=(tuple(window), rasters))
            t.start()
            t.join()

        lat = {
            "dbm.predict (direct)": lambda: dbm.predict(tuple(window), rasters),
            "dbm.predict on a new thread per call": predict_in_a_new_thread,
            "/predict (no output file)": lambda: _post_ok(base, "/predict", predict),
            "/predict (GeoTIFF out)": lambda: _post_ok(base, "/predict",
                                                       {**predict, "out": "p.tif"}),
            f"/dem {SERVE_CROP_PX}^2 crop": lambda: _post_ok(base, "/dem", crop0),
            f"/evaluate {SERVE_TRACK_POINTS} points": lambda: _post_ok(base, "/evaluate",
                                                                       evaluate),
        }
        for label, fn in lat.items():
            log(f"  {label}: median {_median_ms(fn, SERVE_REPS):.2f} ms of {SERVE_REPS} "
                f"warm  [{card_name}]")
    finally:
        for srv, thread in servers:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)


# phase 22: training. The reference's tiles (X 11^2, W1 110^2, W2 22^2, W3
# 11^2, Y 36^2) and batch; 3826 tiles give its 95/5 split of 3634 / 192,
# 28 train batches of 128 and one dev batch
TRAIN_TILES, TRAIN_BATCH, TRAIN_EPOCHS = 3826, 128, 2
TRAIN_EMA = 0.999  # fit keeps EMA weights, so the checkpoint check reads them
STEP_BATCH = 16  # the 12-RRDB step, card vs CPU
CONFIG_STEP_BLOCKS, CONFIG_STEP_BATCH = 2, 8  # kernel / banded / sweep steps
TIMED_STEPS = 10  # warm steps timed one by one after fit
# card vs CPU steps (see step_card_vs_cpu): the CPU's own change under a
# relative perturbation of the weights of PERTURB, NOISE_K times, bounds what
# fp32 round-off can move an ill-conditioned gradient
PERTURB, NOISE_K = 1e-5, 3
# gradients of a whole step, card vs CPU: cuDNN's fp32 conv backward (TF32
# off) is off the float64 gradient by up to 5e-4 of the range on the most
# cancelling weight gradients (deep dense-block convs, |g| ~ 1e-11), where
# the CPU's is off by 4e-7 and the card's with cuDNN disabled by 3.7e-7 (H100,
# a 12-RRDB step at batch 16, PERF.md); a misrouted or missing gradient is
# off by its whole range
TOL_STEP_GRAD = 1e-3
# the kernels at a batch-128 training step's shapes: K1 on the 9^2 latent,
# K2 on the 36^2 output's 64 channels, K3 on its nine tap fields
TRAIN_RDB, TRAIN_TAIL = (TRAIN_BATCH, 9, 9, 64), (TRAIN_BATCH, 36, 36, 64)
GRAD_TAIL = (2, 37, 45, 64)  # K7, K8, K10's small ragged case


def _kernel_launched(name: str, before: int) -> None:
    from deepbedmap_tpu_torch.ops import _kernels

    if _kernels.launches[name] <= before:
        raise AssertionError(f"{name} was not launched by its gradient check")


def check_grad(label: str, name: str, fn, plain, inputs, gen, timed: bool = False,
               bwd: str = None, plain_takes_out: bool = False) -> dict:
    """Phase 22: ``fn`` (a kernel wrapper) against ``plain`` on the card:
    output and the gradient of every input, each within ``TOL_KERNEL`` of
    its range, with one seeded upstream gradient. ``bwd``: the backward
    kernel that the gradient must launch (the tail's); without it the
    backward is autograd of the plain twin recomputed. ``plain_takes_out``:
    ``plain`` also takes the kernel's output, as ``out=``. ``timed``: the
    kernel route's forward and its
    backward by CUDA events, and for a backward kernel also the route it
    replaced, the plain version recomputed under autograd and differentiated
    (``twin_bwd_ms``)."""
    import torch

    from deepbedmap_tpu_torch.ops import _kernels

    before = _kernels.launches[name]
    bwd_before = _kernels.launches[bwd] if bwd else 0
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    _kernel_launched(name, before)
    if out.grad_fn is None:
        raise AssertionError(f"{label}: the kernel's output has no autograd history")
    if bwd and "PlainTwin" in type(out.grad_fn).__name__:
        raise AssertionError(f"{label}: the gradient recomputes the plain version")
    up = _randn(tuple(out.shape), gen)
    got = torch.autograd.grad(out, leaves, up)
    if bwd:
        _kernel_launched(bwd, bwd_before)
    ref_leaves = [t.detach().clone().requires_grad_() for t in inputs]
    call = functools.partial(plain, out=out.detach()) if plain_takes_out else plain
    ref = call(*ref_leaves)
    want = torch.autograd.grad(ref, ref_leaves, up)
    torch.cuda.synchronize()
    shape = tuple(inputs[0].shape)
    err = compare(f"{label} {shape} output", out.detach(), ref.detach(), TOL_KERNEL)
    for i, (g, w) in enumerate(zip(got, want)):
        err = max(err, compare(f"{label} {shape} gradient of input {i}", g, w, TOL_KERNEL))
    res = {"max_abs_err": err}
    if timed:
        res["fwd_ms"] = time_ms(lambda: fn(*leaves), 5)

        def fwd_bwd():
            torch.autograd.grad(fn(*leaves), leaves, up)
        res["fwd_bwd_ms"] = time_ms(fwd_bwd, 5)
        res["bwd_ms"] = res["fwd_bwd_ms"] - res["fwd_ms"]
        if bwd:
            res["twin_bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(call(*ref_leaves), ref_leaves, up), 5)
    return res


def _lrelu_as_kernel(y, out):
    """LeakyReLU of the plain pre-activation ``y`` on the branch K2's output
    ``out`` took. K2's 3xTF32 forward and the plain fp32 one round a few
    pre-activations within ~1e-7 of zero to opposite signs at a training
    step's 10^7 outputs; K2's backward kernel follows its own forward's
    sign, so its reference does too (``tests/test_torch_port_tail_backward.py``
    checks the branches agree outside that band)."""
    import torch

    return torch.where(out >= 0, y, 0.2 * y)


def _rdb_params(gen, blocks: int):
    f, g = 64, 32
    cins, couts = [f + g * j for j in range(5)], [g, g, g, g, f]
    ks, bs = [], []
    for _ in range(blocks):
        ks += [_randn((co, ci, 3, 3), gen, 0.05) for ci, co in zip(cins, couts)]
        bs += [_randn((co,), gen, 0.1) for co in couts]
    return ks, bs


def grad_checks(card_name: str) -> dict:
    """Phase 22, part 1: every kernel wrapper of a generator path against
    autograd of its plain version on the card; K9 refuses a gradient."""
    import torch

    from deepbedmap_tpu_torch.ops import rdb
    from deepbedmap_tpu_torch.ops import tail
    from deepbedmap_tpu_torch.ops.conv3x3 import conv3x3_fused, conv3x3_reference
    from deepbedmap_tpu_torch.ops.deform_conv import (
        deform_conv2d,
        deform_conv2d_zform,
        deform_conv_shifts,
        deform_conv_shifts_zproj,
        sample_tap_fields,
    )

    gen = torch.Generator().manual_seed(22)
    res = {}

    def dense(kernel, blocks):
        def call(fn):
            def run(x, *p):
                ks, bs = p[: 5 * blocks], p[5 * blocks:]
                if blocks == 3:
                    ks, bs = [ks[i:i + 5] for i in (0, 5, 10)], [bs[i:i + 5] for i in (0, 5, 10)]
                return fn(x, ks, bs, 0.1)
            return run
        plain = rdb.rdb_reference if blocks == 1 else rdb.rrdb_reference
        return call(getattr(rdb, kernel)), call(plain)

    for label, name, kernel, blocks in (
        ("K1 rdb_fused", "rdb_forward", "rdb_fused", 1),
        ("K4 rrdb_fused", "rrdb_forward", "rrdb_fused", 3),
        ("K5 rrdb_sweep", "rrdb_sweep_forward", "rrdb_sweep", 3),
        ("K6 rdb_banded", "rdb_banded_forward", "rdb_banded", 1),
    ):
        fn, plain = dense(kernel, blocks)
        ks, bs = _rdb_params(gen, blocks)
        res[name] = check_grad(label, name, fn, plain, [_randn(RAGGED_RDB, gen), *ks, *bs],
                               gen)
    n, h, w, c = GRAD_TAIL
    x, off = _randn(GRAD_TAIL, gen), _offsets((n, h, w, 18), gen)
    w64, b64 = _randn((64, 64, 3, 3), gen, 0.05), _randn((64,), gen, 0.1)
    w1, b1 = _randn((1, 64, 3, 3), gen, 0.05), _randn((1,), gen, 0.1)
    res["deform_conv"] = check_grad(
        "K7 deform_conv2d(method='pallas')", "deform_conv",
        lambda *a: deform_conv2d(*a, method="pallas"),
        lambda *a: deform_conv_shifts(*a, 1, 2), [x, off, w64, b64], gen,
        bwd="deform_conv_bwd")
    res["deform_conv_zproj1"] = check_grad(
        "K8 deform_conv2d(method='pallas'), one output", "deform_conv_zproj1",
        lambda *a: deform_conv2d(*a, method="pallas"),
        lambda *a: deform_conv_shifts_zproj(*a, 1, 2), [x, off, w1, b1], gen,
        bwd="deform_conv_zproj1_bwd")
    res["conv3x3_forward"] = check_grad(
        "K10 conv3x3_fused (residual, LeakyReLU)", "conv3x3_forward",
        lambda x, w_, b_, r: conv3x3_fused(x, w_, b_, True, r),
        lambda x, w_, b_, r: conv3x3_reference(x, w_, b_, True, r),
        [x, w64, b64, _randn(GRAD_TAIL, gen)], gen)

    # at a batch-128 training step's shapes, timed
    fn, plain = dense("rdb_fused", 1)
    ks, bs = _rdb_params(gen, 1)
    res["rdb_forward_train"] = check_grad("K1 rdb_fused", "rdb_forward", fn, plain,
                                          [_randn(TRAIN_RDB, gen), *ks, *bs], gen, True)
    n, h, w, c = TRAIN_TAIL
    x, off = _randn(TRAIN_TAIL, gen), _offsets((n, h, w, 18), gen)
    res["deform64_lrelu_train"] = check_grad(
        "K2 deform64_lrelu", "deform64_lrelu",
        lambda *a: tail.deform64_lrelu(*a, 2),
        lambda *a, out: _lrelu_as_kernel(deform_conv_shifts(*a, 1, 2), out),
        [x, off, w64, b64], gen, True, bwd="deform64_bwd", plain_takes_out=True)
    res["deform_zproj1_train"] = check_grad(
        "K3 deform_zproj1", "deform_zproj1",
        lambda z, o, b_: tail.deform_zproj1(z, o, b_, 2),
        lambda z, o, b_: sample_tap_fields(z[..., None], o, b_, 1, 2),
        [_randn((n, h, w, 9), gen), off, b1], gen, True, bwd="deform_zproj1_bwd")
    r = res["rdb_forward_train"]
    log(f"  rdb_forward_train: forward {r['fwd_ms']:.3f} ms, backward (plain recompute + "
        f"autograd) {r['bwd_ms']:.3f} ms  [{card_name}]")
    for key in ("deform64_lrelu_train", "deform_zproj1_train"):
        r = res[key]
        log(f"  {key}: forward {r['fwd_ms']:.3f} ms, backward kernel {r['bwd_ms']:.3f} ms, "
            f"the plain recompute + autograd it replaced {r['twin_bwd_ms']:.3f} ms  "
            f"[{card_name}]")

    zx = _randn((1, 9, 13, 8), gen).requires_grad_()
    try:
        deform_conv2d_zform(zx, _offsets((1, 9, 13, 18), gen), _randn((16, 8, 3, 3), gen),
                            None)
    except ValueError as e:
        log(f"  K9 deform_conv2d_zform refuses a gradient, as JAX's has no VJP: {e}")
    else:
        raise AssertionError("K9 deform_conv2d_zform gave a gradient path")
    return res


def train_batch(n: int, seed: int) -> dict:
    """Seeded reference-shaped tiles, NHWC numpy (TileDataset.synthetic's)."""
    from deepbedmap_tpu_torch.data.dataset import REFERENCE_SHAPES_NCHW

    rs = np.random.RandomState(seed)
    return {k: rs.rand(n, *s).astype(np.float32).transpose(0, 2, 3, 1).copy()
            for k, s in REFERENCE_SHAPES_NCHW.items()}


# the tail kernels' backward kernels, by the forward's name
TAIL_BWD = {"deform64_lrelu": "deform64_bwd", "deform_conv": "deform_conv_bwd",
            "deform_zproj1": "deform_zproj1_bwd",
            "deform_conv_zproj1": "deform_conv_zproj1_bwd"}


def per_step(config: str, blocks: int) -> dict:
    """Kernel launches of one train step: two generator forwards (the D
    update's, with no gradient, and the G update's) and the G update's
    backward, which launches each tail kernel's backward kernel once
    (``TAIL_BWD``) and recomputes the other kernels' plain versions."""
    scale = {"rdb_forward": blocks / 12, "rdb_banded_forward": blocks / 12,
             "rrdb_forward": blocks / 12, "rrdb_sweep_forward": blocks / 12}
    out = {k: int(2 * v * scale.get(k, 1)) for k, v in PER_FORWARD[config].items()}
    out.update({TAIL_BWD[k]: v for k, v in PER_FORWARD[config].items() if k in TAIL_BWD})
    return out


def _step_tensors(state, b1: float) -> dict:
    """Every parameter's gradient (Adam's first moment after one step is
    (1 - b1) g), Adam's moments, the parameter, and D's BatchNorm statistics,
    in float64 on the host, by ``G.`` / ``D.`` name."""
    out = {}
    for tag, model, opt in (("G.", state.g, state.g_opt), ("D.", state.d, state.d_opt)):
        for name, p in model.named_parameters():
            st = opt.state[p]
            out[tag + name] = {"grad": st["exp_avg"].cpu().double() / (1 - b1),
                               "m": st["exp_avg"].cpu().double(),
                               "v": st["exp_avg_sq"].cpu().double(),
                               "param": p.detach().cpu().double()}
    for name, v in state.d.named_buffers():
        out["D." + name] = {"stat": v.cpu().double()}
    return out


def hold_step(tag: str, got: dict, want: dict, other: dict, metrics, init: dict, t_cfg,
              who: str = "card", ref: str = "the CPU", floors=None,
              noise: str = f"a {PERTURB:g} perturbation of the weights"):
    """Phase 22's contract for one train step ``got`` against ``want`` (both
    ``_step_tensors``; ``other``: ``want``'s step from perturbed weights;
    ``metrics``: the three steps' metrics; ``init``: the weights before the
    step): each metric and BatchNorm statistic within the larger of
    ``TOL_KERNEL`` of its range and ``NOISE_K`` x the perturbation's change,
    gradients the same with ``TOL_STEP_GRAD``; every parameter of ``got``
    within 1e-3 * lr of Adam's update from its own moments where |g| is
    above 1e-3 of the tensor's largest. ``floors``: name -> an absolute
    tolerance below which a gradient or metric passes. ``noise`` names what
    ``other`` changed, for the log. Returns (worst ratios, the tensors
    beyond their relative tolerance)."""
    import torch

    b1, b2, eps = t_cfg.adam_beta1, t_cfg.adam_beta2, t_cfg.adam_eps
    m_got, m_want, m_other = metrics

    def held(label, got, want, other, rel_tol=TOL_KERNEL, atol=0.0) -> float:
        """|got - want| against max(rel_tol * range, NOISE_K * |other - want|,
        atol); returns the error over the range."""
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        floor = float((other - want).abs().max())
        tol = max(rel_tol * scale, NOISE_K * floor, atol)
        if not err <= tol:
            raise AssertionError(f"{tag} {label}: {who} off {ref} by {err:.3e}, above "
                                 f"{tol:.3e} (range {scale:.3e}, perturbation {floor:.3e})")
        return err / scale if scale > 0 else 0.0

    for name in ("discriminator_loss", "discriminator_accu", "generator_loss",
                 "generator_psnr", "generator_ssim"):
        held(name, getattr(m_got, name).cpu().double(), getattr(m_want, name).cpu().double(),
             getattr(m_other, name).cpu().double(), atol=(floors or {}).get(name, 0.0))
    worst = {"grad": (0.0, ""), "stats": (0.0, ""), "update": 0.0}
    floored = []
    for name, w in want.items():
        g, o = got[name], other[name]
        key = "stats" if "stat" in w else "grad"
        field = "stat" if key == "stats" else "grad"
        rel_tol = TOL_STEP_GRAD if key == "grad" else TOL_KERNEL
        rel = held(f"{field} {name}", g[field], w[field], o[field], rel_tol,
                   (floors or {}).get(name, 0.0))
        if rel > rel_tol:
            floored.append(name)
        if rel > worst[key][0]:
            worst[key] = (rel, name)
        if key == "grad":
            if name.startswith("G.") and not bool(g["grad"].abs().max() > 0):
                raise AssertionError(f"{tag}: generator parameter {name} got no gradient")
            lr = t_cfg.learning_rate * (t_cfg.d_lr_scale if name.startswith("D.") else 1.0)
            update = g["m"] / (1 - b1) / ((g["v"] / (1 - b2)).sqrt() + eps)
            big = g["grad"].abs() > 1e-3 * g["grad"].abs().max()
            diff = (g["param"] - (init[name] - lr * update)).abs()
            err = float(torch.where(big, diff, 0.0).max())
            if not err <= 1e-3 * lr:
                raise AssertionError(f"{tag}: {name} after the step is {err:.3e} off the "
                                     f"Adam update of its own gradient (lr {lr:g})")
            worst["update"] = max(worst["update"], err / lr)
    log(f"  {tag}: worst gradient {worst['grad'][0]:.2e} of its range ({worst['grad'][1]}), "
        f"worst BatchNorm statistic {worst['stats'][0]:.2e} ({worst['stats'][1]}); "
        f"{len(floored)} of {len(want)} tensors beyond {TOL_STEP_GRAD:g} (gradients) or "
        f"{TOL_KERNEL:g} (statistics) of their range, each within {NOISE_K} x {ref}'s own "
        f"change under {noise}: {floored}; every parameter "
        f"within {worst['update']:.2e} x lr of Adam's update from the {who}'s own moments")
    return worst, floored


def step_card_vs_cpu(card_name: str, config: str, blocks: int, batch: int) -> dict:
    """Phase 22, parts 2 and 3: one train step in ``config`` from the same
    seeded weights and tiles on the card and on the CPU, with its launch
    counts.

    At the seeded init the GAN step is ill-conditioned in fp32: the fake is
    ~1e-5 m and nearly constant, so D's train-mode BatchNorm over the fake
    batch divides differences of round-off size by ~sqrt(eps), and the
    offsets (~1e-5 px) straddle the sampler's floor at 0. A relative change
    of 1e-6 in the weights moves some of D's gradients by 1% on the CPU
    alone. So each gradient, metric and BatchNorm statistic is held to the
    larger of ``TOL_KERNEL`` of its range and ``NOISE_K`` times the change
    that a ``PERTURB`` relative perturbation of the weights makes on the CPU
    (the card's forward differs from the CPU's by ~2e-6 of the range,
    phase 5), per tensor; gradients to ``TOL_STEP_GRAD`` of their range in
    place of ``TOL_KERNEL`` (cuDNN's conv backward). A wiring fault, a
    missing or misrouted gradient, is off by its whole range. The update is checked on the card's own
    gradients: every parameter equals the initial weight minus lr times
    Adam's step from the card's moments, within 1e-3 * lr where |g| is
    above 1e-3 of the tensor's largest. Returns the card's launch counts
    and the worst ratios."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.train.state import create_gan_state
    from deepbedmap_tpu_torch.train.steps import make_train_step

    g_cfg = GeneratorConfig(num_residual_blocks=blocks, **CONFIGS[config])
    t_cfg = TrainConfig(batch_size=batch)
    b1 = t_cfg.adam_beta1
    arrays = train_batch(batch, seed=blocks)
    step = make_train_step(t_cfg)
    runs = {}
    for key, dev in (("cpu", "cpu"), ("perturbed", "cpu"), ("card", DEVICE)):
        state = create_gan_state(g_cfg, t_cfg=t_cfg, seed=0, device=dev)
        if key == "perturbed":
            gen = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in list(state.g.parameters()) + list(state.d.parameters()):
                    p.mul_(1 + PERTURB * torch.randn(p.shape, generator=gen))
        if key == "card":
            init = {f"{tag}{n}": p.detach().cpu().double()
                    for tag, model in (("G.", state.g), ("D.", state.d))
                    for n, p in model.named_parameters()}
        b = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        _kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[key] = (_step_tensors(state, b1), metrics, time.perf_counter() - t0)
    launches = {k: v for k, v in _kernels.launches.items() if v}
    (cpu, m_cpu, s_cpu), (pert, m_pert, _), (card, m_card, s_card) = (
        runs["cpu"], runs["perturbed"], runs["card"])
    tag = f"{config}, {blocks} RRDB, batch {batch}"
    log(f"  train step {tag}: card {s_card:.2f} s (cold), CPU {s_cpu:.2f} s; card launches "
        f"{launches}")
    check_launches(launches, {k: v for k, v in per_step(config, blocks).items() if v})

    worst, floored = hold_step(tag, card, cpu, pert, (m_card, m_cpu, m_pert), init, t_cfg)
    return {"launches": launches, "worst_grad": worst["grad"][0],
            "worst_stats": worst["stats"][0], "floored": floored}


def no_missing_gradient(card_name: str) -> None:
    """Phase 22: on the card, the generator loss's gradient reaches every
    generator parameter, none None and none all zero: the guard against
    kernel outputs without autograd history."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.train.state import create_gan_state
    from deepbedmap_tpu_torch.train.steps import make_g_loss_fn

    state = create_gan_state(GeneratorConfig(), t_cfg=TrainConfig(), seed=0, device=DEVICE)
    b = {k: torch.from_numpy(v).to(DEVICE) for k, v in train_batch(4, 7).items()}
    params = dict(state.g.named_parameters())
    loss, _ = make_g_loss_fn(state.g, state.d)(b)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    bad = [k for k, g in zip(params, grads) if g is None or not bool(g.abs().max() > 0)]
    if bad:
        raise AssertionError(f"generator parameters without a gradient on the card: {bad}")
    log(f"  all {len(params)} generator parameters get a nonzero gradient on the card")


def step_breakdown(state, batch, t_cfg, reps: int = 3) -> dict:
    """Device time of each stage of one train step (``train.steps``'
    sequence), by CUDA events; the steps are real (the state moves)."""
    import torch

    from deepbedmap_tpu_torch.config import LossConfig
    from deepbedmap_tpu_torch.train.state import learning_rate
    from deepbedmap_tpu_torch.train.steps import (
        apply_gradients,
        ema_update,
        make_d_loss_fn,
        make_g_loss_fn,
    )

    g, d = state.g, state.d
    loss_cfg = LossConfig()

    def stages():
        with torch.no_grad():
            fake = g(batch["X"], batch["W1"], batch["W2"], batch["W3"])
        yield "D update: G forward, no gradient (kernels)"
        d_params = list(d.parameters())
        d_loss, _ = make_d_loss_fn(d)(fake, batch["Y"])
        d_grads = torch.autograd.grad(d_loss, d_params)
        yield "D update: D forward x 2 (train mode) + backward"
        apply_gradients(state.d_opt, d_params, d_grads,
                        learning_rate(t_cfg, state.step, t_cfg.d_lr_scale))
        yield "Adam (D)"
        g_params = list(g.parameters())
        g_loss, _ = make_g_loss_fn(g, d, loss_cfg)(batch)
        yield "G update: G forward (kernels) + D eval forward + losses"
        g_grads = torch.autograd.grad(g_loss, g_params)
        yield "G update: G backward (the kernels' plain recomputes + autograd)"
        apply_gradients(state.g_opt, g_params, g_grads, learning_rate(t_cfg, state.step))
        yield "Adam (G)"
        ema_update(state.g_ema, g, t_cfg.ema_decay)
        state.step += 1
        yield "EMA"

    totals: dict = {}
    for _ in range(reps):
        prev = torch.cuda.Event(enable_timing=True)
        prev.record()
        marks = []
        for name in stages():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        torch.cuda.synchronize()
        for name, ev in marks:
            totals[name] = totals.get(name, 0.0) + prev.elapsed_time(ev) / reps
            prev = ev
    return totals


def _timed_steps(step, state, dataset, rs, steps: int) -> list:
    """Host time of each of ``steps`` train steps on shuffled batches, each
    ended by a synchronize."""
    import torch

    times = []
    for _ in range(steps):
        idx = rs.choice(len(dataset), TRAIN_BATCH, replace=False)
        batch = dataset.take(idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def training(card_name: str, rasters: dict, window, tmp: str) -> dict:
    """Phase 22: training on the card (its parts are listed in the module
    docstring). Returns the numbers of the training JSON line."""
    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.data import geotiff
    from deepbedmap_tpu_torch.data.dataset import TileDataset
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.train.checkpoint import save_checkpoint
    from deepbedmap_tpu_torch.train.loop import fit
    from deepbedmap_tpu_torch.train.state import create_gan_state
    from deepbedmap_tpu_torch.train.steps import make_train_step

    out = {"card": card_name}
    log("  gradient checks: each kernel wrapper against autograd of its plain version")
    grads = grad_checks(card_name)
    out["grad_max_abs_err"] = {k: v["max_abs_err"] for k, v in grads.items()}
    out["train_shape_ms"] = {k: {m: grads[k][m] for m in ("fwd_ms", "bwd_ms", "twin_bwd_ms")
                                 if m in grads[k]}
                             for k in grads if k.endswith("_train")}

    log(f"  one train step, 12 RRDBs, batch {STEP_BATCH}: card vs CPU")
    no_missing_gradient(card_name)
    steps = {"default": step_card_vs_cpu(card_name, "default", 12, STEP_BATCH)}
    for config in ("kernel", "banded", "sweep"):
        steps[config] = step_card_vs_cpu(card_name, config, CONFIG_STEP_BLOCKS,
                                         CONFIG_STEP_BATCH)
    out["launches_per_step"] = {k: v["launches"] for k, v in steps.items()}

    log(f"  fit: {TRAIN_TILES} synthetic tiles, 12 RRDBs, batch {TRAIN_BATCH}, "
        f"{TRAIN_EPOCHS} epochs, EMA {TRAIN_EMA}")
    t0 = time.perf_counter()
    dataset = TileDataset.synthetic(TRAIN_TILES, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    log(f"  dataset of {TRAIN_TILES} tiles on the card in {time.perf_counter() - t0:.2f} s")
    t_cfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, ema_decay=TRAIN_EMA)
    state = create_gan_state(GeneratorConfig(), t_cfg=t_cfg, seed=0, device=DEVICE)
    stamps = []

    def callback(epoch, record):
        stamps.append(time.perf_counter())
        return False

    _kernels.reset_launches()
    t0 = time.perf_counter()
    state, history = fit(state, dataset, t_cfg, callback=callback)
    launches = {k: v for k, v in _kernels.launches.items() if v}
    train_steps = TRAIN_EPOCHS * ((TRAIN_TILES * 95 // 100) // TRAIN_BATCH)
    dev_batches = TRAIN_EPOCHS  # one dev batch, evaluated after each epoch
    want = {"rdb_forward": 72 * train_steps + 36 * dev_batches,
            "deform64_lrelu": 2 * train_steps + dev_batches,
            "deform_zproj1": 2 * train_steps + dev_batches,
            "deform64_bwd": train_steps, "deform_zproj1_bwd": train_steps}
    log(f"  fit launches ({train_steps} steps, {dev_batches} dev batches): {launches}")
    check_launches(launches, want)
    for rec in history:
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"non-finite training metrics {rec}")
        log(f"  epoch {rec['epoch']}: " + ", ".join(f"{k} {v:.5g}" for k, v in rec.items()
                                                      if k != "epoch"))
    out["s_per_epoch_cold"] = stamps[0] - t0
    out["s_per_epoch_warm"] = stamps[1] - stamps[0]

    step = make_train_step(t_cfg)
    rs = np.random.RandomState(1)
    torch.cuda.reset_peak_memory_stats()
    times = _timed_steps(step, state, dataset, rs, TIMED_STEPS)
    out["ms_per_step_median"] = float(np.median(times))
    out["ms_per_step_all"] = times
    out["tiles_per_s"] = 1e3 * TRAIN_BATCH / out["ms_per_step_median"]
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    batch = dataset.take(rs.choice(len(dataset), TRAIN_BATCH, replace=False))
    out["breakdown_ms"] = step_breakdown(state, batch, t_cfg)
    log(f"  warm epoch {out['s_per_epoch_warm']:.2f} s (cold {out['s_per_epoch_cold']:.2f} s), "
        f"median step {out['ms_per_step_median']:.1f} ms of {TIMED_STEPS} "
        f"({out['tiles_per_s']:.0f} tiles/s), peak memory {out['peak_mem_gib']:.2f} GiB  "
        f"[{card_name}]")
    for name, ms in out["breakdown_ms"].items():
        log(f"  step at batch {TRAIN_BATCH}, {name}: {ms:.2f} ms  [{card_name}]")
    log(f"  step total: {sum(out['breakdown_ms'].values()):.2f} ms  [{card_name}]")

    log("  remat=True: the same steps with each RRDB recomputed in the backward")
    r_state = create_gan_state(GeneratorConfig(remat=True), t_cfg=t_cfg, seed=0, device=DEVICE)
    r_step = make_train_step(t_cfg)
    _timed_steps(r_step, r_state, dataset, rs, 1)
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    r_times = _timed_steps(r_step, r_state, dataset, rs, 5)
    r_launches = {k: v // 5 for k, v in _kernels.launches.items() if v}
    check_launches(r_launches, {"rdb_forward": 108, "deform64_lrelu": 2, "deform_zproj1": 2,
                                "deform64_bwd": 1, "deform_zproj1_bwd": 1})
    out["remat"] = {"launches_per_step": r_launches,
                    "ms_per_step_median": float(np.median(r_times)),
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  remat: launches per step {r_launches}, median step "
        f"{out['remat']['ms_per_step_median']:.1f} ms, peak memory "
        f"{out['remat']['peak_mem_gib']:.2f} GiB  [{card_name}]")

    log("  checkpoint: save_checkpoint, then DeepBedMap.from_checkpoint (EMA weights)")
    ck = f"{tmp}/train.ckpt"
    save_checkpoint(state, ck)
    xs = [batch[k] for k in ("X", "W1", "W2", "W3")]
    got = DeepBedMap.from_checkpoint(ck, state.g.cfg, device=DEVICE).forward_fn()(*xs)
    want_out = DeepBedMap({k: v.cpu() for k, v in state.g_ema.items()}, state.g.cfg,
                          device=DEVICE).forward_fn()(*xs)
    if not torch.equal(got, want_out):
        raise AssertionError("from_checkpoint's forward differs from the EMA weights'")
    log(f"  from_checkpoint forward equals the state's EMA weights' bit for bit "
        f"({os.path.getsize(ck) / 2**20:.1f} MB checkpoint)")

    log("  CLI: train in a new process, then predict --checkpoint on phase 19's rasters")
    cli_ck = f"{tmp}/cli_train.ckpt"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deepbedmap_tpu_torch", "train", "--synthetic-tiles", "64",
         "--epochs", "1", "--batch-size", "32", "--out", cli_ck, "--device", DEVICE],
        cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI's train failed ({proc.returncode}):\n"
                             + proc.stdout[-4000:] + proc.stderr[-4000:])
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if res["command"] != "train" or res["checkpoint"] != cli_ck or \
            not np.isfinite(res["final_g_loss"]):
        raise AssertionError(f"the CLI's train printed {res}")
    train_wall = time.perf_counter() - t0
    argv = [sys.executable, "-m", "deepbedmap_tpu_torch", "predict", "--checkpoint", cli_ck,
            "--device", DEVICE, "--bounds=" + ",".join(repr(float(v)) for v in window),
            "-o", f"{tmp}/cli_ck.tif"]
    for name, r in rasters.items():
        path = f"{tmp}/{name}.tif"
        geotiff.write_geotiff(path, r.data, r.left, r.top, r.res, compress=True)
        argv += [CLI_FLAGS[name], path]
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI's predict --checkpoint failed ({proc.returncode}):\n"
                             + proc.stdout[-4000:] + proc.stderr[-4000:])
    got = geotiff.read_geotiff(f"{tmp}/cli_ck.tif")[0]
    want_dem = DeepBedMap.from_checkpoint(cli_ck, device=DEVICE).predict(tuple(window),
                                                                        rasters).data
    if not np.array_equal(got, want_dem):
        raise AssertionError("predict --checkpoint differs from from_checkpoint().predict")
    log(f"  CLI train {res}, {train_wall:.1f} s wall; predict --checkpoint equal to "
        f"DeepBedMap.from_checkpoint(...).predict bit for bit  [{card_name}]")
    return out


# phase 23: the hyperparameter search. The reference's tiles, batch (2^7),
# depth and width, cut in count and epochs: 640 tiles split 608 / 32 at 95/5,
# 4 train batches of 128 and one dev batch of 32 per epoch; the reference
# space with num_epochs cut to SEARCH_EPOCHS; scored on phase 19's 286 km
# window with its 10^5 track points
SEARCH_TILES, SEARCH_EPOCHS, SEARCH_TRIALS = 640, 3, 2
SEARCH_PRUNER = dict(pruner="hyperband", min_resource=15, max_resource=150,
                     reduction_factor=3)  # the reference's (srgan_train.py:1740-1744)
# the evaluator card vs CPU (the CPU's plain deformable tail at 1144^2 would
# take minutes, so on phase 19's 48 km window), and a per-epoch RMSE against
# the same evaluation recomputed: the same float32 operations
TOL_SEARCH_RMSE = 1e-5
# the CLI's hpo against the same trial run in this process: --tiny at a seed
# whose trial draws batch 8 and 1 epoch. Two trainings of it on the card do
# not repeat bit for bit (which operation differs is not traced), and the
# GAN's steps amplify round-off, as phase 22's step check finds; so the value
# is held to the larger of TOL_CLI_HPO relative and NOISE_K times the larger
# of two changes in this process: the same trial run again, and run from
# initial weights perturbed by PERTURB. The same trial also runs
# LIBRARY_RUNS times in each of LIBRARY_PROCESSES new processes
# (``library_trials``), which the log sets beside the CLI's value: whether
# the trial differs between processes more than within one
CLI_HPO_SEED, CLI_HPO_TILES = 6, 160  # the first 160 tiles: 19 steps of 8
LIBRARY_PROCESSES, LIBRARY_RUNS = 2, 2
TOL_CLI_HPO = 1e-5
# one layer K7 / K8 do not take, through deform_conv2d(method='auto'):
# (N, H, W, C_in), C_out, kernel, padding
ODD_DEFORM = ((1, 40, 50, 32), 16, 5, 2)


class _CutEpochs:
    """A trial whose ``num_epochs`` is drawn from [SEARCH_EPOCHS,
    SEARCH_EPOCHS]; every other suggestion goes to the trial unchanged."""

    def __init__(self, trial):
        self._trial = trial

    def suggest_int(self, name, low, high, step=1):
        if name == "num_epochs":
            low = high = SEARCH_EPOCHS
        return self._trial.suggest_int(name, low, high, step)

    def __getattr__(self, name):
        return getattr(self._trial, name)


def search_space(trial) -> dict:
    """The reference's search space with num_epochs cut to SEARCH_EPOCHS."""
    from deepbedmap_tpu_torch.train.objective import suggest_reference_space

    return suggest_reference_space(_CutEpochs(trial))


def _search_launches(blocks: int, steps: int, evaluations: int) -> dict:
    """K1 / K2 / K3 launches of ``steps`` train steps (two generator
    forwards each, and K2's and K3's backward kernels once) and
    ``evaluations`` forwards at batch 1 or of a dev batch."""
    from deepbedmap_tpu_torch.ops import _kernels

    per = {"rdb_forward": 3 * blocks, "deform64_lrelu": 1, "deform_zproj1": 1}
    bwd = {"deform64_bwd": steps, "deform_zproj1_bwd": steps}
    return {k: (2 * steps + evaluations) * per.get(k, 0) + bwd.get(k, 0)
            for k in _kernels.launches}


def _odd_deform(card_name: str) -> None:
    """Fault 2's repair on the card: a layer the kernels do not take goes
    through deform_conv2d(method='auto') to JAX's rule, not to K7 / K8."""
    import torch

    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops.deform_conv import choose_method, deform_conv2d

    shape, c_out, k, pad = ODD_DEFORM
    gen = torch.Generator().manual_seed(23)
    x = _randn(shape, gen)
    off = _randn(shape[:3] + (2 * k * k,), gen, 0.7)
    w = _randn((c_out, shape[-1], k, k), gen, 0.05)
    b = _randn((c_out,), gen)
    method = choose_method("cuda", shape, tuple(w.shape), pad, 2)
    _kernels.reset_launches()
    got = deform_conv2d(x, off, w, b, pad, 2)
    torch.cuda.synchronize()
    if any(_kernels.launches.values()):
        raise AssertionError(f"the odd layer launched kernels: {dict(_kernels.launches)}")
    want = deform_conv2d(x.cpu(), off.cpu(), w.cpu(), b.cpu(), pad, 2)
    compare(f"deform_conv2d(method='auto') {shape} -> {c_out}, {k}x{k}, padding {pad} "
            f"({method!r}, no kernel launched) card vs CPU", got.cpu(), want, TOL_KERNEL)


def _search_inputs(rasters: dict, window):
    """Phase 19's window as the evaluator's inputs (NCHW numpy), its 48 km
    card-vs-CPU window's, and 10^5 track points over the window: the
    low-res bed sampled there (NaN in its voids) plus 10 m of noise."""
    from deepbedmap_tpu_torch.data.groundtruth import get_model_inputs
    from deepbedmap_tpu_torch.evalx.track import elevation_residuals

    names = ("bed_lowres", "surface", "velocity_x", "velocity_y", "accumulation")
    sources = [rasters[k] for k in names]
    x0, y0 = window[:2]
    cx, cy = x0 + REGION_CPU_AT[0], y0 + REGION_CPU_AT[1]
    cpu_window = (cx, cy, cx + 1e3 * REGION_CPU_KM, cy + 1e3 * REGION_CPU_KM)
    inputs = {k: v.cpu().numpy() for k, v in
              get_model_inputs(window, *sources, device=DEVICE).items()}
    cpu_inputs = {k: v.numpy() for k, v in
                  get_model_inputs(cpu_window, *sources, device="cpu").items()}
    rs = np.random.RandomState(23)
    side = window[2] - x0
    tx = rs.uniform(x0 + 1000.0, x0 + side - 1000.0, TRACK_POINTS)
    ty = rs.uniform(y0 + 1000.0, y0 + side - 1000.0, TRACK_POINTS)
    tz = elevation_residuals(rasters["bed_lowres"], tx, ty, np.zeros(TRACK_POINTS),
                             method="bilinear", device=DEVICE)
    tz = tz + rs.randn(TRACK_POINTS) * TRACK_NOISE_M
    return inputs, cpu_inputs, cpu_window, (tx, ty, tz)


def _library_trial(data, inputs: dict, track, bounds):
    """The CLI's ``hpo --tiny --trials 1 --seed CLI_HPO_SEED`` trial through
    the library calls: its finished trial."""
    from deepbedmap_tpu_torch.cli import tiny_space
    from deepbedmap_tpu_torch.evalx.fixed import make_fixed_evaluator
    from deepbedmap_tpu_torch.hpo import create_study
    from deepbedmap_tpu_torch.train import objective as obj

    study = create_study(direction="minimize", sampler_seed=CLI_HPO_SEED, **SEARCH_PRUNER)
    study.optimize(lambda t: obj.objective(
        t, data, suggest=tiny_space, make_evaluator=lambda m: make_fixed_evaluator(
            m, inputs, track, bounds, device=DEVICE)), n_trials=1)
    return study.best_trial


def library_trials(tiles: str, inputs_dir: str, track_csv: str, bounds: str) -> None:
    """Phase 23's trace, run in a new process: ``_library_trial`` LIBRARY_RUNS
    times on the files the CLI's hpo reads; prints their values and params
    as one JSON line."""
    from deepbedmap_tpu_torch.cli import _load_inputs
    from deepbedmap_tpu_torch.data.dataset import TileDataset
    from deepbedmap_tpu_torch.device import disable_tf32
    from deepbedmap_tpu_torch.evalx.track import read_track_csv

    disable_tf32()
    data = TileDataset.load_npy_dir(tiles, device=DEVICE, suffix="_data")
    inputs, track = _load_inputs(inputs_dir), read_track_csv(track_csv)
    window = tuple(float(v) for v in bounds.split(","))
    trials = [_library_trial(data, inputs, track, window) for _ in range(LIBRARY_RUNS)]
    print(json.dumps({"values": [t.value for t in trials], "params": trials[0].params}))


def search(card_name: str, rasters: dict, window, tmp: str) -> dict:
    """Phase 23: the hyperparameter search on the card (its parts are listed
    in the module docstring). Returns the numbers of the search JSON line."""
    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.data import packaging
    from deepbedmap_tpu_torch.data.dataset import (
        REFERENCE_SHAPES_NCHW,
        TileDataset,
        epoch_batches,
        train_dev_split,
    )
    from deepbedmap_tpu_torch.evalx.fixed import make_fixed_evaluator
    from deepbedmap_tpu_torch.hpo import create_study
    from deepbedmap_tpu_torch.hpo.engine import TrialState
    from deepbedmap_tpu_torch.models.api import build_generator
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.train import objective as obj
    from deepbedmap_tpu_torch.train.checkpoint import load_generator_state_dict
    from deepbedmap_tpu_torch.utils.tracking import LocalTracker

    out = {"card": card_name}
    log("  deform_conv2d(method='auto') on a layer the kernels do not take")
    _odd_deform(card_name)

    log(f"  {SEARCH_TILES} seeded reference tiles through a package in a temporary registry")
    rs = np.random.RandomState(23)
    arrays = {k: rs.rand(SEARCH_TILES, *s).astype(np.float32)
              for k, s in REFERENCE_SHAPES_NCHW.items()}
    tiles = f"{tmp}/search_tiles"
    os.makedirs(tiles)
    for k, a in arrays.items():
        np.save(f"{tiles}/{k}_data.npy", a)
    registry = f"{tmp}/registry"
    pkg = packaging.push_training_arrays(tiles, registry)
    dataset = TileDataset.from_package(registry, pkg_hash=pkg, device=DEVICE)
    for k, a in arrays.items():
        if not np.array_equal(dataset.arrays[k].cpu().numpy(), a.transpose(0, 2, 3, 1)):
            raise AssertionError(f"from_package: {k} differs from the pushed tiles")
    log(f"  from_package {pkg[:12]}: {len(dataset)} tiles on the card, every array equal "
        "to the pushed one")

    inputs, cpu_inputs, cpu_window, track = _search_inputs(rasters, window)
    n_train = int(SEARCH_TILES * 0.95)
    log("  evaluator inputs: " + ", ".join(f"{k} {v.shape}" for k, v in inputs.items())
        + f"; {TRACK_POINTS} track points, {int(np.isnan(track[2]).sum())} NaN (bed voids)")

    # by (study tag, trial number): the evaluator and the generator it last
    # scored, each epoch's record, the best epoch's weights, launches, times
    evaluators, gens, records, best_sd, launches, epoch_s, eval_ms = ({} for _ in range(7))
    current, resumed, checking_s = [None], [0.0], [0.0]
    root = f"{tmp}/experiments"

    def make_evaluator(g_model):
        ev = make_fixed_evaluator(g_model, inputs, track, window, device=DEVICE)
        evaluators[current[0]] = ev

        def evaluate(g):  # no .predict: the image needs matplotlib
            gens[current[0]] = g
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            value = ev(g)
            end.record()
            torch.cuda.synchronize()
            eval_ms.setdefault(current[0], []).append(start.elapsed_time(end))
            return value

        return evaluate

    def on_epoch(epoch, record):  # the check's own work, left out of the times
        key = current[0]
        checking = time.perf_counter()
        epoch_s.setdefault(key, []).append(checking - resumed[0])
        again = evaluators[key](gens[key])
        if not abs(again - record["rmse_test"]) <= TOL_SEARCH_RMSE * abs(again):
            raise AssertionError(f"{key} epoch {epoch}: rmse_test "
                                 f"{record['rmse_test']!r}, recomputed {again!r}")
        recs = records.setdefault(key, [])
        recs.append(record)
        if record["rmse_test"] <= min(r["rmse_test"] for r in recs):
            best_sd[key] = {k: v.detach().clone() for k, v in gens[key].state_dict().items()}
        resumed[0] = time.perf_counter()
        checking_s[0] += resumed[0] - checking

    def run(trial, data, tag):
        current[0] = (tag, trial.number)
        tracker = LocalTracker(root, experiment_key=f"{tag}_{trial.number}")
        _kernels.reset_launches()
        resumed[0] = time.perf_counter()
        try:
            return obj.objective(
                trial, data, suggest=search_space, make_evaluator=make_evaluator,
                checkpoint_dir=f"{tmp}/checkpoints_{tag}", tracker=tracker, log=on_epoch,
                rmse_save_threshold=float("inf"), rmse_upload_threshold=float("inf"))
        finally:
            torch.cuda.synchronize()
            launches[current[0]] = dict(_kernels.launches)
            tracker.end()

    log(f"  study 1: {SEARCH_TRIALS} trials of the reference space, {SEARCH_EPOCHS} "
        f"epochs, {SEARCH_PRUNER}, sqlite storage, a LocalTracker per trial")
    study = create_study(direction="minimize", storage=f"sqlite:///{tmp}/search.db",
                         sampler_seed=0, study_name="DeepBedMap_tuning", **SEARCH_PRUNER)
    t0 = time.perf_counter()
    study.optimize(lambda t: run(t, dataset, "trial"), n_trials=SEARCH_TRIALS)
    # without on_epoch's recomputed evaluation and weight copies
    out["study_wall_s"] = time.perf_counter() - t0 - checking_s[0]
    out["study_check_s"] = checking_s[0]

    completed = [t for t in study.trials if t.state == TrialState.COMPLETE]
    if len(completed) != SEARCH_TRIALS:
        raise AssertionError(f"study 1: {[t.state for t in study.trials]}")
    for t in completed:
        key = ("trial", t.number)
        recs = records[key]
        hp = t.params
        batch = min(2 ** hp["batch_size_exponent"], n_train)  # the objective's
        steps = SEARCH_EPOCHS * (n_train // batch)
        # per epoch: the dev batch, the objective's evaluation, the recomputed one
        want = _search_launches(hp["num_residual_blocks"], steps, 3 * SEARCH_EPOCHS)
        check_launches(launches[key], want)
        if len(recs) != SEARCH_EPOCHS or t.value != min(r["rmse_test"] for r in recs):
            raise AssertionError(f"trial {t.number}: value {t.value} vs records {recs}")
        tracked = LocalTracker(root, f"trial_{t.number}", create=False)
        if [m["metrics"]["rmse_test"] for m in tracked.metrics()] != \
                [r["rmse_test"] for r in recs]:
            raise AssertionError(f"trial {t.number}: the tracker's metrics differ")
        if not all(np.isfinite(v) for r in recs for k, v in r.items()
                   if not isinstance(v, bool)):
            raise AssertionError(f"trial {t.number}: non-finite record {recs}")
        log(f"  trial {t.number} {hp}: rmse_test per epoch "
            + ", ".join(f"{r['rmse_test']:.4f}" for r in recs)
            + f" m (each equal to its recomputation within {TOL_SEARCH_RMSE:g}); launches "
            f"{launches[key]} = {steps} steps x (72, 2, 2) + "
            f"{3 * SEARCH_EPOCHS} evaluations x (36, 1, 1)")
    best = study.best_trial
    if best.value != min(t.value for t in completed):
        raise AssertionError(f"best_value {best.value} is not the smallest completed value")
    out["best_value_m"] = best.value
    out["s_per_trial_epoch"] = {str(n): epoch_s[("trial", n)] for n in range(SEARCH_TRIALS)}
    out["ms_per_evaluation"] = [ms for n in range(SEARCH_TRIALS)
                                for ms in eval_ms[("trial", n)]]

    log(f"  from_experiment on the best trial ({best.number}, {best.value:.4f} m)")
    dbm = DeepBedMap.from_experiment(root, f"trial_{best.number}",
                                     download_path=f"{tmp}/fetched/w.npz", device=DEVICE)
    sd, want_sd = dbm.model.state_dict(), best_sd[("trial", best.number)]
    saved = load_generator_state_dict(f"{tmp}/checkpoints_trial/trial_{best.number}",
                                      use_ema=False)
    for label, ref in (("the best epoch's weights", want_sd), ("its checkpoint", saved)):
        if sd.keys() != ref.keys() or not all(torch.equal(sd[k].cpu(), ref[k].cpu())
                                              for k in ref):
            raise AssertionError(f"from_experiment's generator differs from {label}")
    if dbm.cfg.residual_scaling != best.params["residual_scaling"]:
        raise AssertionError(f"from_experiment scaling {dbm.cfg.residual_scaling}")
    log("  from_experiment rebuilds the best trial's generator bit for bit (against the "
        "best epoch's weights and the trial's checkpoint)")

    x0, y0, x1, y1 = cpu_window
    inside = (track[0] > x0) & (track[0] < x1) & (track[1] > y0) & (track[1] < y1)
    small = tuple(a[inside] for a in track)
    rmse = {}
    for dev in (DEVICE, "cpu"):
        g = build_generator(dbm.cfg, device=dev)
        g.load_state_dict(want_sd)
        rmse[dev] = make_fixed_evaluator(g, cpu_inputs, small, cpu_window, device=dev)()
    if not abs(rmse[DEVICE] - rmse["cpu"]) <= TOL_SEARCH_RMSE * abs(rmse["cpu"]):
        raise AssertionError(f"evaluator card {rmse[DEVICE]!r} vs CPU {rmse['cpu']!r}")
    log(f"  evaluator on {REGION_CPU_KM} km ({int(inside.sum())} points), best weights: "
        f"card {rmse[DEVICE]!r}, CPU {rmse['cpu']!r} m (tolerance {TOL_SEARCH_RMSE:g} "
        "relative)")

    log("  study 2: one trial on the tiles with a NaN in one tile's Y")
    nan_set = TileDataset({k: v.clone() for k, v in dataset.arrays.items()})
    batch = min(2 ** best.params["batch_size_exponent"], n_train)
    train_idx, _ = train_dev_split(SEARCH_TILES, 0.95, 42)
    first = int(epoch_batches(train_idx, batch, np.random.RandomState(42))[0, 0])
    nan_set.arrays["Y"][first, 17, 17, 0] = float("nan")
    study2 = create_study(direction="minimize", sampler_seed=1, **SEARCH_PRUNER)
    study2.optimize(lambda t: run(t, nan_set, "nan"), n_trials=1)
    t2 = study2.trials[0]
    recs = records[("nan", t2.number)]
    if t2.state != TrialState.PRUNED or len(recs) != 1 or \
            not np.isnan(recs[0]["generator_loss"]):
        raise AssertionError(f"study 2's trial ended {t2.state} after {recs}")
    check_launches(launches[("nan", t2.number)],
                   _search_launches(t2.params["num_residual_blocks"], n_train // batch, 3))
    log(f"  study 2: tile {first} (epoch 0's first) holds a NaN; the trial ended "
        f"{t2.state} after epoch 0 by the divergence rule")

    log(f"  CLI: hpo --tiny in a new process on {CLI_HPO_TILES} tiles, with the evaluator "
        "from files")
    cli_tiles = f"{tmp}/cli_tiles"
    os.makedirs(cli_tiles)
    for k, a in arrays.items():
        np.save(f"{cli_tiles}/{k}_data.npy", a[:CLI_HPO_TILES])
    ev_dir = f"{tmp}/eval_inputs"
    os.makedirs(ev_dir)
    for k, v in inputs.items():
        np.save(f"{ev_dir}/{k}.npy", v)
    with open(f"{tmp}/track.csv", "w") as f:
        f.write("x,y,z\n" + "".join(f"{x!r},{y!r},{z!r}\n" for x, y, z in
                                    zip(*(a.tolist() for a in track))))
    bounds = ",".join(repr(float(v)) for v in window)
    root_dir = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deepbedmap_tpu_torch", "hpo", "--tiny", "--trials", "1",
         "--seed", str(CLI_HPO_SEED), "--tiles", cli_tiles, "--eval-inputs", ev_dir,
         "--eval-track", f"{tmp}/track.csv", f"--eval-bounds={bounds}",
         "--storage", f"sqlite:///{tmp}/cli_hpo.db", "--device", DEVICE],
        cwd=root_dir, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI's hpo failed ({proc.returncode}):\n"
                             + proc.stdout[-4000:] + proc.stderr[-4000:])
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    cli_wall = time.perf_counter() - t0
    lib_data = TileDataset.load_npy_dir(cli_tiles, device=DEVICE, suffix="_data")
    create = obj.create_gan_state

    def perturbed(*args, **kwargs):
        state = create(*args, **kwargs)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for model in (state.g, state.d):
                for p in model.parameters():
                    p.mul_(1 + PERTURB * torch.randn(p.shape, generator=gen).to(p.device))
        return state

    lib = []
    for initial in (create, create, perturbed):
        obj.create_gan_state = initial
        try:
            lib.append(_library_trial(lib_data, inputs, track, window))
        finally:
            obj.create_gan_state = create
    want = lib[0]
    if want.params["num_epochs"] != 1 or cli["best_params"] != want.params or \
            cli["value_metric"] != "rmse_test_m" or cli["trials"] != 1:
        raise AssertionError(f"the CLI's hpo printed {cli}; the library's trial {want}")
    got = cli["top_trials"][0]["value"]
    again, moved = abs(lib[1].value - want.value), abs(lib[2].value - want.value)
    tol = max(TOL_CLI_HPO * abs(want.value), NOISE_K * max(again, moved))
    if not abs(got - want.value) <= tol or cli["best_value"] != round(got, 4):
        raise AssertionError(f"the CLI's hpo value {got!r}, the library's {want.value!r} "
                             f"(tolerance {tol:.3e})")
    log(f"  CLI hpo: {cli['best_params']}, {got!r} m; the same trial in this process "
        f"{want.value!r} m, again {lib[1].value!r}, from weights perturbed by {PERTURB:g} "
        f"{lib[2].value!r} (tolerance {tol:.3e} m); {cli_wall:.1f} s wall of the smoke "
        f"preset, mostly start-up  [{card_name}]")

    fresh = []
    for _ in range(LIBRARY_PROCESSES):
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.library_trials("
             "*sys.argv[1:])", cli_tiles, ev_dir, f"{tmp}/track.csv", bounds],
            cwd=root_dir, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"library_trials failed ({proc.returncode}):\n"
                                 + proc.stdout[-4000:] + proc.stderr[-4000:])
        runs = json.loads(proc.stdout.strip().splitlines()[-1])
        if runs["params"] != want.params or not all(np.isfinite(runs["values"])):
            raise AssertionError(f"library_trials printed {runs}; in this process {want}")
        fresh.append(runs["values"])
    spread = lambda vals: max(vals) - min(vals)  # noqa: E731
    log(f"  the same trial in {LIBRARY_PROCESSES} new processes, {LIBRARY_RUNS} runs each: "
        + "; ".join(", ".join(repr(v) for v in vals) for vals in fresh)
        + f" m. Spread within a process: here {again:.4g}, "
        + ", ".join(f"{spread(v):.4g}" for v in fresh)
        + f" m; between processes (the CLI's, this one's and the new ones' first runs): "
        f"{spread([got, want.value] + [v[0] for v in fresh]):.4g} m  [{card_name}]")
    out["cli_hpo"] = {"value_m": got, "library_values_m": [t.value for t in lib],
                      "new_process_values_m": fresh, "smoke_wall_s": cli_wall}

    for n in range(SEARCH_TRIALS):
        log(f"  trial {n}: s per epoch (its train steps, dev batch and evaluation), "
            "epoch by epoch: " + ", ".join(f"{v:.2f}" for v in epoch_s[("trial", n)])
            + f"  [{card_name}]")
    log(f"  evaluation at batch 1 ({inputs['X'].shape[-1]} px -> "
        f"{4 * (inputs['X'].shape[-1] - 2)}^2, {TRACK_POINTS} points): median "
        f"{np.median(out['ms_per_evaluation']):.2f} ms of {len(out['ms_per_evaluation'])} "
        f"(CUDA events)  [{card_name}]")
    log(f"  study 1 wall time: {out['study_wall_s']:.1f} s for {SEARCH_TRIALS} trials x "
        f"{SEARCH_EPOCHS} epochs, without the check's {out['study_check_s']:.1f} s of "
        f"recomputed evaluations and weight copies  [{card_name}]")
    return out


# --- phase 24: data prep ------------------------------------------------------

# (a) tests/test_dataprep_scale.py's reference-cardinality rehearsal: the 11
# packaged survey formats, 12,000 points each, on a 4 x 3 mosaic of 23 km
# patches at a 26 km pitch around the West Antarctica lon/lat patch
PREP_POINTS, PREP_SPAN, PREP_PITCH = 12_000, 23_000.0, 26_000.0
PREP_BASE_LONLAT = (-99.9, -75.99)
PREP_BUFFER = 10_000.0  # the grounding-line buffer (data_prep.py:599-607)
# the parsed tables against the writer's: the fixture's relative 1e-9 (the
# writer prints 17 digits, which pandas' parser, and so the port's, does not
# always round correctly); the built arrays card vs CPU: 1e-6 of each array's
# range (the same float32 sampling, fused multiply-adds on the card)
TOL_PREP_PARSE = 1e-9
TOL_PREP_ARRAYS = 1e-6
# (b) one large survey through the relax backend: 801^2 gridline nodes (200 km
# at 250 m, above the exact backend's 300,000), ~2e6 points on flight lines;
# card vs CPU at a 257^2 cut (64 km), within 1e-4 of the range (float32 sums
# over 500 sweeps per level, fused multiply-adds on the card)
RELAX_NODES, RELAX_CUT_NODES = 801, 257
RELAX_LINES, RELAX_LINE_POINTS, RELAX_LINE_KM = 200, 20_000, 300.0
RELAX_ORIGIN = (-1_700_000.0, -350_000.0)
RELAX_NOISE_M = 5.0
TOL_RELAX = 1e-4
PREP_CLI_SURVEY = "20xx_Antarctica_TO"  # (c): a two-file glob, a converter, lon/lat


def survey_bed(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The smooth synthetic bed of ``tests/survey_fixtures.py`` (metres)."""
    return -500.0 + 120.0 * np.sin(x / 800.0) + 80.0 * np.cos(y / 700.0) + 1e-4 * (x - y)


def write_survey(config: str, out_dir: str, n_points: int, seed: int, span_m: float,
                 origin) -> tuple:
    """A pandas-free copy of ``tests/survey_fixtures.make_survey_miniature``:
    writes the file(s) of ``config``'s format (junk header lines and columns,
    ``*`` markers, a single-member zip, two files for a ``*`` glob, lon/lat
    columns where the config reprojects) over ``survey_bed``, and returns the
    (x, y, z) table ``ascii_to_xyz`` must give."""
    import fnmatch
    import zipfile

    from deepbedmap_tpu_torch.data.proj import lonlat_to_xy, xy_to_lonlat

    with open(config) as f:
        stages = {s["type"]: s for s in json.load(f)["pipeline"]}
    reader = stages["readers.text"]
    sep, skip = reader["separator"], int(reader["skip"])
    names, usecols = reader["header"].split(sep), reader["usecols"].split(sep)
    rs = np.random.RandomState(seed)
    px = rs.uniform(origin[0], origin[0] + span_m, n_points)
    py = rs.uniform(origin[1], origin[1] + span_m, n_points)
    file_x, file_y = px, py
    if "filters.reprojection" in stages:
        file_x, file_y = xy_to_lonlat(px, py)
        px, py = lonlat_to_xy(file_x, file_y)  # what the reader's reprojection gives
    z = survey_bed(px, py)
    values = {}
    if reader.get("converters"):
        lhs, _, rhs = dict(reader["converters"]).popitem()[1].partition("-")
        thickness = rs.uniform(500.0, 1500.0, n_points)
        values = {lhs: z + thickness, rhs: thickness}
    plain = sorted(c for c in usecols if c not in values)
    values.update(zip(plain, (file_x, file_y, z)))
    columns = [values.get(name, np.full(n_points, float(i))) for i, name in enumerate(names)]
    write_sep = {"\t": "\t", ",": ","}.get(sep, " ")
    body = [write_sep.join(map(repr, row)) for row in zip(*(c.tolist() for c in columns))]
    na_marker = reader.get("na_values")
    if na_marker:  # the z column's marker in the first two rows, which the reader drops
        zcol = names.index(lhs if reader.get("converters") else plain[2])
        for bad in (0, 1):
            parts = body[bad].split(write_sep)
            parts[zcol] = na_marker
            body[bad] = write_sep.join(parts)
    content = "\n".join([f"# junk header line {r}" for r in range(skip)]
                        + [write_sep.join(names)] + body) + "\n"
    pattern = reader["filename"]
    files = [pattern.replace("?", "1").replace("*", "")]
    if "*" in pattern:
        files.append(pattern.replace("?", "1").replace("*", "_b"))
    for name in files:
        assert fnmatch.fnmatch(name, pattern), (name, pattern)
        if name.endswith(".zip"):
            with zipfile.ZipFile(os.path.join(out_dir, name), "w") as zf:
                zf.writestr(name[:-4] + ".txt", content)
        else:
            with open(os.path.join(out_dir, name), "w") as f:
                f.write(content)
    keep = slice(2, None) if na_marker else slice(None)
    return tuple(np.tile(a[keep], len(files)) for a in (px, py, z))


def _prep_raster(bounds, res: float, fn):
    """A float32 Raster over ``bounds`` (xmin, ymin, xmax, ymax) of ``fn`` at
    the cell centres."""
    from deepbedmap_tpu_torch.data.raster import Raster

    xmin, ymin, xmax, ymax = bounds
    xs = xmin + (np.arange(int((xmax - xmin) / res)) + 0.5) * res
    ys = ymax - (np.arange(int((ymax - ymin) / res)) + 0.5) * res
    return Raster(fn(*np.meshgrid(xs, ys)).astype(np.float32), left=float(xmin),
                  top=float(ymax), res=float(res), nodata=None)


def _prep_conditioning(bounds) -> dict:
    """tests/test_dataprep_scale.py's conditioning rasters over ``bounds``:
    the bed at 1000 m, the surface at 100 m, velocity x/y at 500 m and
    accumulation at 1000 m."""
    x0, y0 = bounds[0] + 9_000.0, bounds[1] + 9_000.0
    return {"lowres": _prep_raster(bounds, 1000.0, survey_bed),
            "surface": _prep_raster(bounds, 100.0, lambda x, y: survey_bed(x, y) + 1500.0),
            "velocity_x": _prep_raster(bounds, 500.0, lambda x, y: 0.001 * (x - x0)),
            "velocity_y": _prep_raster(bounds, 500.0, lambda x, y: 0.001 * (y - y0)),
            "accumulation": _prep_raster(bounds, 1000.0, lambda x, y: 0.2 + 0 * x)}


def _build(highres, bounds, cond, device, out_dir=None):
    from deepbedmap_tpu_torch.data.builder import build_training_arrays

    return build_training_arrays(
        {k: highres[k] for k in bounds}, bounds, lowres=cond["lowres"],
        surface=cond["surface"], velocity=(cond["velocity_x"], cond["velocity_y"]),
        accumulation=cond["accumulation"], out_dir=out_dir, device=device)


def _synced(fn):
    """``fn()`` and its host-clock seconds, ended by a synchronise."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _events(fn):
    """``fn()``, its CUDA-event ms and its host-clock ms, from one call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)


def prep_reference(card_name: str, tmp: str) -> tuple:
    """Phase 24 (a): the 11 survey formats at reference cardinality through
    parse -> region -> exact grid -> windows -> polygon filter -> training
    arrays on the card, each stage's counts and the arrays against the same
    calls on the CPU. Returns (numbers, grids, data dirs, conditioning
    rasters)."""
    import torch

    from deepbedmap_tpu_torch.data.dataset import ARRAY_KEYS, TileDataset, content_hash
    from deepbedmap_tpu_torch.data.gridder import blockmedian, get_region, xyz_to_grid
    from deepbedmap_tpu_torch.data.pipeline import ascii_to_xyz, list_survey_configs
    from deepbedmap_tpu_torch.data.proj import lonlat_to_xy
    from deepbedmap_tpu_torch.data.windows import filter_within_polygon, get_window_bounds

    configs = list_survey_configs()
    if len(configs) != 11:
        raise AssertionError(f"{len(configs)} packaged survey configs, not 11")
    bx, by = lonlat_to_xy(np.array([PREP_BASE_LONLAT[0]]), np.array([PREP_BASE_LONLAT[1]]))
    base = (float(bx[0]), float(by[0]))
    out = {"card": card_name, "surveys": len(configs)}
    xyzs, dirs, t_parse, off_bits = {}, {}, 0.0, 0
    for k, config in enumerate(configs):
        name = os.path.splitext(os.path.basename(config))[0]
        dirs[name] = f"{tmp}/prep/{name}"
        os.makedirs(dirs[name])
        want = write_survey(config, dirs[name], PREP_POINTS, 100 + k, PREP_SPAN,
                            (base[0] + (k % 4) * PREP_PITCH, base[1] + (k // 4) * PREP_PITCH))
        t0 = time.perf_counter()
        xyzs[name] = ascii_to_xyz(config, data_dir=dirs[name])
        t_parse += time.perf_counter() - t0
        for got, exp in zip((xyzs[name].x, xyzs[name].y, xyzs[name].z), want):
            if got.shape != exp.shape or not np.allclose(got, exp, rtol=TOL_PREP_PARSE, atol=0):
                raise AssertionError(f"ascii_to_xyz({name}) differs from the written table")
            off_bits += int((got != exp).sum())
    points = sum(map(len, xyzs.values()))
    out.update(points=points, parse_s=t_parse, parse_values_not_bit_equal=off_bits)
    log(f"  parse: 11 formats, {points} points in {t_parse:.2f} s ({points / t_parse:.0f} "
        f"points/s); every table within {TOL_PREP_PARSE:g} relative of the written one, "
        f"{off_bits} of {3 * points} values not bit-equal (17-digit text, pandas' parser)")

    # the solver imports scipy inside; its first import (~2 s) stays out of
    # both timings
    import scipy.ndimage  # noqa: F401
    import scipy.sparse.linalg  # noqa: F401

    grids, grids_cpu, t_grid, t_grid_cpu = {}, {}, 0.0, 0.0
    for name, xyz in xyzs.items():
        region = get_region(xyz)
        grids[name], dt = _synced(lambda: xyz_to_grid(xyz, region, spacing=250,
                                                      device=DEVICE))
        t_grid += dt
        t0 = time.perf_counter()
        grids_cpu[name] = xyz_to_grid(xyz, region, spacing=250, device="cpu")
        t_grid_cpu += time.perf_counter() - t0
        if grids[name].data.tobytes() != grids_cpu[name].data.tobytes():
            raise AssertionError(f"the exact grid of {name} differs card vs CPU")
    # the block medians alone, warm, on the card and on the CPU
    t_median = {DEVICE: 0.0, "cpu": 0.0}
    for xyz in xyzs.values():
        for dev in t_median:
            t_median[dev] += _synced(lambda: blockmedian(xyz, get_region(xyz), device=dev))[1]
    cells = sum(g.data.size for g in grids.values())
    out.update(exact_grids_s=t_grid, exact_grids_cpu_s=t_grid_cpu, grid_cells=cells,
               exact_blockmedian_s=t_median[DEVICE], exact_blockmedian_cpu_s=t_median["cpu"])
    log(f"  exact grids (blockmedian on the card, the GMT-surface solve on the host): "
        f"{cells} cells in {t_grid:.2f} s (all-CPU {t_grid_cpu:.2f} s), equal bit for bit; "
        f"the 11 block medians again, warm: card {t_median[DEVICE]:.3f} s, CPU "
        f"{t_median['cpu']:.3f} s  [{card_name}]")

    xmin, ymin = base[0] - 5_000.0, base[1] - 5_000.0
    xmax, ymax = base[0] + 4 * PREP_PITCH + 5_000.0, base[1] + 3 * PREP_PITCH + 5_000.0
    notch_x, notch_y = xmin + 20_000.0, ymin + 20_000.0
    polygon = np.array([(notch_x, ymin), (xmax, ymin), (xmax, ymax), (xmin, ymax),
                        (xmin, notch_y), (notch_x, notch_y)])
    t0 = time.perf_counter()
    windows = {k: get_window_bounds(g) for k, g in grids.items()}
    kept = {k: [wb[i] for i in filter_within_polygon(wb, polygon, buffer=PREP_BUFFER)]
            for k, wb in windows.items()}
    t_windows = time.perf_counter() - t0
    windows_cpu = {k: get_window_bounds(g) for k, g in grids_cpu.items()}
    n_windows, n_kept = sum(map(len, windows.values())), sum(map(len, kept.values()))
    if windows != windows_cpu or not 0 < n_kept < n_windows:
        raise AssertionError(f"windows {n_windows} -> {n_kept}: not the CPU's, or the "
                             "notch dropped none")
    out.update(windows=n_windows, kept=n_kept, windows_filter_s=t_windows)
    log(f"  windows + filter: {n_windows} -> {n_kept} windows in {t_windows:.2f} s "
        "(the CPU's grids give the same)")

    cond = _prep_conditioning((xmin - 4_000.0, ymin - 4_000.0, xmax + 4_000.0, ymax + 4_000.0))
    kept = {k: v for k, v in kept.items() if v}
    model = f"{tmp}/prep_model"
    dataset, t_build = _synced(lambda: _build(grids, kept, cond, DEVICE, model))
    t0 = time.perf_counter()
    dataset_cpu = _build(grids_cpu, kept, cond, "cpu")
    t_build_cpu = time.perf_counter() - t0
    n = len(dataset)
    if n != len(dataset_cpu) or n != n_kept:
        raise AssertionError(f"{n} tiles on the card, {len(dataset_cpu)} on the CPU, "
                             f"{n_kept} windows")
    shapes = {"X": (n, 11, 11, 1), "W1": (n, 110, 110, 1), "W2": (n, 22, 22, 2),
              "W3": (n, 11, 11, 1), "Y": (n, 36, 36, 1)}
    for k in ARRAY_KEYS:
        got, want = dataset.arrays[k], dataset_cpu.arrays[k]
        if tuple(got.shape) != shapes[k] or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{k}: shape {tuple(got.shape)} or non-finite values")
        err = float((got.cpu().double() - want.double()).abs().max())
        scale = float(want.max() - want.min())
        if not err <= TOL_PREP_ARRAYS * scale:
            raise AssertionError(f"{k}: card vs CPU {err:.3e} above "
                                 f"{TOL_PREP_ARRAYS:g} x range {scale:.3e}")
    saved = {k: np.load(f"{model}/{k}_data.npy") for k in ARRAY_KEYS}
    with open(f"{model}/CONTENT_HASH") as f:
        if f.read().strip() != content_hash(saved):
            raise AssertionError("CONTENT_HASH is not the content hash of the saved files")
    loaded = TileDataset.load_npy_dir(model, suffix="_data", device=DEVICE)
    if not all(torch.equal(loaded.arrays[k], dataset.arrays[k]) for k in ARRAY_KEYS):
        raise AssertionError("load_npy_dir of the saved arrays differs from the dataset")
    mb = sum(a.nbytes for a in saved.values()) / 2**20
    out.update(tiles=n, build_s=t_build, build_cpu_s=t_build_cpu, tiles_per_s=n / t_build,
               arrays_mb=mb)
    log(f"  build on the card: {n} tiles, {mb:.1f} MB in {t_build:.2f} s ({n / t_build:.0f} "
        f"tiles/s, np.save included; CPU {t_build_cpu:.2f} s); card vs CPU within "
        f"{TOL_PREP_ARRAYS:g} of each range, shapes, finite, CONTENT_HASH, load_npy_dir  "
        f"[{card_name}]")
    return out, grids, dirs, cond


def _flight_lines(rs, bounds) -> tuple:
    """~``RELAX_LINES * RELAX_LINE_POINTS / 2`` points along straight
    flight lines (random centre and heading, 15 m spacing) inside ``bounds``,
    over ``survey_bed`` with seeded noise."""
    xmin, ymin, xmax, ymax = bounds
    cx = rs.uniform(xmin, xmax, RELAX_LINES)[:, None]
    cy = rs.uniform(ymin, ymax, RELAX_LINES)[:, None]
    angle = rs.uniform(0.0, np.pi, RELAX_LINES)[:, None]
    t = np.linspace(-500.0 * RELAX_LINE_KM, 500.0 * RELAX_LINE_KM, RELAX_LINE_POINTS)[None]
    x, y = (cx + t * np.cos(angle)).ravel(), (cy + t * np.sin(angle)).ravel()
    inside = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    x, y = x[inside], y[inside]
    return x, y, survey_bed(x, y) + rs.normal(0.0, RELAX_NOISE_M, x.size)


def prep_relax(card_name: str) -> dict:
    """Phase 24 (b): one large survey through the relax backend on the card:
    blockmedian card vs CPU, the solve's constrained nodes, the mask against
    scipy's dilation, stage times; then card vs CPU at a 257^2 cut."""
    import torch
    from scipy import ndimage

    from deepbedmap_tpu_torch.data import gridder
    from deepbedmap_tpu_torch.data.pipeline import XYZ
    from deepbedmap_tpu_torch.ops.spline import solve_tension_spline

    side = (RELAX_NODES - 1) * 250.0
    x0, y0 = RELAX_ORIGIN
    region = (x0, x0 + side, y0, y0 + side)
    xyz = XYZ(*_flight_lines(np.random.RandomState(24), (x0, y0, x0 + side, y0 + side)))
    out = {"card": card_name, "relax_points": len(xyz), "relax_nodes": RELAX_NODES ** 2}
    med, bm_ms, bm_host_ms = _events(lambda: gridder.blockmedian(xyz, region, device=DEVICE))
    t0 = time.perf_counter()
    med_cpu = gridder.blockmedian(xyz, region, device="cpu")
    bm_cpu_s = time.perf_counter() - t0
    _, bm_warm_ms, bm_warm_host_ms = _events(
        lambda: gridder.blockmedian(xyz, region, device=DEVICE))
    for k in "xyz":
        if not np.array_equal(getattr(med, k), getattr(med_cpu, k), equal_nan=True):
            raise AssertionError(f"blockmedian {k}: card differs from the CPU")
    log(f"  relax: {len(xyz)} points on {RELAX_LINES} flight lines, {RELAX_NODES}^2 nodes; "
        f"blockmedian {len(med)} blocks: {bm_ms:.1f} ms CUDA events / {bm_host_ms:.1f} ms host "
        f"cold, {bm_warm_ms:.1f} / {bm_warm_host_ms:.1f} ms warm (CPU {bm_cpu_s:.2f} s), "
        f"card vs CPU equal  [{card_name}]")

    row, col = gridder.relax_nodes(med, region, 250.0)
    data, has = gridder.node_constraints(row, col, med.z, (RELAX_NODES, RELAX_NODES))
    z, solve_ms, solve_host_ms = _events(
        lambda: solve_tension_spline(data, has, iterations=500, device=DEVICE))
    z = z.cpu().numpy()
    if not (np.isfinite(z).all() and np.array_equal(z[has], data[has])):
        raise AssertionError("the solve is not finite or moved a constrained node")
    grid, grid_ms, grid_host_ms = _events(lambda: gridder.xyz_to_grid(xyz, region,
                                                                      device=DEVICE))
    far = ~ndimage.binary_dilation(has, np.ones((3, 3), bool), iterations=3)
    far_pixel = far[:-1, :-1] | far[:-1, 1:] | far[1:, :-1] | far[1:, 1:]
    if not np.array_equal(np.isnan(grid.data), far_pixel):
        raise AssertionError("the relax grid's NaN cells are not scipy's dilation mask")
    per_1e5 = solve_ms / (RELAX_NODES ** 2 / 1e5)
    out.update(blockmedian_ms=bm_warm_ms, blockmedian_host_ms=bm_warm_host_ms,
               blockmedian_cold_ms=bm_ms, blockmedian_cpu_s=bm_cpu_s, solve_ms=solve_ms,
               solve_host_ms=solve_host_ms, solve_ms_per_1e5_nodes=per_1e5,
               xyz_to_grid_ms=grid_ms, xyz_to_grid_host_ms=grid_host_ms)
    log(f"  relax solve (500 sweeps per level): {solve_ms:.1f} ms CUDA events / "
        f"{solve_host_ms:.1f} ms host = {per_1e5:.2f} ms per 1e5 nodes; constrained nodes "
        f"exact; whole xyz_to_grid (two solves, offset correction): {grid_ms:.1f} / "
        f"{grid_host_ms:.1f} ms; NaN cells = scipy's dilation  [{card_name}]")

    cut = (RELAX_CUT_NODES - 1) * 250.0
    cut_region = (x0, x0 + cut, y0, y0 + cut)
    inside = (xyz.x <= x0 + cut) & (xyz.y <= y0 + cut)
    sub = XYZ(xyz.x[inside], xyz.y[inside], xyz.z[inside])
    got = gridder.xyz_to_grid(sub, cut_region, backend="relax", device=DEVICE).data
    t0 = time.perf_counter()
    want = gridder.xyz_to_grid(sub, cut_region, backend="relax", device="cpu").data
    cut_cpu_s = time.perf_counter() - t0
    finite = ~np.isnan(want)
    err = float(np.abs(got[finite].astype(np.float64) - want[finite]).max())
    scale = float(np.ptp(want[finite]))
    if not (np.array_equal(np.isnan(got), ~finite) and err <= TOL_RELAX * scale):
        raise AssertionError(f"relax {RELAX_CUT_NODES}^2 card vs CPU: {err:.3e} above "
                             f"{TOL_RELAX:g} x range {scale:.3e}, or other NaN cells")
    out.update(relax_cut_err=err, relax_cut_range=scale, relax_cut_cpu_s=cut_cpu_s)
    log(f"  relax {RELAX_CUT_NODES}^2 ({int(inside.sum())} points) card vs CPU: max_abs_err "
        f"{err:.3e} (tolerance {TOL_RELAX * scale:.3e} = {TOL_RELAX:g} x range {scale:.3e}), "
        f"the same NaN cells; the CPU took {cut_cpu_s:.1f} s")
    return out


def _run_cli(argv, what: str) -> tuple:
    """``python -m deepbedmap_tpu_torch`` with ``argv`` in a new process from
    the checkout's root: (its JSON line, its wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deepbedmap_tpu_torch"] + argv,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI's {what} failed ({proc.returncode}):\n"
                             + proc.stdout[-4000:] + proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1]), wall


def prep_cli(card_name: str, tmp: str, grids: dict, dirs: dict, cond: dict) -> dict:
    """Phase 24 (c): the CLI's ``grid`` and ``build`` in new processes on the
    card with GeoTIFF files, each equal to the library's results of (a) bit
    for bit, and their JSON lines to the library's numbers."""
    from deepbedmap_tpu_torch.data import geotiff
    from deepbedmap_tpu_torch.data.dataset import ARRAY_KEYS
    from deepbedmap_tpu_torch.data.gridder import get_region
    from deepbedmap_tpu_torch.data.pipeline import ascii_to_xyz, survey_config_path
    from deepbedmap_tpu_torch.data.raster import read_raster
    from deepbedmap_tpu_torch.data.windows import get_window_bounds

    name = PREP_CLI_SURVEY
    config = survey_config_path(name)
    surveys = f"{tmp}/cli_prep/surveys"
    os.makedirs(surveys)
    grid_tif = f"{surveys}/{name}.tif"
    line, grid_s = _run_cli(["grid", config, "-o", grid_tif, "--data-dir", dirs[name],
                             "--device", DEVICE], "grid")
    want = grids[name]
    xyz = ascii_to_xyz(config, data_dir=dirs[name])
    expected = {"command": "grid", "points": len(xyz), "region": list(get_region(xyz)),
                "shape": list(want.data.shape), "out": grid_tif}
    got = read_raster(grid_tif)
    if line != expected or got.data.tobytes() != want.data.tobytes() or (
            got.left, got.top, got.res) != (want.left, want.top, want.res):
        raise AssertionError(f"the CLI's grid {line} differs from the library's {expected}")
    log(f"  CLI grid {name} in a new process (GeoTIFF out): equal to (a)'s grid bit for "
        f"bit, JSON line equal; {grid_s:.1f} s wall  [{card_name}]")

    for other, raster in grids.items():
        if other != name:
            geotiff.write_geotiff(f"{surveys}/{other}.tif", raster.data, raster.left,
                                  raster.top, raster.res, compress=True)
    argv = ["build", "--surveys", surveys, "-o", f"{tmp}/cli_prep/model", "--device", DEVICE]
    for key, raster in cond.items():
        path = f"{tmp}/cli_prep/{key}.tif"
        geotiff.write_geotiff(path, raster.data, raster.left, raster.top, raster.res,
                              compress=True)
        argv += ["--" + key.replace("_", "-"), path]
    line, build_s = _run_cli(argv, "build")
    windows = {k: get_window_bounds(g) for k, g in grids.items()}
    dataset = _build(grids, {k: v for k, v in windows.items() if v}, cond, DEVICE)
    expected = {"command": "build", "surveys": sorted(grids),
                "windows": {k: len(v) for k, v in sorted(windows.items())},
                "tiles": len(dataset), "out": f"{tmp}/cli_prep/model"}
    if line != expected:
        raise AssertionError(f"the CLI's build {line} differs from the library's {expected}")
    for k in ARRAY_KEYS:
        saved = np.load(f"{tmp}/cli_prep/model/{k}_data.npy")
        if saved.tobytes() != dataset.arrays[k].permute(0, 3, 1, 2).contiguous().cpu(
                ).numpy().tobytes():
            raise AssertionError(f"the CLI's build: {k} differs from the library's")
    log(f"  CLI build in a new process (GeoTIFF surveys and rasters): {len(dataset)} tiles "
        f"equal to build_training_arrays' bit for bit, JSON line equal; {build_s:.1f} s wall"
        f"  [{card_name}]")
    return {"cli_grid_s": grid_s, "cli_build_s": build_s, "cli_build_tiles": len(dataset)}


def data_prep(card_name: str, tmp: str) -> dict:
    """Phase 24: data prep on the card, (a), (b) and (c) (the module
    docstring lists their checks). Returns the numbers of its JSON line."""
    t0 = time.perf_counter()
    log("  (a) 11 survey formats at reference cardinality")
    out, grids, dirs, cond = prep_reference(card_name, tmp)
    log("  (b) one large survey through the relax backend")
    out.update(prep_relax(card_name))
    log("  (c) the CLI's grid and build in new processes")
    out.update(prep_cli(card_name, tmp, grids, dirs, cond))
    out["phase_wall_s"] = time.perf_counter() - t0
    log(f"  phase 24 wall time {out['phase_wall_s']:.1f} s  [{card_name}]")
    return out


# phase 25: evaluation, figures, live curves and a trace, on phase 19's
# window, rasters, weights and track
EVAL_HRES_FACTOR = 1 / 2.5  # the synthetic-HRES baseline (deepbedmap.py:344-356)
ROUGH_WINDOW = 5  # the paper's roughness window (paper_figures.py:847-865)
TRANSECT_POINTS, TRANSECT_INSET = 400, 2000.0
# card vs CPU: the baselines 1e-6 of each output's range; the roughness
# variance 1e-6 x max(x^2) (the one-pass formula's error scale, JAX's);
# the hillshade 1e-5 absolute; transects 1e-4 of each profile's range; the
# track RMSEs 1e-5 relative
TOL_BASELINE, TOL_VARIANCE, TOL_HILLSHADE = 1e-6, 1e-6, 1e-5
TOL_TRANSECT, TOL_EVAL_RMSE = 1e-4, 1e-5
EVAL_REPS = 3
LIVE_TILES, LIVE_EPOCHS = 256, 2  # the CLI's train, 12 RRDBs at batch 128
# a kernel of each of the main path's three wrappers, as its symbol appears
# among the trace's CUDA kernel events (K1 runs its five conv stages as
# conv3x3_tc_stage launches)
TRACE_SYMBOLS = {"rdb_forward": "conv3x3_tc_stage", "deform64_lrelu": "deform64_tc_kernel",
                 "deform_zproj1": "deform_zproj1_kernel"}
TRACE_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def close_nan(label: str, got: np.ndarray, want: np.ndarray, tol: float,
              scale: float = None, squared: bool = False) -> float:
    """``got`` against ``want`` with NaN masks equal; the error is of the
    finite cells (of their squares when ``squared``), the tolerance ``tol`` x
    ``scale`` (default: ``want``'s finite range). Returns the error."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} != {want.shape}")
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        raise AssertionError(f"{label}: NaN masks differ")
    if nan.all():
        raise AssertionError(f"{label}: all NaN")
    g, w = got[~nan].astype(np.float64), want[~nan].astype(np.float64)
    if squared:
        g, w = g * g, w * w
    scale = float(np.ptp(w)) if scale is None else scale
    err = float(np.abs(g - w).max())
    log(f"  {label}: max_abs_err{' of the squares' if squared else ''} {err:.3e} "
        f"(tolerance {tol * scale:.3e}), NaN masks equal ({int(nan.sum())} NaN)")
    if not err <= tol * scale:
        raise AssertionError(f"{label}: error {err:.3e} above {tol * scale:.3e}")
    return err


def close_analysis(label: str, got, want, grid: np.ndarray) -> None:
    """Phase 25's checks by kind, from ``label``: a roughness grid (its
    variance), a hillshade, or a transect."""
    if "roughness" in label and got.ndim == 2:
        close_nan(label, got, want, TOL_VARIANCE,
                  scale=float(np.nanmax(grid.astype(np.float64) ** 2)), squared=True)
    elif "hillshade" in label:
        close_nan(label, got, want, TOL_HILLSHADE, scale=1.0)
    else:
        close_nan(label, got, want, TOL_TRANSECT)


def trace_summary(events: list, top: int = 5) -> dict:
    """A ``torch.profiler`` Chrome trace's device side: the device events
    (kernels, copies, sets), the total time of the ``top`` operations by
    name, the longest idle gaps, and the idle share: one minus the union of
    the device events' intervals over the window from the first device event
    to the last."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in TRACE_DEVICE_CATEGORIES]
    if not dev:
        raise AssertionError("the trace holds no device event")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in dev)
    merged = []  # [start, end, name of the event that ends it, of the one that starts it]
    for s, e, name in spans:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1:3] = [e, name]
        else:
            merged.append([s, e, name, name])
    start, end = merged[0][0], merged[-1][1]
    busy = sum(m[1] - m[0] for m in merged)
    gaps = [(b[0] - a[1], a[2], b[3]) for a, b in zip(merged, merged[1:])]
    totals: dict = {}
    for s, e, name in spans:
        totals[name] = totals.get(name, 0.0) + (e - s)
    return {
        "device_events": len(dev),
        "kernel_names": sorted({e["name"] for e in dev if e["cat"] == "kernel"}),
        "window_ms": (end - start) / 1e3,
        "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / (end - start),
        "top_ops_ms": [(n, t / 1e3)
                       for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]],
        "longest_gaps_ms": [(g / 1e3, a, b) for g, a, b in sorted(gaps, reverse=True)[:top]],
    }


def _short(name: str, n: int = 70) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def evaluate_region(card_name: str, region: dict) -> dict:
    """Phase 25 (a): the reference's last notebook on phase 19's window at
    full width: ``predict``, the 'cubicbedmap' and synthetic-HRES baselines,
    ``track_rmse`` of DeepBedMap and cubicbedmap, the roughness and hillshade
    of both grids and their transects, each card vs CPU, each stage timed."""
    import torch

    from deepbedmap_tpu_torch.data.groundtruth import get_model_inputs
    from deepbedmap_tpu_torch.data.raster import Raster
    from deepbedmap_tpu_torch.evalx import bicubic_upsample, bilinear_resample, track_rmse
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.viz import hillshade, standard_deviation_2d
    from deepbedmap_tpu_torch.viz.paper import transect_profiles

    dbm, rasters, window = region["dbm"], region["rasters"], region["window"]
    tx, ty, tz = region["track"]
    xmin, ymin, xmax, ymax = window
    _kernels.reset_launches()
    dem = dbm.predict(window, rasters)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    log(f"  launches in predict: {launches}")
    check_launches(launches, {k: PER_FORWARD["default"].get(k, 0) for k in launches})

    names = ("bed_lowres", "surface", "velocity_x", "velocity_y", "accumulation")
    x = get_model_inputs(window, *(rasters[k] for k in names), device=DEVICE)["X"]
    bed = rasters["bed_lowres"]
    x_raster = Raster(x[0, 0].cpu().numpy(), left=xmin - 1000.0, top=ymax + 1000.0,
                      res=bed.res)
    if not np.isfinite(x_raster.data).all() or not (x_raster.data == -5000.0).any():
        raise AssertionError("X should be finite and hold gapfilled (-5000) cells")
    cubic = bicubic_upsample(x_raster, 4, device=DEVICE)
    hres = bilinear_resample(rasters["surface"], EVAL_HRES_FACTOR, device=DEVICE)
    log(f"  cubicbedmap {cubic.data.shape} @ {cubic.res:g} m from X {x_raster.data.shape}; "
        f"synthetic HRES {hres.data.shape} @ {hres.res:g} m from the surface "
        f"{rasters['surface'].data.shape} @ {rasters['surface'].res:g} m")
    close_nan(f"bicubic_upsample x4 {cubic.data.shape} card vs CPU", cubic.data,
              bicubic_upsample(x_raster, 4, device="cpu").data, TOL_BASELINE)
    close_nan(f"bilinear_resample x{EVAL_HRES_FACTOR:g} {hres.data.shape} card vs CPU",
              hres.data, bilinear_resample(rasters["surface"], EVAL_HRES_FACTOR,
                                           device="cpu").data, TOL_BASELINE)
    if (cubic.left, cubic.top, cubic.res) != (x_raster.left, x_raster.top, 250.0):
        raise AssertionError(f"cubicbedmap georeferencing {cubic.left, cubic.top, cubic.res}")

    out = {"card": card_name, "launches": launches}
    grids = {"DeepBedMap": dem, "cubicbedmap": cubic}
    for name, grid in grids.items():
        card = track_rmse(grid, tx, ty, tz, device=DEVICE)
        cpu = track_rmse(grid, tx, ty, tz, device="cpu")
        if not abs(card - cpu) <= TOL_EVAL_RMSE * abs(cpu):
            raise AssertionError(f"track_rmse {name}: card {card!r} vs CPU {cpu!r}")
        out[f"rmse_{name}_m"] = card
        log(f"  track_rmse {name} on {len(tx)} points: card {card!r}, CPU {cpu!r}")

    for name, grid in grids.items():
        for label, fn in (("roughness", lambda d, g: standard_deviation_2d(
                g, ROUGH_WINDOW, device=d)), ("hillshade", lambda d, g: hillshade(
                    g, grid.res, device=d))):
            close_analysis(f"{name} {label} {grid.data.shape} card vs CPU",
                           fn(DEVICE, grid.data).cpu().numpy(), fn("cpu", grid.data).numpy(),
                           grid.data)
    xs = np.linspace(xmin + TRANSECT_INSET, xmax - TRANSECT_INSET, TRANSECT_POINTS)
    ys = np.linspace(ymin + TRANSECT_INSET, ymax - TRANSECT_INSET, TRANSECT_POINTS)
    card_profiles = transect_profiles(grids, xs, ys, ROUGH_WINDOW, device=DEVICE)
    cpu_profiles = transect_profiles(grids, xs, ys, ROUGH_WINDOW, device="cpu")
    for name, (z, r) in card_profiles.items():
        close_analysis(f"{name} elevation transect ({TRANSECT_POINTS} points) card vs CPU",
                       z, cpu_profiles[name][0], None)
        close_analysis(f"{name} roughness transect card vs CPU", r, cpu_profiles[name][1],
                       None)

    stages = {
        "predict": lambda: dbm.predict(window, rasters),
        "bicubic_upsample x4": lambda: bicubic_upsample(x_raster, 4, device=DEVICE),
        f"bilinear_resample x{EVAL_HRES_FACTOR:g}": lambda: bilinear_resample(
            rasters["surface"], EVAL_HRES_FACTOR, device=DEVICE),
        "track_rmse x2": lambda: [track_rmse(g, tx, ty, tz, device=DEVICE)
                                  for g in grids.values()],
        "roughness + hillshade x2": lambda: [
            (standard_deviation_2d(g.data, ROUGH_WINDOW, device=DEVICE),
             hillshade(g.data, g.res, device=DEVICE)) for g in grids.values()],
        "transects x2": lambda: transect_profiles(grids, xs, ys, ROUGH_WINDOW, device=DEVICE),
    }
    out["stage_ms"] = {k: time_ms(fn, EVAL_REPS) for k, fn in stages.items()}
    for k, ms in out["stage_ms"].items():
        log(f"  {k}: {ms:.2f} ms (CUDA events, warm)  [{card_name}]")
    log(f"  RMSE on {len(tx)} track points: DeepBedMap {out['rmse_DeepBedMap_m']:.4f} m, "
        f"cubicbedmap {out['rmse_cubicbedmap_m']:.4f} m  [{card_name}]")
    return out


def figures_phase(card_name: str, tmp: str) -> dict:
    """Phase 25 (b): the figure set. With matplotlib, ``figure_set.main`` on
    the card and the CLI's ``figures`` in a new process, seven non-empty
    PNGs each; without it, the figure set's device work card vs CPU and the
    CLI's refusal naming matplotlib."""
    import importlib.util

    from deepbedmap_tpu_torch.viz import figure_set

    if importlib.util.find_spec("matplotlib") is not None:
        log("  matplotlib present: the figure set drawn in this process and by the CLI")
        figure_set.main(f"{tmp}/figures", device=DEVICE)
        out = f"{tmp}/cli_figures"
        line, _ = _run_cli(["figures", "-o", out, "--device", DEVICE], "figures")
        if line != {"command": "figures", "out": out, "rc": 0}:
            raise AssertionError(f"the CLI's figures printed {line}")
        for label, out in (("figure_set.main", f"{tmp}/figures"), ("CLI figures", out)):
            sizes = {n: os.path.getsize(f"{out}/{n}") for n in figure_set.FIGURES}
            if sorted(os.listdir(out)) != sorted(figure_set.FIGURES) or min(sizes.values()) == 0:
                raise AssertionError(f"{label} wrote {sorted(os.listdir(out))}")
            log(f"  {label}: {len(sizes)} PNGs, {sum(sizes.values()) / 2**20:.1f} MB")
        return {"branch": "matplotlib", "pngs": len(figure_set.FIGURES)}

    log("  matplotlib absent: the figure set's device work card vs CPU, the CLI refuses")
    got = figure_set.figure_arrays(device=DEVICE)
    want = figure_set.figure_arrays(device="cpu")
    dems = figure_set.synthetic_dems()
    for key in want:
        close_analysis(f"figure set {key} {got[key].shape}", got[key], want[key],
                       dems["DeepBedMap"].data)
    proc = subprocess.run([sys.executable, "-m", "deepbedmap_tpu_torch", "figures", "-o",
                           f"{tmp}/cli_figures", "--device", DEVICE],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if proc.returncode == 0 or "matplotlib" not in line.get("error", ""):
        raise AssertionError(f"the CLI's figures without matplotlib: rc {proc.returncode}, "
                             f"{line}")
    log(f"  CLI figures: rc {proc.returncode}, {line['error']!r}")
    return {"branch": "no matplotlib", "arrays": len(want)}


def live_curves(card_name: str, tmp: str) -> dict:
    """Phase 25 (c): the CLI's ``train --live-term`` (and ``--live-png``
    with matplotlib) in a new process at 12 RRDBs and batch 128: one
    sparkline line per metric after each epoch, then the JSON line."""
    import importlib.util

    argv = ["train", "--synthetic-tiles", str(LIVE_TILES), "--epochs", str(LIVE_EPOCHS),
            "--live-term", "--device", DEVICE]
    png = f"{tmp}/live.png" if importlib.util.find_spec("matplotlib") else None
    if png:
        argv += ["--live-png", png]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deepbedmap_tpu_torch"] + argv,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI's train --live-term failed ({proc.returncode}):\n"
                             + proc.stdout[-4000:] + proc.stderr[-4000:])
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    spark = lines[:-1]
    per_epoch = len(spark) // LIVE_EPOCHS
    names = [line.split()[1] for line in spark]
    if res["command"] != "train" or res["epochs"] != LIVE_EPOCHS or not per_epoch or \
            len(spark) != per_epoch * LIVE_EPOCHS or \
            names != names[:per_epoch] * LIVE_EPOCHS or \
            len(set(names[:per_epoch])) != per_epoch or \
            [len(line.split()[2]) for line in spark[-per_epoch:]] != [LIVE_EPOCHS] * per_epoch:
        raise AssertionError("the CLI's train --live-term printed:\n" + proc.stdout[-4000:])
    if png and not os.path.getsize(png):
        raise AssertionError("--live-png wrote no PNG")
    for line in spark[-per_epoch:]:
        log(f"  | {line}")
    log(f"  CLI train --live-term{' --live-png' if png else ''}: {LIVE_EPOCHS} epochs x "
        f"{per_epoch} sparkline lines, then {res}; {wall:.1f} s wall  [{card_name}]")
    return {"sparkline_lines": len(spark), "png": bool(png), "wall_s": wall}


def trace_continent(card_name: str, params, tmp: str) -> dict:
    """Phase 25 (d): a ``torch.profiler`` trace of one warm default
    ``predict_continent`` on phase 6's region: K1's, K2's and K3's kernels
    among its CUDA kernel events, the top device operations, the longest
    idle gaps and the device's idle share. The traced run is not timed."""
    import glob

    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.utils.profiling import trace

    inputs, bounds, kw = continent_region()
    dbm = DeepBedMap(params, device=DEVICE)
    dbm.predict_continent(inputs, bounds, **kw)
    torch.cuda.synchronize()
    with trace(f"{tmp}/trace", device=DEVICE):
        dbm.predict_continent(inputs, bounds, **kw)
    files = glob.glob(f"{tmp}/trace/*.pt.trace.json")
    if len(files) != 1:
        raise AssertionError(f"trace files {files}")
    with open(files[0]) as f:
        summary = trace_summary(json.load(f)["traceEvents"])
    for wrapper, symbol in TRACE_SYMBOLS.items():
        hits = [n for n in summary["kernel_names"] if symbol in n]
        if not hits:
            raise AssertionError(f"{wrapper}'s kernel {symbol} is not in the trace")
        log(f"  {wrapper}: {len(hits)} kernel symbol(s) with {symbol} in the trace")
    log(f"  {summary['device_events']} device events over {summary['window_ms']:.2f} ms, "
        f"busy {summary['busy_ms']:.2f} ms: idle share {summary['idle_share']:.4f}  "
        f"[{card_name}]")
    for name, ms in summary["top_ops_ms"]:
        log(f"  top device op {ms:.3f} ms: {_short(name)}")
    for gap, before, after in summary["longest_gaps_ms"]:
        log(f"  idle gap {gap:.3f} ms after {_short(before, 40)} before {_short(after, 40)}")
    del summary["kernel_names"]
    return summary


def flop_shares(card_name: str, forward_ms: dict, train: dict) -> dict:
    """Phase 25 (e): the analytic FLOPs of each main path's forward (lr 288,
    batch 2) and of phase 22's train step over their CUDA-event times, as a
    share of the card's TF32 tensor-core peak. Log lines only."""
    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.utils.flops import generator_tile_flops, train_step_flops

    out = {}
    for config, ms in forward_ms.items():
        flops = TILES_PER_DISPATCH * generator_tile_flops(GeneratorConfig(**CONFIGS[config]),
                                                          288)["total"]
        out[f"forward_{config}"] = rate = flops / (ms / 1e3)
        log(f"  forward {config}: {flops / 1e12:.3f} TFLOP in {ms:.2f} ms = "
            f"{rate / 1e12:.2f} TFLOP/s, {100 * rate / PEAK_TF32_TC:.2f}% of the TF32 "
            f"tensor-core peak  [{card_name}]")
    ms = train["ms_per_step_median"]
    flops = train_step_flops(batch=TRAIN_BATCH)["total"]
    out["train_step"] = rate = flops / (ms / 1e3)
    log(f"  train step (batch {TRAIN_BATCH}): {flops / 1e12:.3f} TFLOP in {ms:.1f} ms = "
        f"{rate / 1e12:.2f} TFLOP/s, {100 * rate / PEAK_TF32_TC:.2f}% of the TF32 "
        f"tensor-core peak  [{card_name}]")
    return {k: v / PEAK_TF32_TC for k, v in out.items()}


def evaluation(card_name: str, region: dict, params, forward_ms: dict, train: dict,
               tmp: str) -> dict:
    """Phase 25: (a) to (e) (the module docstring lists their checks).
    Returns the numbers of its JSON line."""
    t0 = time.perf_counter()
    log("  (a) evaluation at full width: predict, baselines, track RMSE, roughness, "
        "hillshade, transects")
    out = evaluate_region(card_name, region)
    log("  (b) the figure set")
    out["figures"] = figures_phase(card_name, tmp)
    log("  (c) the CLI's train with live curves")
    out["live"] = live_curves(card_name, tmp)
    log("  (d) a torch.profiler trace of predict_continent")
    out["trace"] = trace_continent(card_name, params, tmp)
    log("  (e) FLOPs as a share of the TF32 tensor-core peak")
    out["tf32_peak_share"] = flop_shares(card_name, forward_ms, train)
    out["phase_wall_s"] = time.perf_counter() - t0
    log(f"  phase 25 wall time {out['phase_wall_s']:.1f} s  [{card_name}]")
    return out


# --- phase 26: the parallel layer ---------------------------------------------
# (a) world size 1 in this process (NCCL); (b) world size 2 on the one card:
# two processes of this script (``parallel_worker``), and the CLI's continent in
# two more pairs. NCCL refuses two ranks on one GPU, so (b) runs on Gloo unless
# a two-rank NCCL all-reduce on the card (``parallel_probe``) succeeds; the log
# says which ran. World 2 on one card measures correctness and the collectives'
# overhead, not scaling.
PARALLEL_WORLD = 2
PARALLEL_TIMEOUT_S = 300  # every process of (b); a hang fails the phase
PROBE_TIMEOUT_S = 90
DP_BATCH = TRAIN_BATCH  # the reference's 128: 64 rows per rank at world 2
TP_LR = 32  # the channel-parallel forward: a 32-px crop (output 120^2), batch 2
# the band-distributed product against the same options in one process: the
# same kernels on the same crops of the same card, so bit for bit is expected;
# at most 1 m on fewer than PRODUCT_DIFF_SHARE of the pixels would mean outputs
# that differ by round-off and round to different int16 metres
PRODUCT_DIFF_SHARE = 1e-5
# D's last bias: RaGAN compares each logit with the other side's mean, so a
# shift of every logit changes nothing and this gradient is 0 up to round-off
# (a few 1e-7 in either sum order), as in tests/test_torch_port_train.py
ZERO_GRADS = {"D.linear_2.bias": 1e-6}


def _spawn(args) -> subprocess.Popen:
    return subprocess.Popen(args, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _helper(fn: str, *args) -> list:
    return [sys.executable, "-c", f"import sys, chip_smoke; chip_smoke.{fn}(*sys.argv[1:])",
            *map(str, args)]


def _wait_all(procs: dict, timeout: float) -> dict:
    """name -> (returncode or None if it was killed at the deadline, stdout,
    stderr); every process still running at the deadline is killed."""
    deadline = time.monotonic() + timeout
    done = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            done[name] = (p.returncode, out, err)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            out, err = p.communicate()
            done[name] = (None, out, err)
    return done


def _require_ok(done: dict, what: str) -> None:
    bad = {k: v for k, v in done.items() if v[0] != 0}
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(
            f"{k} {'timed out' if rc is None else f'exited {rc}'}:\n{out[-2000:]}{err[-3000:]}"
            for k, (rc, out, err) in bad.items()))


def parallel_probe(rank: str, d: str) -> None:
    """Phase 26: one rank of a two-rank NCCL all-reduce on the one card."""
    import torch
    import torch.distributed as dist

    from deepbedmap_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{d}/probe_store", 2, int(rank), backend="nccl",
                           device=DEVICE, timeout_s=PROBE_TIMEOUT_S / 2)
    x = torch.ones(1, device=DEVICE)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print(f"probe rank {rank}: all_reduce {float(x)}", flush=True)


def parallel_worker(rank: str, world: str, d: str, backend: str) -> None:
    """Phase 26 (b): one rank of the world-2 run on the card, its group on
    ``backend`` over a ``file://`` store in ``d``. Saves rank 0's canvas,
    step and forward in ``d`` and every rank's counts and times in
    ``d/rank{r}.json``."""
    import torch
    import torch.distributed as dist

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.device import disable_tf32
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.parallel import (batch_sharding, distributed, make_mesh,
                                               make_mesh_2d, make_sharded_train_step,
                                               make_tp_forward, shard_params_tp)
    from deepbedmap_tpu_torch.train.state import create_gan_state

    rank, world = int(rank), int(world)
    disable_tf32()
    distributed.initialize(f"file://{d}/store", world, rank, backend=backend, device=DEVICE,
                           timeout_s=PARALLEL_TIMEOUT_S / 2)
    rec = {"backend": dist.get_backend(), "cuda_device": torch.cuda.current_device()}
    mesh = make_mesh(world, device=DEVICE)

    def timed(fn):
        dist.barrier()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # tile-sharded continent inference on phase 6's region and weights
    dbm = DeepBedMap(torch.load(f"{d}/params.pt", weights_only=True), cfg=GeneratorConfig(),
                     device=DEVICE)
    inputs, bounds, kw = continent_region()
    _kernels.reset_launches()
    raster, rec["continent_cold_s"] = timed(
        lambda: dbm.predict_continent(inputs, bounds, mesh=mesh, **kw))
    rec["continent_launches"] = dict(_kernels.launches)
    _, rec["continent_s"] = timed(lambda: dbm.predict_continent(inputs, bounds, mesh=mesh, **kw))
    if rank == 0:
        np.save(f"{d}/canvas.npy", raster.data)

    # the band-distributed streamed product on phase 20's region and generator
    prod = DeepBedMap(cfg=GeneratorConfig(init_scale=PRODUCT_INIT_SCALE), device=DEVICE)
    p_inputs, p_bounds = product_region()
    _kernels.reset_launches()
    rec["multihost_returned"], rec["multihost_s"] = timed(lambda: prod.predict_continent(
        p_inputs, p_bounds, outfilepath=f"{d}/multihost", tile_out=TILE_OUT, halo_lr=HALO_LR,
        multihost=True, stream_product=True))
    rec["multihost_launches"] = dict(_kernels.launches)

    # one data-parallel step at the reference's batch, 64 rows per rank
    t_cfg = TrainConfig(batch_size=DP_BATCH)
    state = create_gan_state(GeneratorConfig(), t_cfg=t_cfg, seed=0, device=DEVICE)
    step = make_sharded_train_step(mesh, t_cfg)
    local = batch_sharding(mesh)({k: torch.from_numpy(v).to(DEVICE)
                                  for k, v in train_batch(DP_BATCH, seed=26).items()})
    _kernels.reset_launches()
    (state, metrics), rec["dp_cold_s"] = timed(lambda: step(state, local))
    rec["dp_launches"] = dict(_kernels.launches)
    if rank == 0:
        torch.save({"tensors": _step_tensors(state, t_cfg.adam_beta1),
                    "metrics": {k: v.cpu() for k, v in vars(metrics).items()}}, f"{d}/dp.pt")
    _, rec["dp_step_s"] = timed(lambda: step(state, local))

    # the channel-parallel forward on a (1, 2) mesh, phase 20's generator
    mesh2 = make_mesh_2d(1, world, device=DEVICE)
    shards = shard_params_tp(mesh2, prod.model.state_dict())
    xs = [torch.from_numpy(a).to(DEVICE) for a in _crop_inputs(TP_LR, 2, seed=26)]
    with torch.no_grad():
        out, rec["tp_forward_s"] = timed(lambda: make_tp_forward(mesh2, prod.model, shards)(*xs))
    if rank == 0:
        np.save(f"{d}/tp.npy", out.cpu().numpy())
    with open(f"{d}/rank{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    print(f"parallel worker {rank} ok", flush=True)


def _dp_runs(t_cfg, mesh) -> dict:
    """Phase 26 (a): one step at DP_BATCH from the seeded state on one device
    (also from perturbed weights) and through ``make_sharded_train_step`` at
    world 1: name -> (``_step_tensors``, metrics, launches, warm step s);
    ``init``: the weights before the step."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.parallel import make_sharded_train_step
    from deepbedmap_tpu_torch.train.state import create_gan_state
    from deepbedmap_tpu_torch.train.steps import make_train_step

    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in train_batch(DP_BATCH, seed=26).items()}
    runs = {}
    for key in ("single", "perturbed", "world1"):
        state = create_gan_state(GeneratorConfig(), t_cfg=t_cfg, seed=0, device=DEVICE)
        if key == "single":
            runs["init"] = {f"{tag}{n}": p.detach().cpu().double()
                            for tag, model in (("G.", state.g), ("D.", state.d))
                            for n, p in model.named_parameters()}
        if key == "perturbed":
            gen = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in list(state.g.parameters()) + list(state.d.parameters()):
                    p.mul_(1 + PERTURB * torch.randn(p.shape, generator=gen).to(p.device))
        step = make_sharded_train_step(mesh, t_cfg) if key == "world1" else make_train_step(t_cfg)
        _kernels.reset_launches()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _kernels.launches.items() if v}
        tensors = _step_tensors(state, t_cfg.adam_beta1)
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        runs[key] = (tensors, metrics, launches, time.perf_counter() - t0)
    return runs


def parallel_phase(card_name: str, params, default_out, tmp: str,
                   world: int = PARALLEL_WORLD) -> dict:
    """Phase 26: (a) world size 1 on NCCL in this process: ``initialize``,
    ``make_mesh(1)``, ``predict_continent(mesh=)`` on phase 6's region and
    weights against phase 6's canvas, one ``make_sharded_train_step`` step at
    the reference's batch against the one-device step; (b) world size
    ``world``, one ``parallel_worker`` process per rank, rank r on card r
    modulo the cards present (world 2 on the one card here;
    ``chip_parallel.py`` runs one rank per card): the tile-sharded continent
    against phase 6's canvas, the band-distributed streamed product on phase
    20's region against the same options in this process, one data-parallel
    step at 128 / world rows per rank against the one-device step at 128, the
    channel-parallel forward on a (1, world) mesh against the one-device
    forward, and the CLI's ``continent --mesh-devices`` and ``--multihost``
    (world processes each) with rank 0's JSON line."""
    import torch
    import torch.distributed as dist

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.data import geotiff
    from deepbedmap_tpu_torch.inference import TilePlan
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.parallel import distributed, make_mesh
    from deepbedmap_tpu_torch.train.steps import StepMetrics

    t_start = time.perf_counter()
    res = {"card": card_name}
    inputs, bounds, kw = continent_region()
    plan = TilePlan(out_h=2 * TILE_OUT, out_w=2 * TILE_OUT, tile_out=TILE_OUT, halo_lr=HALO_LR)
    t_cfg = TrainConfig(batch_size=DP_BATCH)

    log("  (a) world size 1 in this process")
    if not distributed.initialize(device=DEVICE):
        raise AssertionError("a process group was already up before phase 26")
    res["world1_backend"] = dist.get_backend()
    mesh = make_mesh(1, device=DEVICE)
    dbm = DeepBedMap(params, cfg=GeneratorConfig(), device=DEVICE)
    _kernels.reset_launches()
    raster = dbm.predict_continent(inputs, bounds, mesh=mesh, **kw)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    # the buffered mesh path predicts one tile per forward, as JAX's does
    log(f"  launches in predict_continent(mesh=make_mesh(1)) ({plan.num_tiles} forwards, "
        f"backend {res['world1_backend']}): {launches}")
    check_launches(launches, _expected_launches(plan.num_tiles))
    compare(f"world 1: predict_continent(mesh=) vs phase 6's canvas",
            torch.from_numpy(raster.data), default_out, TOL_SEAM)
    t0 = time.perf_counter()
    dbm.predict_continent(inputs, bounds, mesh=mesh, **kw)
    torch.cuda.synchronize()
    res["continent_ms_per_tile"] = {"1": 1e3 * (time.perf_counter() - t0) / plan.num_tiles}
    runs = _dp_runs(t_cfg, mesh)
    check_launches(runs["world1"][2], {k: v for k, v in per_step("default", 12).items() if v})
    single, pert, init = runs["single"], runs["perturbed"], runs["init"]
    hold_step(f"world 1: make_sharded_train_step at batch {DP_BATCH}", runs["world1"][0],
              single[0], pert[0], (runs["world1"][1], single[1], pert[1]), init, t_cfg,
              who="1-rank step", ref="the one-device step", floors=ZERO_GRADS)
    res["dp_step_ms"] = {"1": 1e3 * runs["world1"][3]}
    res["single_step_ms"] = 1e3 * single[3]
    dist.destroy_process_group()
    log(f"  world 1 ({res['world1_backend']}): predict_continent(mesh=) "
        f"{res['continent_ms_per_tile']['1']:.1f} ms/tile warm; DP step "
        f"{res['dp_step_ms']['1']:.1f} ms, one-device step {res['single_step_ms']:.1f} ms at "
        f"batch {DP_BATCH}  [{card_name}]")

    log(f"  (b) world size {world} on {torch.cuda.device_count()} card(s)")
    d = f"{tmp}/parallel"
    os.makedirs(f"{d}/region")
    torch.save({k: v.cpu() for k, v in params.items()}, f"{d}/params.pt")
    for k, v in inputs.items():
        np.save(f"{d}/region/{k}.npy", v)
    probe = _wait_all({r: _spawn(_helper("parallel_probe", r, d)) for r in range(2)},
                      PROBE_TIMEOUT_S)
    if all(v[0] == 0 for v in probe.values()):
        backend = "nccl"
        res["nccl_probe"] = "ran"
    else:
        backend = "gloo"
        why = [(v[2].strip().splitlines() or ["(no stderr)"])[-1] for v in probe.values()]
        res["nccl_probe"] = "refused: " + why[0][:300]
    cards = "one card" if torch.cuda.device_count() == 1 else "two cards"
    log(f"  NCCL with two ranks on {cards}: {res['nccl_probe']}; world {world} runs on "
        f"{backend}")
    t0 = time.perf_counter()
    done = _wait_all({f"worker{r}": _spawn(_helper("parallel_worker", r, world, d, backend))
                      for r in range(world)}, PARALLEL_TIMEOUT_S)
    res[f"world{world}_wall_s"] = time.perf_counter() - t0
    _require_ok(done, f"phase 26's world-{world} workers")
    # the CLI's processes after the workers, so that they do not share the
    # card with the timed runs
    procs = {}
    cli_base = ["-m", "deepbedmap_tpu_torch", "continent", "--inputs", f"{d}/region",
                "--bounds", ",".join(map(str, bounds)), "--device", DEVICE, "--stream",
                "--tile-out", str(TILE_OUT), "--halo-lr", str(HALO_LR),
                "--num-processes", str(world), "--backend", backend]
    for name, extra in (("cli_mesh", ["--mesh-devices", str(world)]),
                        ("cli_multihost", ["--multihost"])):
        for r in range(world):
            procs[f"{name}{r}"] = _spawn([sys.executable, *cli_base, "-o", f"{d}/{name}",
                                          "--coordinator", f"file://{d}/store_{name}",
                                          "--process-id", str(r), *extra])
    done.update(_wait_all(procs, PARALLEL_TIMEOUT_S))
    _require_ok(done, f"phase 26's world-{world} CLI runs")
    recs = []
    for r in range(world):
        with open(f"{d}/rank{r}.json") as f:
            recs.append(json.load(f))
    res[f"world{world}_backend"] = recs[0]["backend"]
    cards = [r % torch.cuda.device_count() for r in range(world)]
    if [(x["backend"], x["cuda_device"]) for x in recs] != [(backend, c) for c in cards]:
        raise AssertionError(f"the ranks ran on {[(x['backend'], x['cuda_device']) for x in recs]}")
    per_rank = plan.grid[0] * -(-plan.grid[1] // world)  # each band's tiles over the ranks
    for r, x in enumerate(recs):
        log(f"  rank {r}: launches in predict_continent(mesh=make_mesh({world})) ({per_rank} "
            f"forwards): {x['continent_launches']}; in the band-distributed product: "
            f"{x['multihost_launches']}; in the DP step: {x['dp_launches']}")
        check_launches(x["continent_launches"], _expected_launches(per_rank))
        check_launches({k: v for k, v in x["dp_launches"].items() if v},
                       {k: v for k, v in per_step("default", 12).items() if v})
    compare(f"world {world}: predict_continent(mesh=) vs phase 6's canvas",
            torch.from_numpy(np.load(f"{d}/canvas.npy")), default_out, TOL_SEAM)
    res["continent_ms_per_tile"][str(world)] = 1e3 * recs[0]["continent_s"] / plan.num_tiles

    prod = DeepBedMap(cfg=GeneratorConfig(init_scale=PRODUCT_INIT_SCALE), device=DEVICE)
    p_inputs, p_bounds = product_region()
    if any(x["multihost_returned"] is not None for x in recs):  # streamed: no Raster
        raise AssertionError(f"the multihost product returned "
                             f"{[x['multihost_returned'] for x in recs]}")
    t0 = time.perf_counter()
    prod.predict_continent(p_inputs, p_bounds, outfilepath=f"{d}/single", tile_out=TILE_OUT,
                           halo_lr=HALO_LR, multihost=True, stream_product=True)
    torch.cuda.synchronize()
    res["single_product_s"] = time.perf_counter() - t0
    res["multihost_product_s"] = recs[0]["multihost_s"]
    got, _ = geotiff.read_geotiff(f"{d}/multihost.tif")
    want, _ = geotiff.read_geotiff(f"{d}/single.tif")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    res["product_max_int16_diff"] = int(diff.max())
    res["product_pixels_differing"] = int((diff > 0).sum())
    with open(f"{d}/multihost.tif", "rb") as a, open(f"{d}/single.tif", "rb") as b:
        res["product_bytes_equal"] = a.read() == b.read()
    log(f"  world {world} band-distributed product vs the same options in one "
        f"process: largest int16 difference {res['product_max_int16_diff']} m on "
        f"{res['product_pixels_differing']} of {diff.size} pixels, bytes equal "
        f"{res['product_bytes_equal']}; wall {res['multihost_product_s']:.3f} s vs "
        f"{res['single_product_s']:.3f} s  [{card_name}]")
    if got.shape != want.shape or diff.max() > 1 or (diff > 0).mean() >= PRODUCT_DIFF_SHARE:
        raise AssertionError("the band-distributed product differs from one process's")

    saved = torch.load(f"{d}/dp.pt", weights_only=True)
    hold_step(f"world {world}: make_sharded_train_step at {DP_BATCH // world} "
              f"rows per rank", saved["tensors"], single[0], pert[0],
              (StepMetrics(**saved["metrics"]), single[1], pert[1]), init, t_cfg,
              who=f"{world}-rank step", ref="the one-device step",
              floors=ZERO_GRADS)
    res["dp_step_ms"][str(world)] = 1e3 * recs[0]["dp_step_s"]

    xs = [torch.from_numpy(a).to(DEVICE) for a in _crop_inputs(TP_LR, 2, seed=26)]
    with torch.inference_mode():
        want_tp = prod.model(*xs).cpu()
    compare(f"world {world}: make_tp_forward on a (1, {world}) mesh vs the "
            "one-device forward", torch.from_numpy(np.load(f"{d}/tp.npy")), want_tp,
            TOL_GENERATOR)
    res["tp_forward_ms"] = 1e3 * recs[0]["tp_forward_s"]

    for name, sharded in (("cli_mesh", True), ("cli_multihost", False)):
        lines = [done[f"{name}{r}"][1].strip().splitlines() for r in range(world)]
        line = json.loads(lines[0][-1])
        want_line = {"command": "continent", "bounds": list(bounds), "out": f"{d}/{name}.tif",
                     "sharded": sharded, "streamed": True, "processes": world}
        if line != want_line or any(lines[1:]):
            raise AssertionError(f"the CLI's {name}: rank 0 printed {line}, the others "
                                 f"{lines[1:]}")
        dem, _ = geotiff.read_geotiff(f"{d}/{name}.tif")
        if dem.shape != (plan.out_h, plan.out_w):
            raise AssertionError(f"the CLI's {name} product has shape {dem.shape}")
        log(f"  the CLI's continent ({name}, {world} processes): rank 0 printed "
            f"{line}, the others nothing")
    res["phase_wall_s"] = time.perf_counter() - t_start
    log(f"  world {world} ({res[f'world{world}_backend']}): predict_continent(mesh=) "
        f"{res['continent_ms_per_tile'][str(world)]:.1f} ms/tile warm; DP step "
        f"{res['dp_step_ms'][str(world)]:.1f} ms; TP forward {res['tp_forward_ms']:.1f} ms; its "
        f"workers {res[f'world{world}_wall_s']:.1f} s wall; phase 26 wall time "
        f"{res['phase_wall_s']:.1f} s  [{card_name}]")
    return res


# --- phase 27: the generator options -------------------------------------------

OPTIONS = ("bf16", "phase", "hcw", "plain", "plain16")
# JAX's own bound on a bf16 forward's distance from the float32 one
# (tests/test_models.py:154-194), relative to the float32 output's range
TOL_BF16 = 2e-2
# the bf16 train step card vs CPU: 2 RRDBs (the CPU's bf16 step at batch
# 128 takes ~33 s), the reference's batch, the generator drawn at init scale
# 1.0 as the tier-1 bf16 step test draws it (at 0.1 the fake is ~1e-5 m and
# D's train-mode BatchNorm normalises round-off)
OPTION_STEP_BLOCKS, OPTION_STEP_INIT = 2, 1.0
# fit: 420 synthetic tiles, 3 steps of 128 and one dev batch, 12 RRDBs
OPTION_FIT_TILES, OPTION_TIMED_STEPS = 420, 5


def hold_bf16(label: str, got, want16, want32) -> dict:
    """A bf16 (or float16) result against the reference at that dtype
    ``want16``: nearer it than ``want16`` lies to the float32 result
    ``want32`` (so ``got`` ran the reduced-precision path), and both
    distances within ``TOL_BF16`` of ``want32``'s range."""
    import torch

    for name, t in (("got", got), ("reference", want16)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite values in {name}")
    d_got = float((got.double() - want16.double()).abs().max())
    d_ref = float((want16.double() - want32.double()).abs().max())
    scale = float(want32.abs().max())
    log(f"  {label}: {d_got:.3e} from the reference at its compute dtype, which lies "
        f"{d_ref:.3e} from float32 (ratio {d_got / d_ref:.3g}; tolerance {TOL_BF16:g} x "
        f"{scale:.3e})")
    if not (d_got < d_ref and d_ref <= TOL_BF16 * scale and d_got <= TOL_BF16 * scale):
        raise AssertionError(f"{label}: {d_got:.3e} / {d_ref:.3e} outside the bf16 rule")
    return {"err": d_got, "bf16_vs_fp32": d_ref, "range": scale}


def option_card_vs_cpu(config: str) -> dict:
    """The 12-RRDB generator in ``config`` on phase 5's crop, the card
    against the CPU (init scale 0.1, seeded): within ``TOL_GENERATOR``, or
    under bf16 by ``hold_bf16`` against the CPU's bf16 and float32 forwards."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.models import build_generator

    flags = CONFIGS[config]
    cpu_model = build_generator(GeneratorConfig(**flags), seed=0, device="cpu").eval()
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    xs = [torch.from_numpy(a) for a in _crop_inputs(GEN_LR, 1, seed=1)]
    with torch.inference_mode():
        want = cpu_model(*xs)
        got = gpu_model(*[a.to(DEVICE) for a in xs]).cpu()
        label = f"generator 12 RRDB {flags}, {GEN_LR}-px crop, card vs CPU"
        if flags.get("compute_dtype") != "bfloat16":
            return {"err": compare(label, got, want, TOL_GENERATOR)}
        fp32 = GeneratorConfig(**{k: v for k, v in flags.items() if k != "compute_dtype"})
        cpu32 = build_generator(fp32, seed=0, device="cpu").eval()
        cpu32.load_state_dict(cpu_model.state_dict())
        return hold_bf16(label, got, want, cpu32(*xs))


def option_kernels(name: str, model, xs) -> dict:
    """The kernels of ``model``'s configuration (K1; K2 and K3, or K7 and
    K8) on the inputs its own forward gives them at the main path's shapes,
    each against its plain version on the card within ``TOL_KERNEL``; the
    forward is replayed stage by stage, with the layers' own dispatch
    (``deform_conv2d``'s 'auto': the kernels on the card), and its output
    must equal ``model.tail``'s bit for bit, so these are the path's own
    inputs."""
    import torch

    from deepbedmap_tpu_torch.config import trunk_kernel
    from deepbedmap_tpu_torch.ops.conv import conv_nhwc, leaky_relu
    from deepbedmap_tpu_torch.ops.deform_conv import (
        deform_conv2d,
        deform_conv_shifts,
        deform_conv_shifts_zproj,
        sample_tap_fields,
        tap_projection,
    )
    from deepbedmap_tpu_torch.ops.rdb import rdb_fused, rdb_reference
    from deepbedmap_tpu_torch.ops.tail import deform64_lrelu, deform_zproj1

    cfg, dt = model.cfg, model.dtype
    clamp = cfg.deform_clamp
    errs = {}
    with torch.inference_mode():
        a1 = model.head(*xs)
        if trunk_kernel(cfg) == "rdb":
            rdb = model.residual_network[0].residual_dense_block1
            ks = [c.weight for c in rdb.convs()]
            bs = [c.bias for c in rdb.convs()]
            x = a1.float().contiguous()
            errs["rdb_forward"] = compare(
                f"{name}: K1 rdb_forward {tuple(x.shape)} (the path's input)",
                rdb_fused(x, ks, bs, rdb.residual_scaling),
                rdb_reference(x, ks, bs, rdb.residual_scaling), TOL_KERNEL)
        a4 = model.upsample(model.trunk(a1), a1)
        want = model.tail(a4)
        l1, l2 = model.final_conv_layer1, model.final_conv_layer2
        o1k, o1b, w1, b1 = l1.tensors()
        o2k, o2b, w2, b2 = l2.tensors()
        # the tail's steps, in its order, dtypes and layouts
        x_in = a4.permute(0, 1, 3, 2) if cfg.tail_hcw else a4
        off1 = conv_nhwc(x_in, o1k, o1b, 1, dt).float().contiguous()
        x = x_in.float().contiguous()
        if cfg.tail_fused:
            a5 = deform64_lrelu(x, off1, w1, b1, clamp)
            plain = leaky_relu(deform_conv_shifts(x, off1, w1, b1, 1, clamp))
            k64, k1 = "deform64_lrelu", "deform_zproj1"
        else:
            a5 = deform_conv2d(x, off1, w1, b1, 1, clamp)
            plain = deform_conv_shifts(x, off1, w1, b1, 1, clamp)
            k64, k1 = "deform_conv", "deform_conv_zproj1"
        errs[k64] = compare(f"{name}: {k64} {tuple(x.shape)} (the path's input)", a5, plain,
                            TOL_KERNEL)
        del plain
        if not cfg.tail_fused:  # the LeakyReLU on the layer's (view of its) output
            a5 = (leaky_relu(a5.permute(0, 1, 3, 2)).permute(0, 1, 3, 2) if cfg.tail_hcw
                  else leaky_relu(a5))
        off2 = conv_nhwc(a5, o2k, o2b, 1, dt).float().contiguous()
        if cfg.tail_fused:
            z = tap_projection(a5, w2)
            out = deform_zproj1(z, off2, b2, clamp)
            plain = sample_tap_fields(z[..., None], off2, b2, 1, clamp)
        else:
            a5 = a5.float().contiguous()
            out = deform_conv2d(a5, off2, w2, b2, 1, clamp)
            plain = deform_conv_shifts_zproj(a5, off2, w2, b2, 1, clamp)
        errs[k1] = compare(f"{name}: {k1} {tuple(a5.shape)} -> 1 (the path's input)", out,
                           plain, TOL_KERNEL)
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: the replayed tail differs from the model's")
    return errs


def bf16_step_card_vs_cpu(card_name: str) -> dict:
    """Phase 27 (c): one bf16 train step (``OPTION_STEP_*``, batch
    ``TRAIN_BATCH``) from the same seeded weights and tiles on the card and
    on the CPU, and the CPU's float32 step from the same weights. A bf16
    step's round-off is bf16's, which a 1e-5 perturbation of the float32
    weights barely reaches (it moves ~0.5% of their bf16 roundings), so
    ``hold_step`` takes the float32 step as its ``other``: each metric,
    gradient and BatchNorm statistic within ``NOISE_K`` x the bf16 step's own
    distance from the float32 one, D's accuracy (a share of 2 x batch sign
    decisions) also within ``NOISE_K`` decisions and D's last bias within
    ``ZERO_GRADS``, as phase 26's; and G's gradients, summed
    over every element, nearer the CPU's bf16 step than that lies to its
    float32 one: the card ran the bf16 path. The update is checked on the
    card's own moments, as phase 22's."""
    import dataclasses

    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.train.state import create_gan_state
    from deepbedmap_tpu_torch.train.steps import make_train_step

    blocks, batch = OPTION_STEP_BLOCKS, TRAIN_BATCH
    g16 = GeneratorConfig(num_residual_blocks=blocks, init_scale=OPTION_STEP_INIT,
                          **CONFIGS["bf16"])
    t_cfg = TrainConfig(batch_size=batch)
    arrays = train_batch(batch, seed=blocks)
    step = make_train_step(t_cfg)
    runs = {}
    for key, g_cfg, dev in (("cpu", g16, "cpu"),
                            ("fp32", dataclasses.replace(g16, compute_dtype="float32"), "cpu"),
                            ("card", g16, DEVICE)):
        state = create_gan_state(g_cfg, t_cfg=t_cfg, seed=0, device=dev)
        if key == "card":
            init = {f"{tag}{n}": p.detach().cpu().double()
                    for tag, model in (("G.", state.g), ("D.", state.d))
                    for n, p in model.named_parameters()}
        b = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        _kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[key] = (_step_tensors(state, t_cfg.adam_beta1), metrics,
                     time.perf_counter() - t0)
    launches = {k: v for k, v in _kernels.launches.items() if v}
    (cpu, m_cpu, s_cpu), (fp32, m_fp32, _), (card, m_card, s_card) = (
        runs["cpu"], runs["fp32"], runs["card"])
    tag = f"bf16, {blocks} RRDB, batch {batch}, init {OPTION_STEP_INIT}"
    log(f"  train step {tag}: card {s_card:.2f} s (cold), CPU {s_cpu:.2f} s; card launches "
        f"{launches}")
    check_launches(launches, {k: v for k, v in per_step("bf16", blocks).items() if v})
    worst, floored = hold_step(
        tag, card, cpu, fp32, (m_card, m_cpu, m_fp32), init, t_cfg,
        floors={**ZERO_GRADS, "discriminator_accu": NOISE_K / (2 * batch)},
        noise="float32 compute in place of bf16 (the same weights)")
    g_names = [k for k in cpu if k.startswith("G.")]
    d_card = sum(float((card[k]["grad"] - cpu[k]["grad"]).abs().sum()) for k in g_names)
    d_ref = sum(float((cpu[k]["grad"] - fp32[k]["grad"]).abs().sum()) for k in g_names)
    log(f"  {tag}: G's gradients {d_card:.3e} from the CPU's bf16 step, which lies "
        f"{d_ref:.3e} from its float32 one (ratio {d_card / d_ref:.3g})")
    if not d_card < d_ref:
        raise AssertionError(f"{tag}: the card's bf16 gradients are not nearer the CPU's "
                             "bf16 step than its float32 one")
    return {"launches": launches, "worst_grad": worst["grad"][0],
            "worst_stats": worst["stats"][0], "floored": floored,
            "g_grad_ratio": d_card / d_ref, "cpu_s": s_cpu}


def option_training(card_name: str) -> dict:
    """Phase 27 (c): bf16 training. One step card vs CPU
    (``bf16_step_card_vs_cpu``), then ``fit`` at 12 RRDBs and batch 128 on
    the card with its launch counts, and warm steps timed."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.data.dataset import TileDataset
    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.train.loop import fit
    from deepbedmap_tpu_torch.train.state import create_gan_state
    from deepbedmap_tpu_torch.train.steps import make_train_step

    out = {"step": bf16_step_card_vs_cpu(card_name)}
    t_cfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=1)
    state = create_gan_state(GeneratorConfig(**CONFIGS["bf16"]), t_cfg=t_cfg, seed=0,
                             device=DEVICE)
    if any(p.dtype != torch.float32 for p in state.g.parameters()):
        raise AssertionError("bf16 training keeps float32 parameters")
    dataset = TileDataset.synthetic(OPTION_FIT_TILES, seed=0, device=DEVICE)
    _kernels.reset_launches()
    state, history = fit(state, dataset, t_cfg)
    launches = {k: v for k, v in _kernels.launches.items() if v}
    steps = (OPTION_FIT_TILES * 95 // 100) // TRAIN_BATCH
    check_launches(launches, {"deform64_lrelu": 2 * steps + 1, "deform_zproj1": 2 * steps + 1,
                              "deform64_bwd": steps, "deform_zproj1_bwd": steps})
    for rec in history:
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"non-finite bf16 training metrics {rec}")
        log("  bf16 fit, epoch " + ", ".join(f"{k} {v:.5g}" for k, v in rec.items()))
    times = _timed_steps(make_train_step(t_cfg), state, dataset, np.random.RandomState(1),
                         OPTION_TIMED_STEPS)
    out.update(fit_launches=launches, ms_per_step_median=float(np.median(times)),
               ms_per_step_all=times)
    log(f"  bf16 fit: {steps} steps + a dev batch, launches {launches}; median warm step "
        f"{out['ms_per_step_median']:.1f} ms of {OPTION_TIMED_STEPS} at batch {TRAIN_BATCH}, "
        f"12 RRDBs ({1e3 * TRAIN_BATCH / out['ms_per_step_median']:.0f} tiles/s)  "
        f"[{card_name}]")
    return out


def generator_options(card_name: str, params, default_out) -> dict:
    """Phase 27: each of ``OPTIONS`` through ``predict_continent`` on phase
    6's region at 12 RRDBs and full width (``main_path``: exact launches,
    tiled vs untiled, the canvas against phase 6's default one within
    ``TOL_GENERATOR``, or bf16's within ``TOL_BF16``; the growth-16 trunk
    has weights of its own), the generator card vs CPU, the path's kernels
    on its own inputs, the FLOP share of its forward, and bf16 training.
    Returns the numbers of the options JSON line."""
    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.inference import TilePlan
    from deepbedmap_tpu_torch.utils.flops import (
        H100_BF16_TC_PEAK_FLOPS,
        generator_tile_flops,
    )

    t_start = time.perf_counter()
    out = {"card": card_name}
    plan = TilePlan(out_h=2 * TILE_OUT, out_w=2 * TILE_OUT, tile_out=TILE_OUT,
                    halo_lr=HALO_LR)
    xs = [torch.from_numpy(a).to(DEVICE)
          for a in _crop_inputs(plan.crop_lr, TILES_PER_DISPATCH, seed=3)]
    for name in OPTIONS:
        flags = CONFIGS[name]
        bf16 = flags.get("compute_dtype") == "bfloat16"
        log(f"  {name}: {flags}")
        own = flags.get("growth_channels", 32) != 32  # other shapes: seeded weights
        r = main_path(card_name, name, None if own else params, None if own else default_out,
                      TOL_BF16 if bf16 else TOL_GENERATOR)
        res = {"launches": r["launches"], "tile_ms": r["tile_ms"],
               "forward_ms": r["forward_ms"], "stages_ms": r["stages_ms"]}
        if not own:
            res["vs_default"] = float((r["out"].double() - default_out.double()).abs().max())
            res["default_range"] = float(default_out.abs().max())
            log(f"  {name}: canvas {res['vs_default']:.3e} from the default's (range "
                f"{res['default_range']:.3e})")
        if flags.get("tail_hcw"):
            # the layout's cost: the same weights with the NHWC unfused tail
            nhwc = DeepBedMap(params, cfg=GeneratorConfig(tail_fused=False), device=DEVICE)
            res["nhwc_stages_ms"] = forward_breakdown(nhwc.model, xs)
            for stage, ms in res["nhwc_stages_ms"].items():
                log(f"  the NHWC unfused tail's forward, {stage}: {ms:.2f} ms  [{card_name}]")
            del nhwc
        res["card_vs_cpu"] = option_card_vs_cpu(name)
        res["kernel_err"] = option_kernels(name, r["model"], xs)
        flops = TILES_PER_DISPATCH * generator_tile_flops(GeneratorConfig(**flags),
                                                          plan.crop_lr)["total"]
        peak, peak_name = ((H100_BF16_TC_PEAK_FLOPS, "bf16") if bf16 else
                           (PEAK_TF32_TC, "TF32"))
        rate = flops / (r["forward_ms"] / 1e3)
        res["flop_share"] = rate / peak
        log(f"  {name}: {r['tile_ms']:.1f} ms/tile warm; forward {flops / 1e12:.3f} TFLOP in "
            f"{r['forward_ms']:.2f} ms = {rate / 1e12:.2f} TFLOP/s, "
            f"{100 * res['flop_share']:.2f}% of the {peak_name} tensor-core peak  "
            f"[{card_name}]")
        out[name] = res
        del r
        torch.cuda.empty_cache()
    log("  bf16 training: a step card vs CPU, then fit on the card")
    out["bf16_training"] = option_training(card_name)
    out["phase_wall_s"] = time.perf_counter() - t_start
    log(f"  phase 27 wall time {out['phase_wall_s']:.1f} s  [{card_name}]")
    return out


# --- phase 28: the kernels' bf16-multiplicand routes and the last surfaces ---

# The bf16 routes (K1, K4, K5, K6, K10 with mxu_bf16) against their plain
# versions on bf16-rounded operands on the card: products of bf16 values are
# exact in fp32, so only the sum order differs, and where a later stage
# rounds a sum that lies on a bf16 boundary the two round it to neighbouring
# bf16 values (a flip) and carry that on. With the dense blocks' weights at
# MXU_WEIGHT_SCALE (the generator's init scale 0.1 gives ~0.006; at 0.05
# each conv amplifies and a flip in an RRDB's first block spreads over most
# of its third's outputs) the mean difference stays within TOL_MXU_MEAN of
# the range (measured 1e-8 to 7e-8 at the main-path shapes, NVIDIA H100 80GB
# HBM3, 700 W) and the largest, a few flips' tail, within TOL_MXU_MAX (up to
# 9.1e-6 measured at (2,286,286,64)); an indexing or layout fault is of the
# order of the range. The 3xTF32 kernel's mean distance from the rounded
# plain version must exceed TOL_MXU_MEAN, which shows the cast is live (5e-6
# to 3e-4 measured). tests/test_torch_port_mxu_bf16.py holds the CPU to JAX
# by the same rule
TOL_MXU_MAX, TOL_MXU_MEAN = 5e-5, 1e-6
MXU_WEIGHT_SCALE = 0.01
# the residual scaling of those checks, JAX's tests' 0.2: at 0.1 a whole
# RRDB's convs reach its output at 0.01 and the 3xTF32 kernel's distance from
# the rounded plain version falls under TOL_MXU_MAX
MXU_SCALING = 0.2
MXU_CONFIGS = ("k1_mxu", "k4_mxu", "k6_mxu", "k5_mxu")
# the generators card vs CPU: a 32-px crop (latent 30^2), 12 RRDBs
MXU_GEN_LR = 32
# the determinism finding: one 12-RRDB step at the reference's batch, in a
# process of its own (cuBLAS reads CUBLAS_WORKSPACE_CONFIG when it starts)
DET_BATCH = TRAIN_BATCH
DET_TIMED_STEPS = 5  # warm steps timed in each setting
DET_TIMEOUT_S = 300
MODE_TIMING_ROUNDS = 3  # rounds of default, mode, mode, default


def bound_bf16(mm_flops: float, nbytes: float) -> dict:
    """``bound`` for work on bf16 multiplicands: the matrix products at the
    bf16 tensor-core peak (the least time the card could take for them),
    against the bytes."""
    t_mm = 1e3 * mm_flops / PEAK_BF16_TC
    t_bytes = 1e3 * nbytes / PEAK_HBM_BYTES
    return {"bound_ms": max(t_mm, t_bytes),
            "bound_by": "operations" if t_mm >= t_bytes else "bytes",
            "bound_route": "bf16 tensor cores" if t_mm >= t_bytes else "HBM bytes"}


def hold_mxu(label: str, got, want, tf32x3) -> dict:
    """A bf16 route ``got`` against its plain version on rounded operands
    ``want``, by the rule above; ``tf32x3`` is the 3xTF32 kernel on the same
    inputs."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite values")
    scale = float(want.abs().max())
    d = (got.double() - want.double()).abs()
    d32 = (tf32x3.double() - want.double()).abs()
    err, mean = float(d.max()), float(d.mean())
    log(f"  {label}: max_abs_err {err:.3e} = {err / scale:.3e} of the range {scale:.3e}, "
        f"mean {mean / scale:.3e} (tolerances {TOL_MXU_MAX:g}, {TOL_MXU_MEAN:g}); the "
        f"3xTF32 kernel: {float(d32.max()) / scale:.3e}, mean {float(d32.mean()) / scale:.3e}; "
        f"route vs 3xTF32 {float((got - tf32x3).abs().max()) / scale:.3e}")
    if not (err <= TOL_MXU_MAX * scale and mean <= TOL_MXU_MEAN * scale):
        raise AssertionError(f"{label}: bf16 route outside its tolerance")
    if not float(d32.mean()) > TOL_MXU_MEAN * scale:
        raise AssertionError(f"{label}: the 3xTF32 kernel is as near the rounded plain "
                             "version as the bf16 route: the cast is not live")
    return {"max_abs_err": err, "mean_rel_err": mean / scale}


def _mxu_dense(kind: str, shape, gen, timed: bool) -> dict:
    """K1 (``rdb_fused``), K6 (``rdb_banded``), K4 (``rrdb_fused``) or K5
    (``rrdb_sweep``) in the mode, beside the same kernel's 3xTF32 route."""
    import torch

    from deepbedmap_tpu_torch.ops import rdb

    fn = getattr(rdb, kind)
    blocks = 3 if kind.startswith("rrdb") else 1
    ref = rdb.rdb_reference if blocks == 1 else rdb.rrdb_reference
    f, g = 64, 32
    cins, couts = [f + g * j for j in range(5)], [g, g, g, g, f]
    kernels = [[_randn((co, ci, 3, 3), gen, MXU_WEIGHT_SCALE) for ci, co in zip(cins, couts)]
               for _ in range(blocks)]
    biases = [[_randn((co,), gen, 0.1) for co in couts] for _ in range(blocks)]
    if blocks == 1:
        kernels, biases = kernels[0], biases[0]
    x = _randn(shape, gen)
    got = fn(x, kernels, biases, MXU_SCALING, True)
    want = ref(x, kernels, biases, MXU_SCALING, mxu_bf16=True)
    other = fn(x, kernels, biases, MXU_SCALING)
    torch.cuda.synchronize()
    res = hold_mxu(f"{kind} bf16 route {shape}", got, want, other)
    del got, want, other
    if timed:
        res["ms"] = time_ms(lambda: fn(x, kernels, biases, MXU_SCALING, True), 10)
        res["tf32x3_ms"] = time_ms(lambda: fn(x, kernels, biases, MXU_SCALING), 10)
        res["plain_ms"] = time_ms(lambda: ref(x, kernels, biases, MXU_SCALING, mxu_bf16=True), 10)
        flat = sum(kernels + biases, []) if blocks == 3 else kernels + biases
        res.update(bound_bf16(blocks * 2 * (x.numel() // 64) * RDB_MACS,
                              4 * (2 * x.numel() + _numel(*flat))), library_ms=None)
    return res


def _mxu_conv(shape, gen, timed: bool) -> dict:
    """K10 in the mode at one shape, beside its 3xTF32 route; timed, also
    two library yardsticks: cuDNN's bare ``F.conv2d`` on tensors already in
    bf16 (``library_ms``: half the bytes read, bf16 written, no bias,
    residual or LeakyReLU), and the whole function in PyTorch calls
    (``library_fn_ms``: ``x.bfloat16()``, cuDNN's bf16 conv, ``.float()``,
    + bias [+ residual] [LeakyReLU])."""
    import torch
    import torch.nn.functional as F

    from deepbedmap_tpu_torch.ops.conv3x3 import conv3x3_fused, conv3x3_reference

    n, h, w, cin, leaky, residual = shape
    x = _randn((n, h, w, cin), gen)
    wt, b = _randn((64, cin, 3, 3), gen, 0.05), _randn((64,), gen, 0.1)
    r = _randn((n, h, w, 64), gen) if residual else None
    got = conv3x3_fused(x, wt, b, leaky, r, True)
    want = conv3x3_reference(x, wt, b, leaky, r, True)
    other = conv3x3_fused(x, wt, b, leaky, r)
    torch.cuda.synchronize()
    res = hold_mxu(f"conv3x3_forward bf16 route {(n, h, w, cin)}, leaky {leaky}, residual "
                   f"{residual}", got, want, other)
    del got, want, other
    if timed:
        res["ms"] = time_ms(lambda: conv3x3_fused(x, wt, b, leaky, r, True), 10)
        res["tf32x3_ms"] = time_ms(lambda: conv3x3_fused(x, wt, b, leaky, r), 10)
        res["plain_ms"] = time_ms(lambda: conv3x3_reference(x, wt, b, leaky, r, True), 10)
        xb = x.permute(0, 3, 1, 2).bfloat16()  # channels_last, as the port keeps it
        wb, bb = wt.bfloat16(), b.bfloat16()
        res["library_ms"] = time_ms(lambda: F.conv2d(xb, wb, bb, padding=1), 10)
        xn = x.permute(0, 3, 1, 2)

        def whole():
            z = F.conv2d(xn.bfloat16(), wb, padding=1).float().permute(0, 2, 3, 1) + b
            if r is not None:
                z = z + r
            return F.leaky_relu(z, 0.2) if leaky else z

        res["library_fn_ms"] = time_ms(whole, 10)
        res.update(bound_bf16(2 * n * h * w * 9 * cin * 64,
                              4 * (x.numel() + n * h * w * 64 * (2 if residual else 1)
                                   + _numel(wt, b))))
    return res


def mxu_kernels(card_name: str) -> dict:
    """Phase 28 (a): each bf16 route at the ragged shapes and the main-path
    shapes (K10's four calls of one forward, summed), held to its plain
    version on rounded operands, and timed beside its 3xTF32 route."""
    import torch

    gen = torch.Generator().manual_seed(28)
    out = {}
    for name, kind in (("rdb_forward_bf16", "rdb_fused"), ("rrdb_forward_bf16", "rrdb_fused"),
                       ("rdb_banded_forward_bf16", "rdb_banded"),
                       ("rrdb_sweep_forward_bf16", "rrdb_sweep")):
        _mxu_dense(kind, RAGGED_RDB, gen, False)
        out[name] = _mxu_dense(kind, MAIN_RDB, gen, True)
    for s in RAGGED_CONVS:
        _mxu_conv(s, gen, False)
    parts = [_mxu_conv(s, gen, True) for s in MAIN_CONVS]
    for s, p in zip(MAIN_CONVS, parts):
        log(f"  K10 bf16 route at {s}: {p['ms']:.3f} ms (3xTF32 {p['tf32x3_ms']:.3f}), plain "
            f"{p['plain_ms']:.3f}, F.conv2d bf16 {p['library_ms']:.3f}, the whole function "
            f"in PyTorch calls {p['library_fn_ms']:.3f}, bound {p['bound_ms']:.3f} ms  "
            f"[{card_name}]")
    conv = {"max_abs_err": max(p["max_abs_err"] for p in parts),
            "mean_rel_err": max(p["mean_rel_err"] for p in parts)}
    for key in ("ms", "tf32x3_ms", "plain_ms", "library_ms", "library_fn_ms", "bound_ms"):
        conv[key] = sum(p[key] for p in parts)
    top = max(parts, key=lambda p: p["bound_ms"])
    conv.update(bound_by=top["bound_by"], bound_route=" / ".join(
        dict.fromkeys(p["bound_route"] for p in parts)))
    out["conv3x3_forward_bf16"] = conv
    for name, r in out.items():
        lib = "" if r["library_ms"] is None else (
            f", F.conv2d bf16 {r['library_ms']:.3f} ms, the whole function in PyTorch calls "
            f"{r['library_fn_ms']:.3f} ms")
        log(f"  {name} at the main-path shape: {r['ms']:.3f} ms against 3xTF32 "
            f"{r['tf32x3_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{lib}, bound "
            f"{r['bound_ms']:.3f} ms at the bf16 peak ({100 * r['bound_ms'] / r['ms']:.0f}%)  "
            f"[{card_name}]")
    return out


def hold_mxu_generator(label: str, got, want16, want32) -> dict:
    """A generator in the mode, the card against the CPU's rounded plain
    versions (``want16``): nearer them than the CPU's float32 forward
    (``want32``) lies to them, ``hold_bf16``'s rule (a generator at init
    scale 1.0 carries bf16 flips through its 180 chained convs). No bound on
    the mode's own distance: with K10's mode the offsets move, and at init
    scale 1.0 the output with them, by 6.5% of the range (measured), beyond
    ``TOL_BF16``."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite values")
    d_got = float((got.double() - want16.double()).abs().max())
    d_32 = float((want32.double() - want16.double()).abs().max())
    scale = float(want16.abs().max())
    log(f"  {label}: card {d_got:.3e} from the CPU's mode, whose float32 forward lies "
        f"{d_32:.3e} from it (ratio {d_got / d_32:.3g}; range {scale:.3e})")
    if not d_got < d_32:
        raise AssertionError(f"{label}: {d_got:.3e} / {d_32:.3e} outside the mode's rule")
    return {"err": d_got, "mode_vs_fp32": d_32, "range": scale}


def mxu_card_vs_cpu(config: str) -> dict:
    """Phase 28 (c): the 12-RRDB generator in ``config`` (a forced trunk in
    the mode) at init scale 1.0 on a ``MXU_GEN_LR``-px crop, the card against
    the CPU (``hold_mxu_generator``)."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.models import build_generator

    flags = CONFIGS[config]
    fp32 = dict(flags, rdb_mxu_bf16=False, conv_mxu_bf16=False)
    xs = [torch.from_numpy(a) for a in _crop_inputs(MXU_GEN_LR, 1, seed=1)]
    models = {key: build_generator(GeneratorConfig(init_scale=1.0, **f), seed=0,
                                   device="cpu").eval()
              for key, f in (("mode", flags), ("fp32", fp32))}
    gpu = copy.deepcopy(models["mode"]).to(DEVICE)
    with torch.inference_mode():
        outs = {key: model(*xs) for key, model in models.items()}
        got = gpu(*[a.to(DEVICE) for a in xs]).cpu()
    return hold_mxu_generator(f"generator 12 RRDB {flags}, init 1.0, {MXU_GEN_LR}-px crop",
                              got, outs["mode"], outs["fp32"])


def surfaces_card_vs_cpu(config: str) -> dict:
    """Phase 28 (d): ``config`` (growth 16 under 'auto', two output
    channels on the unfused tail, float16) at 12 RRDBs on phase 5's crop,
    the card against the CPU, with the card forward's launch counts (float16
    by ``hold_bf16``'s rule against the CPU's float16 and float32 forwards,
    the others within ``TOL_GENERATOR``)."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.models import build_generator
    from deepbedmap_tpu_torch.ops import _kernels

    flags = CONFIGS[config]
    xs = [torch.from_numpy(a) for a in _crop_inputs(GEN_LR, 1, seed=1)]
    cpu = build_generator(GeneratorConfig(**flags), seed=0, device="cpu").eval()
    gpu = copy.deepcopy(cpu).to(DEVICE)
    with torch.inference_mode():
        want = cpu(*xs)
        _kernels.reset_launches()
        got = gpu(*[a.to(DEVICE) for a in xs])
        torch.cuda.synchronize()
        launches = {k: v for k, v in _kernels.launches.items() if v}
        got = got.cpu()
    check_launches(launches, PER_FORWARD[config])
    label = f"generator 12 RRDB {flags}, {GEN_LR}-px crop -> {tuple(got.shape)}"
    if flags.get("compute_dtype") == "float16":
        cpu32 = build_generator(GeneratorConfig(**dict(flags, compute_dtype="float32")),
                                seed=0, device="cpu").eval()
        with torch.inference_mode():
            want32 = cpu32(*xs)
        res = hold_bf16(label + ", float16", got, want, want32)
    else:
        res = {"err": compare(label, got, want, TOL_GENERATOR)}
    res["launches"] = launches
    return res


def checkpoint_phase(card_name: str, tmp: str) -> dict:
    """Phase 28 (e): ``save_checkpoint`` of a 12-RRDB train state at the
    reference's batch, blocking and with ``block=False``: the time until the
    call returns and until ``wait_for_checkpoints`` has committed the file,
    the restore of the non-blocking file equal to the saved state bit for
    bit, and a training step run while the write is in flight."""
    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
        wait_for_checkpoints,
    )
    from deepbedmap_tpu_torch.train.state import create_gan_state
    from deepbedmap_tpu_torch.train.steps import make_train_step

    t_cfg = TrainConfig(batch_size=TRAIN_BATCH, ema_decay=TRAIN_EMA)
    state = create_gan_state(GeneratorConfig(), t_cfg=t_cfg, seed=0, device=DEVICE)
    step = make_train_step(t_cfg)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in train_batch(TRAIN_BATCH, 7).items()}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    out = {"card": card_name}
    blocking, nonblocking = os.path.join(tmp, "blocking.pt"), os.path.join(tmp, "async.pt")
    t0 = time.perf_counter()
    save_checkpoint(state, blocking)
    out["blocking_s"] = time.perf_counter() - t0
    saved = {"g": copy.deepcopy(state.g.state_dict()), "d": copy.deepcopy(state.d.state_dict()),
             "g_ema": copy.deepcopy(state.g_ema), "step": int(state.step)}
    t0 = time.perf_counter()
    save_checkpoint(state, nonblocking, block=False)
    out["nonblocking_return_s"] = time.perf_counter() - t0
    state, _ = step(state, batch)  # the state moves on while the file is written
    torch.cuda.synchronize()
    out["step_during_write_s"] = time.perf_counter() - t0
    wait_for_checkpoints()
    out["nonblocking_commit_s"] = time.perf_counter() - t0
    back = restore_checkpoint(nonblocking, device=DEVICE)
    for key in ("g", "d"):
        got = getattr(back, key).state_dict()
        for name, t in saved[key].items():
            if not torch.equal(got[name], t):
                raise AssertionError(f"checkpoint: {key}.{name} differs after the restore")
    for name, t in (saved["g_ema"] or {}).items():
        if not torch.equal(back.g_ema[name], t):
            raise AssertionError(f"checkpoint: g_ema.{name} differs after the restore")
    if int(back.step) != saved["step"]:
        raise AssertionError("checkpoint: the step differs after the restore")
    out["mb"] = _mb(nonblocking)
    log(f"  save_checkpoint ({out['mb']:.1f} MB): blocking {out['blocking_s']:.3f} s; "
        f"block=False returns in {out['nonblocking_return_s']:.3f} s, a train step after it "
        f"ends at {out['step_during_write_s']:.3f} s, committed at "
        f"{out['nonblocking_commit_s']:.3f} s; the restore equals the saved state bit for "
        f"bit  [{card_name}]")
    return out


def determinism_worker(path: str) -> None:
    """Phase 28 (f), in a process of its own: one 12-RRDB train step at
    ``DET_BATCH`` from the same seeded state and tiles, twice in each of
    three settings: as the port runs by default, with
    ``torch.backends.cudnn.deterministic`` alone, and with it and
    ``torch.use_deterministic_algorithms(True, warn_only=True)``. For each:
    the largest difference of the updated parameters between the two runs,
    the tensors that differ, the median of ``DET_TIMED_STEPS`` warm steps,
    and (the last) the operations PyTorch warns have no deterministic
    implementation. Writes a JSON file to ``path``."""
    import warnings

    import torch

    from deepbedmap_tpu_torch.config import GeneratorConfig, TrainConfig
    from deepbedmap_tpu_torch.train.state import create_gan_state
    from deepbedmap_tpu_torch.train.steps import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_cfg = TrainConfig(batch_size=DET_BATCH)
    step = make_train_step(t_cfg)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in train_batch(DET_BATCH, 12).items()}

    def once(steps: int = 1) -> tuple:
        state = create_gan_state(GeneratorConfig(), t_cfg=t_cfg, seed=0, device=DEVICE)
        first, times = None, []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if first is None:
                first = {f"{tag}{n}": p.detach().clone()
                         for tag, m in (("G.", state.g), ("D.", state.d))
                         for n, p in m.named_parameters()}
        return first, times

    out = {}
    for setting in ("default", "cudnn_deterministic", "deterministic_algorithms"):
        torch.backends.cudnn.deterministic = setting != "default"
        torch.use_deterministic_algorithms(setting == "deterministic_algorithms",
                                           warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            once()  # warm
            (a, _), (b, times) = once(), once(1 + DET_TIMED_STEPS)
        diff = {k: float((a[k].double() - b[k].double()).abs().max()) for k in a}
        differ = [k for k, v in diff.items() if v > 0]
        ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                      if "deterministic" in str(w.message)})
        out[setting] = {"max_param_diff": max(diff.values()), "tensors_differ": len(differ),
                        "first_differ": differ[:8],
                        "step_ms_median": float(np.median(times[1:])),
                        "step_ms": times[1:], "nondeterministic_ops": ops}
    torch.use_deterministic_algorithms(False)
    with open(path, "w") as f:
        json.dump(out, f)


def determinism_phase(card_name: str, tmp: str) -> dict:
    """Phase 28 (f): ``determinism_worker`` in a new process with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, its finding logged."""
    path = os.path.join(tmp, "determinism.json")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run(_helper("determinism_worker", path),
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=DET_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"determinism worker exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    with open(path) as f:
        out = json.load(f)
    for setting, r in out.items():
        log(f"  determinism, {setting}: two 12-RRDB steps at batch {DET_BATCH} differ by "
            f"{r['max_param_diff']:.3e} in {r['tensors_differ']} parameter tensors (first: "
            f"{r['first_differ'][:4]}); median warm step {r['step_ms_median']:.1f} ms of "
            f"{DET_TIMED_STEPS}; no deterministic implementation: "
            f"{r['nondeterministic_ops']}  [{card_name}]")
    out["wall_s"] = time.perf_counter() - t0
    return out


# the forced trunks in the mode timed in ms/tile in turns with the default
TIMED_MXU_CONFIGS = ("k1_mxu", "k6_mxu", "k5_mxu")


def mode_tile_ms(card_name: str, params) -> dict:
    """Phase 28 (b), the decision measurement's time and the tile-local
    trunks' in the mode: warm ``predict_continent`` ms/tile on phase 6's
    region and weights of the default configuration, ``k1_mxu`` (the default
    with the mode honoured), ``k6_mxu`` and ``k5_mxu``, in turns default,
    each mode configuration, the same backwards, default,
    ``MODE_TIMING_ROUNDS`` times; the medians and every run."""
    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import GeneratorConfig

    inputs, bounds, kw = continent_region()
    tiles = 4
    configs = ("default",) + TIMED_MXU_CONFIGS
    dbms = {c: DeepBedMap(params, cfg=GeneratorConfig(**CONFIGS[c]), device=DEVICE)
            for c in configs}
    runs = {c: [] for c in dbms}
    for c in dbms:  # warm
        dbms[c].predict_continent(inputs, bounds, **kw)
    for _ in range(MODE_TIMING_ROUNDS):
        for c in configs + configs[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dbms[c].predict_continent(inputs, bounds, **kw)
            torch.cuda.synchronize()
            runs[c].append(1e3 * (time.perf_counter() - t0) / tiles)
    out = {c: {"median_ms": float(np.median(r)), "runs_ms": r} for c, r in runs.items()}
    log(f"  ms/tile in turns (median of {len(runs['default'])}): "
        + ", ".join(f"{c} {out[c]['median_ms']:.1f}" for c in configs) + f"  [{card_name}]")
    return out


def bf16_routes_phase(card_name: str, params, default_out, default_tile_ms: float,
                      tmp: str) -> tuple:
    """Phase 28: (a) the five bf16 routes (``mxu_kernels``); (b) the four
    forced trunks in the mode through ``main_path`` on phase 6's region and
    weights (exact launches of the bf16 routes, tiled vs untiled, the canvas
    against phase 6's within ``TOL_BF16``, the trunk's device time per
    forward); the first, the default configuration with the trunk forced, is
    the decision measurement: the default canvas's distance from float32;
    ``k1_mxu``, ``k6_mxu`` and ``k5_mxu`` timed in ms/tile in turns with
    the default (``mode_tile_ms``); (c) each forced
    trunk card vs CPU (``mxu_card_vs_cpu``); (d) growth 16 under 'auto',
    ``out_channels=2`` and float16 card vs CPU (``surfaces_card_vs_cpu``);
    (e) the non-blocking checkpoint; (f) the determinism finding. Returns
    (the numbers of the ``bf16_routes`` JSON line, the routes' kernel
    results, each mode path's launches)."""
    import torch

    t_start = time.perf_counter()
    out = {"card": card_name}
    kernels = mxu_kernels(card_name)
    launches = {}
    for config in MXU_CONFIGS:
        log(f"  main path in {CONFIGS[config]}")
        r = main_path(card_name, config, params, default_out, TOL_BF16)
        launches[config] = r["launches"]
        vs = float((r["out"].double() - default_out.double()).abs().max())
        rng = float(default_out.abs().max())
        trunk_ms = next(ms for name, ms in r["stages_ms"].items() if name.startswith("trunk"))
        out[config] = {"launches": r["launches"], "tile_ms": r["tile_ms"],
                       "forward_ms": r["forward_ms"], "trunk_ms": trunk_ms,
                       "vs_default": vs, "vs_default_share": vs / rng}
        log(f"  {config}: canvas {vs:.3e} from the float32 default's = {vs / rng:.3e} of its "
            f"range {rng:.3e}; trunk {trunk_ms:.2f} ms of a {r['forward_ms']:.2f} ms forward; "
            f"{r['tile_ms']:.1f} ms/tile against the default's {default_tile_ms:.1f}  "
            f"[{card_name}]")
        del r
        torch.cuda.empty_cache()
        out[config]["card_vs_cpu"] = mxu_card_vs_cpu(config)
    out["mode_tile_ms"] = mode_tile_ms(card_name, params)
    for config in ("growth16", "out2", "fp16"):
        out[config] = surfaces_card_vs_cpu(config)
    out["checkpoint"] = checkpoint_phase(card_name, tmp)
    out["determinism"] = determinism_phase(card_name, tmp)
    out["phase_wall_s"] = time.perf_counter() - t_start
    log(f"  phase 28 wall time {out['phase_wall_s']:.1f} s  [{card_name}]")
    return out, kernels, launches


# phase 29: SwinIR-M x4 (``SwinIRConfig()``), the port's second generator.
# The window-attention kernel's cases (N, H, W, 3C, heads), each at both
# shifts: SwinIR-M's heads of 30 channels (padded to 32 inside the kernel)
# on 2 x 3 windows, heads of 32 (no padding) at batch 2, heads of 2 on a
# grid one window wide; the main shape is the continent cell's qkv, 2 tiles
# of 288^2 tokens
SMALL_WINDOW_ATTN = [(1, 16, 24, 540, 6), (2, 8, 16, 192, 2), (1, 24, 8, 36, 6)]
MAIN_WINDOW_ATTN = (2, 288, 288, 540, 6)
SWINIR_WINDOW, SWINIR_SHIFT = 8, 4  # SwinIR-M's odd layers shift by half the window
SWINIR_GEN_LR = 36  # the card-vs-CPU crop: latent 34, padded to 40 (5 x 5 windows)
# the library's attention (F.scaled_dot_product_attention) only has to be
# the same function as the kernel, whatever its fp32 route: a TF32 pass
# lies ~1e-4 of the range off, a lost bias or mask O(1)
TOL_LIBRARY_ATTN = 1e-2


def check_window_attn(shape, gen, timed: bool) -> dict:
    """The window-attention kernel (``window_attn``) against its plain
    version on the card at shift 0 and ``SWINIR_SHIFT``, one launch each;
    when ``timed``, also against the plain version in float64 (the
    precision check: the kernel's products are fp32, while a TF32 pass lies
    ~1e-4 of the range off, above ``TOL_TF32X3``), and the mean of both
    shifts timed beside the plain version and beside
    ``F.scaled_dot_product_attention`` over the partitioned windows with the
    bias plus the mask as its ``attn_mask`` (``library_ms``; the roll and
    the partition it needs are not timed)."""
    import torch
    import torch.nn.functional as F

    from deepbedmap_tpu_torch.ops import _kernels
    from deepbedmap_tpu_torch.ops import window_attn as wa

    n, h, w, c3, heads = shape
    ws, shifts = SWINIR_WINDOW, (0, SWINIR_SHIFT)
    c, tok = c3 // 3, SWINIR_WINDOW ** 2
    d, nw = c // heads, (h // ws) * (w // ws)
    qkv = _randn((n, h, w, c3), gen)
    table = _randn(((2 * ws - 1) ** 2, heads), gen)
    res = {"max_abs_err": 0.0}
    for shift in shifts:
        before = _kernels.launches["window_attn"]
        got = wa.window_attention(qkv, table, heads, ws, shift)
        want = wa.window_attention_plain(qkv, table, heads, ws, shift)
        torch.cuda.synchronize()
        if _kernels.launches["window_attn"] != before + 1:
            raise AssertionError("window_attention did not launch the kernel once")
        label = f"window_attn {(n, h, w, c3)}, {heads} heads of {d}, shift {shift}"
        res["max_abs_err"] = max(res["max_abs_err"], compare(label, got, want, TOL_KERNEL))
        if timed:
            want = wa.window_attention_plain(qkv.double(), table.double(), heads, ws, shift)
            torch.cuda.synchronize()
            compare(f"{label} vs float64 (precision check)", got, want, TOL_TF32X3)
        del got, want
    if not timed:
        return res

    def kernel():
        for shift in shifts:
            wa.window_attention(qkv, table, heads, ws, shift)

    def plain():
        for shift in shifts:
            wa.window_attention_plain(qkv, table, heads, ws, shift)

    bias = table[wa.relative_position_index(ws, DEVICE)].permute(2, 0, 1)  # (heads, tok, tok)
    library = []
    for shift in shifts:
        x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
        x = x.reshape(n, h // ws, ws, w // ws, ws, 3, heads, d)
        q, k, v = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, n * nw, heads, tok, d)
        mask = bias
        if shift:
            mask = (bias + wa.shift_mask(h, w, ws, shift, DEVICE)[:, None]).expand(
                n, nw, heads, tok, tok).reshape(n * nw, heads, tok, tok)
        library.append((q.contiguous(), k.contiguous(), v.contiguous(), mask))
        o = F.scaled_dot_product_attention(*library[-1])
        o = o.view(n, h // ws, w // ws, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
        o = o.reshape(n, h, w, c)
        o = torch.roll(o, (shift, shift), (1, 2)) if shift else o
        compare(f"F.scaled_dot_product_attention, shift {shift}, vs the plain version "
                "(the library's timing measures the same function)", o,
                wa.window_attention_plain(qkv, table, heads, ws, shift), TOL_LIBRARY_ATTN)

    def sdpa():
        for args in library:
            F.scaled_dot_product_attention(*args)

    res["ms"] = time_ms(kernel, 10) / len(shifts)
    res["plain_ms"] = time_ms(plain, 5) / len(shifts)
    res["library_ms"] = time_ms(sdpa, 10) / len(shifts)
    # q k^T and P v over each window's 64 tokens, masked pairs included;
    # qkv and the table read once, the output written once
    res.update(bound(4 * tok * n * h * w * c, 4 * (qkv.numel() + n * h * w * c
                                                   + table.numel())))
    return res


def _timed_stages(model, xs, names, reps: int = 3) -> dict:
    """Device time of each stage of one forward (the model's ``head``,
    ``trunk``, ``upsample`` and ``tail``, logged under ``names``), by CUDA
    events."""
    import torch

    def stages():
        a1 = model.head(*xs)
        yield names[0]
        t = model.trunk(a1)
        yield names[1]
        a4 = model.upsample(t, a1)
        yield names[2]
        model.tail(a4)
        yield names[3]

    totals: dict = {}
    with torch.inference_mode():
        for _ in range(reps):
            prev = torch.cuda.Event(enable_timing=True)
            prev.record()
            marks = []
            for name in stages():
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))
            torch.cuda.synchronize()
            for name, ev in marks:
                totals[name] = totals.get(name, 0.0) + prev.elapsed_time(ev) / reps
                prev = ev
    return totals


def swinir_phase(card_name: str) -> tuple:
    """Phase 29: (a) the window-attention kernel (``check_window_attn``) at
    ``SMALL_WINDOW_ATTN`` and at ``MAIN_WINDOW_ATTN``, timed; (b) SwinIR-M x4
    at full width and depth on a ``SWINIR_GEN_LR``-px crop at batch 2, card
    against the same port on the CPU (the plain attention), with seeded
    weights whose bias tables are drawn at std 1 and whose LayerNorm affines
    are moved off 1 and 0, so that the bias and the mask weigh in; (c) one
    forward at the continent cell's shapes (2 tiles of 288-px crops), which
    launches the kernel once a Swin layer (``PER_FORWARD['swinir']``) and
    nothing else; (d) ``predict_continent`` on phase 6's region with the
    published initialisation, its launch counts, a finite canvas and the
    warm per-tile time; (e) the forward's stages at batch 2 by CUDA events.
    Returns the phase's numbers and the kernel's row of the kernels line."""
    import torch

    from deepbedmap_tpu_torch import DeepBedMap
    from deepbedmap_tpu_torch.config import SwinIRConfig
    from deepbedmap_tpu_torch.inference import TilePlan
    from deepbedmap_tpu_torch.models import build_generator
    from deepbedmap_tpu_torch.ops import _kernels

    r = check_kernel("window_attn", check_window_attn, SMALL_WINDOW_ATTN, MAIN_WINDOW_ATTN,
                     29, card_name)
    del r["bound_fp32_ms"]  # computed, not measured: the log line carries it

    def expected(forwards: int) -> dict:
        return {k: forwards * PER_FORWARD["swinir"].get(k, 0) for k in _kernels.launches}

    cfg = SwinIRConfig()
    cpu_model = build_generator(cfg, seed=0, device="cpu").eval()
    g = torch.Generator().manual_seed(29)
    with torch.no_grad():
        for m in cpu_model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.add_(0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=g))
            elif hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0.0, 1.0, generator=g)
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    xs = [torch.from_numpy(a) for a in _crop_inputs(SWINIR_GEN_LR, 2, seed=1)]
    _kernels.reset_launches()
    with torch.inference_mode():
        want = cpu_model(*xs)
        got = gpu_model(*[a.to(DEVICE) for a in xs])
        torch.cuda.synchronize()
    check_launches(dict(_kernels.launches), expected(1))
    err = compare(f"SwinIR-M x4, {SWINIR_GEN_LR}-px crop -> {tuple(got.shape)}, card vs CPU",
                  got.cpu(), want, TOL_GENERATOR)
    del cpu_model, gpu_model, want, got

    inputs, bounds, kw = continent_region()
    dbm = DeepBedMap(None, cfg=cfg, device=DEVICE)
    plan = TilePlan(out_h=2 * TILE_OUT, out_w=2 * TILE_OUT, tile_out=TILE_OUT,
                    halo_lr=HALO_LR)
    xs = [torch.from_numpy(a).to(DEVICE)
          for a in _crop_inputs(plan.crop_lr, TILES_PER_DISPATCH, seed=3)]
    _kernels.reset_launches()
    with torch.inference_mode():
        out = dbm.model(*xs)
        torch.cuda.synchronize()
    log(f"  one forward at batch {TILES_PER_DISPATCH} x {plan.crop_lr} px -> "
        f"{tuple(out.shape)}: launches {dict(_kernels.launches)}")
    check_launches(dict(_kernels.launches), expected(1))
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("SwinIR's forward at the cell's shapes is not finite")

    _kernels.reset_launches()
    t0 = time.perf_counter()
    raster = dbm.predict_continent(inputs, bounds, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    forwards = plan.grid[0] * -(-plan.grid[1] // TILES_PER_DISPATCH)
    log(f"  launches in predict_continent ({forwards} forwards): {launches}")
    check_launches(launches, expected(forwards))
    if raster.data.shape != (2 * TILE_OUT,) * 2 or not np.isfinite(raster.data).all():
        raise AssertionError(f"bad SwinIR continent output {raster.data.shape}")
    t0 = time.perf_counter()
    dbm.predict_continent(inputs, bounds, **kw)
    torch.cuda.synchronize()
    tile_ms = 1e3 * (time.perf_counter() - t0) / plan.num_tiles
    log(f"  predict_continent {plan.num_tiles} tiles: cold {cold_s:.3f} s, warm "
        f"{tile_ms:.1f} ms/tile  [{card_name}]")

    stages_ms = _timed_stages(dbm.model, xs, [
        "input block + window padding + conv_first (cuDNN fp32)",
        f"trunk: {sum(cfg.depths)} Swin layers ({sum(cfg.depths)} x window_attn, cuBLAS "
        f"fp32 linears) + {len(cfg.depths)} RSTB convs",
        "conv_after_body + 3 convs and 2 pixel shuffles (cuDNN fp32)",
        "conv_last (cuDNN fp32)"])
    for name, ms in stages_ms.items():
        log(f"  forward at batch {TILES_PER_DISPATCH} x {plan.crop_lr} px, {name}: "
            f"{ms:.2f} ms  [{card_name}]")
    forward_ms = sum(stages_ms.values())
    log(f"  forward total: {forward_ms:.2f} ms  [{card_name}]")
    row = {"name": "window_attn", "route": "cuda",
           "source": "deepbedmap_tpu_torch/csrc/window_attn.cu", "replaces": None,
           "launches": launches["window_attn"], **r}
    return {"card_vs_cpu_max_abs_err": err, "tile_ms": tile_ms, "cold_s": cold_s,
            "forward_ms": forward_ms, "stages_ms": stages_ms}, row


# (launch-counter name, source, TPU kernel it replaces, check, small shapes,
# main-path shape, phase, the configuration whose main path gives its
# launches); K9's launches come from its own path in phase 15
# phase 28's bf16 routes: (launch-counter name, source, TPU kernel it
# replaces, the mode's main path that gives its launches)
MXU_KERNELS = [
    ("rdb_forward_bf16", "deepbedmap_tpu_torch/csrc/rdb.cu",
     "deepbedmap_tpu/ops/pallas_rdb.py:635", "k1_mxu"),
    ("rrdb_forward_bf16", "deepbedmap_tpu_torch/csrc/rdb.cu",
     "deepbedmap_tpu/ops/pallas_rdb.py:908", "k4_mxu"),
    ("conv3x3_forward_bf16", "deepbedmap_tpu_torch/csrc/conv3x3.cu",
     "deepbedmap_tpu/ops/pallas_conv.py:166", "k4_mxu"),
    ("rdb_banded_forward_bf16", "deepbedmap_tpu_torch/csrc/rdb_banded.cu",
     "deepbedmap_tpu/ops/pallas_rdb.py:391", "k6_mxu"),
    ("rrdb_sweep_forward_bf16", "deepbedmap_tpu_torch/csrc/rrdb_sweep.cu",
     "deepbedmap_tpu/ops/pallas_rdb.py:1234", "k5_mxu"),
]

KERNELS = [
    ("rdb_forward", "deepbedmap_tpu_torch/csrc/rdb.cu",
     "deepbedmap_tpu/ops/pallas_rdb.py:635", check_rdb, [SMALL_RDB, RAGGED_RDB],
     MAIN_RDB, 2, "default"),
    ("deform64_lrelu", "deepbedmap_tpu_torch/csrc/deform_tail.cu",
     "deepbedmap_tpu/ops/pallas_tail.py:196", check_deform64, SMALL_TAILS, MAIN_TAIL, 3,
     "default"),
    ("deform_zproj1", "deepbedmap_tpu_torch/csrc/deform_tail.cu",
     "deepbedmap_tpu/ops/pallas_tail.py:275", check_zproj1, SMALL_TAILS, MAIN_TAIL, 4,
     "default"),
    ("rrdb_forward", "deepbedmap_tpu_torch/csrc/rdb.cu",
     "deepbedmap_tpu/ops/pallas_rdb.py:908", check_rrdb, [SMALL_RDB, RAGGED_RDB],
     MAIN_RDB, 7, "kernel"),
    ("conv3x3_forward", "deepbedmap_tpu_torch/csrc/conv3x3.cu",
     "deepbedmap_tpu/ops/pallas_conv.py:166", check_conv3x3, SMALL_CONVS, MAIN_CONVS, 8,
     "kernel"),
    ("deform_conv", "deepbedmap_tpu_torch/csrc/deform_tail.cu",
     "deepbedmap_tpu/ops/pallas_kernels.py:330", check_deform_conv, SMALL_TAILS,
     MAIN_TAIL, 9, "kernel"),
    ("deform_conv_zproj1", "deepbedmap_tpu_torch/csrc/deform_tail.cu",
     "deepbedmap_tpu/ops/pallas_kernels.py:882", check_deform_conv_zproj1, SMALL_TAILS,
     MAIN_TAIL, 10, "kernel"),
    ("rdb_banded_forward", "deepbedmap_tpu_torch/csrc/rdb_banded.cu",
     "deepbedmap_tpu/ops/pallas_rdb.py:391",
     functools.partial(check_rdb, kernel="rdb_banded"), [SMALL_RDB, RAGGED_RDB], MAIN_RDB,
     13, "banded"),
    ("rrdb_sweep_forward", "deepbedmap_tpu_torch/csrc/rrdb_sweep.cu",
     "deepbedmap_tpu/ops/pallas_rdb.py:1234",
     functools.partial(check_rrdb, kernel="rrdb_sweep"), [SMALL_RDB, SWEEP_RDB, RAGGED_RDB],
     MAIN_RDB, 14, "sweep"),
    ("deform_zform", "deepbedmap_tpu_torch/csrc/deform_zform.cu",
     "deepbedmap_tpu/ops/pallas_kernels.py:1119", check_zform, SMALL_ZFORM, MAIN_ZFORM,
     15, None),
]


def check_kernel(name, check, smalls, main_shape, phase: int, card_name: str) -> dict:
    import torch

    log(f"phase {phase}: {name}")
    gen = torch.Generator().manual_seed(phase)
    for small in smalls:
        check(small, gen, timed=False)
    r = check(main_shape, gen, timed=True)
    lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
    log(f"  {name} at the main-path shape: kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms{lib}, bound {r['bound_ms']:.3f} ms "
        f"({r['bound_route']}; fp32 bound {r['bound_fp32_ms']:.3f} ms) = "
        f"{100 * r['bound_ms'] / r['ms']:.0f}% of the bound  [{card_name}]")
    return r


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it does not run on the CPU")
    from deepbedmap_tpu_torch.ops import _kernels

    t_start = time.perf_counter()
    log("phase 0: setup")
    card_name = card()
    log(card_name)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("phase 1: build")
    t0 = time.perf_counter()
    _kernels.library()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    if list(argv) == ["--training"]:
        log("phase 22 alone: training, with phase 19's rasters (the CLI's predict "
            "--checkpoint)")
        window, cpu_window = region_windows()
        rasters = region_rasters(window, cpu_window, seed=19)
        with tempfile.TemporaryDirectory() as tmp:
            train = training(card_name, rasters, window, tmp)
        print(json.dumps({"training": train}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if list(argv) == ["--swinir"]:
        log("phase 29: SwinIR-M x4 (the window-attention kernel, card vs CPU, the cell's "
            "forward, the continent path)")
        swinir, row = swinir_phase(card_name)
        print(json.dumps({"swinir": swinir}), flush=True)
        print(json.dumps({"kernels": [row]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if argv:
        raise SystemExit(f"chip_smoke.py: unknown arguments {list(argv)} (only --swinir or "
                         "--training)")

    results = {}

    def kernels(*phases):
        for name, _, _, check, smalls, main_shape, phase, _ in KERNELS:
            if phase in phases:
                results[name] = check_kernel(name, check, smalls, main_shape, phase,
                                             card_name)

    kernels(2, 3, 4)
    log("phase 5: whole generator, card vs CPU")
    check_generator(0.1, {})
    check_generator(1.0, {})

    log("phase 6: main path")
    path_launches, forward_ms = {}, {}

    def run_path(config, *args):
        r = main_path(card_name, config, *args)
        path_launches[config], forward_ms[config] = r["launches"], r["forward_ms"]
        return r

    r = run_path("default")
    params, default_out, default_tile_ms = r["model"].state_dict(), r["out"], r["tile_ms"]

    kernels(7, 8, 9, 10)
    log(f"phase 11: whole generator in {CONFIGS['kernel']}, card vs CPU")
    check_generator(0.1, CONFIGS["kernel"])
    check_generator(1.0, CONFIGS["kernel"])

    log(f"phase 12: second main path, {CONFIGS['kernel']}")
    run_path("kernel", params, default_out)

    kernels(13, 14, 15)
    log(f"phase 16: whole generator in {CONFIGS['banded']} and {CONFIGS['sweep']}, "
        "card vs CPU")
    for config in ("banded", "sweep"):
        check_generator(0.1, CONFIGS[config])
        check_generator(1.0, CONFIGS[config])

    for phase, config in ((17, "banded"), (18, "sweep")):
        log(f"phase {phase}: main path in {CONFIGS[config]}")
        run_path(config, params, default_out)

    log("phase 19: single region (from_chainer_npz, from_experiment, predict, track_rmse)")
    region = single_region(card_name, params)
    rasters, window = region["rasters"], region["window"]

    with tempfile.TemporaryDirectory() as tmp:
        log("phase 20: the continent product (buffered and streamed int16 LZW GeoTIFF)")
        product = continent_product(card_name, tmp)
        log("phase 21: the HTTP server (/healthz, /predict, /dem, /evaluate)")
        serving(card_name, params, rasters, window, product, tmp)
        log("phase 22: training (gradients through the kernels, steps card vs CPU, fit, "
            "checkpoints, the CLI's train)")
        train = training(card_name, rasters, window, tmp)
        log("phase 23: the hyperparameter search (packaged tiles, studies on the card, "
            "the fixed-area evaluator, from_experiment, the CLI's hpo)")
        t0 = time.perf_counter()
        searched = search(card_name, rasters, window, tmp)
        searched["phase_wall_s"] = time.perf_counter() - t0
        log(f"  phase 23 wall time {searched['phase_wall_s']:.1f} s  [{card_name}]")
        log("phase 24: data prep (survey ascii, blockmedian, gridding, windows, training "
            "arrays, the CLI's grid and build)")
        prepared = data_prep(card_name, tmp)
        log("phase 25: evaluation and figures (predict, the baselines, track RMSE, roughness, "
            "hillshade, transects, the figure set, the CLI's live curves, a torch.profiler "
            "trace, FLOP shares)")
        evaluated = evaluation(card_name, region, params, forward_ms, train, tmp)
        log("phase 26: parallel (world 1 on NCCL; world 2 on the one card: the tile-sharded "
            "continent, the band-distributed product, the data-parallel step, the "
            "channel-parallel forward, the CLI)")
        parallel = parallel_phase(card_name, params, default_out, tmp)
    log("phase 27: the generator options (bf16, the phase convs, the channels-before-width "
        "tail, the plain trunk at growth 32 and 16; bf16 training)")
    options = generator_options(card_name, params, default_out)
    log("phase 28: the kernels' bf16-multiplicand routes (K1, K4, K5, K6, K10), the forced "
        "trunks in the mode, growth 16 under 'auto', out_channels=2, float16, non-blocking "
        "checkpoints, the determinism finding")
    with tempfile.TemporaryDirectory() as tmp:
        routes, mxu_results, mxu_launches = bf16_routes_phase(
            card_name, params, default_out, default_tile_ms, tmp)
    log("phase 29: SwinIR-M x4 (the window-attention kernel, card vs CPU, the cell's "
        "forward, the continent path)")
    swinir, swinir_row = swinir_phase(card_name)

    rows = []
    for name, src, rep, *_, path in KERNELS:
        r = dict(results[name])
        del r["bound_fp32_ms"]  # computed, not measured: the log lines carry it
        launches = r.pop("launches") if path is None else path_launches[path][name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches, **r})
    for name, src, rep, config in MXU_KERNELS:
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": mxu_launches[config][name], **mxu_results[name]})
    rows.append(swinir_row)
    if not all(row["launches"] > 0 for row in rows):
        raise AssertionError("a kernel was never launched on its path")
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"training": train}), flush=True)
    print(json.dumps({"search": searched}), flush=True)
    print(json.dumps({"data_prep": prepared}), flush=True)
    print(json.dumps({"evaluation": evaluated}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"options": options}), flush=True)
    print(json.dumps({"bf16_routes": routes}), flush=True)
    print(json.dumps({"swinir": swinir}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

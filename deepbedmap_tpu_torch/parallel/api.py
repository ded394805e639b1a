"""Sharded training and inference entry points.

Counterpart of ``deepbedmap_tpu/parallel/api.py``. JAX jits the
single-device step with the batch sharded and lets GSPMD insert the
collectives; here each rank of a ``DeviceMesh`` runs its own process, so the
collectives are written into the step (``train.steps.make_train_step``'s
``group``) and the tile loop is split by hand, as JAX's ``shard_map`` splits
it.

Training: ``make_sharded_train_step`` returns one rank's step. It takes the
rank's contiguous rows of the global batch (``parallel.batch_sharding``) and
equals the single-device step on the global batch: global-batch BatchNorm,
RaGAN means, accuracy and PSNR, the ranks' mean gradient before Adam, and the
state broadcast from the mesh's first rank on the first call, as JAX's
replicated ``in_shardings`` place it.

Inference: the tile grid is flattened and padded to a multiple of the mesh
size (padding tiles wrap around and are recomputed, then dropped); rank
``r`` predicts the ``r``-th contiguous block of tile ids against the whole
(replicated) input rasters, and one ``all_gather`` hands every rank all
tiles. ``stitch_tiles`` reassembles the canvas with pure reshapes.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from deepbedmap_tpu_torch.config import LossConfig, TrainConfig
from deepbedmap_tpu_torch.inference.engine import (
    TilePlan,
    make_tile_forward,
    make_tile_group_forward,
    pad_inputs,
)
from deepbedmap_tpu_torch.parallel.mesh import mesh_device, mesh_rank, mesh_size, replicated
from deepbedmap_tpu_torch.train.steps import make_train_step


def make_sharded_train_step(
    mesh: DeviceMesh,
    t_cfg: TrainConfig = TrainConfig(),
    loss_cfg: LossConfig = LossConfig(),
):
    """``step(state, local_batch) -> (state, metrics)`` for this rank of the
    1-D ``mesh`` (axis ``t_cfg.data_axis``). The models are the state's, as
    in ``train.steps.make_train_step``. Every rank passes its rows of the
    global batch; the ranks' row counts must agree (the global batch divides
    by the mesh size). The first call broadcasts the state from the mesh's
    first rank; the metrics are the global batch's on every rank."""
    axis = t_cfg.data_axis
    mesh_rank(mesh, axis)  # the caller must be part of the mesh
    group = mesh.get_group(axis)
    n = mesh_size(mesh, axis)
    put = replicated(mesh)
    step = make_train_step(t_cfg, loss_cfg, group=group)
    synced = []

    def sharded_step(state, local_batch: Dict[str, torch.Tensor]):
        rows = {int(v.shape[0]) for v in local_batch.values()}
        if len(rows) != 1:
            raise ValueError(f"the batch's tensors have different row counts {rows}")
        mine = torch.tensor([rows.pop()], device=mesh_device(mesh))
        counts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(counts, mine, group=group)
        counts = [int(c) for c in counts]
        if len(set(counts)) != 1:
            raise ValueError(
                f"the ranks hold {counts} rows: the global batch of {sum(counts)} "
                f"must divide evenly over the {n} ranks of the mesh"
            )
        if not synced:
            put(state)
            synced.append(True)
        return step(state, local_batch)

    return sharded_step


def sharded_predict_tiles(
    forward_fn: Callable[..., torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    plan: TilePlan,
    mesh: DeviceMesh,
    axis_name: str = "data",
    pad_mode: str = "edge",
    prepadded: bool = False,
    tiles_per_dispatch: int = 1,
) -> torch.Tensor:
    """Predict all tiles of the plan, the tile axis split over the mesh.

    Every rank holds the whole ``inputs`` (NHWC tensors on its device) and
    returns all ``(num_tiles, tile_out, tile_out)`` tiles, its own and the
    other ranks' (one ``all_gather``).

    ``prepadded``: the inputs already carry the plan's ``pad_lr`` halo on
    every side (a continent row band whose vertical halo is real neighbour
    rows, ``inference.continent``); otherwise they are padded here by
    ``pad_mode``, any mode ``jnp.pad`` takes (``inference.engine.pad_hw``).

    ``tiles_per_dispatch``: tiles stacked per forward within each rank's
    block; the block's last id is repeated to fill the last group
    (recomputed, dropped), as in JAX.
    """
    if tiles_per_dispatch < 1:
        raise ValueError(f"tiles_per_dispatch must be >= 1, got {tiles_per_dispatch}")
    r = mesh_rank(mesh, axis_name)
    n = mesh_size(mesh, axis_name)
    gx = plan.grid[1]
    num = plan.num_tiles
    per = -(-num // n)
    # padding tiles wrap (recomputed, dropped); rank r takes the r-th block
    ids = [t % num for t in range(r * per, (r + 1) * per)]
    padded = inputs if prepadded else pad_inputs(inputs, plan, pad_mode)
    b = tiles_per_dispatch
    if b == 1:
        tile_forward = make_tile_forward(forward_fn, plan)
        local = torch.cat([tile_forward(padded, t // gx, t % gx)[..., 0] for t in ids])
    else:
        group_forward = make_tile_group_forward(forward_fn, plan)
        groups = -(-per // b)
        ids_b = ids + ids[-1:] * (groups * b - per)  # repeat the last id
        local = torch.cat([
            group_forward(padded, [t // gx for t in g], [t % gx for t in g])
            for g in (ids_b[i * b : (i + 1) * b] for i in range(groups))
        ])[:per]
    local = local.contiguous()
    gathered = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(gathered, local, group=mesh.get_group(axis_name))
    return torch.cat(gathered)[:num]


def stitch_tiles(tiles: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(num_tiles, T, T) row-major tiles -> (out_h, out_w) canvas."""
    gy, gx = plan.grid
    t = plan.tile_out
    return tiles.reshape(gy, gx, t, t).permute(0, 2, 1, 3).reshape(plan.out_h, plan.out_w)

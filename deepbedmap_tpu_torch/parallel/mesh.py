"""Mesh construction and the two placements the workloads use.

Counterpart of ``deepbedmap_tpu/parallel/mesh.py``. A JAX ``Mesh`` is a grid
of one host's chips, all driven by one process; PyTorch's idiom is one
process per card, so the port's mesh is a ``DeviceMesh`` over the process
group's ranks (``parallel.distributed.initialize`` starts the group), with
dimension name ``"data"`` (``parallel.tp`` adds ``"model"``).

JAX's shardings become what they mean for one rank:

- ``batch_sharding(mesh)``: ``P("data")``, contiguous rows: rank ``r`` of
  ``n`` takes rows ``r*B/n .. (r+1)*B/n`` of a global tensor, the rows JAX
  places on device ``r``;
- ``replicated(mesh)``: ``P()``: every rank holds the same values, which the
  port makes true by broadcasting from the mesh's first rank.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from deepbedmap_tpu_torch.device import resolve_device


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = "data", device="cuda"
) -> DeviceMesh:
    """1-D mesh over the group's first n (default: all) ranks, on ``device``'s
    type (the card unless the caller asks for the CPU). Every rank of the
    group calls it; a rank beyond the first n gets a mesh it is not part of."""
    return _mesh((n_devices,), (axis_name,), device)


def _mesh(shape, names, device) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.distributed.initialize() before "
            "building a mesh"
        )
    world = dist.get_world_size()
    if shape == (None,):
        shape = (world,)
    need = 1
    for s in shape:
        if s < 1:
            raise ValueError(f"mesh shape {shape}: every dimension must be >= 1")
        need *= s
    if need > world:
        raise ValueError(
            f"a mesh of shape {shape} needs {need} ranks, but the world size is {world}"
        )
    ranks = torch.arange(need).reshape(shape)
    return DeviceMesh(resolve_device(device).type, ranks, mesh_dim_names=tuple(names))


def mesh_rank(mesh: DeviceMesh, axis_name: str = "data") -> int:
    """This rank's coordinate along ``axis_name``; raises if the caller is not
    part of the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(
            f"rank {dist.get_rank()} is not part of the mesh {mesh.mesh.tolist()}"
        )
    return mesh.get_local_rank(axis_name)


def mesh_size(mesh: DeviceMesh, axis_name: str = "data") -> int:
    """The mesh's size along ``axis_name``."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for ``mesh``: its current card for a
    CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh: DeviceMesh, axis_name: str = "data"):
    """``shard(x)``: this rank's contiguous rows of the global tensor ``x``
    (or of every tensor of a dict). The leading axis must divide by the
    mesh's size along ``axis_name``."""
    n = mesh_size(mesh, axis_name)
    r = mesh_rank(mesh, axis_name)

    def shard(x):
        if isinstance(x, Mapping):
            return {k: shard(v) for k, v in x.items()}
        if x.shape[0] % n:
            raise ValueError(
                f"a global batch of {x.shape[0]} rows does not divide over {n} ranks"
            )
        b = x.shape[0] // n
        return x[r * b : (r + 1) * b]

    return shard


def replicated(mesh: DeviceMesh):
    """``put(obj)``: broadcast ``obj``'s tensors in place from the mesh's
    first rank and return ``obj``. ``obj`` is a tensor, a dict of tensors, a
    module (parameters and buffers), an optimizer (its state) or a
    ``train.state.GANState`` (all of these, and its step)."""
    group = mesh.get_group()
    src = int(mesh.mesh.flatten()[0])
    dev = mesh_device(mesh)

    def bcast(t: torch.Tensor) -> None:
        if t.device == dev:
            dist.broadcast(t.data, src, group=group)
        else:  # e.g. Adam's step count, kept on the CPU
            buf = t.detach().to(dev)
            dist.broadcast(buf, src, group=group)
            t.data.copy_(buf)

    def put(obj):
        from deepbedmap_tpu_torch.train.state import GANState

        if isinstance(obj, torch.Tensor):
            bcast(obj)
        elif isinstance(obj, Mapping):
            for v in obj.values():
                put(v)
        elif isinstance(obj, nn.Module):
            for t in list(obj.parameters()) + list(obj.buffers()):
                bcast(t)
        elif isinstance(obj, torch.optim.Optimizer):
            for group_ in obj.param_groups:
                for p in group_["params"]:
                    state = obj.state.get(p, {})
                    put({k: v for k, v in state.items() if isinstance(v, torch.Tensor)})
        elif isinstance(obj, GANState):
            step = torch.tensor([obj.step], dtype=torch.int64, device=dev)
            dist.broadcast(step, src, group=group)
            obj.step = int(step.item())
            for part in (obj.g, obj.d, obj.g_opt, obj.d_opt):
                put(part)
            if obj.g_ema is not None:
                put(obj.g_ema)
        else:
            raise TypeError(f"replicated: cannot broadcast a {type(obj).__name__}")
        return obj

    return put

"""Multi-process initialisation.

Counterpart of ``deepbedmap_tpu/parallel/distributed.py``. JAX drives every
chip of a host from one process and needs ``jax.distributed.initialize``
only across hosts; PyTorch runs one process per card, so every multi-card
run starts a ``torch.distributed`` process group here first. After it,
``parallel.make_mesh`` sees the group's ranks as the device set, as JAX's
``make_mesh`` sees the global devices.

The address, world size and rank are given explicitly (``tcp://host:port``
or ``file://path``), or read from torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, as JAX reads a Cloud TPU pod's
environment. With neither, a one-rank group starts on an in-memory store.
The backend is NCCL on the card and Gloo on the CPU unless the caller names
one: two processes that share one card need Gloo, since NCCL refuses two
ranks on one GPU. Nothing falls back: a failed init or collective raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from deepbedmap_tpu_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    device="cuda",
) -> bool:
    """Start this process's group; a no-op (returning False) when one is up.
    Returns True when it started one, so a caller can destroy what it made.

    ``coordinator_address``: ``tcp://host:port``, ``file://path`` or a bare
    ``host:port`` (JAX's form). ``device``: the card unless the caller asks
    for the CPU; it picks the default backend, and on CUDA this process's
    card (``LOCAL_RANK``, else the rank, modulo the cards present). Every
    collective of the group times out after ``timeout_s`` seconds."""
    if dist.is_initialized():
        return False
    if timeout_s is None or not timeout_s > 0:
        raise ValueError(f"timeout_s must be a positive number, got {timeout_s!r}")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        if (num_processes or 1) != 1:
            raise ValueError(
                f"{num_processes} processes need a coordinator address "
                "(tcp://host:port or file://path, or torchrun's MASTER_ADDR/MASTER_PORT)"
            )
        _set_card(dev, 0)
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                timeout=timeout)
        return True
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id "
                         "(or torchrun's WORLD_SIZE and RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside 0..{num_processes - 1}")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    _set_card(dev, process_id)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id, timeout=timeout)
    return True


def _set_card(dev: torch.device, rank: int) -> None:
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local % torch.cuda.device_count())


def process_count() -> int:
    """The group's world size; 1 when no group is up (``jax.process_count``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 when no group is up (``jax.process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that should write checkpoints and logs."""
    return process_index() == 0

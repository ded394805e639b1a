"""Global-batch means over a process group, for data-parallel training.

JAX's data-parallel step is the single-device step under GSPMD, which turns
every batch mean into a cross-device reduction. The port's step calls the
same functions with a ``group`` (``parallel.make_sharded_train_step``); each
batch-coupled mean then goes through ``global_mean``, and ``group=None``
leaves the single-device arithmetic untouched.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """The group's sum; its backward is the sum of the incoming gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group's ranks of ``x`` (each rank's value from an
    equal share of the global batch), with gradient; ``x`` itself when
    ``group`` is None. The backward sums the ranks' incoming gradients: a
    rank's local loss then carries the other ranks' terms through the shared
    statistic, and the step's mean of the ranks' parameter gradients is the
    global loss's gradient."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)

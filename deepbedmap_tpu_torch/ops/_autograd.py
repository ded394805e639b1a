"""Gradients through the hand-written kernels: the port's ``jax.custom_vjp``.

The JAX package wraps each Pallas call in a custom VJP whose backward is
autodiff of the kernel's plain composition, recomputed from the saved inputs
(``pallas_rdb.py:_rdb_flat_bwd``, ``pallas_tail.py:_fused_bwd``,
``deform_conv.py:_pallas_bwd``, ``pallas_conv.py``); no backward kernel
exists. ``kernel_with_plain_grad`` is the same contract in PyTorch: the
forward is the kernel launch, whose output has no autograd history of its
own, and the backward recomputes the plain twin on the saved inputs under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it. The
kernel's wrapper calls it on a CUDA tensor; on a CPU tensor the wrappers run
the plain twin directly, so autograd differentiates it as it stands.

Packed weights are closed over by ``kernel``, never inputs: they are packed
under ``torch.no_grad()`` and the gradient goes to the source parameters,
which are inputs of both ``kernel`` and ``plain``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class _PlainTwinGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves)
        wrt = [leaf for leaf, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True))
        return (None, None, *(next(grads) if need else None for need in needs))


def kernel_with_plain_grad(
    kernel: Callable[..., torch.Tensor],
    plain: Callable[..., torch.Tensor],
    *inputs: Optional[torch.Tensor],
) -> torch.Tensor:
    """``kernel(*inputs)``, differentiable as ``plain(*inputs)`` is: when
    gradients are on and an input requires one, the call goes through an
    ``autograd.Function`` whose backward is autograd of ``plain`` recomputed
    on the saved inputs; otherwise ``kernel`` runs bare and nothing is
    saved. ``inputs`` are tensors or None, passed to both positionally."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _PlainTwinGrad.apply(kernel, plain, *inputs)
    return kernel(*inputs)


def refuse_grad(name: str, *inputs: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` when gradients are on and an input requires one:
    for an entry whose JAX counterpart has no VJP."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise ValueError(
            f"{name} has no gradient (as in JAX, whose kernel has no VJP); "
            "call it under torch.no_grad() or on inputs that need none"
        )

"""Tensor (channel) parallelism for the conv GAN.

Counterpart of ``deepbedmap_tpu/parallel/tp.py``. JAX shards each conv
kernel on its output-channel axis over the ``"model"`` axis of a 2-D
``("data", "model")`` mesh and lets GSPMD insert the all-gathers; the port
writes them out on a 2-D ``DeviceMesh`` over the process group's ranks:

- ``tp_param_shardings``: JAX's rule on the port's layouts. JAX shards the
  last axis of an HWIO kernel and of a Dense ``(in, out)`` kernel, the
  output channels; those are axis 0 of the port's OIHW weights and of
  ``nn.Linear``'s ``(out, in)``. A bias or BatchNorm vector of length > 1
  is sharded too. A leaf whose axis 0 does not divide by the ``"model"``
  size stays replicated: the 64 -> 1 head, the 18 offsets under 4 ranks,
  and scalars. The placements are DTensor's ``Shard(0)`` / ``Replicate()``.
- ``make_tp_forward``: each sharded conv computes its own output-channel
  slice, then the slices are all-gathered along the channels before the
  next layer reads them; a replicated leaf computes whole on every rank.
  The batch is split over ``"data"`` and the output gathered back.

Gradients follow Megatron's pair of operations instead of
``torch.distributed.nn``'s all-gather, whose backward sums the identical
gradients that a replicated consumer (the head) hands every rank, and so
counts them ``n_model`` times: a tensor that every rank holds whole enters a
sharded layer through an identity whose backward all-reduces the ranks'
partial input gradients, and the channel all-gather's backward keeps the
rank's own slice. Nothing is then counted twice and nothing needs dividing
out. ``reduce_tp_grads`` completes DP x TP by summing each shard's gradient
over ``"data"`` (each data rank holds its rows' share of the loss).

Under TP with ``n_model`` > 1 the trunk runs the plain dense block with
sharded convs (the dense-block kernels take F = 64 and G = 32 whole) at the
configuration's compute dtype, and the tail the plain deformable convs in
float32; with ``n_model`` = 1 the model's own forward runs, kernels
included.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from deepbedmap_tpu_torch.ops.conv import conv_nhwc, leaky_relu, scaled, torch_dtype
from deepbedmap_tpu_torch.ops.deform_conv import deform_conv_shifts, deform_conv_shifts_zproj
from deepbedmap_tpu_torch.ops.resize import nearest_upsample, space_to_depth
from deepbedmap_tpu_torch.parallel.mesh import _mesh, mesh_device, mesh_rank, mesh_size


def make_mesh_2d(n_data: int, n_model: int, axis_names=("data", "model"),
                 device="cuda") -> DeviceMesh:
    """2-D ``("data", "model")`` mesh over the group's first
    ``n_data * n_model`` ranks, ``"model"`` the minor axis (neighbouring
    ranks, the faster links on one host)."""
    return _mesh((n_data, n_model), axis_names, device)


def _sharded(shape, n_model: int) -> bool:
    """JAX's channel rule (module docstring) with its divisibility guard."""
    if len(shape) >= 2 or (len(shape) == 1 and shape[0] > 1):
        return shape[0] % n_model == 0
    return False


def tp_param_shardings(mesh: DeviceMesh, params: Mapping[str, torch.Tensor]) -> Dict:
    """name -> ``Shard(0)`` or ``Replicate()`` for a flat dict of tensors
    (a ``state_dict``) under channel sharding over ``"model"``."""
    n_model = mesh_size(mesh, "model")
    return {k: Shard(0) if _sharded(tuple(v.shape), n_model) else Replicate()
            for k, v in params.items()}


def shard_params_tp(mesh: DeviceMesh, params: Mapping[str, torch.Tensor]) -> Dict:
    """This rank's piece of every tensor by ``tp_param_shardings``, on the
    mesh's device: its ``"model"`` coordinate's slice of axis 0, or the
    whole tensor."""
    n_model, m = mesh_size(mesh, "model"), mesh_rank(mesh, "model")
    dev = mesh_device(mesh)
    out = {}
    for k, p in tp_param_shardings(mesh, params).items():
        t = params[k].detach()
        if isinstance(p, Shard):
            t = t.chunk(n_model, 0)[m]
        out[k] = t.to(dev).contiguous()
    return out


def tp_state_shardings(mesh: DeviceMesh, state) -> Dict:
    """Placements for every tensor of a ``train.state.GANState``, keyed
    ``g.<param>``, ``d.<param or statistic>``, ``g_ema.<param>`` and
    ``g_opt.<param>.<moment>`` / ``d_opt...``: Adam's moments follow their
    parameters, its step counts and the state's step are replicated."""
    flat = {"step": torch.tensor(state.step)}
    for prefix, model, opt in (("g", state.g, state.g_opt), ("d", state.d, state.d_opt)):
        flat.update({f"{prefix}.{k}": v for k, v in model.state_dict().items()})
        for k, p in model.named_parameters():
            for moment, v in opt.state.get(p, {}).items():
                flat[f"{prefix}_opt.{k}.{moment}"] = v
    if state.g_ema is not None:
        flat.update({f"g_ema.{k}": v for k, v in state.g_ema.items()})
    return tp_param_shardings(mesh, flat)


class _Copy(torch.autograd.Function):
    """Identity; the backward sums the ranks' partial input gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather of equal slices along ``dim``; the backward keeps the
    rank's own slice of the (replicated) incoming gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.dim, ctx.size, ctx.rank = dim, x.shape[dim], dist.get_rank(group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def _tp_generator_forward(cfg, p: Mapping[str, torch.Tensor], sharded: Mapping[str, bool],
                          group, x, w1, w2, w3) -> torch.Tensor:
    """``models.generator.Generator.forward`` with every conv's output
    channels split over ``group`` (plain PyTorch convolutions, at the
    configuration's compute dtype; the upsample stages and the tail in
    their literal NHWC form, the function ``upsample_phase_conv`` and
    ``tail_hcw`` compute too)."""

    def layer(name: str, a: torch.Tensor, op) -> torch.Tensor:
        if not sharded[f"{name}.weight"]:
            return op(a, p[f"{name}.weight"], p[f"{name}.bias"])
        return _Gather.apply(op(_Copy.apply(a, group), p[f"{name}.weight"],
                                p[f"{name}.bias"]), group, -1)

    dt = torch_dtype(cfg.compute_dtype)

    def conv(name, a, padding=1):
        return layer(name, a, lambda a, w, b: conv_nhwc(a, w, b, padding, dt))

    branches = []
    for name, a, block in (("conv_on_X", x, 1), ("conv_on_W1", w1, 10),
                           ("conv_on_W2", w2, 2), ("conv_on_W3", w3, 1)):
        if block > 1:
            a = space_to_depth(a, block)
        branches.append(conv(f"input_block.{name}", a, 0))
    a1 = leaky_relu(conv("pre_residual_conv_layer", torch.cat(branches, -1)))
    t = a1
    s = cfg.residual_scaling
    for b in range(cfg.num_residual_blocks):
        r = t
        for d in range(1, 4):
            acts = [r]
            for j in range(1, 6):
                z = conv(f"residual_network.{b}.residual_dense_block{d}.conv_layer{j}",
                         torch.cat(acts, -1))
                if j < 5:
                    acts.append(leaky_relu(z))
            r = r + scaled(s, z)
        t = t + scaled(s, r)
    a3 = conv("post_residual_conv_layer", t) + a1
    a4 = leaky_relu(conv("post_upsample_conv_layer_1", nearest_upsample(a3, 2)))
    a4 = leaky_relu(conv("post_upsample_conv_layer_2", nearest_upsample(a4, 2)))
    clamp = cfg.deform_clamp
    # the samplers compute in float32, whatever the compute dtype
    off1 = conv("final_conv_layer1.offset_conv", a4).float()
    off1_in = _Copy.apply(off1, group) if sharded["final_conv_layer1.weight"] else off1
    a5 = leaky_relu(layer("final_conv_layer1", a4.float(), lambda a, w, b: deform_conv_shifts(
        a, off1_in, w, b, 1, clamp)))
    off2 = conv("final_conv_layer2.offset_conv", a5).float()
    off2_in = _Copy.apply(off2, group) if sharded["final_conv_layer2.weight"] else off2
    return layer("final_conv_layer2", a5, lambda a, w, b: deform_conv_shifts_zproj(
        a, off2_in, w, b, 1, clamp))


def make_tp_forward(mesh: DeviceMesh, model, params_sharded: Mapping[str, torch.Tensor]):
    """``fwd(x, w1, w2, w3)``: the generator ``model`` with this rank's
    ``params_sharded`` (``shard_params_tp``). It takes the global batch
    (NHWC, on the mesh's device), computes this rank's ``"data"`` rows with
    the channels split over ``"model"`` and returns the global output on
    every rank. Differentiable in ``params_sharded`` (``reduce_tp_grads``)."""
    n_data, n_model = mesh_size(mesh, "data"), mesh_size(mesh, "model")
    rd = mesh_rank(mesh, "data")
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
    full = dict(model.state_dict())
    sharded = {k: isinstance(v, Shard) for k, v in tp_param_shardings(mesh, full).items()}

    def fwd(x, w1, w2, w3):
        if x.shape[0] % n_data:
            raise ValueError(f"a batch of {x.shape[0]} does not divide over {n_data} ranks")
        b = x.shape[0] // n_data
        args = [a[rd * b : (rd + 1) * b] for a in (x, w1, w2, w3)]
        if n_model == 1:
            out = torch.func.functional_call(model, dict(params_sharded), tuple(args))
        else:
            out = _tp_generator_forward(model.cfg, params_sharded, sharded, model_group,
                                        *args)
        return out if n_data == 1 else _Gather.apply(out, data_group, 0)

    return fwd


def reduce_tp_grads(mesh: DeviceMesh, params_sharded: Mapping[str, torch.Tensor]) -> None:
    """Sum each shard's ``.grad`` over ``"data"``, in place: after the
    backward of a loss of ``make_tp_forward``'s (global) output, each data
    rank holds its own rows' share of every gradient."""
    group = mesh.get_group("data")
    for t in params_sharded.values():
        if t.grad is not None:
            dist.all_reduce(t.grad, group=group)

"""Weight bridge: JAX generator params and discriminator variables <-> the
port's ``state_dict``s.

The JAX side is the flax param tree of ``deepbedmap_tpu.models.Generator``
given as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), so this module needs no JAX. Every leaf maps:

- conv kernels HWIO (3, 3, C_in, C_out) -> ``weight`` OIHW (C_out, C_in, 3, 3);
- ``input_block/conv_on_X/Conv_0/kernel`` -> ``input_block.conv_on_X.weight``;
- ``residual_network/block/...`` leaves are stacked on a leading axis of
  length ``num_residual_blocks``; entry b becomes ``residual_network.{b}....``;
- the deformable layers' offset convs keep the JAX channel order
  ([:9] = dy, [9:] = dx), which is also the port's.

Do not go through the Chainer npz export: it swaps the offset halves.

The discriminator's flax variables ``{"params": ..., "batch_stats": ...}``
map onto ``models.discriminator.Discriminator``: conv kernels HWIO -> OIHW,
Dense kernels (in, out) -> ``weight`` (out, in), BatchNorm ``scale`` /
``bias`` and its ``batch_stats`` ``mean`` / ``var`` under their own names.
The port flattens the last map in flax's (H, W, C) order, so ``linear_1``'s
rows need no reordering.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_TRUNK = "residual_network"


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _to_torch(name: str, a: np.ndarray) -> torch.Tensor:
    if name == "kernel":
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _to_jax(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0) if name == "kernel" else a)


def _leaf_name(name: str) -> str:
    return {"kernel": "weight", "bias": "bias"}[name]


def jax_params_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax generator params (nested dicts of arrays) -> port ``state_dict``."""
    sd = {}
    for path, a in _flatten(tree).items():
        leaf = path[-1]
        if path[0] == _TRUNK:
            # residual_network/block/residual_dense_block{j}/conv_layer{k}/leaf
            _, _, rdb, conv = path[:-1]
            for b in range(a.shape[0]):
                sd[f"{_TRUNK}.{b}.{rdb}.{conv}.{_leaf_name(leaf)}"] = _to_torch(leaf, a[b])
            continue
        mods = [p for p in path[:-1] if p != "Conv_0"]
        sd[".".join(mods + [_leaf_name(leaf)])] = _to_torch(leaf, a)
    return sd


def state_dict_to_jax_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port ``state_dict`` -> flax generator params (nested dicts of numpy)."""
    tree: Dict[str, Any] = {}
    trunk: Dict[tuple, Dict[int, np.ndarray]] = {}

    def put(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for key, t in sd.items():
        parts = key.split(".")
        leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
        if parts[0] == _TRUNK:
            b, rdb, conv = int(parts[1]), parts[2], parts[3]
            trunk.setdefault((rdb, conv, leaf), {})[b] = _to_jax(leaf, t)
            continue
        mods = parts[:-1]
        if mods[0] == "input_block":
            mods = mods + ["Conv_0"]
        put(tuple(mods) + (leaf,), _to_jax(leaf, t))
    for (rdb, conv, leaf), per_block in trunk.items():
        stacked = np.stack([per_block[b] for b in range(len(per_block))])
        put((_TRUNK, "block", rdb, conv, leaf), stacked)
    return tree


def jax_d_vars_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax discriminator variables (params and batch_stats, nested dicts of
    arrays) -> the port discriminator's ``state_dict``."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for (layer, leaf), a in _flatten(variables[collection]).items():
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                leaf = "weight"
            sd[f"{layer}.{leaf}"] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return sd


def state_dict_to_jax_d_vars(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port discriminator's ``state_dict`` -> flax variables
    ``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy)."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        layer, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        if leaf == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            leaf = "kernel"
        out[collection].setdefault(layer, {})[leaf] = np.ascontiguousarray(a)
    return out

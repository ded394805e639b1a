"""Chainer-npz weights: import into, and export from, the flax layout.

Counterpart of the npz part of ``deepbedmap_tpu/train/checkpoint.py``, copied
because importing the JAX package loads JAX (the Orbax train-state checkpoints
come with the training port). The reference saves its generator with
``chainer.serializers.save_npz``; the import builds the JAX generator's param
tree (nested dicts of numpy arrays) from it, with the layout changes:

- conv kernels (C_out, C_in, kh, kw) -> (kh, kw, C_in, C_out);
- the input block's k30s10/k6s2 kernels -> space-to-depth 3x3 form;
- the repeated RRDBs -> one stacked leading axis.

The port reaches its ``state_dict`` from that tree through
``bridge.jax_params_to_state_dict`` (``DeepBedMap.from_chainer_npz``), so the
bridge stays the one mapping onto the port's modules.

Offset-channel order: Chainer's deformable-conv sampler takes its x offsets in
the first kh*kw channels and y in the second half; JAX's (and the port's)
order is [y-halves, x-halves]. ``offset_order='xy'`` (the default) swaps the
halves on import and again on export; ``'yx'`` keeps them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np


def _conv_w(w: np.ndarray) -> np.ndarray:
    """(C_out, C_in, kh, kw) -> (kh, kw, C_in, C_out)."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _strided_conv_w(w: np.ndarray, block: int) -> np.ndarray:
    """(C_out, C_in, 3b, 3b) -> space-to-depth 3x3 form (3, 3, b*b*C_in, C_out).

    Channel order matches ``ops.resize.space_to_depth``: (bh, bw, c) row-major.
    """
    c_out, c_in = w.shape[:2]
    return np.ascontiguousarray(
        w.reshape(c_out, c_in, 3, block, 3, block)
        .transpose(2, 4, 3, 5, 1, 0)
        .reshape(3, 3, block * block * c_in, c_out)
    )


def _offset_conv_w(w: np.ndarray, offset_order: str) -> np.ndarray:
    """Offset-conv kernel with optional y/x half swap of output channels."""
    out = _conv_w(w)  # (3, 3, C_in, 2K)
    if offset_order == "xy":  # source stores x-halves first; ours is y-first
        k = out.shape[-1] // 2
        out = np.concatenate([out[..., k:], out[..., :k]], axis=-1)
    return out


def _offset_bias(b: np.ndarray, offset_order: str) -> np.ndarray:
    if offset_order == "xy":
        k = len(b) // 2
        return np.concatenate([b[k:], b[:k]])
    return b


def _stack(trees: List[Dict]) -> Dict:
    """Per-block trees of one structure -> one tree of leading-axis stacks."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(a) for a in trees])


def import_chainer_generator_npz(
    npz: Any,  # path or dict-like of name -> array
    num_residual_blocks: int = 12,
    offset_order: str = "xy",
) -> Dict:
    """Build the flax Generator params tree from a Chainer GeneratorModel npz."""
    if isinstance(npz, (str, os.PathLike)):
        npz = dict(np.load(npz))
    g = {k: np.asarray(v) for k, v in npz.items()}

    def conv(prefix):
        return {
            "kernel": _conv_w(g[f"{prefix}/W"]),
            "bias": g[f"{prefix}/b"],
        }

    def strided(prefix, block):
        return {
            "Conv_0": {
                "kernel": (
                    _strided_conv_w(g[f"{prefix}/W"], block)
                    if block > 1
                    else _conv_w(g[f"{prefix}/W"])
                ),
                "bias": g[f"{prefix}/b"],
            }
        }

    def deform(prefix):
        return {
            "offset_conv": {
                "kernel": _offset_conv_w(g[f"{prefix}/offset_conv/W"], offset_order),
                "bias": _offset_bias(g[f"{prefix}/offset_conv/b"], offset_order),
            },
            "kernel": _conv_w(g[f"{prefix}/deform_conv/W"]),
            "bias": g[f"{prefix}/deform_conv/b"],
        }

    def rdb(prefix):
        return {
            f"conv_layer{i}": conv(f"{prefix}/conv_layer{i}") for i in range(1, 6)
        }

    # stack the repeated RRDBs along the scan axis
    blocks = [
        {
            f"residual_dense_block{j}": rdb(
                f"residual_network/{b}/residual_dense_block{j}"
            )
            for j in (1, 2, 3)
        }
        for b in range(num_residual_blocks)
    ]
    stacked = {"block": _stack(blocks)} if blocks else {}

    return {
        "input_block": {
            "conv_on_X": strided("input_block/conv_on_X", 1),
            "conv_on_W1": strided("input_block/conv_on_W1", 10),
            "conv_on_W2": strided("input_block/conv_on_W2", 2),
            "conv_on_W3": strided("input_block/conv_on_W3", 1),
        },
        "pre_residual_conv_layer": conv("pre_residual_conv_layer"),
        "residual_network": stacked,
        "post_residual_conv_layer": conv("post_residual_conv_layer"),
        "post_upsample_conv_layer_1": conv("post_upsample_conv_layer_1"),
        "post_upsample_conv_layer_2": conv("post_upsample_conv_layer_2"),
        "final_conv_layer1": deform("final_conv_layer1"),
        "final_conv_layer2": deform("final_conv_layer2"),
    }


def export_generator_npz(params: Dict, path: str, offset_order: str = "xy") -> None:
    """Inverse of the import: write a reference-layout npz from a flax-layout
    params tree (``bridge.state_dict_to_jax_params`` gives one from the port's
    ``state_dict``)."""
    flat: Dict[str, np.ndarray] = {}

    def inv_conv(tree, prefix):
        flat[f"{prefix}/W"] = np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)
        flat[f"{prefix}/b"] = np.asarray(tree["bias"])

    def inv_strided(tree, prefix, block):
        kern = np.asarray(tree["Conv_0"]["kernel"])
        if block > 1:
            kh, kw, bc, co = kern.shape
            c_in = bc // (block * block)
            kern = (
                kern.reshape(3, 3, block, block, c_in, co)
                .transpose(5, 4, 0, 2, 1, 3)
                .reshape(co, c_in, 3 * block, 3 * block)
            )
        else:
            kern = kern.transpose(3, 2, 0, 1)
        flat[f"{prefix}/W"] = np.ascontiguousarray(kern)
        flat[f"{prefix}/b"] = np.asarray(tree["Conv_0"]["bias"])

    def inv_deform(tree, prefix):
        ok = np.asarray(tree["offset_conv"]["kernel"])
        ob = np.asarray(tree["offset_conv"]["bias"])
        if offset_order == "xy":
            k = ok.shape[-1] // 2
            ok = np.concatenate([ok[..., k:], ok[..., :k]], axis=-1)
            ob = np.concatenate([ob[k:], ob[:k]])
        flat[f"{prefix}/offset_conv/W"] = ok.transpose(3, 2, 0, 1)
        flat[f"{prefix}/offset_conv/b"] = ob
        flat[f"{prefix}/deform_conv/W"] = np.asarray(tree["kernel"]).transpose(
            3, 2, 0, 1
        )
        flat[f"{prefix}/deform_conv/b"] = np.asarray(tree["bias"])

    inv_strided(params["input_block"]["conv_on_X"], "input_block/conv_on_X", 1)
    inv_strided(params["input_block"]["conv_on_W1"], "input_block/conv_on_W1", 10)
    inv_strided(params["input_block"]["conv_on_W2"], "input_block/conv_on_W2", 2)
    inv_strided(params["input_block"]["conv_on_W3"], "input_block/conv_on_W3", 1)
    inv_conv(params["pre_residual_conv_layer"], "pre_residual_conv_layer")
    inv_conv(params["post_residual_conv_layer"], "post_residual_conv_layer")
    inv_conv(params["post_upsample_conv_layer_1"], "post_upsample_conv_layer_1")
    inv_conv(params["post_upsample_conv_layer_2"], "post_upsample_conv_layer_2")
    inv_deform(params["final_conv_layer1"], "final_conv_layer1")
    inv_deform(params["final_conv_layer2"], "final_conv_layer2")

    blocks = params["residual_network"]["block"]
    n_blocks = np.asarray(
        blocks["residual_dense_block1"]["conv_layer1"]["kernel"]
    ).shape[0]
    for b in range(n_blocks):
        for j in (1, 2, 3):
            for i in range(1, 6):
                tree = blocks[f"residual_dense_block{j}"][f"conv_layer{i}"]
                prefix = f"residual_network/{b}/residual_dense_block{j}/conv_layer{i}"
                flat[f"{prefix}/W"] = np.asarray(tree["kernel"][b]).transpose(
                    3, 2, 0, 1
                )
                flat[f"{prefix}/b"] = np.asarray(tree["bias"][b])

    np.savez(path, **flat)

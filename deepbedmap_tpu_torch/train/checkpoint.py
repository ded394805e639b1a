"""Training checkpoints, and Chainer-npz weights into and out of the flax layout.

Counterpart of ``deepbedmap_tpu/train/checkpoint.py``, copied because
importing the JAX package loads JAX.

The port's own checkpoints replace JAX's Orbax ones: ``save_checkpoint``
copies the whole ``GANState`` to the host (step, both models' ``state_dict``s
with the discriminator's BatchNorm statistics, both Adams, the EMA weights,
and the two models' configurations) and writes it with ``torch.save`` to a
temporary name in the target's directory, then renames it into place, so a
killed write leaves no half file; with ``block=False`` the write runs on a
thread while training goes on, and ``wait_for_checkpoints`` commits it, as
JAX's ``AsyncCheckpointer`` does. ``restore_checkpoint`` rebuilds the state on a device,
``checkpoint_has_ema`` says whether a run kept EMA weights, and
``load_generator_state_dict`` gives the weights ``DeepBedMap.from_checkpoint``
runs. A JAX Orbax checkpoint (a directory) cannot be read here, since the
card's machine has no Orbax, tensorstore or JAX: its path raises
``ValueError`` naming the route that crosses over, ``export_generator_npz``
in JAX and ``DeepBedMap.from_chainer_npz`` here.

The reference saves its generator with
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

import dataclasses
import os
import threading
from typing import Any, Dict, List

import numpy as np
import torch

from deepbedmap_tpu_torch.config import DiscriminatorConfig, GeneratorConfig
from deepbedmap_tpu_torch.device import resolve_device
from deepbedmap_tpu_torch.models.api import check_generator_device
from deepbedmap_tpu_torch.models.discriminator import Discriminator
from deepbedmap_tpu_torch.models.generator import Generator
from deepbedmap_tpu_torch.train.state import GANState

_FORMAT = "deepbedmap_tpu_torch.GANState/1"


_writers: List[threading.Thread] = []  # saves of save_checkpoint(block=False) in flight
_errors: List[Exception] = []  # what those writers raised, for wait_for_checkpoints
_writers_lock = threading.Lock()


def _to_host(tree):
    """A copy on the host of every tensor in a nested state, so that the
    caller may go on updating the state in place while it is written."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        out = type(tree)((k, _to_host(v)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):  # a state_dict's per-module versions
            out._metadata = tree._metadata
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write(payload: Dict[str, Any], path: str) -> None:
    """``torch.save`` to a temporary name beside ``path``, then
    ``os.replace``: a failed or killed write leaves nothing at ``path``."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp.{os.getpid()}."
                                  f"{threading.get_ident()}")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _write_in_background(payload: Dict[str, Any], path: str) -> None:
    try:
        _write(payload, path)
    except Exception as e:  # raised again by wait_for_checkpoints
        with _writers_lock:
            _errors.append(e)


def save_checkpoint(state: GANState, path: str, block: bool = True) -> None:
    """The whole train state to the file ``path``, atomically (a temporary
    name in the same directory, then ``os.replace``).

    The state is copied to the host once, before this returns. With
    ``block=False`` the file is then written on a thread of its own while
    the caller runs on (JAX's Orbax ``AsyncCheckpointer``): a later save
    first waits for the one in flight, and ``wait_for_checkpoints()`` must
    be called before the file is read or the process exits; it raises what
    a writer raised. A failed write leaves no file at ``path``."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory; a checkpoint of the port is one file")
    wait_for_checkpoints()
    payload = _to_host({
        "format": _FORMAT,
        "step": int(state.step),
        "g_cfg": dataclasses.asdict(state.g.cfg),
        "d_cfg": dataclasses.asdict(state.d.cfg),
        "d_in_px": state.d.in_px,
        "g": state.g.state_dict(),
        "d": state.d.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "g_ema": state.g_ema,
    })
    if block:
        _write(payload, path)
        return
    writer = threading.Thread(target=_write_in_background, args=(payload, path),
                              name=f"save_checkpoint {path}")
    with _writers_lock:  # started before a waiter on another thread can join it
        writer.start()
        _writers.append(writer)


def wait_for_checkpoints() -> None:
    """Block until every ``save_checkpoint(block=False)`` has committed its
    file; raise the first error a writer met (its file was not written)."""
    with _writers_lock:
        writers = list(_writers)
        _writers.clear()
    for writer in writers:
        writer.join()
    with _writers_lock:
        errors = list(_errors)
        _errors.clear()
    if errors:
        raise errors[0]


def _load(path: str, device="cpu") -> Dict[str, Any]:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, which the port's checkpoints never are: an "
            "Orbax checkpoint of the JAX package cannot be read by the PyTorch "
            "port. Export its generator with deepbedmap_tpu.train.checkpoint."
            "export_generator_npz and load that with DeepBedMap.from_chainer_npz"
        )
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    payload = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a checkpoint of deepbedmap_tpu_torch")
    return payload


def restore_checkpoint(path: str, device="cuda") -> GANState:
    """The ``GANState`` saved at ``path``, on ``device`` (the card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    payload = _load(path, dev)
    g_cfg = GeneratorConfig(**payload["g_cfg"])
    check_generator_device(g_cfg, dev)
    g = Generator(g_cfg)
    g.load_state_dict(payload["g"])
    g.to(dev)
    d = Discriminator(DiscriminatorConfig(**payload["d_cfg"]), in_px=payload["d_in_px"])
    d.load_state_dict(payload["d"])
    d.to(dev)
    g_opt = torch.optim.Adam(g.parameters())
    g_opt.load_state_dict(payload["g_opt"])
    d_opt = torch.optim.Adam(d.parameters())
    d_opt.load_state_dict(payload["d_opt"])
    return GANState(step=payload["step"], g=g, g_opt=g_opt, d=d, d_opt=d_opt,
                    g_ema=payload["g_ema"])


def checkpoint_has_ema(path: str) -> bool:
    """Whether the run saved at ``path`` kept EMA weights."""
    return _load(path)["g_ema"] is not None


def load_generator_state_dict(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The generator's weights saved at ``path`` (on the CPU): the EMA
    weights when ``use_ema`` and the run kept them, else the trained ones."""
    payload = _load(path)
    if use_ema and payload["g_ema"] is not None:
        return payload["g_ema"]
    return payload["g"]


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

"""Windowed multi-head attention: Swin's shifted-window self-attention and
HAT's overlapping cross-attention, their plain versions and the kernel
wrappers.

It replaces no TPU kernel: the JAX package has no attention. It serves the
port's SwinIR and HAT generators (``models/swinir.py``, ``models/hat.py``).

``window_attention`` is the Swin layer's ``WindowAttention`` of the
published code (Liang et al., SwinIR, 2021; ``SwinTransformerBlock.forward``;
HAT's ``HAB``) from the qkv projection's output to the input of ``proj``:

- the token grid (N, H, W) is cyclically shifted by ``-shift`` on both axes
  (``torch.roll``), cut into ``window`` x ``window`` windows, and each
  window's tokens attend to each other, head by head: softmax(q k^T *
  d^-0.5 + B [+ M]) v, with d = C / heads;
- B is the learned relative-position bias: ``table`` ((2 window - 1)^2,
  heads) indexed by ``relative_position_index``;
- M, on shifted layers only, is ``shift_mask``: 0 between tokens of one
  region of the shifted grid, -100 (not -inf, as published) between
  regions that the roll brought together; 9 regions, as ``calculate_mask``;
- the heads' outputs are concatenated (channel = head * d + i), the windows
  put back and the grid shifted by ``+shift``.

``overlap_attention`` is HAT's ``OCAB`` (Chen et al., HAT, 2023) from its
qkv linear's output to the input of ``proj``: q is cut into ``window`` x
``window`` windows (no shift); k and v into ``overlap`` x ``overlap``
windows centred on them (``nn.Unfold(overlap, stride=window, padding=(overlap
- window) / 2)``, zero padding: a key outside the grid is a zero key and value
that stays in the softmax); each head takes softmax(q k^T d^-0.5 + B) v with
B from ``table`` ((window + overlap - 1)^2, heads) indexed by
``overlap_position_index``: the row of a (query, key) pair is a function of
the key's offset (dy, dx) from its query alone, (dy + window - 1 + pad)
(window + overlap - 1) + dx + window - 1 + pad. The published
``calculate_rpi_oca`` maps the same offsets one to one onto the table's rows
in another order (and through negative indices); with a drawn table the two
orders are the same model.

Both take qkv (N, H, W, 3C) in token order, as the qkv linear writes it
(channel = part * C + head * d + i, part q, k, v), and return (N, H, W, C) in
token order, ready for ``proj``. On a CPU tensor they run the plain versions
(roll, partition, unfold, matmul, softmax, matmul, reverse, roll). On a CUDA
tensor each is one kernel launch: 8 x 8 windows ``csrc/window_attn.cu``
(a whole window in shared memory, counted as ``window_attn``), other windows
and the cross-attention ``csrc/window_attn_tiled.cu`` (an online softmax over
chunks of 64 keys, counted as ``window_attn_tiled`` and
``overlap_attn_tiled``). Both fold the shift, the window partition and
reverse and the key windows' padding into their indexing (no roll, no copy,
no unfold), compute the mask from the token's region, add the bias and the
mask, and take an fp32 softmax and both products in fp32 on the CUDA cores
(head width padded to 32 inside the kernel). The tiled kernel takes windows
whose square is a multiple of 128 (16, 32), key windows whose square is a
multiple of 64 up to 1024 (16, 24, 32) and heads of at most 32 channels;
other sizes raise ``NotImplementedError`` at the launch.
Gradients: the backward is autograd of the plain version
(``_autograd.kernel_with_plain_grad``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from deepbedmap_tpu_torch.ops import _kernels
from deepbedmap_tpu_torch.ops._autograd import kernel_with_plain_grad

MASK_VALUE = -100.0
KERNEL_WINDOW = 8
KERNEL_MAX_HEAD_DIM = 32
# the tiled kernel's blocks of queries and chunks of keys, and its largest
# key window and bias table
TILED_QUERIES = 128
TILED_KEYS = 64
TILED_MAX_KEYS = 1024
TILED_MAX_TABLE = 4096


# the cached tables are made outside inference mode, so that autograd may
# save them after an inference-mode call made them


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _relative_index_cpu(window: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)  # (2, N)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def relative_position_index(window: int, device="cpu") -> torch.Tensor:
    """(N, N) long, N = window^2: the row of the bias table for each pair of a
    window's tokens (row-major), as Swin's ``relative_position_index``."""
    return _relative_index_cpu(window).to(device)


@functools.lru_cache(maxsize=8)
@torch.inference_mode(False)
def _mask_cpu(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    label = torch.zeros(h, w)
    bounds = (0, -window, -shift, None)
    cnt = 0
    for rs in zip(bounds, bounds[1:]):
        for cs in zip(bounds, bounds[1:]):
            label[slice(*rs), slice(*cs)] = cnt
            cnt += 1
    windows = label.view(h // window, window, w // window, window).transpose(1, 2)
    windows = windows.reshape(-1, window * window)
    diff = windows[:, :, None] - windows[:, None, :]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def shift_mask(h: int, w: int, window: int, shift: int, device="cpu") -> torch.Tensor:
    """(nW, N, N) float32 for an (h, w) grid after a roll by ``-shift``:
    ``MASK_VALUE`` between tokens of different regions, 0 within one."""
    return _mask_cpu(h, w, window, shift).to(device)


def _check(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
           shift: int) -> None:
    n, h, w, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"qkv's {c3} channels are not 3 x heads x head width ({heads} heads)")
    if not 0 <= shift < window:
        raise ValueError(f"shift {shift} outside [0, window {window})")
    if h % window or w % window:
        raise ValueError(f"the grid {h} x {w} is not a multiple of the window {window}")
    if tuple(table.shape) != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"the bias table has shape {tuple(table.shape)}, expected "
                         f"{((2 * window - 1) ** 2, heads)}")


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                           window: int, shift: int) -> torch.Tensor:
    """The plain version (module docstring): (N, H, W, 3C) -> (N, H, W, C)."""
    _check(qkv, table, heads, window, shift)
    n, h, w, c3 = qkv.shape
    c, ws = c3 // 3, window
    d, tokens = c // heads, window * window
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), (1, 2))
    x = qkv.reshape(n, h // ws, ws, w // ws, ws, 3, heads, d)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, heads, tokens, d)
    q, k, v = x[0] * d ** -0.5, x[1], x[2]
    attn = q @ k.transpose(-2, -1)
    attn = attn + table[relative_position_index(ws, qkv.device)].permute(2, 0, 1)
    if shift:
        nw = (h // ws) * (w // ws)
        mask = shift_mask(h, w, ws, shift, qkv.device)
        attn = (attn.view(n, nw, heads, tokens, tokens) + mask[None, :, None]).view(
            -1, heads, tokens, tokens)
    o = torch.softmax(attn, dim=-1) @ v  # (n nW, heads, tokens, d)
    o = o.view(n, h // ws, w // ws, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
    o = o.reshape(n, h, w, c)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def _launch(qkv, table, heads, window, shift, overlap=None):
    """One launch: self-attention in 8 x 8 windows on ``window_attn``, in
    other windows, and the cross-attention (``overlap`` given), on the tiled
    kernel."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    keys = window if overlap is None else overlap
    tiled = overlap is not None or window != KERNEL_WINDOW
    if d > KERNEL_MAX_HEAD_DIM or tiled and (
            (window * window) % TILED_QUERIES or (keys * keys) % TILED_KEYS
            or keys * keys > TILED_MAX_KEYS or (window + keys - 1) ** 2 > TILED_MAX_TABLE):
        raise NotImplementedError(
            f"the window attention kernels take heads of at most {KERNEL_MAX_HEAD_DIM} "
            f"channels, and the tiled one windows whose square is a multiple of "
            f"{TILED_QUERIES} and key windows whose square is a multiple of {TILED_KEYS} up "
            f"to {TILED_MAX_KEYS}; got window {window} and {d}"
            + ("" if overlap is None else f" (key window {overlap})"))
    _kernels.check_image_shape(n, h, w, c3)
    _kernels.check_tensor(qkv, "qkv", (n, h, w, c3))
    _kernels.check_tensor(table, "table", tuple(table.shape))
    out = torch.empty((n, h, w, c), device=qkv.device, dtype=torch.float32)
    if tiled:
        _kernels.launch_window_attn_tiled(qkv, table, out, n, h, w, c, heads, window, keys,
                                          shift, overlap is not None, d ** -0.5)
    else:
        _kernels.launch_window_attn(qkv, table, out, n, h, w, c, heads, shift, d ** -0.5)
    return out


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                     shift: int) -> torch.Tensor:
    """(N, H, W, 3C) float32 -> (N, H, W, C) float32: a kernel on a CUDA
    tensor (8 x 8 windows ``window_attn``, others the tiled kernel), the
    plain version on a CPU tensor (module docstring)."""
    if not qkv.is_cuda:
        return window_attention_plain(qkv, table, heads, window, shift)
    _check(qkv, table, heads, window, shift)
    return kernel_with_plain_grad(
        lambda q, t: _launch(q, t, heads, window, shift),
        lambda q, t: window_attention_plain(q, t, heads, window, shift),
        qkv.contiguous(), table.contiguous())


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _overlap_index_cpu(window: int, overlap: int) -> torch.Tensor:
    pad = (overlap - window) // 2
    q = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                   indexing="ij")).flatten(1)  # (2, ws^2)
    k = torch.stack(torch.meshgrid(torch.arange(overlap), torch.arange(overlap),
                                   indexing="ij")).flatten(1) - pad  # (2, ow^2)
    rel = (k[:, None, :] - q[:, :, None]) + (window - 1 + pad)  # (2, ws^2, ow^2)
    return rel[0] * (window + overlap - 1) + rel[1]


def overlap_position_index(window: int, overlap: int, device="cpu") -> torch.Tensor:
    """(window^2, overlap^2) long: the row of the cross-attention's bias table
    for each (query, key) pair of a window (row-major, the key window's
    origin ``(overlap - window) / 2`` up and left of the query window's):
    (dy + window - 1 + pad) (window + overlap - 1) + dx + window - 1 + pad,
    (dy, dx) the key's offset from its query."""
    return _overlap_index_cpu(window, overlap).to(device)


def _check_overlap(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                   overlap: int) -> None:
    n, h, w, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"qkv's {c3} channels are not 3 x heads x head width ({heads} heads)")
    if overlap < window or (overlap - window) % 2:
        raise ValueError(f"the key window {overlap} is not the window {window} plus a whole "
                         "padding on each side")
    if h % window or w % window:
        raise ValueError(f"the grid {h} x {w} is not a multiple of the window {window}")
    if tuple(table.shape) != ((window + overlap - 1) ** 2, heads):
        raise ValueError(f"the bias table has shape {tuple(table.shape)}, expected "
                         f"{((window + overlap - 1) ** 2, heads)}")


def overlap_attention_plain(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                            window: int, overlap: int) -> torch.Tensor:
    """The plain version of the cross-attention (module docstring): (N, H, W,
    3C) -> (N, H, W, C), the keys and values cut by ``F.unfold`` with zero
    padding."""
    _check_overlap(qkv, table, heads, window, overlap)
    n, h, w, c3 = qkv.shape
    c, ws, ow = c3 // 3, window, overlap
    d = c // heads
    nw = (h // ws) * (w // ws)
    q = qkv[..., :c].reshape(n, h // ws, ws, w // ws, ws, heads, d)
    q = q.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, heads, ws * ws, d) * d ** -0.5
    kv = F.unfold(qkv[..., c:].permute(0, 3, 1, 2), ow, padding=(ow - ws) // 2, stride=ws)
    kv = kv.view(n, 2, heads, d, ow * ow, nw).permute(1, 0, 5, 2, 4, 3)
    kv = kv.reshape(2, -1, heads, ow * ow, d)
    attn = q @ kv[0].transpose(-2, -1)
    attn = attn + table[overlap_position_index(ws, ow, qkv.device)].permute(2, 0, 1)
    o = torch.softmax(attn, dim=-1) @ kv[1]  # (n nW, heads, ws^2, d)
    o = o.view(n, h // ws, w // ws, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(n, h, w, c)


def overlap_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                      overlap: int) -> torch.Tensor:
    """(N, H, W, 3C) float32 -> (N, H, W, C) float32: the tiled kernel's
    cross-attention on a CUDA tensor, the plain version on a CPU tensor
    (module docstring)."""
    if not qkv.is_cuda:
        return overlap_attention_plain(qkv, table, heads, window, overlap)
    _check_overlap(qkv, table, heads, window, overlap)
    return kernel_with_plain_grad(
        lambda q, t: _launch(q, t, heads, window, 0, overlap),
        lambda q, t: overlap_attention_plain(q, t, heads, window, overlap),
        qkv.contiguous(), table.contiguous())

"""Shifted-window multi-head self-attention (Swin): the plain version and
the kernel wrapper.

It replaces no TPU kernel: the JAX package has no attention. It serves the
port's SwinIR generator (``models/swinir.py``), where it is the Swin layer's
``WindowAttention`` of the published code (Liang et al., SwinIR, 2021;
``SwinTransformerBlock.forward``) from the qkv projection's output to the
input of ``proj``:

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

``window_attention`` takes qkv (N, H, W, 3C) in token order, as ``qkv``'s
linear writes it (channel = part * C + head * d + i, part q, k, v), and
returns (N, H, W, C) in token order, ready for ``proj``. On a CPU tensor it
runs ``window_attention_plain`` (roll, partition, matmul, softmax,
matmul, reverse, roll). On a CUDA tensor it launches the kernel
``csrc/window_attn.cu`` once, which folds the shift and the window
partition and reverse into its indexing (no roll, no copy), computes the
mask from the token's region, adds the bias and the mask, takes an fp32
softmax and both products in fp32 on the CUDA cores (head width padded to
32 inside the kernel), for 8 x 8 windows and heads of at most 32 channels;
other sizes raise ``NotImplementedError`` at the launch.
Gradients: the backward is autograd of the plain version
(``_autograd.kernel_with_plain_grad``).
"""

from __future__ import annotations

import functools

import torch

from deepbedmap_tpu_torch.ops import _kernels
from deepbedmap_tpu_torch.ops._autograd import kernel_with_plain_grad

MASK_VALUE = -100.0
KERNEL_WINDOW = 8
KERNEL_MAX_HEAD_DIM = 32


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


def _launch(qkv, table, heads, window, shift):
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if window != KERNEL_WINDOW or d > KERNEL_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the window attention kernel takes {KERNEL_WINDOW} x {KERNEL_WINDOW} windows "
            f"and heads of at most {KERNEL_MAX_HEAD_DIM} channels, got window {window} and "
            f"{d}")
    _kernels.check_image_shape(n, h, w, c3)
    _kernels.check_tensor(qkv, "qkv", (n, h, w, c3))
    _kernels.check_tensor(table, "table", tuple(table.shape))
    out = torch.empty((n, h, w, c), device=qkv.device, dtype=torch.float32)
    _kernels.launch_window_attn(qkv, table, out, n, h, w, c, heads, shift, d ** -0.5)
    return out


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                     shift: int) -> torch.Tensor:
    """(N, H, W, 3C) float32 -> (N, H, W, C) float32: the kernel on a CUDA
    tensor, the plain version on a CPU tensor (module docstring)."""
    if not qkv.is_cuda:
        return window_attention_plain(qkv, table, heads, window, shift)
    _check(qkv, table, heads, window, shift)
    return kernel_with_plain_grad(
        lambda q, t: _launch(q, t, heads, window, shift),
        lambda q, t: window_attention_plain(q, t, heads, window, shift),
        qkv.contiguous(), table.contiguous())

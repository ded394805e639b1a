"""The plain SwinIR generator: the yardstick the port's ``models/swinir.py``
is held to.

Plain PyTorch, float32, importing nothing of the program under test and no
JAX. Written from the published model (Liang, Cao, Sun, Zhang, Van Gool,
Timofte, "SwinIR: Image Restoration Using Swin Transformer", ICCV Workshops
2021, arXiv:2108.10257; code github.com/JingyunLiang/SwinIR,
``models/network_swinir.py``): tokens (B, L, C), ``window_partition`` /
``window_reverse``, ``WindowAttention`` with the relative-position table and
index, ``SwinTransformerBlock`` with ``calculate_mask``, RSTBs closed by one
3x3 conv, ``forward_features``, the pixel-shuffle upsampler. No kernels: each
window's scores are materialised. Its defaults are the classical SR x4
"SwinIR-M" of ``main_test_swinir.py`` (embed 180, depths and heads 6 x 6,
window 8, MLP ratio 2, ``upsampler='pixelshuffle'``,
``resi_connection='1conv'``, ``patch_norm=True``, ``ape=False``,
``qkv_bias=True``).

Departures from the published model, as the port makes them:

- head: DeepBedMap's four-branch input block (Leong & Horgan 2020: VALID
  convs X 3x3, W1 30x30 stride 10, W2 6x6 stride 2, W3 3x3, each kernel
  stored as a 3x3 conv over space-to-depth channels in (row-in-block,
  column-in-block, channel) order) gives 4 x 32 channels, which
  ``conv_first`` reads in place of a 3-channel image;
- ``check_image_size``'s reflect padding applies to that latent, and the
  output is cropped to 4 x the latent;
- one output channel, no ``mean`` / ``img_range`` shift.

It reads NCHW inputs and the weights by the program's parameter names
(``param_spec``). ``precision`` names how the multiplicands of every
product (convs, linears, both attention products) are rounded before fp32
accumulation: 'fp32' (none), 'tf32' (10-bit mantissa, round to nearest, ties
away, as cvt.rna.tf32), 'bf16' or 'fp8' (e4m3, one scale per tensor);
``attn_precision`` does the same for the attention's two products alone.
``drop`` plants faults for the benchmark's calibration: 'bias' (no
relative-position bias), 'mask' (no shifted-window mask), 'shift' (no layer
shifted). Products of rounded multiplicands are exact in fp32, so on a card
the reference runs with TF32 off (``strict_fp32``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# SwinIR-M x4's published settings (main_test_swinir.py, classical_sr)
SWINIR_M = dict(embed_dim=180, depths=(6, 6, 6, 6, 6, 6), num_heads=(6, 6, 6, 6, 6, 6),
                window_size=8)
# the widths the published class fixes (upscale x4, MLP ratio 2,
# conv_before_upsample's 64), and the departures' one output channel and
# input block of 4 x 32 channels
UPSCALE = 4
MLP_RATIO = 2
NUM_FEAT = 64
OUT_CHANNELS = 1
INBLOCK_CHANNELS = 32
NORM_EPS = 1e-5
UPSAMPLE_SLOPE = 0.01
MASK_VALUE = -100.0
# one step down from each precision a configuration may state: the control
LOWER = {"fp32": "tf32", "tf32": "bf16", "bf16": "fp8"}


def settings(cfg: Optional[dict] = None) -> dict:
    """SwinIR-M's settings with the keys of ``cfg`` that name one."""
    return {**SWINIR_M, **{k: v for k, v in (cfg or {}).items() if k in SWINIR_M}}


@contextlib.contextmanager
def strict_fp32():
    """cuDNN convs and cuBLAS products in true fp32 while the block runs."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` (float32) with its values rounded to ``precision``, in float32."""
    if precision == "fp32":
        return t
    if precision == "tf32":
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "bf16":
        return t.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


def param_spec(cfg: Optional[dict] = None) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every parameter, kind one of 'input'
    (the input block's convs), 'conv', 'last' (``conv_last``), 'linear',
    'bias', 'norm_weight', 'norm_bias', 'table'; fan_in 0 where none."""
    s = settings(cfg)
    c, f, ws = s["embed_dim"], NUM_FEAT, s["window_size"]
    hidden = MLP_RATIO * c
    spec = []

    def conv(name, c_out, c_in, kind="conv"):
        spec.append((f"{name}.weight", (c_out, c_in, 3, 3), kind, 9 * c_in))
        spec.append((f"{name}.bias", (c_out,), "bias", 0))

    def linear(name, c_out, c_in):
        spec.append((f"{name}.weight", (c_out, c_in), "linear", c_in))
        spec.append((f"{name}.bias", (c_out,), "bias", 0))

    def norm(name):
        spec.append((f"{name}.weight", (c,), "norm_weight", 0))
        spec.append((f"{name}.bias", (c,), "norm_bias", 0))

    ib = INBLOCK_CHANNELS
    for branch, c_in in (("X", 1), ("W1", 100), ("W2", 8), ("W3", 1)):
        conv(f"input_block.conv_on_{branch}", ib, c_in, "input")
    conv("conv_first", c, 4 * ib)
    norm("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            norm(f"{b}.norm1")
            spec.append((f"{b}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads),
                         "table", 0))
            linear(f"{b}.attn.qkv", 3 * c, c)
            linear(f"{b}.attn.proj", c, c)
            norm(f"{b}.norm2")
            linear(f"{b}.mlp.fc1", hidden, c)
            linear(f"{b}.mlp.fc2", c, hidden)
        conv(f"layers.{i}.conv", c, c)
    norm("norm")
    conv("conv_after_body", c, c)
    conv("conv_before_upsample.0", f, c)
    for i in range(UPSCALE.bit_length() - 1):
        conv(f"upsample_convs.{i}", 4 * f, f)
    conv("conv_last", OUT_CHANNELS, f, "last")
    return spec


def conv(x, w, b, precision: str, stride: int = 1, padding: int = 1):
    return F.conv2d(round_to(x, precision), round_to(w, precision), b, stride=stride,
                    padding=padding)


def linear(x, w, b, precision: str):
    return F.linear(round_to(x, precision), round_to(w, precision), b)


def _strided_kernel(w: torch.Tensor, block: int, c_in: int) -> torch.Tensor:
    c_out = w.shape[0]
    k = w.reshape(c_out, block, block, c_in, 3, 3).permute(0, 3, 4, 1, 5, 2)
    return k.reshape(c_out, c_in, 3 * block, 3 * block)


def input_block(p, x, w1, w2, w3, precision: str) -> torch.Tensor:
    branches = []
    for key, a, block, c_in in (("X", x, 1, 1), ("W1", w1, 10, 1), ("W2", w2, 2, 2),
                                ("W3", w3, 1, 1)):
        k = _strided_kernel(p[f"input_block.conv_on_{key}.weight"], block, c_in)
        branches.append(conv(a, k, p[f"input_block.conv_on_{key}.bias"], precision,
                             stride=block, padding=0))
    return torch.cat(branches, 1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def calculate_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, MASK_VALUE).masked_fill(attn_mask == 0, 0.0)


def window_attention(x, p, name: str, heads: int, ws: int, mask, precision: str,
                     attn_precision: str, drop: Sequence[str]):
    """(nW B, N, C) windows -> (nW B, N, C): the published ``WindowAttention``."""
    b_, n, c = x.shape
    qkv = linear(x, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"], precision)
    qkv = qkv.reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = round_to(q, attn_precision) @ round_to(k, attn_precision).transpose(-2, -1)
    if "bias" not in drop:
        table = p[f"{name}.relative_position_bias_table"]
        bias = table[relative_position_index(ws).view(-1).to(table.device)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    x = (round_to(attn, attn_precision) @ round_to(v, attn_precision)).transpose(1, 2)
    return linear(x.reshape(b_, n, c), p[f"{name}.proj.weight"], p[f"{name}.proj.bias"],
                  precision)


def layer_norm(x, p, name: str):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], NORM_EPS)


def swin_block(x, x_size, p, name: str, heads: int, ws: int, shift: int, precision: str,
               attn_precision: str, drop: Sequence[str]):
    """The published ``SwinTransformerBlock`` on (B, L, C) tokens."""
    h, w = x_size
    b, _, c = x.shape
    if min(h, w) <= ws or "shift" in drop:  # a grid no wider than the window: no shift
        shift = 0
    shortcut = x
    x = layer_norm(x, p, f"{name}.norm1").view(b, h, w, c)
    shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x
    windows = window_partition(shifted, ws).view(-1, ws * ws, c)
    mask = None
    if shift and "mask" not in drop:
        mask = calculate_mask(h, w, ws, shift).to(x.device)
    windows = window_attention(windows, p, f"{name}.attn", heads, ws, mask, precision,
                               attn_precision, drop)
    shifted = window_reverse(windows.view(-1, ws, ws, c), ws, h, w)
    x = torch.roll(shifted, shifts=(shift, shift), dims=(1, 2)) if shift else shifted
    x = shortcut + x.view(b, h * w, c)
    y = layer_norm(x, p, f"{name}.norm2")
    y = F.gelu(linear(y, p[f"{name}.mlp.fc1.weight"], p[f"{name}.mlp.fc1.bias"], precision))
    return x + linear(y, p[f"{name}.mlp.fc2.weight"], p[f"{name}.mlp.fc2.bias"], precision)


def swinir(p: Dict[str, torch.Tensor], x, w1, w2, w3, cfg: Optional[dict] = None,
           precision: str = "fp32", attn_precision: Optional[str] = None,
           drop: Sequence[str] = ()) -> torch.Tensor:
    """NCHW inputs x (N,1,h,w), w1 (N,1,10h,10w), w2 (N,2,2h,2w), w3 (N,1,h,w)
    -> (N, 1, 4(h-2), 4(w-2)) float32."""
    s = settings(cfg)
    attn_precision = attn_precision or precision
    ws, c = s["window_size"], s["embed_dim"]
    z = input_block(p, x, w1, w2, w3, precision)
    lat_h, lat_w = z.shape[2], z.shape[3]
    # check_image_size
    z = F.pad(z, (0, -lat_w % ws, 0, -lat_h % ws), "reflect")
    first = conv(z, p["conv_first.weight"], p["conv_first.bias"], precision)
    # forward_features
    b, _, h, w = first.shape
    t = first.flatten(2).transpose(1, 2)
    t = layer_norm(t, p, "patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        res = t
        for j in range(depth):
            t = swin_block(t, (h, w), p, f"layers.{i}.residual_group.blocks.{j}", heads, ws,
                           0 if j % 2 == 0 else ws // 2, precision, attn_precision, drop)
        img = t.transpose(1, 2).view(b, c, h, w)
        t = conv(img, p[f"layers.{i}.conv.weight"], p[f"layers.{i}.conv.bias"],
                 precision).flatten(2).transpose(1, 2) + res
    t = layer_norm(t, p, "norm").transpose(1, 2).view(b, c, h, w)
    a = conv(t, p["conv_after_body.weight"], p["conv_after_body.bias"], precision) + first
    a = F.leaky_relu(conv(a, p["conv_before_upsample.0.weight"],
                          p["conv_before_upsample.0.bias"], precision), UPSAMPLE_SLOPE)
    for i in range(UPSCALE.bit_length() - 1):
        a = F.pixel_shuffle(conv(a, p[f"upsample_convs.{i}.weight"],
                                 p[f"upsample_convs.{i}.bias"], precision), 2)
    out = conv(a, p["conv_last.weight"], p["conv_last.bias"], precision)
    return out[:, :, : UPSCALE * lat_h, : UPSCALE * lat_w]


def widest_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| as a share of want's range, in float64;
    infinite where the shapes differ or ``got`` holds a non-finite value."""
    if tuple(got.shape) != tuple(want.shape) or not bool(torch.isfinite(got).all()):
        return float("inf")
    got, want = got.double(), want.double()
    span = float(want.max() - want.min())
    return float((got - want).abs().max()) / max(span, 1e-30)

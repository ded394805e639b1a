"""The plain HAT generator: the yardstick the port's ``models/hat.py`` is
held to.

Plain PyTorch, float32, importing nothing of the program under test and no
JAX (SwinIR's plain helpers come from ``swinir.py`` beside it). Written from
the published model (Chen, Wang, Zhou, Qiao, Dong, "Activating More Pixels
in Image Super-Resolution Transformer", CVPR 2023, arXiv:2205.04437; code
github.com/XPixelGroup/HAT, ``hat/archs/hat_arch.py``): tokens (B, L, C);
``HAB`` (``WindowAttention`` with the relative-position table and index,
``calculate_mask``, and beside it ``CAB``: conv3x3, GELU, conv3x3,
``ChannelAttention`` with ``AdaptiveAvgPool2d(1)``, its output times
``conv_scale``); ``OCAB`` (q in windows, k and v through a real
``nn.Unfold``-equivalent ``F.unfold`` with zero padding, rearranged as the
published ``rearrange`` does, each window's scores materialised);
``RHAG`` closed by one 3x3 conv; ``forward_features``; the pixel-shuffle
upsampler. No kernels. Its defaults are the x4 "HAT" of
``HAT_SRx4_ImageNet-pretrain.yml`` (embed 180, depths and heads 6 x 6, window
16, compress ratio 3, squeeze factor 30, conv scale 0.01, overlap ratio 0.5,
MLP ratio 2, ``upsampler='pixelshuffle'``, ``resi_connection='1conv'``,
``patch_norm=True``, ``ape=False``, ``qkv_bias=True``).

Departures from the published model, as the port makes them:

- head, padding, output: SwinIR's (``swinir.py``): DeepBedMap's four-branch
  input block gives 4 x 32 channels, which ``conv_first`` reads in place of
  a 3-channel image; the latent is reflect-padded to a multiple of the
  window (HAT's test-time ``pre_process``) and the output cropped to 4 x the
  latent; one output channel, no ``mean`` / ``img_range`` shift;
- the OCAB's bias order: ``calculate_rpi_oca`` below indexes the ((window +
  overlap - 1)^2, heads) table by the key's offset (dy, dx) from its query,
  shifted by window - 1 + pad so that every index lies in the table. The
  published one adds window - overlap + 1 to the offsets of the key window's
  own coordinates, which maps the same offsets one to one onto the table's
  rows in another order (through negative indices that wrap); with a drawn
  table the two orders are the same model;
- the channel attention's pool runs over the padded grid of the crop.

It reads NCHW inputs and the weights by the program's parameter names
(``param_spec``). ``precision`` and ``attn_precision`` are ``swinir.py``'s:
how the multiplicands of every product (convs, linears) and of the
attention's two products alone are rounded before fp32 accumulation.
``drop`` plants faults for the benchmark's calibration: 'bias' (no
relative-position bias, in the HABs and the OCABs), 'mask' (no shifted-window
mask), 'shift' (no block shifted), 'cab' (the CAB branch left out) and
'oca_pad' (the OCAB's zero-padded keys left out of the softmax, where they
belong in it). Products of rounded multiplicands are exact in fp32, so on a
card the reference runs with TF32 off (``strict_fp32``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .swinir import (  # noqa: F401  (LOWER, strict_fp32, widest_gap: the drivers')
    INBLOCK_CHANNELS,
    LOWER,
    MLP_RATIO,
    NUM_FEAT,
    OUT_CHANNELS,
    UPSAMPLE_SLOPE,
    UPSCALE,
    calculate_mask,
    conv,
    input_block,
    layer_norm,
    linear,
    round_to,
    strict_fp32,
    widest_gap,
    window_attention,
    window_partition,
    window_reverse,
)

# HAT x4's published settings (HAT_SRx4_ImageNet-pretrain.yml)
HAT_X4 = dict(embed_dim=180, depths=(6, 6, 6, 6, 6, 6), num_heads=(6, 6, 6, 6, 6, 6),
              window_size=16, compress_ratio=3, squeeze_factor=30, conv_scale=0.01,
              overlap_ratio=0.5)


def settings(cfg: Optional[dict] = None) -> dict:
    """HAT x4's settings with the keys of ``cfg`` that name one."""
    return {**HAT_X4, **{k: v for k, v in (cfg or {}).items() if k in HAT_X4}}


def overlap_window(s: dict) -> int:
    """OCAB's ``overlap_win_size``."""
    return int(s["window_size"] * s["overlap_ratio"]) + s["window_size"]


def param_spec(cfg: Optional[dict] = None) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every parameter, kind one of 'input'
    (the input block's convs), 'conv', 'cab' (the CAB's 3x3 convs), 'ca' (the
    channel attention's 1x1 convs), 'last' (``conv_last``), 'linear', 'bias',
    'norm_weight', 'norm_bias', 'table'; fan_in 0 where none."""
    s = settings(cfg)
    c, f, ws, ow = s["embed_dim"], NUM_FEAT, s["window_size"], overlap_window(s)
    hidden, mid, sq = MLP_RATIO * c, c // s["compress_ratio"], c // s["squeeze_factor"]
    spec = []

    def conv2d(name, c_out, c_in, kind="conv", k=3):
        spec.append((f"{name}.weight", (c_out, c_in, k, k), kind, k * k * c_in))
        spec.append((f"{name}.bias", (c_out,), "bias", 0))

    def lin(name, c_out, c_in):
        spec.append((f"{name}.weight", (c_out, c_in), "linear", c_in))
        spec.append((f"{name}.bias", (c_out,), "bias", 0))

    def norm(name):
        spec.append((f"{name}.weight", (c,), "norm_weight", 0))
        spec.append((f"{name}.bias", (c,), "norm_bias", 0))

    ib = INBLOCK_CHANNELS
    for branch, c_in in (("X", 1), ("W1", 100), ("W2", 8), ("W3", 1)):
        conv2d(f"input_block.conv_on_{branch}", ib, c_in, "input")
    conv2d("conv_first", c, 4 * ib)
    norm("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        g = f"layers.{i}.residual_group"
        for j in range(depth):
            b = f"{g}.blocks.{j}"
            norm(f"{b}.norm1")
            spec.append((f"{b}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads),
                         "table", 0))
            lin(f"{b}.attn.qkv", 3 * c, c)
            lin(f"{b}.attn.proj", c, c)
            norm(f"{b}.norm2")
            lin(f"{b}.mlp.fc1", hidden, c)
            lin(f"{b}.mlp.fc2", c, hidden)
            conv2d(f"{b}.conv_block.cab.0", mid, c, "cab")
            conv2d(f"{b}.conv_block.cab.2", c, mid, "cab")
            conv2d(f"{b}.conv_block.cab.3.attention.1", sq, c, "ca", 1)
            conv2d(f"{b}.conv_block.cab.3.attention.3", c, sq, "ca", 1)
        o = f"{g}.overlap_attn"
        spec.append((f"{o}.relative_position_bias_table", ((ws + ow - 1) ** 2, heads),
                     "table", 0))
        norm(f"{o}.norm1")
        lin(f"{o}.qkv", 3 * c, c)
        lin(f"{o}.proj", c, c)
        norm(f"{o}.norm2")
        lin(f"{o}.mlp.fc1", hidden, c)
        lin(f"{o}.mlp.fc2", c, hidden)
        conv2d(f"layers.{i}.conv", c, c)
    norm("norm")
    conv2d("conv_after_body", c, c)
    conv2d("conv_before_upsample.0", f, c)
    for i in range(UPSCALE.bit_length() - 1):
        conv2d(f"upsample_convs.{i}", 4 * f, f)
    conv2d("conv_last", OUT_CHANNELS, f, "last")
    return spec


def calculate_rpi_oca(ws: int, ow: int) -> torch.Tensor:
    """(ws^2, ow^2): the OCAB's bias row of each (query, key) pair, by the
    key's offset from its query (module docstring)."""
    coords_ori = torch.flatten(torch.stack(torch.meshgrid(
        [torch.arange(ws), torch.arange(ws)], indexing="ij")), 1)  # 2, ws*ws
    coords_ext = torch.flatten(torch.stack(torch.meshgrid(
        [torch.arange(ow), torch.arange(ow)], indexing="ij")), 1)  # 2, ow*ow
    rel = coords_ext[:, None, :] - coords_ori[:, :, None]  # 2, ws*ws, ow*ow
    rel = rel.permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1  # (ext - pad) - ori + ws - 1 + pad
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= ws + ow - 1
    return rel.sum(-1)


def mlp(x, p, name: str, precision: str):
    y = F.gelu(linear(x, p[f"{name}.fc1.weight"], p[f"{name}.fc1.bias"], precision))
    return linear(y, p[f"{name}.fc2.weight"], p[f"{name}.fc2.bias"], precision)


def cab(x, p, name: str, precision: str):
    """The published ``CAB`` on (B, C, H, W): conv3x3, GELU, conv3x3,
    ``ChannelAttention``."""
    y = conv(x, p[f"{name}.cab.0.weight"], p[f"{name}.cab.0.bias"], precision)
    y = conv(F.gelu(y), p[f"{name}.cab.2.weight"], p[f"{name}.cab.2.bias"], precision)
    a = F.adaptive_avg_pool2d(y, 1)
    a = F.relu(conv(a, p[f"{name}.cab.3.attention.1.weight"],
                    p[f"{name}.cab.3.attention.1.bias"], precision, padding=0))
    a = torch.sigmoid(conv(a, p[f"{name}.cab.3.attention.3.weight"],
                           p[f"{name}.cab.3.attention.3.bias"], precision, padding=0))
    return y * a


def hab(x, x_size, p, name: str, heads: int, ws: int, shift: int, conv_scale: float,
        precision: str, attn_precision: str, drop: Sequence[str]):
    """The published ``HAB`` on (B, L, C) tokens."""
    h, w = x_size
    b, _, c = x.shape
    if min(h, w) <= ws or "shift" in drop:  # a grid no wider than the window: no shift
        shift = 0
    shortcut = x
    x = layer_norm(x, p, f"{name}.norm1").view(b, h, w, c)
    conv_x = cab(x.permute(0, 3, 1, 2), p, f"{name}.conv_block", precision)
    conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, h * w, c)
    shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x
    windows = window_partition(shifted, ws).view(-1, ws * ws, c)
    mask = None
    if shift and "mask" not in drop:
        mask = calculate_mask(h, w, ws, shift).to(x.device)
    windows = window_attention(windows, p, f"{name}.attn", heads, ws, mask, precision,
                               attn_precision, drop)
    shifted = window_reverse(windows.view(-1, ws, ws, c), ws, h, w)
    attn_x = torch.roll(shifted, shifts=(shift, shift), dims=(1, 2)) if shift else shifted
    x = shortcut + attn_x.view(b, h * w, c)
    if "cab" not in drop:
        x = x + conv_x * conv_scale
    return x + mlp(layer_norm(x, p, f"{name}.norm2"), p, f"{name}.mlp", precision)


def ocab(x, x_size, p, name: str, heads: int, ws: int, ow: int, precision: str,
         attn_precision: str, drop: Sequence[str]):
    """The published ``OCAB`` on (B, L, C) tokens."""
    h, w = x_size
    b, _, c = x.shape
    pad = (ow - ws) // 2
    shortcut = x
    x = layer_norm(x, p, f"{name}.norm1").view(b, h, w, c)
    qkv = linear(x, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"], precision)
    qkv = qkv.reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)  # 3, b, c, h, w
    q = qkv[0].permute(0, 2, 3, 1)  # b, h, w, c
    kv = torch.cat((qkv[1], qkv[2]), dim=1)  # b, 2c, h, w
    q_windows = window_partition(q, ws).view(-1, ws * ws, c)
    kv_windows = F.unfold(kv, (ow, ow), stride=ws, padding=pad)  # b, 2c ow ow, nw
    nw = kv_windows.shape[-1]
    # rearrange 'b (nc ch owh oww) nw -> nc (b nw) (owh oww) ch'
    kv_windows = kv_windows.view(b, 2, c, ow * ow, nw).permute(1, 0, 4, 3, 2)
    kv_windows = kv_windows.reshape(2, b * nw, ow * ow, c)
    k_windows, v_windows = kv_windows[0], kv_windows[1]
    b_, nq, _ = q_windows.shape
    n = ow * ow
    d = c // heads
    q = q_windows.reshape(b_, nq, heads, d).permute(0, 2, 1, 3)
    k = k_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    v = v_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    q = q * d ** -0.5
    attn = round_to(q, attn_precision) @ round_to(k, attn_precision).transpose(-2, -1)
    if "bias" not in drop:
        table = p[f"{name}.relative_position_bias_table"]
        bias = table[calculate_rpi_oca(ws, ow).view(-1).to(table.device)].view(nq, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if "oca_pad" in drop:
        inside = F.unfold(torch.ones(1, 1, h, w, device=x.device), (ow, ow), stride=ws,
                          padding=pad)  # 1, ow ow, nw
        outside = torch.where(inside[0].t() > 0, 0.0, float("-inf"))  # nw, ow ow
        attn = (attn.view(b, nw, heads, nq, n) + outside[None, :, None, None, :]).view(
            b_, heads, nq, n)
    attn = torch.softmax(attn, dim=-1)
    out = (round_to(attn, attn_precision) @ round_to(v, attn_precision)).transpose(1, 2)
    out = window_reverse(out.reshape(b_, nq, c).view(-1, ws, ws, c), ws, h, w)
    x = linear(out.view(b, h * w, c), p[f"{name}.proj.weight"], p[f"{name}.proj.bias"],
               precision) + shortcut
    return x + mlp(layer_norm(x, p, f"{name}.norm2"), p, f"{name}.mlp", precision)


def hat(p: Dict[str, torch.Tensor], x, w1, w2, w3, cfg: Optional[dict] = None,
        precision: str = "fp32", attn_precision: Optional[str] = None,
        drop: Sequence[str] = ()) -> torch.Tensor:
    """NCHW inputs x (N,1,h,w), w1 (N,1,10h,10w), w2 (N,2,2h,2w), w3 (N,1,h,w)
    -> (N, 1, 4(h-2), 4(w-2)) float32."""
    s = settings(cfg)
    attn_precision = attn_precision or precision
    ws, c, ow = s["window_size"], s["embed_dim"], overlap_window(s)
    z = input_block(p, x, w1, w2, w3, precision)
    lat_h, lat_w = z.shape[2], z.shape[3]
    # pre_process's reflect padding to the window
    z = F.pad(z, (0, -lat_w % ws, 0, -lat_h % ws), "reflect")
    first = conv(z, p["conv_first.weight"], p["conv_first.bias"], precision)
    # forward_features
    b, _, h, w = first.shape
    t = first.flatten(2).transpose(1, 2)
    t = layer_norm(t, p, "patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        res = t
        g = f"layers.{i}.residual_group"
        for j in range(depth):
            t = hab(t, (h, w), p, f"{g}.blocks.{j}", heads, ws, 0 if j % 2 == 0 else ws // 2,
                    s["conv_scale"], precision, attn_precision, drop)
        t = ocab(t, (h, w), p, f"{g}.overlap_attn", heads, ws, ow, precision, attn_precision,
                 drop)
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

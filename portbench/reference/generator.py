"""The plain DeepBedMap generator: the yardstick that decides `correct`.

Plain PyTorch in NCHW, written from the published model (Leong & Horgan,
The Cryosphere 14, 3687-3705, 2020; srgan_train.py:201-576 of its code) and
importing nothing of the program under test. It reads the weights by the
program's parameter names (`param_spec`), which the benchmark draws itself,
and works out every derived form (the strided input convs' kernels, the
deformable samples) again:

- input block: four VALID convs, X 3x3, W1 30x30 stride 10, W2 6x6 stride 2,
  W3 3x3; a branch's kernel is stored as a 3x3 conv over the space-to-depth
  channels in (row-in-block, column-in-block, channel) order;
- pre-residual 3x3 conv and LeakyReLU(0.2); 12 residual-in-residual dense
  blocks (5 convs each, growth 32, LeakyReLU after the first four,
  out = x + 0.1 * conv5; an RRDB adds 0.1 * its three blocks to its input);
- post-residual conv plus the long skip; two (nearest x2, conv, LeakyReLU);
- two deformable convs (v1): 18 offsets from a 3x3 conv, rows [:9] the dy
  and [9:] the dx of each tap in row-major order, each clamped to +-2 px;
  bilinear samples with zero outside the image; LeakyReLU after the first.

`precision` names how the multiplicands of every product (convs and the
deformable contraction) are rounded before fp32 accumulation: 'fp32' (none),
'tf32' (10-bit mantissa, round to nearest, ties away, as cvt.rna.tf32),
'bf16' (round to nearest even) or 'fp8' (e4m3 with one scale per tensor).
`trunk_precision` does the same for the dense blocks alone. Products of
such multiplicands are exact in fp32, so on a card the reference runs with
TF32 off (`strict_fp32`) and gives the same rounding on a CPU.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

SLOPE = 0.2
CLAMP = 2
RESIDUAL_SCALING = 0.1
TAPS = 9
# one step down from each precision a configuration may state: the control
LOWER = {"fp32": "tf32", "tf32": "bf16", "bf16": "fp8"}


@contextlib.contextmanager
def strict_fp32():
    """cuDNN convs and cuBLAS products in true fp32 while the block runs."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def param_spec(blocks: int = 12, base: int = 64, growth: int = 32, inblock: int = 32,
               out_channels: int = 1) -> List[Tuple[str, tuple, Optional[int]]]:
    """(name, shape, fan_in) of every parameter; fan_in is None for a bias."""
    spec = []

    def conv(name, c_out, c_in):
        spec.append((f"{name}.weight", (c_out, c_in, 3, 3), 9 * c_in))
        spec.append((f"{name}.bias", (c_out,), None))

    for branch, c_in in (("X", 1), ("W1", 100), ("W2", 8), ("W3", 1)):
        conv(f"input_block.conv_on_{branch}", inblock, c_in)
    conv("pre_residual_conv_layer", base, 4 * inblock)
    for r in range(blocks):
        for d in (1, 2, 3):
            for j in range(5):
                conv(f"residual_network.{r}.residual_dense_block{d}.conv_layer{j + 1}",
                     growth if j < 4 else base, base + j * growth)
    for name in ("post_residual_conv_layer", "post_upsample_conv_layer_1",
                 "post_upsample_conv_layer_2", "final_conv_layer1"):
        conv(name, base, base)
    conv("final_conv_layer1.offset_conv", 18, base)
    conv("final_conv_layer2", out_channels, base)
    conv("final_conv_layer2.offset_conv", 18, base)
    return spec


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` (float32) with its values rounded to ``precision``, in float32;
    a gradient passes through the rounding unchanged."""
    if precision == "fp32":
        return t
    v = t.detach()
    if precision == "tf32":
        r = ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    elif precision == "bf16":
        r = v.to(torch.bfloat16).float()
    elif precision == "fp8":
        scale = v.abs().amax().clamp_min(1e-30) / 448.0
        r = (v / scale).to(torch.float8_e4m3fn).float() * scale
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return t + (r - v) if t.requires_grad else r


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, SLOPE * x)


def conv(x, w, b, precision: str, stride: int = 1, padding: int = 1):
    return F.conv2d(round_to(x, precision), round_to(w, precision), b, stride=stride,
                    padding=padding)


def _strided_kernel(w: torch.Tensor, block: int, c_in: int) -> torch.Tensor:
    """A 3x3 kernel over space-to-depth channels (bh, bw, c) as the
    (3 block) x (3 block) kernel it stands for."""
    c_out = w.shape[0]
    k = w.reshape(c_out, block, block, c_in, 3, 3).permute(0, 3, 4, 1, 5, 2)
    return k.reshape(c_out, c_in, 3 * block, 3 * block)


def dense_block(x, p: Dict[str, torch.Tensor], name: str, precision: str):
    acts = [x]
    for j in range(5):
        z = conv(torch.cat(acts, 1), p[f"{name}.conv_layer{j + 1}.weight"],
                 p[f"{name}.conv_layer{j + 1}.bias"], precision)
        if j < 4:
            acts.append(lrelu(z))
    return x + RESIDUAL_SCALING * z


def deform_conv(x, offsets, w, b, precision: str):
    """Deformable conv v1 of NCHW ``x`` with 3x3 ``w``, offsets clamped to
    +-CLAMP, zero outside the image: each tap's bilinear samples, then the
    contraction over channels and taps."""
    n, c, h, wd = x.shape
    flat = x.reshape(n, c, h * wd)
    ys = torch.arange(h, device=x.device).view(1, h, 1)
    xs = torch.arange(wd, device=x.device).view(1, 1, wd)
    out = None
    for t in range(TAPS):
        u, v = divmod(t, 3)
        dy = offsets[:, t].clamp(-CLAMP, CLAMP)
        dx = offsets[:, TAPS + t].clamp(-CLAMP, CLAMP)
        iy, ix = torch.floor(dy), torch.floor(dx)
        fy, fx = dy - iy, dx - ix
        r0 = ys + (u - 1) + iy.long()
        c0 = xs + (v - 1) + ix.long()
        sample = None
        for rr, wy in ((r0, 1.0 - fy), (r0 + 1, fy)):
            for cc, wx in ((c0, 1.0 - fx), (c0 + 1, fx)):
                valid = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < wd)
                idx = (rr.clamp(0, h - 1) * wd + cc.clamp(0, wd - 1)).view(n, 1, h * wd)
                got = torch.gather(flat, 2, idx.expand(n, c, h * wd)).view(n, c, h, wd)
                term = got * (wy * wx * valid)[:, None]
                sample = term if sample is None else sample + term
        part = torch.einsum("oc,nchw->nohw", round_to(w[:, :, u, v], precision),
                            round_to(sample, precision))
        out = part if out is None else out + part
    return out + b.view(1, -1, 1, 1)


def nearest2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def generator(p: Dict[str, torch.Tensor], x, w1, w2, w3, blocks: int = 12,
              precision: str = "fp32", trunk_precision: Optional[str] = None):
    """NCHW inputs x (N,1,h,w), w1 (N,1,10h,10w), w2 (N,2,2h,2w), w3 (N,1,h,w)
    -> (N, 1, 4(h-2), 4(w-2)) float32."""
    trunk_precision = trunk_precision or precision
    branches = []
    for key, a, block, c_in in (("X", x, 1, 1), ("W1", w1, 10, 1), ("W2", w2, 2, 2),
                                ("W3", w3, 1, 1)):
        k = _strided_kernel(p[f"input_block.conv_on_{key}.weight"], block, c_in)
        branches.append(conv(a, k, p[f"input_block.conv_on_{key}.bias"], precision,
                             stride=block, padding=0))
    a1 = lrelu(conv(torch.cat(branches, 1), p["pre_residual_conv_layer.weight"],
                    p["pre_residual_conv_layer.bias"], precision))
    t = a1
    for r in range(blocks):
        a = t
        for d in (1, 2, 3):
            a = dense_block(a, p, f"residual_network.{r}.residual_dense_block{d}",
                            trunk_precision)
        t = t + RESIDUAL_SCALING * a
    a = conv(t, p["post_residual_conv_layer.weight"], p["post_residual_conv_layer.bias"],
             precision) + a1
    for layer in ("post_upsample_conv_layer_1", "post_upsample_conv_layer_2"):
        a = lrelu(conv(nearest2(a), p[f"{layer}.weight"], p[f"{layer}.bias"], precision))
    for layer, act in (("final_conv_layer1", lrelu), ("final_conv_layer2", None)):
        off = conv(a, p[f"{layer}.offset_conv.weight"], p[f"{layer}.offset_conv.bias"],
                   precision)
        a = deform_conv(a, off, p[f"{layer}.weight"], p[f"{layer}.bias"], precision)
        if act is not None:
            a = act(a)
    return a


def widest_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| as a share of want's range, in float64;
    infinite where the shapes differ or ``got`` holds a non-finite value."""
    if tuple(got.shape) != tuple(want.shape) or not bool(torch.isfinite(got).all()):
        return float("inf")
    got, want = got.double(), want.double()
    span = float(want.max() - want.min())
    return float((got - want).abs().max()) / max(span, 1e-30)

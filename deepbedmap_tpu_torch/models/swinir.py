"""SwinIR as the port's second generator (Liang, Cao, Sun, Zhang, Van Gool,
Timofte, "SwinIR: Image Restoration Using Swin Transformer", ICCV Workshops
2021, arXiv:2108.10257; code github.com/JingyunLiang/SwinIR, class
``SwinIR``), NHWC at its forward, with DeepBedMap's ``Generator`` signature
and output geometry: x (N,h,w,1), w1 (N,10h,10w,1), w2 (N,2h,2w,2), w3
(N,h,w,1) -> (N, 4(h-2), 4(w-2), 1), so the engine, its halo and the band
loop take it as they take DeepBedMap.

As published (``SwinIRConfig``'s defaults are the classical SR x4
"SwinIR-M": embed 180, 6 RSTBs of 6 Swin layers, 6 heads, window 8, MLP
ratio 2, pixel-shuffle upsampler, one conv closing each RSTB):

- ``patch_embed``'s LayerNorm; each RSTB: its Swin layers (shift 0 on even
  layers, window / 2 on odd ones; LayerNorm, shifted-window attention,
  residual; LayerNorm, fc1, exact GELU, fc2, residual), then a 3x3 conv and
  the group's residual; the final LayerNorm, ``conv_after_body`` and the
  long residual;
- ``conv_before_upsample`` (embed -> 64) with LeakyReLU at PyTorch's
  default slope 0.01; two (3x3 conv 64 -> 256, pixel shuffle x2);
  ``conv_last`` (64 -> out);
- LayerNorm eps 1e-5, qkv with bias, scale d^-0.5, the (2 window - 1)^2 x
  heads relative-position table indexed as Swin indexes it, the shifted
  layers' mask -100 between regions (``ops.window_attn``); a layer whose
  grid is no wider than the window has no shift, as published.

The departures:

- **Head.** DeepBedMap's four-branch ``InputBlock`` reads the four rasters
  and gives 4 x 32 channels at (h-2)^2; ``conv_first`` (3x3 SAME, 128 ->
  embed, no activation) reads them where the published one reads a
  3-channel image.
- **Window padding.** That latent is reflect-padded on its bottom and right
  to a multiple of the window, as ``check_image_size`` pads its input;
  everything after runs at the padded size and the output is cropped to
  4 (h-2) x 4 (w-2), as the published forward crops to H * scale.
- **Output.** One channel (a bed DEM in metres), no ``mean`` /
  ``img_range`` shift: the rasters enter as DeepBedMap takes them.

On a CUDA tensor the attention of each Swin layer is one launch of the
window kernel (``csrc/window_attn.cu`` at 8 x 8 windows, the tiled
``csrc/window_attn_tiled.cu`` at windows whose square is a multiple of 128;
``ops.window_attn`` refuses other windows and heads wider than 32
channels); the LayerNorms, linears (cuBLAS),
GELU, residuals and convs (cuDNN) are PyTorch, fp32 with TF32 off as the
caller sets it (``device.disable_tf32``). On a CPU tensor the kernel's plain
version runs. Telemetry (``utils.profiling``): device spans ``swin.msa``
(qkv, the kernel, proj: from LayerNorm 1's output to proj's), ``swin.attn``
(the kernel alone, inside it), ``swin.mlp`` (LayerNorm 2, fc1, GELU, fc2),
``swin.rstb_conv``; counters ``swin.attn.calls``, ``swin.windows`` (windows
x heads attended) and ``swin.pad_px`` (pixels the window padding adds).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from deepbedmap_tpu_torch.config import (
    SWINIR_INBLOCK_CHANNELS,
    SWINIR_MLP_RATIO,
    SWINIR_NUM_FEAT,
    SWINIR_OUT_CHANNELS,
    SWINIR_UPSCALE,
    SwinIRConfig,
    check_swinir,
)
from deepbedmap_tpu_torch.models.blocks import Conv3x3, InputBlock
from deepbedmap_tpu_torch.ops.conv import conv_nhwc, leaky_relu
from deepbedmap_tpu_torch.ops.window_attn import window_attention
from deepbedmap_tpu_torch.utils.profiling import count, device_span

UPSAMPLE_SLOPE = 0.01  # nn.LeakyReLU's default, as published
LINEAR_INIT_STD = 0.02  # trunc_normal_(std=.02); its +-2 cut never binds


def apply_conv(layer: Conv3x3, x: torch.Tensor) -> torch.Tensor:
    return conv_nhwc(x, layer.weight, layer.bias, 1)


def pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """``nn.PixelShuffle(r)`` of an NHWC tensor: channel c * r^2 + i * r + j
    goes to (r y + i, r x + j) of channel c."""
    n, h, w, c = x.shape
    x = x.view(n, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


def reflect_pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``F.pad(x, (0, pw, 0, ph), 'reflect')`` of the NCHW view of an NHWC
    tensor, pw and ph the least that make W and H multiples of
    ``multiple``; contiguous NHWC out."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = -h % multiple, -w % multiple
    if not (ph or pw):
        return x

    def index(n, p):
        i = torch.arange(n + p, device=x.device)
        return torch.where(i < n, i, 2 * (n - 1) - i)

    return x.index_select(1, index(h, ph)).index_select(2, index(w, pw))


class WindowAttention(nn.Module):
    """qkv, the window kernel and proj: (N, H, W, C) -> (N, H, W, C)."""

    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window, self.heads = window, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        n, h, w, _ = x.shape
        qkv = self.qkv(x)
        count("swin.attn.calls")
        count("swin.windows", n * (h // self.window) * (w // self.window) * self.heads)
        with device_span("swin.attn", x.device):
            o = window_attention(qkv, self.relative_position_bias_table, self.heads,
                                 self.window, shift)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def mlp_residual(norm: nn.LayerNorm, mlp: Mlp, x: torch.Tensor) -> torch.Tensor:
    """``x + mlp(norm(x))``, the MLP under the device span ``swin.mlp``."""
    with device_span("swin.mlp", x.device):
        h = mlp(norm(x))
    return x + h


class SwinLayer(nn.Module):
    """The published ``SwinTransformerBlock`` on an NHWC grid."""

    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, SWINIR_MLP_RATIO * dim)

    def msa(self, h: torch.Tensor) -> torch.Tensor:
        """The shifted-window attention of LayerNorm 1's output, under the
        device span ``swin.msa``."""
        shift = self.shift if min(h.shape[1], h.shape[2]) > self.window else 0
        with device_span("swin.msa", h.device):
            return self.attn(h, shift)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.msa(self.norm1(x))
        return mlp_residual(self.norm2, self.mlp, x)


class RSTB(nn.Module):
    """Residual Swin transformer block: ``depth`` layers (``layer(dim, heads,
    window, shift)``, shift 0 on even layers and window / 2 on odd ones), a
    3x3 conv under the device span ``conv_span``, the group's residual."""

    conv_span = "swin.rstb_conv"

    def __init__(self, dim: int, depth: int, heads: int, window: int, layer=SwinLayer):
        super().__init__()
        self.residual_group = nn.ModuleDict({"blocks": nn.ModuleList(
            layer(dim, heads, window, 0 if i % 2 == 0 else window // 2)
            for i in range(depth))})
        self.conv = Conv3x3(dim, dim)

    def group(self, t: torch.Tensor) -> torch.Tensor:
        for layer in self.residual_group["blocks"]:
            t = layer(t)
        return t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.group(x)
        with device_span(self.conv_span, x.device):
            return apply_conv(self.conv, t) + x


class SwinIR(nn.Module):
    """SwinIR behind DeepBedMap's input block (module docstring). A subclass
    sets ``check`` and ``make_group`` to build another model on the same
    head, trunk loop, upsampler and crop (``models.hat.HAT``)."""

    check = staticmethod(check_swinir)

    def __init__(self, cfg: SwinIRConfig = SwinIRConfig()):
        super().__init__()
        self.check(cfg)
        self.cfg = cfg
        c, f = cfg.embed_dim, SWINIR_NUM_FEAT
        self.input_block = InputBlock(SWINIR_INBLOCK_CHANNELS)
        self.conv_first = Conv3x3(4 * SWINIR_INBLOCK_CHANNELS, c)
        self.patch_embed = nn.ModuleDict({"norm": nn.LayerNorm(c)})
        self.layers = nn.ModuleList(self.make_group(depth, heads)
                                    for depth, heads in zip(cfg.depths, cfg.num_heads))
        self.norm = nn.LayerNorm(c)
        self.conv_after_body = Conv3x3(c, c)
        self.conv_before_upsample = nn.ModuleList([Conv3x3(c, f)])
        # the published Upsample's convs (a PixelShuffle after each); not
        # named `upsample`, which is the stage method
        self.upsample_convs = nn.ModuleList(Conv3x3(f, 4 * f)
                                            for _ in range(SWINIR_UPSCALE.bit_length() - 1))
        self.conv_last = Conv3x3(f, SWINIR_OUT_CHANNELS)

    def make_group(self, depth: int, heads: int) -> nn.Module:
        """One residual group of the trunk: an RSTB."""
        return RSTB(self.cfg.embed_dim, depth, heads, self.cfg.window_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The published initialisation, drawn from ``generator``: linears
        and the bias tables N(0, 0.02^2) with zero biases, LayerNorms 1 and
        0, convs PyTorch's default (U(+-1/sqrt(fan_in)) for the weight and
        the bias)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, LINEAR_INIT_STD, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif "relative_position_bias_table" in m._parameters:
                    m.relative_position_bias_table.normal_(0.0, LINEAR_INIT_STD,
                                                           generator=generator)
                elif isinstance(m, (Conv3x3, nn.Conv2d)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.uniform_(-bound, bound, generator=generator)

    # the forward's four stages, as Generator's, which the benchmark times

    def head(self, x, w1, w2, w3) -> torch.Tensor:
        """The input block, the window padding and ``conv_first``."""
        z = self.input_block(x, w1, w2, w3)
        n, h, w, _ = z.shape
        z = reflect_pad_to(z, self.cfg.window_size)
        count("swin.pad_px", n * (z.shape[1] * z.shape[2] - h * w))
        return apply_conv(self.conv_first, z)

    def trunk(self, a1: torch.Tensor) -> torch.Tensor:
        """``forward_features``: the patch norm, the RSTBs, the final norm."""
        t = self.patch_embed["norm"](a1)
        for rstb in self.layers:
            t = rstb(t)
        return self.norm(t)

    def upsample(self, t: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
        """``conv_after_body`` and the long residual, ``conv_before_upsample``
        and the pixel-shuffle stages."""
        a = apply_conv(self.conv_after_body, t) + a1
        a = leaky_relu(apply_conv(self.conv_before_upsample[0], a), UPSAMPLE_SLOPE)
        for conv in self.upsample_convs:
            a = pixel_shuffle_nhwc(apply_conv(conv, a), 2)
        return a

    def tail(self, a4: torch.Tensor) -> torch.Tensor:
        """``conv_last`` at the padded size."""
        return apply_conv(self.conv_last, a4)

    def forward(self, x, w1, w2, w3) -> torch.Tensor:
        """NHWC inputs as ``Generator.forward`` -> (N, 4(h-2), 4(w-2), 1)
        float32: the padded output cropped."""
        a1 = self.head(x, w1, w2, w3)
        out = self.tail(self.upsample(self.trunk(a1), a1))
        s = SWINIR_UPSCALE
        return out[:, : s * (x.shape[1] - 2), : s * (x.shape[2] - 2)]

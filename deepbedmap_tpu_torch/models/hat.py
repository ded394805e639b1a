"""HAT, the Hybrid Attention Transformer, as the port's third generator (Chen,
Wang, Zhou, Qiao, Dong, "Activating More Pixels in Image Super-Resolution
Transformer", CVPR 2023, arXiv:2205.04437; code github.com/XPixelGroup/HAT,
``hat/archs/hat_arch.py``), NHWC at its forward, with DeepBedMap's
``Generator`` signature and output geometry, on SwinIR's head, trunk loop,
upsampler and crop (``models.swinir``): x (N,h,w,1), w1 (N,10h,10w,1), w2
(N,2h,2w,2), w3 (N,h,w,1) -> (N, 4(h-2), 4(w-2), 1).

As published (``HATConfig``'s defaults are the x4 "HAT" of
``HAT_SRx4_ImageNet-pretrain.yml``: embed 180, 6 RHAGs of 6 HABs, 6 heads,
window 16, compress ratio 3, squeeze factor 30, conv scale 0.01, overlap
ratio 0.5, MLP ratio 2, pixel-shuffle upsampler, one conv closing each
RHAG):

- HAB (hybrid attention block; shift 0 on even blocks, window / 2 on odd
  ones): x_n = LN1(x); attn = proj(W-MSA(x_n)) as SwinIR's Swin layer
  computes it (``SwinLayer.msa``: qkv with bias, scale d^-0.5, the (2
  window - 1)^2 x heads table, the shifted blocks' mask -100); cab =
  CA(conv3x3(GELU(conv3x3(x_n)))), embed -> embed / compress -> embed, with
  CA(y) = y * sigmoid(conv1x1(ReLU(conv1x1(avgpool_HW(y))))), embed ->
  embed / squeeze -> embed, the pool over the whole grid; x = x + attn +
  conv_scale * cab; x = x + fc2(GELU(fc1(LN2(x))));
- OCAB (overlapping cross-attention block, one a group after its HABs): qkv
  = Linear(LN1(x)); q in window x window windows, k and v in (window +
  int(overlap_ratio window))^2 windows centred on them with zero padding
  (``ops.window_attn.overlap_attention``); x = x + proj(attn); x = x +
  MLP(LN2(x));
- RHAG: the HABs, the OCAB, a 3x3 conv and the group's residual; the rest
  (``patch_embed``'s LayerNorm, the final LayerNorm, ``conv_after_body``,
  the long residual, the upsampler) is SwinIR's.

The departures, SwinIR's first (``models.swinir``):

- **Head, padding, output.** DeepBedMap's four-branch ``InputBlock`` and
  ``conv_first`` (128 -> embed) in place of the 3-channel image's conv; the
  latent reflect-padded on its bottom and right to a multiple of the window
  (286^2 -> 288^2 at the continent's crop, as HAT's test-time
  ``pre_process`` pads its input), the output cropped to 4 (h-2) x 4 (w-2);
  one output channel; no ``mean`` / ``img_range`` shift.
- **OCAB bias order.** The cross-attention's table is indexed by the key's
  offset (dy, dx) from its query, (dy + window - 1 + pad) (window + overlap
  - 1) + dx + window - 1 + pad (``ops.window_attn.overlap_position_index``).
  The published ``calculate_rpi_oca`` maps the same offsets one to one onto
  the table's rows in another order; with a drawn table the two orders are
  the same model.
- **Channel-attention pool.** It averages over the padded grid of each
  forward's crop, halo included, so a tile's output depends on its own crop
  as everything else here does.

On a CUDA tensor each HAB's attention is one launch of the tiled window
kernel (``csrc/window_attn_tiled.cu``, counted as ``window_attn_tiled``)
and each OCAB's one launch of its cross-attention case
(``overlap_attn_tiled``): no roll, no partition, no unfold of k and v runs
on the card. The LayerNorms, linears (cuBLAS), GELU, residuals, the CAB's
convs (cuDNN) and its channel attention are PyTorch, fp32 with TF32 off as
the caller sets it (``device.disable_tf32``). On a CPU tensor the kernels'
plain versions run. Telemetry (``utils.profiling``): the HAB's Swin part
records SwinIR's ``swin.msa``, ``swin.attn``, ``swin.mlp`` and ``swin.*``
counters (the OCAB's MLP too); device spans ``hat.cab`` (conv, GELU, conv,
the channel attention and the conv scale), ``hat.oca`` (from the OCAB's
LayerNorm 1 output through qkv, the kernel and proj), ``hat.oca_attn`` (the
kernel alone, inside it), ``hat.rhag_conv``; counters ``hat.cab.calls``,
``hat.oca.calls`` and ``hat.oca.pad_keys`` (key positions of the zero
padding attended, over windows and heads).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from deepbedmap_tpu_torch.config import SWINIR_MLP_RATIO, HATConfig, check_hat
from deepbedmap_tpu_torch.models.blocks import Conv3x3
from deepbedmap_tpu_torch.models.swinir import (
    RSTB,
    Mlp,
    SwinIR,
    SwinLayer,
    apply_conv,
    mlp_residual,
)
from deepbedmap_tpu_torch.ops.window_attn import overlap_attention
from deepbedmap_tpu_torch.utils.profiling import count, device_span


class ChannelAttention(nn.Module):
    """The published ``ChannelAttention`` on an NHWC tensor; its 1x1 convs
    act on the pooled (N, C) vector as linears."""

    def __init__(self, dim: int, squeeze: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // squeeze, 1), nn.ReLU(),
            nn.Conv2d(dim // squeeze, dim, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        down, up = self.attention[1], self.attention[3]
        y = F.relu(F.linear(x.mean((1, 2)), down.weight.flatten(1), down.bias))
        y = torch.sigmoid(F.linear(y, up.weight.flatten(1), up.bias))
        return x * y[:, None, None, :]


class CAB(nn.Module):
    """The channel-attention block: conv3x3, GELU, conv3x3, channel
    attention (the published ``nn.Sequential``'s names)."""

    def __init__(self, dim: int, compress: int, squeeze: int):
        super().__init__()
        self.cab = nn.Sequential(Conv3x3(dim, dim // compress), nn.GELU(),
                                 Conv3x3(dim // compress, dim), ChannelAttention(dim, squeeze))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = apply_conv(self.cab[2], F.gelu(apply_conv(self.cab[0], x)))
        return self.cab[3](y)


class HAB(SwinLayer):
    """The hybrid attention block: SwinIR's Swin layer with the CAB beside
    its attention."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, compress: int,
                 squeeze: int, conv_scale: float):
        super().__init__(dim, heads, window, shift)
        self.conv_scale = conv_scale
        self.conv_block = CAB(dim, compress, squeeze)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        count("hat.cab.calls")
        with device_span("hat.cab", x.device):
            cab = self.conv_block(h) * self.conv_scale
        x = x + self.msa(h) + cab
        return mlp_residual(self.norm2, self.mlp, x)


@functools.lru_cache(maxsize=64)
def pad_keys(h: int, w: int, window: int, overlap: int) -> int:
    """Key positions of the zero padding over an (h, w) grid's windows: each
    window's overlap^2 keys less those inside the grid."""
    pad = (overlap - window) // 2

    def inside(n):
        return [min(n, window * i - pad + overlap) - max(0, window * i - pad)
                for i in range(n // window)]

    return sum(overlap * overlap - a * b for a in inside(h) for b in inside(w))


class OCAB(nn.Module):
    """The overlapping cross-attention block (module docstring)."""

    def __init__(self, dim: int, heads: int, window: int, overlap: int):
        super().__init__()
        self.heads, self.window, self.overlap = heads, window, overlap
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window + overlap - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, SWINIR_MLP_RATIO * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, hh, ww, _ = x.shape
        h = self.norm1(x)
        count("hat.oca.calls")
        count("hat.oca.pad_keys", n * self.heads * pad_keys(hh, ww, self.window, self.overlap))
        with device_span("hat.oca", x.device):
            qkv = self.qkv(h)
            with device_span("hat.oca_attn", x.device):
                o = overlap_attention(qkv, self.relative_position_bias_table, self.heads,
                                      self.window, self.overlap)
            h = self.proj(o)
        return mlp_residual(self.norm2, self.mlp, x + h)


class RHAG(RSTB):
    """The residual hybrid attention group: HABs, the OCAB, a 3x3 conv, the
    group's residual."""

    conv_span = "hat.rhag_conv"

    def __init__(self, dim: int, depth: int, heads: int, cfg: HATConfig):
        super().__init__(dim, depth, heads, cfg.window_size, functools.partial(
            HAB, compress=cfg.compress_ratio, squeeze=cfg.squeeze_factor,
            conv_scale=cfg.conv_scale))
        self.residual_group["overlap_attn"] = OCAB(dim, heads, cfg.window_size,
                                                   cfg.overlap_window)

    def group(self, t: torch.Tensor) -> torch.Tensor:
        return self.residual_group["overlap_attn"](super().group(t))


class HAT(SwinIR):
    """HAT behind DeepBedMap's input block (module docstring)."""

    check = staticmethod(check_hat)

    def __init__(self, cfg: HATConfig = HATConfig()):
        super().__init__(cfg)

    def make_group(self, depth: int, heads: int) -> nn.Module:
        return RHAG(self.cfg.embed_dim, depth, heads, self.cfg)

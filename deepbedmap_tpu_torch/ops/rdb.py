"""Residual dense blocks: the plain versions and the K1, K4, K5 and K6 kernel
wrappers.

Counterpart of ``deepbedmap_tpu/ops/pallas_rdb.py``. ``rdb_reference`` is the
port of its ``rdb_reference`` (the plain composition of five 3x3 SAME convs)
and, at a compute dtype, of JAX's XLA dense block: it is the plain trunk's
block (``config.trunk_kernel`` 'plain', e.g. ``fused_rdb='never'`` or
bfloat16 at the defaults), which runs PyTorch's convs on either device, as
JAX runs XLA's. Two kernels compute it on the card: ``rdb_fused``, K1 (``csrc/rdb.cu``
``rdb_forward``, the resident trunk's block: five conv launches on a dense
(N, H, W, 192) workspace in device memory, each a 3xTF32 implicit GEMM on
the tensor cores, ``csrc/conv3x3_tc.cuh``), and ``rdb_banded``, K6
(``csrc/rdb_banded.cu``, the non-resident trunk's block: one launch, the
intermediates of each 8 x 16 tile in shared memory). ``rrdb_reference`` is a
whole residual-in-residual block (three dense blocks and the scaled outer
skip), the function of the JAX ``rrdb_pallas_flat`` and
``rrdb_sweep_pallas_flat``; ``rrdb_fused`` runs it as K4 (``rrdb_forward``,
two workspaces in ping-pong) and ``rrdb_sweep`` as K5
(``csrc/rrdb_sweep.cu``, one cooperative launch sweeping row bands, the
block outputs in band rings). K5 and K6 share ``csrc/rdb_tile.cuh``, one
8 x 16 tile of a dense block on the tensor cores (3xTF32 ``wgmma``, or bf16
``wgmma`` with ``mxu_bf16``) with its intermediates in shared memory. Each
wrapper takes its kernel for a CUDA tensor
and the plain version for a CPU tensor. There is no size rule and no
fallback: any N, H, W >= 1 go through the kernels on the card.

Gradients: K1 on its fp32 route has a backward kernel (``_RdbFused``,
``rdb_backward``, ``csrc/rdb_backward.cu``): it reads the forward's own
workspace (x and a1..a4) and runs the dgrad chain and the weight gradients in
3xTF32 on the tensor cores; its plain version is ``rdb_backward_plain``. Every
other CUDA branch (K1's bf16 route, K4, K5, K6) goes through
``_autograd.kernel_with_plain_grad``: the forward is the kernel, the backward
autograd of ``rdb_reference`` / ``rrdb_reference`` recomputed on the saved
input and source weights, as the JAX custom VJPs do
(``pallas_rdb.py:310-332``, ``:665-695``, ``:949-981``, ``:1275-1288``). The
packed weights carry no gradient; it goes to the kernels and biases.

bf16 multiplicands (``mxu_bf16=True``, the JAX kernels' ``mxu_bf16``,
``pallas_rdb.py:124-128``): every conv's input and weight are rounded to
bf16 (to nearest even) and everything else stays float32: accumulation,
biases, LeakyReLU, the dense concat and both skips. A later stage reads the
float32 activations of the earlier ones and rounds them only at its own dot.
``rdb_reference(mxu_bf16=True)`` is the plain version; the kernels take
their bf16 route, bf16 ``wgmma`` k16 on weights the packers round and pack
in bf16: K1 and K4 in ``csrc/conv3x3_tc.cuh`` (``pack_rdb_weights`` /
``pack_rrdb_weights`` with ``mxu_bf16``), K6 and K5 in ``csrc/rdb_tile.cuh``
(``pack_rdb_weights_tc`` / ``pack_rrdb_weights_tc`` with ``mxu_bf16``, the
same bytes), which keep the tile's input and intermediates in bf16. As in JAX
(``pallas_rdb.py:321-329, 686-692``) the mode's gradient is that of the
float32 plain version: the rounding is not differentiated, on either
device.

Layout: NHWC at every function; the JAX kernels' flat row-band layout is not
carried over. Conv weights are OIHW, as everywhere in the port; each wrapper
packs them for its kernel through ``_packed.packed`` (once per version of
the weights): ``pack_rdb_weights`` / ``pack_rrdb_weights`` for K1 / K4,
``pack_rdb_weights_tc`` / ``pack_rrdb_weights_tc`` (split into TF32 hi/lo;
in bf16 with ``mxu_bf16``) for K6 / K5; ``pack_rdb_dgrad_weights`` for K1's
backward.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from deepbedmap_tpu_torch.ops import _kernels
from deepbedmap_tpu_torch.ops._autograd import kernel_with_plain_grad, needs_grad
from deepbedmap_tpu_torch.ops._packed import packed
from deepbedmap_tpu_torch.ops.conv import conv_nhwc, leaky_relu, round_bf16, scaled
from deepbedmap_tpu_torch.ops.conv3x3 import pack_conv_weight
from deepbedmap_tpu_torch.ops.deform_conv import tf32_split
from deepbedmap_tpu_torch.utils.profiling import device_span

FEATURES = 64
GROWTH = 32
WORKSPACE = FEATURES + 4 * GROWTH  # channels of the kernels' dense workspace


def _stage_shapes() -> List[Tuple[int, int]]:
    """(C_out, C_in) of the dense block's five convs."""
    return [(GROWTH if j < 4 else FEATURES, FEATURES + GROWTH * j) for j in range(5)]


# values of one block's packed weights: 9 x sum_j C_in_j x C_out_j
_BLOCK_WEIGHTS = sum(9 * c_out * c_in for c_out, c_in in _stage_shapes())


def rdb_reference(
    x: torch.Tensor,  # (N, H, W, F)
    kernels: Sequence[torch.Tensor],  # five OIHW (C_out_j, C_in_j, 3, 3)
    biases: Sequence[torch.Tensor],  # five (C_out_j,)
    scaling: float,
    dtype: Optional[torch.dtype] = None,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """out = x + scaling * conv5(dense(x)), LeakyReLU(0.2) after conv1-4: JAX's
    XLA composition (``models/blocks.py:182-202``). With a ``dtype`` each
    conv takes its input, kernel and bias in it and rounds as flax's
    (``ops.conv.conv_nhwc``); the concatenations, the LeakyReLUs and the
    residual follow PyTorch's type promotion, which is JAX's, so a bfloat16
    block computes in bfloat16 and one whose input is float32 returns
    float32, as JAX's. ``mxu_bf16`` rounds each conv's input and weight to
    bf16 and computes the rest as it stands (module docstring)."""
    acts = [x]
    for j in range(5):
        a, k = torch.cat(acts, -1), kernels[j]
        if mxu_bf16:
            a, k = round_bf16(a), round_bf16(k)
        z = conv_nhwc(a, k, biases[j], 1, dtype)
        if j < 4:
            acts.append(leaky_relu(z))
    return x + scaled(scaling, z)


def pack_rdb_weights(
    kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
    mxu_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weight layout: each stage as ``pack_conv_weight`` packs
    it (in bf16, in the bf16 route's layout, with ``mxu_bf16``), the five
    stages back to back, and the five biases concatenated."""
    w = torch.cat([pack_conv_weight(k, mxu_bf16) for k in kernels]).contiguous()
    b = torch.cat([b_.detach() for b_ in biases]).contiguous()
    return w, b


_SLOT_CHANNELS = torch.tensor([2 * (k % 4) + k // 4 for k in range(8)])


def _pack_stage_tc(kernel: torch.Tensor, mxu_bf16: bool = False) -> torch.Tensor:
    """One stage's OIHW (C_out, C_in, 3, 3) kernel as ``csrc/rdb_tile.cuh``
    streams it: per 8-channel chunk c, kernel row ky and column kx, hi then lo
    (``tf32_split``), each the (8, C_out) B operand of one wgmma k8 step in
    its K-major core-matrix layout [n / 8][k / 4][n % 8][k % 4]. Slot k takes
    channel 8 c + 2 (k % 4) + k // 4, the order in which a lane reads its A
    values (conv3x3_tc.cuh's). With ``mxu_bf16`` the bf16 route's: the
    kernel rounded to bf16 as ``pack_conv_weight(mxu_bf16=True)`` packs it,
    per 16 input channels and tap the k16 B descriptor's core matrices
    (stage 5's second N half 4 core-matrix rows further on)."""
    if mxu_bf16:
        return pack_conv_weight(kernel, True)
    c_out, c_in = kernel.shape[:2]
    w = kernel.detach().float().permute(1, 2, 3, 0)  # (C_in, ky, kx, C_out)
    w = w.reshape(c_in // 8, 8, 3, 3, c_out)[:, _SLOT_CHANNELS.to(w.device)]
    w = w.reshape(c_in // 8, 2, 4, 3, 3, c_out // 8, 8).permute(0, 3, 4, 5, 1, 6, 2)
    return torch.stack(tf32_split(w), dim=3).reshape(-1)


def pack_rdb_weights_tc(
    kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
    mxu_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's layout: the five stages' ``_pack_stage_tc`` back to back (twice
    ``pack_rdb_weights``' floats: hi and lo; with ``mxu_bf16`` the bf16
    tensor ``pack_rdb_weights(mxu_bf16=True)`` gives), and the five biases
    concatenated."""
    w = torch.cat([_pack_stage_tc(k, mxu_bf16) for k in kernels]).contiguous()
    b = torch.cat([b_.detach() for b_ in biases]).contiguous()
    return w, b


def pack_rrdb_weights_tc(
    kernels: Sequence[Sequence[torch.Tensor]], biases: Sequence[Sequence[torch.Tensor]],
    mxu_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's layout: the three blocks' ``pack_rdb_weights_tc`` back to back."""
    packs = [pack_rdb_weights_tc(ks, bs, mxu_bf16) for ks, bs in zip(kernels, biases)]
    return (torch.cat([w for w, _ in packs]).contiguous(),
            torch.cat([b for _, b in packs]).contiguous())


def _kernel_args(x: torch.Tensor, kernels, biases, name: str, blocks: int,
                 split: bool, mxu_bf16: bool) -> tuple:
    """What every dense-block kernel takes, checked: (N, H, W) and the packed
    weights of ``blocks`` dense blocks (1, or 3 for a whole RRDB), split into
    TF32 hi/lo for the tile-local kernels (``split``), in bf16 for the bf16
    route (``mxu_bf16``, every kernel). ``_PACKERS`` is the one map from a
    kernel to its layout."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    n, h, w, _ = x.shape
    _kernels.check_tensor(x, "x", (n, h, w, FEATURES))
    _kernels.check_image_shape(n, h, w, WORKSPACE)
    w_packed, b_packed = packed(_PACKERS[blocks, split], (kernels, biases), mxu_bf16)
    values = blocks * _BLOCK_WEIGHTS * (2 if split and not mxu_bf16 else 1)
    _kernels.check_tensor(w_packed, "packed weights", (values,),
                          torch.bfloat16 if mxu_bf16 else torch.float32)
    _kernels.check_tensor(b_packed, "packed biases", (blocks * WORKSPACE,))
    return n, h, w, w_packed, b_packed


def _plain(blocks: int, scaling: float, mxu_bf16: bool):
    """The plain version as a function of (x, *kernels, *biases), flat:
    ``rdb_reference`` for a dense block (``blocks`` 1, five kernels) or
    ``rrdb_reference`` for a whole RRDB (``blocks`` 3, three blocks' five)."""
    def plain(x, *params):
        ks, bs = params[: len(params) // 2], params[len(params) // 2:]
        if blocks == 1:
            return rdb_reference(x, ks, bs, scaling, mxu_bf16=mxu_bf16)
        ks = [ks[i:i + 5] for i in (0, 5, 10)]
        bs = [bs[i:i + 5] for i in (0, 5, 10)]
        return rrdb_reference(x, ks, bs, scaling, mxu_bf16=mxu_bf16)

    return plain


def _with_plain_grad(forward, x, kernels, biases, scaling: float,
                     blocks: int) -> torch.Tensor:
    """``forward(x, *kernels, *biases)`` as the forward; as the backward,
    autograd (in x and the source kernels and biases) of the float32 plain
    version (``_plain``), as JAX's custom VJPs differentiate it in either
    precision mode."""
    flat = (lambda ts: [t for b in ts for t in b]) if blocks == 3 else list
    return kernel_with_plain_grad(forward, _plain(blocks, scaling, False), x,
                                  *flat(kernels), *flat(biases))


def _differentiable(launch, x, kernels, biases, scaling: float,
                    blocks: int) -> torch.Tensor:
    """``launch(x)`` (a kernel) as the forward, the float32 plain version's
    autograd as the backward (``_with_plain_grad``)."""
    return _with_plain_grad(lambda x, *_: launch(x), x, kernels, biases, scaling, blocks)


def _on_cpu(x, kernels, biases, scaling: float, blocks: int,
            mxu_bf16: bool) -> torch.Tensor:
    """A wrapper's CPU branch: the plain version; in the bf16 mode the
    rounded one, differentiated as the float32 one (``_with_plain_grad``)."""
    if mxu_bf16:
        return _with_plain_grad(_plain(blocks, scaling, True), x, kernels, biases, scaling,
                                blocks)
    return (rdb_reference if blocks == 1 else rrdb_reference)(x, kernels, biases, scaling)


def _launch_rdb(x, w_packed, b_packed, scaling: float, mxu_bf16: bool):
    """K1 on ``x``: (output, its (N, H, W, 192) workspace: x and a1..a4)."""
    n, h, w, _ = x.shape
    ws = torch.empty((n, h, w, WORKSPACE), device=x.device)
    out = torch.empty_like(x)
    _kernels.launch_rdb_forward(x, ws, out, w_packed, b_packed, n, h, w, scaling, mxu_bf16)
    return out, ws


def _pack_dgrad_stage(kernel: torch.Tensor) -> torch.Tensor:
    """One stage's dgrad weights: the OIHW kernel transposed and flipped,
    (C_in, C_out, 3, 3), the weight of the SAME conv that takes the stage's
    output gradient to its input's, in ``pack_conv_weight``'s layout."""
    return pack_conv_weight(kernel.transpose(0, 1).flip(2, 3))


@functools.lru_cache(maxsize=None)
def _dgrad_index(device: torch.device) -> torch.Tensor:
    """Where each value of ``pack_rdb_dgrad_weights`` sits in the five
    kernels flattened and concatenated: ``_pack_dgrad_stage`` of each
    stage's positions."""
    idx, at = [], 0
    for co, ci in _stage_shapes():
        idx.append(_pack_dgrad_stage(torch.arange(at, at + co * ci * 9).view(co, ci, 3, 3)))
        at += co * ci * 9
    return torch.cat(idx).to(device)


def pack_rdb_dgrad_weights(kernels: Sequence[torch.Tensor]) -> torch.Tensor:
    """K1's backward's layout: the five stages' ``_pack_dgrad_stage`` back to
    back (as many floats as ``pack_rdb_weights``), gathered from the kernels
    in one index op."""
    flat = torch.cat([k.detach().float().reshape(-1) for k in kernels])
    return flat[_dgrad_index(flat.device)]


def rdb_backward_plain(
    ws: torch.Tensor,  # (N, H, W, 192): x and a1..a4, as K1's forward leaves them
    g_out: torch.Tensor,  # (N, H, W, 64): the block output's gradient
    kernels: Sequence[torch.Tensor],  # five OIHW
    scaling: float,
):
    """The plain version of K1's backward kernel: the gradient of
    ``rdb_reference(x, kernels, biases, scaling)``, whose workspace is
    ``ws``, with upstream ``g_out`` -> (g_x, [dW_1..dW_5] OIHW, [db_1..db_5]),
    in ws's dtype. g_z5 = s g_out; each dgrad is the SAME conv of g_z_j with
    the kernel transposed and flipped into the first C_in_j channels of the
    workspace's gradient, g_z_j its slice j times the LeakyReLU's slope, 1
    where a_j >= 0 and 0.2 elsewhere; g_x = g_out + its first 64 channels;
    dW_j per tap the shifted workspace against g_z_j, db_j the sum of g_z_j."""
    dt = ws.dtype
    h, w = ws.shape[1:3]
    g_out = g_out.to(dt)
    g_z = [None] * 5
    g_z[4] = scaling * g_out
    g_ws = torch.zeros_like(ws)
    for j in range(4, -1, -1):
        if j < 4:
            lo = FEATURES + GROWTH * j
            g_z[j] = torch.where(ws[..., lo:lo + GROWTH] >= 0, g_ws[..., lo:lo + GROWTH],
                                 0.2 * g_ws[..., lo:lo + GROWTH])
        c_in = FEATURES + GROWTH * j
        g_ws[..., :c_in] += conv_nhwc(g_z[j], kernels[j].to(dt).transpose(0, 1).flip(2, 3),
                                      None)
    g_x = g_out + g_ws[..., :FEATURES]
    ws_pad = torch.nn.functional.pad(ws, (0, 0, 1, 1, 1, 1))
    d_k, d_b = [], []
    for j, (c_out, c_in) in enumerate(_stage_shapes()):
        g = g_z[j].reshape(-1, c_out)
        d_w = ws.new_empty((c_out, c_in, 3, 3))
        for ky in range(3):
            for kx in range(3):
                a = ws_pad[:, ky:ky + h, kx:kx + w, :c_in].reshape(-1, c_in)
                d_w[:, :, ky, kx] = g.T @ a
        d_k.append(d_w)
        d_b.append(g.sum(0))
    return g_x, d_k, d_b


# the backward kernel's weight-gradient launch: (stage, kernel row, 64 input
# channels) units, one block each per split of the pixels (csrc/rdb_backward.cu)
_WGRAD_UNITS = 3 * sum(-(-ci // 64) for _, ci in _stage_shapes())
_GRAD_VALUES = _BLOCK_WEIGHTS + WORKSPACE  # dW_1..dW_5 OIHW, then b1..b5


def rdb_backward(ws: torch.Tensor, g_out: torch.Tensor, kernels: Sequence[torch.Tensor],
                 scaling: float):
    """K1's backward kernel on the card (``csrc/rdb_backward.cu``, counted
    as ``rdb_bwd``): the gradient of K1's output with upstream ``g_out``
    from its forward's workspace ``ws`` -> (g_x, [dW_j] OIHW, [db_j]),
    float32; its plain version is ``rdb_backward_plain``. The weight
    gradients are summed over ``splits`` parts of the pixels (two blocks a
    unit per SM: stage 5's units take twice the others' time, so a second
    wave evens them out) and the parts added in order: no atomics."""
    n, h, w, _ = ws.shape
    g_out = g_out.contiguous()
    _kernels.check_tensor(ws, "workspace", (n, h, w, WORKSPACE))
    _kernels.check_tensor(g_out, "gradient", (n, h, w, FEATURES))
    _kernels.check_image_shape(n, h, w, WORKSPACE)
    wt = packed(pack_rdb_dgrad_weights, (kernels,))
    _kernels.check_tensor(wt, "packed dgrad weights", (_BLOCK_WEIGHTS,))
    sms = torch.cuda.get_device_properties(ws.device).multi_processor_count
    splits = max(1, 2 * sms // _WGRAD_UNITS)
    g_ws, g_x = torch.empty_like(ws), torch.empty_like(g_out)
    part = torch.empty(splits * _GRAD_VALUES, device=ws.device)
    grad = torch.empty(_GRAD_VALUES, device=ws.device)
    _kernels.launch_rdb_backward(ws, g_out, wt, g_ws, g_x, part, grad, n, h, w, scaling,
                                 splits)
    d_k, d_b, at = [], [], 0
    for c_out, c_in in _stage_shapes():
        d_k.append(grad[at:at + c_out * c_in * 9].view(c_out, c_in, 3, 3))
        at += c_out * c_in * 9
    for c_out, _ in _stage_shapes():
        d_b.append(grad[at:at + c_out])
        at += c_out
    return g_x, d_k, d_b


class _RdbFused(torch.autograd.Function):
    """K1's forward on the fp32 route, its backward kernel ``rdb_backward``
    on the saved workspace. The source kernels are kept on ``ctx`` (the
    backward packs its weights from them); only the workspace is saved, so
    ``torch.utils.checkpoint`` drops and recomputes it."""

    @staticmethod
    def forward(ctx, x, w_packed, b_packed, scaling, *params):
        out, ws = _launch_rdb(x, w_packed, b_packed, scaling, False)
        ctx.save_for_backward(ws)
        ctx.kernels, ctx.scaling = params[:5], scaling
        return out

    @staticmethod
    def backward(ctx, grad):
        (ws,) = ctx.saved_tensors
        with device_span("rdb.backward", grad.device, range=True):
            g_x, d_k, d_b = rdb_backward(ws, grad, ctx.kernels, ctx.scaling)
        needs = ctx.needs_input_grad
        return (g_x if needs[0] else None, None, None, None,
                *(g if need else None for g, need in zip([*d_k, *d_b], needs[4:])))


def rdb_fused(
    x: torch.Tensor,  # (N, H, W, 64) float32
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    scaling: float,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """One dense block: K1 (``csrc/rdb.cu``) on a CUDA tensor, the plain
    ``rdb_reference`` on a CPU tensor. ``mxu_bf16``: bf16 multiplicands,
    the kernel's bf16 route or the rounded plain version (module
    docstring). When a gradient is needed the fp32 route's backward is
    ``rdb_backward``, the bf16 route's autograd of the float32 twin."""
    if x.device.type == "cpu":
        return _on_cpu(x, kernels, biases, scaling, 1, mxu_bf16)
    _, _, _, w_packed, b_packed = _kernel_args(x, kernels, biases, "rdb_fused", 1, False,
                                               mxu_bf16)
    if not mxu_bf16 and needs_grad(x, *kernels, *biases):
        return _RdbFused.apply(x, w_packed, b_packed, scaling, *kernels, *biases)
    return _differentiable(lambda x: _launch_rdb(x, w_packed, b_packed, scaling, mxu_bf16)[0],
                           x, kernels, biases, scaling, 1)


def rrdb_reference(
    x: torch.Tensor,  # (N, H, W, F)
    kernels: Sequence[Sequence[torch.Tensor]],  # three blocks' five OIHW kernels
    biases: Sequence[Sequence[torch.Tensor]],  # three blocks' five biases
    scaling: float,
    dtype: Optional[torch.dtype] = None,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """x + scaling * rdb3(rdb2(rdb1(x))): three ``rdb_reference`` calls and
    the scaled outer skip."""
    a = x
    for ks, bs in zip(kernels, biases):
        a = rdb_reference(a, ks, bs, scaling, dtype, mxu_bf16)
    return x + scaled(scaling, a)


def pack_rrdb_weights(
    kernels: Sequence[Sequence[torch.Tensor]], biases: Sequence[Sequence[torch.Tensor]],
    mxu_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's layout: the three blocks' ``pack_rdb_weights`` back to back."""
    packs = [pack_rdb_weights(ks, bs, mxu_bf16) for ks, bs in zip(kernels, biases)]
    return (torch.cat([w for w, _ in packs]).contiguous(),
            torch.cat([b for _, b in packs]).contiguous())


# (blocks, split) -> the packer of that kernel's layout: K1, K4, K6, K5
_PACKERS = {(1, False): pack_rdb_weights, (3, False): pack_rrdb_weights,
            (1, True): pack_rdb_weights_tc, (3, True): pack_rrdb_weights_tc}


def rrdb_fused(
    x: torch.Tensor,  # (N, H, W, 64) float32
    kernels: Sequence[Sequence[torch.Tensor]],
    biases: Sequence[Sequence[torch.Tensor]],
    scaling: float,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """One whole RRDB: K4 (``csrc/rdb.cu`` ``rrdb_forward``) on a CUDA
    tensor, the plain ``rrdb_reference`` on a CPU tensor. The kernel runs on
    two (N, H, W, 192) workspaces and writes a new output tensor."""
    if x.device.type == "cpu":
        return _on_cpu(x, kernels, biases, scaling, 3, mxu_bf16)
    n, h, w, w_packed, b_packed = _kernel_args(x, kernels, biases, "rrdb_fused", 3,
                                               False, mxu_bf16)

    def launch(x):
        ws_a = torch.empty((n, h, w, WORKSPACE), device=x.device)
        ws_b = torch.empty_like(ws_a)
        out = torch.empty_like(x)
        _kernels.launch_rrdb_forward(x, ws_a, ws_b, out, w_packed, b_packed, n, h, w,
                                     scaling, mxu_bf16)
        return out

    return _differentiable(launch, x, kernels, biases, scaling, 3)


def rdb_banded(
    x: torch.Tensor,  # (N, H, W, 64) float32
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    scaling: float,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """One dense block: K6 (``csrc/rdb_banded.cu``) on a CUDA tensor, the
    plain ``rdb_reference`` on a CPU tensor. The kernel allocates nothing:
    only the output is created here."""
    if x.device.type == "cpu":
        return _on_cpu(x, kernels, biases, scaling, 1, mxu_bf16)
    n, h, w, w_packed, b_packed = _kernel_args(x, kernels, biases, "rdb_banded", 1,
                                               True, mxu_bf16)

    def launch(x):
        out = torch.empty_like(x)
        _kernels.launch_rdb_banded_forward(x, out, w_packed, b_packed, n, h, w, scaling,
                                           mxu_bf16)
        return out

    return _differentiable(launch, x, kernels, biases, scaling, 1)


SWEEP_BAND = 8  # K5's band height (its tile's rows)
SWEEP_SLOTS = 4  # band slots of each of K5's two rings


def rrdb_sweep(
    x: torch.Tensor,  # (N, H, W, 64) float32
    kernels: Sequence[Sequence[torch.Tensor]],
    biases: Sequence[Sequence[torch.Tensor]],
    scaling: float,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """One whole RRDB: K5 (``csrc/rrdb_sweep.cu``) on a CUDA tensor, the
    plain ``rrdb_reference`` on a CPU tensor. Its only scratch is the two
    band rings, (4, N, 8, W, 64) each: their size does not grow with H."""
    if x.device.type == "cpu":
        return _on_cpu(x, kernels, biases, scaling, 3, mxu_bf16)
    n, h, w, w_packed, b_packed = _kernel_args(x, kernels, biases, "rrdb_sweep", 3,
                                               True, mxu_bf16)

    def launch(x):
        ring1 = torch.empty((SWEEP_SLOTS, n, SWEEP_BAND, w, FEATURES), device=x.device)
        ring2 = torch.empty_like(ring1)
        out = torch.empty_like(x)
        _kernels.launch_rrdb_sweep_forward(x, ring1, ring2, out, w_packed, b_packed, n,
                                           h, w, scaling, mxu_bf16)
        return out

    return _differentiable(launch, x, kernels, biases, scaling, 3)

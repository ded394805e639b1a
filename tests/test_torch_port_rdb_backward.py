"""PyTorch port: the backward of K1, the dense block (``ops.rdb.rdb_fused``
on its fp32 route, ``rdb_backward`` / ``csrc/rdb_backward.cu``).

On the CPU the plain version of the backward kernel, ``rdb_backward_plain``,
is held in float64 to ``torch.autograd.grad`` of ``rdb_reference``, from the
workspace (x and a1..a4) the forward leaves: ragged, square and one-pixel
shapes, scalings 0.1 and 0.2, pre-activations exactly 0 (the LeakyReLU
passes 1 there), the gradient of x alone and of the weights alone. The
dgrad packer is held to its definition, the kernel transposed and flipped in
``pack_conv_weight``'s layout.

The tests marked ``card`` hold the backward kernel on a CUDA card to
autograd of the same plain version in float64 within ``TOL_KERNEL`` of each
gradient's range, at those shapes and at a training step's (128, 9, 9, 64);
check that a dense block's gradient launches ``rdb_bwd`` once and that a
default generator's gradient never recomputes a plain version
(``ops._autograd._PlainTwinGrad``), while K1's bf16 route, K4, K5 and K6
still do; that a forward without a gradient launches only ``rdb_forward``;
and that ``GeneratorConfig(remat=True)`` gives the same gradients. They skip
without a card; on the card's machine, which has no JAX
(``tests/conftest.py`` imports it), run them with ``python -m pytest
--noconftest -p no:cacheprovider -q -m card
tests/test_torch_port_rdb_backward.py``."""

import pytest
import torch

from deepbedmap_tpu_torch.ops import _autograd, _kernels, rdb
from deepbedmap_tpu_torch.ops.conv import conv_nhwc, leaky_relu
from deepbedmap_tpu_torch.ops.conv3x3 import pack_conv_weight

SHAPES = [(3, 13, 7), (2, 9, 9), (1, 1, 1)]  # ragged, a training tile's, one pixel
SCALINGS = [0.1, 0.2]
TRAIN_RDB = (128, 9, 9)  # a dense block at a batch-128 training step
# the kernel sums in fp32 (3xTF32 products) in another order than the float64
# reference: a few 1e-7 of the range per gradient; an indexing or masking
# fault is off by the order of the gradient itself (chip_smoke.py's TOL_KERNEL)
TOL_KERNEL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(gen, shape, zeros: bool = False):
    """x, five kernels and five biases in float64. With ``zeros`` the first
    image's x and every bias are 0: that image's pre-activations are exactly
    0 at every stage."""
    n, h, w = shape
    x = torch.randn((n, h, w, 64), generator=gen, dtype=torch.float64)
    ks, bs = [], []
    for c_out, c_in in rdb._stage_shapes():
        ks.append(torch.randn((c_out, c_in, 3, 3), generator=gen, dtype=torch.float64) * 0.05)
        bs.append(torch.randn(c_out, generator=gen, dtype=torch.float64) * 0.1)
    if zeros:
        x[0] = 0.0
        bs = [torch.zeros_like(b) for b in bs]
    return x, ks, bs


def _workspace(x, ks, bs, branch=None):
    """(pre-activations z1..z4, the workspace [x, a1..a4], z5) of the plain
    dense block; ``branch``: a workspace whose signs choose each LeakyReLU's
    branch (the kernel's own)."""
    acts, pre = [x], []
    for j in range(5):
        z = conv_nhwc(torch.cat(acts, -1), ks[j], bs[j])
        if j < 4:
            pre.append(z)
            if branch is None:
                acts.append(leaky_relu(z))
            else:
                lo = 64 + 32 * j
                acts.append(torch.where(branch[..., lo:lo + 32] >= 0, z, 0.2 * z))
    return pre, torch.cat(acts, -1), z


def _autograd_of_twin(x, ks, bs, scaling, up, wrt, branch=None):
    leaves = [t.detach().clone().requires_grad_(need)
              for t, need in zip([x, *ks, *bs], wrt)]
    _, ws, z5 = _workspace(leaves[0], leaves[1:6], leaves[6:], branch)
    out = leaves[0] + scaling * z5
    wanted = [leaf for leaf, need in zip(leaves, wrt) if need]
    grads = iter(torch.autograd.grad(out, wanted, up))
    return ws.detach(), [next(grads) if need else None for need in wrt]


def _near(got, want, tol: float) -> None:
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape
        assert torch.isfinite(g).all()
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * float(w.abs().max()), (err, float(w.abs().max()))


WRT = {"all": [True] * 11, "x": [True] + [False] * 10, "weights": [False] + [True] * 10}


@pytest.mark.parametrize("wrt", list(WRT))
@pytest.mark.parametrize("zeros", [False, True], ids=["random", "zeros"])
@pytest.mark.parametrize("scaling", SCALINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rdb_backward_plain_is_autograd_of_the_twin(shape, scaling, zeros, wrt):
    gen = torch.Generator().manual_seed(10 * SHAPES.index(shape) + 2 * SCALINGS.index(scaling)
                                        + zeros)
    x, ks, bs = _case(gen, shape, zeros)
    pre, _, _ = _workspace(x, ks, bs)
    if zeros:  # the LeakyReLU's boundary is exercised at every stage
        assert all((z[0] == 0).all() for z in pre)
    up = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    ws, want = _autograd_of_twin(x, ks, bs, scaling, up, WRT[wrt])
    g_x, d_k, d_b = rdb.rdb_backward_plain(ws, up, ks, scaling)
    assert g_x.dtype == torch.float64
    got = [g_x, *d_k, *d_b]
    _near([g for g, w in zip(got, want) if w is not None], [w for w in want if w is not None],
          1e-12)


def test_pack_rdb_dgrad_weights_is_the_transposed_flipped_kernels():
    gen = torch.Generator().manual_seed(3)
    _, ks, _ = _case(gen, (1, 1, 1))
    ks = [k.float() for k in ks]
    want = torch.cat([pack_conv_weight(k.transpose(0, 1).flip(2, 3)) for k in ks])
    got = rdb.pack_rdb_dgrad_weights(ks)
    assert got.dtype == torch.float32 and got.shape == (rdb._BLOCK_WEIGHTS,)
    assert torch.equal(got, want)


def test_the_cpu_branch_is_autograd_of_the_plain_version():
    gen = torch.Generator().manual_seed(4)
    x, ks, bs = _case(gen, (2, 5, 6))
    leaves = [t.float().requires_grad_() for t in (x, *ks, *bs)]
    out = rdb.rdb_fused(leaves[0], leaves[1:6], leaves[6:], 0.2)
    assert "PlainTwin" not in type(out.grad_fn).__name__
    up = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, leaves, up)
    _, ws, _ = _workspace(x, ks, bs)
    g_x, d_k, d_b = rdb.rdb_backward_plain(ws, up.double(), ks, 0.2)
    _near(got, [g_x, *d_k, *d_b], 1e-5)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _branches_agree(pre, ws_kernel) -> None:
    """The kernel's forward (3xTF32) and the float64 plain one round a
    pre-activation within ~1e-7 of zero to opposite signs at a few of a
    training step's 10^6; the backward kernel follows its own forward, so the
    reference takes the branch from it as well: outside that band the two
    agree."""
    for j, z in enumerate(pre):
        lo = 64 + 32 * j
        band = 1e-5 * float(z.abs().max())
        clear = z.abs() > band
        assert torch.equal((z >= 0)[clear], (ws_kernel[..., lo:lo + 32] >= 0)[clear])


def _check_kernel(card, shape, scaling, seed, wrt="all", zeros=False):
    gen = torch.Generator().manual_seed(seed)
    x, ks, bs = _case(gen, shape, zeros)
    need = WRT[wrt]
    leaves = [t.float().to(card).requires_grad_(n) for t, n in zip([x, *ks, *bs], need)]
    before = dict(_kernels.launches)
    out = rdb.rdb_fused(leaves[0], leaves[1:6], leaves[6:], scaling)
    assert type(out.grad_fn).__name__ == "_RdbFusedBackward"
    up = torch.randn(out.shape, generator=gen)
    wanted = [leaf for leaf, n in zip(leaves, need) if n]
    got = iter(torch.autograd.grad(out, wanted, up.to(card)))
    got = [next(got) if n else None for n in need]
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in _kernels.launches.items() if v != before[k]}
    assert ran == {"rdb_forward": 1, "rdb_bwd": 1}
    # the kernel's own workspace, for its LeakyReLU branches
    w_packed, b_packed = rdb.packed(rdb.pack_rdb_weights, (leaves[1:6], leaves[6:]), False)
    _, ws_kernel = rdb._launch_rdb(leaves[0].detach(), w_packed, b_packed, scaling, False)
    ws_kernel = ws_kernel.cpu()
    pre, _, _ = _workspace(x, ks, bs)
    _branches_agree(pre, ws_kernel)
    _, want = _autograd_of_twin(x, ks, bs, scaling, up.double(), need, branch=ws_kernel)
    _near([None if g is None else g.cpu() for g in got], want, TOL_KERNEL)


@pytest.mark.card
@pytest.mark.parametrize("zeros", [False, True], ids=["random", "zeros"])
@pytest.mark.parametrize("scaling", SCALINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rdb_backward_kernel_matches_autograd_of_the_twin(card, shape, scaling, zeros):
    _check_kernel(card, shape, scaling, 100 + 10 * SHAPES.index(shape)
                  + 2 * SCALINGS.index(scaling) + zeros, zeros=zeros)


@pytest.mark.card
@pytest.mark.parametrize("wrt", ["x", "weights"])
def test_rdb_backward_kernel_of_x_alone_and_of_the_weights_alone(card, wrt):
    _check_kernel(card, (3, 13, 7), 0.1, 200 + len(wrt), wrt)


@pytest.mark.card
def test_rdb_backward_kernel_at_the_training_shape(card):
    _check_kernel(card, TRAIN_RDB, 0.1, 300)


@pytest.mark.card
def test_rdb_backward_kernel_repeats_bit_for_bit(card):
    gen = torch.Generator().manual_seed(301)
    x, ks, bs = _case(gen, TRAIN_RDB)
    leaves = [t.float().to(card).requires_grad_() for t in (x, *ks, *bs)]
    up = torch.randn(x.shape, generator=gen).to(card)
    runs = [torch.autograd.grad(rdb.rdb_fused(leaves[0], leaves[1:6], leaves[6:], 0.1),
                                leaves, up) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _generator_grads(card, gen_cfg, seed: int = 400):
    from deepbedmap_tpu_torch.data.dataset import REFERENCE_SHAPES_NCHW
    from deepbedmap_tpu_torch.models.api import build_generator

    g = build_generator(gen_cfg, seed=seed, device=card)
    gen = torch.Generator().manual_seed(seed)
    ins = [torch.rand((2, *REFERENCE_SHAPES_NCHW[k][1:], REFERENCE_SHAPES_NCHW[k][0]),
                      generator=gen).to(card) for k in ("X", "W1", "W2", "W3")]
    params = list(g.parameters())
    out = g(*ins)
    assert torch.isfinite(out).all()
    return torch.autograd.grad(out.square().sum(), params)


@pytest.mark.card
def test_a_default_generators_gradient_takes_the_backward_kernels(card, monkeypatch):
    from deepbedmap_tpu_torch.config import GeneratorConfig

    def refuse(*args):
        raise AssertionError("a kernel's plain version was recomputed under autograd")

    monkeypatch.setattr(_autograd._PlainTwinGrad, "apply", refuse)
    _kernels.reset_launches()
    grads = _generator_grads(card, GeneratorConfig(num_residual_blocks=2))
    torch.cuda.synchronize()
    assert all(torch.isfinite(gr).all() for gr in grads)
    ran = {k: v for k, v in _kernels.launches.items() if v}
    assert ran == {"rdb_forward": 6, "rdb_bwd": 6, "deform64_lrelu": 1, "deform_zproj1": 1,
                   "deform64_bwd": 1, "deform_zproj1_bwd": 1}


@pytest.mark.card
@pytest.mark.parametrize("kernel,blocks,mxu_bf16", [
    ("rdb_fused", 1, True), ("rrdb_fused", 3, False), ("rrdb_sweep", 3, False),
    ("rdb_banded", 1, False)], ids=["K1_bf16", "K4", "K5", "K6"])
def test_the_other_dense_block_kernels_keep_the_twin(card, kernel, blocks, mxu_bf16):
    gen = torch.Generator().manual_seed(500)
    x = torch.randn((2, 9, 9, 64), generator=gen).to(card).requires_grad_()
    ks, bs = [], []
    for _ in range(blocks):
        _, k, b = _case(gen, (1, 1, 1))
        ks.append([t.float().to(card).requires_grad_() for t in k])
        bs.append([t.float().to(card).requires_grad_() for t in b])
    if blocks == 1:
        ks, bs = ks[0], bs[0]
    before = _kernels.launches["rdb_bwd"]
    out = getattr(rdb, kernel)(x, ks, bs, 0.1, mxu_bf16=mxu_bf16)
    assert type(out.grad_fn).__name__ == "_PlainTwinGradBackward"
    grad = torch.autograd.grad(out.sum(), x)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(grad).all()
    assert _kernels.launches["rdb_bwd"] == before


@pytest.mark.card
@pytest.mark.parametrize("mode", ["no_grad", "no_input_needs_one"])
def test_a_forward_without_a_gradient_launches_only_the_forward(card, mode):
    gen = torch.Generator().manual_seed(600)
    x, ks, bs = _case(gen, (2, 9, 9))
    need = mode == "no_grad"
    x, ks, bs = (x.float().to(card).requires_grad_(need),
                 [k.float().to(card).requires_grad_(need) for k in ks],
                 [b.float().to(card).requires_grad_(need) for b in bs])
    before = dict(_kernels.launches)
    with torch.set_grad_enabled(mode != "no_grad"):
        out = rdb.rdb_fused(x, ks, bs, 0.1)
    torch.cuda.synchronize()
    assert out.grad_fn is None
    ran = {k: v - before[k] for k, v in _kernels.launches.items() if v != before[k]}
    assert ran == {"rdb_forward": 1}


@pytest.mark.card
def test_remat_gives_the_same_gradients(card):
    from deepbedmap_tpu_torch.config import GeneratorConfig

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = _generator_grads(card, GeneratorConfig(num_residual_blocks=2))
        _kernels.reset_launches()
        remat = _generator_grads(card, GeneratorConfig(num_residual_blocks=2, remat=True))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert _kernels.launches["rdb_forward"] == 12 and _kernels.launches["rdb_bwd"] == 6
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))

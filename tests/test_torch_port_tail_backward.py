"""PyTorch port: the backward of the deformable tail's kernels, K2 / K7
(``ops.deform_conv.deform64``) and K3 / K8 (``deform_tap_fields``).

On the CPU the plain versions of the backward kernels,
``deform64_backward_plain`` and ``tap_fields_backward_plain``, are held in
float64 to ``torch.autograd.grad`` of the masked-shift plain versions
(``deform_conv_shifts`` [+ ``leaky_relu``], ``sample_tap_fields``), whose
gradient the kernels compute: random offsets, offsets at exact integers
(the bilinear fraction 0: the derivative is x(iy + 1) - x(iy)), at exactly
+-clamp (the clamp passes the gradient) and beyond it (it passes none),
clamps 1 and 2, a ragged and a square shape, and pre-activations exactly 0
(the LeakyReLU passes 1 there).

The tests marked ``card`` hold the backward kernels on a CUDA card to
autograd of the same plain versions in float64 within ``TOL_KERNEL`` of each
gradient's range, at the same cases and at a training step's tail shape
``TRAIN_TAIL``, and check that a gradient through the fused tail launches
each backward kernel once and never recomputes a plain version
(``ops._autograd._PlainTwinGrad``). They skip without a card; on the card's
machine, which has no JAX (``tests/conftest.py`` imports it), run them with
``python -m pytest --noconftest -p no:cacheprovider -q -m card
tests/test_torch_port_tail_backward.py``."""

import pytest
import torch

from deepbedmap_tpu_torch.ops import _autograd, _kernels, tail
from deepbedmap_tpu_torch.ops.conv import leaky_relu
from deepbedmap_tpu_torch.ops.deform_conv import (
    deform64_backward_plain,
    deform_conv2d,
    deform_conv_shifts,
    deform_tap_fields,
    sample_tap_fields,
    tap_fields_backward_plain,
)

SHAPES = [(3, 13, 7), (2, 9, 9)]  # ragged (no multiple of the 8 x 8 / 8 x 32 tiles), square
OFFSETS = ["random", "integers", "at_clamp", "beyond"]
TRAIN_TAIL = (128, 36, 36)  # the tail at a batch-128 training step
# the kernels sum in fp32 in another order than the float64 reference: a few
# 1e-7 of the range per gradient; an indexing or masking fault is off by the
# order of the gradient itself (chip_smoke.py's TOL_KERNEL)
TOL_KERNEL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _offsets(gen, shape, clamp: int, kind: str) -> torch.Tensor:
    """(N, H, W, 18) float64 offsets of one kind: std-1.5 random (some
    beyond the clamp), whole numbers in [-clamp - 1, clamp + 1], exactly
    +-clamp, or beyond +-clamp."""
    sign = torch.randint(2, shape, generator=gen).double() * 2 - 1
    if kind == "random":
        return torch.randn(shape, generator=gen, dtype=torch.float64) * 1.5
    if kind == "integers":
        return torch.randint(-clamp - 1, clamp + 2, shape, generator=gen).double()
    if kind == "at_clamp":
        return sign * clamp
    return sign * (clamp + 0.25 + torch.rand(shape, generator=gen, dtype=torch.float64))


def _deform64_case(gen, shape, clamp, kind):
    """x, offsets, weight and bias in float64, x zero over the first
    image's top 8 rows and bias zero in 8 channels: the outputs of the top
    rows that sample only zeros have pre-activations exactly 0 there."""
    n, h, w = shape
    x = torch.randn((n, h, w, 64), generator=gen, dtype=torch.float64)
    x[0, :8] = 0.0
    b = torch.randn(64, generator=gen, dtype=torch.float64) * 0.1
    b[:8] = 0.0
    wt = torch.randn((64, 64, 3, 3), generator=gen, dtype=torch.float64) * 0.05
    return x, _offsets(gen, (n, h, w, 18), clamp, kind), wt, b


def _twin_grads(fn, inputs, up):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, up)


def _near(got, want, tol: float) -> None:
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.isfinite(g).all()
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * float(w.abs().max()), (err, float(w.abs().max()))


@pytest.mark.parametrize("lrelu", [True, False], ids=["K2", "K7"])
@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("clamp", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_deform64_backward_plain_is_autograd_of_the_twin(shape, clamp, kind, lrelu):
    gen = torch.Generator().manual_seed(100 * clamp + 10 * OFFSETS.index(kind) + lrelu)
    x, off, wt, b = _deform64_case(gen, shape, clamp, kind)
    pre = deform_conv_shifts(x, off, wt, b, 1, clamp)
    assert (pre == 0).any()  # the LeakyReLU's boundary is exercised

    def plain(x, off, wt, b):
        y = deform_conv_shifts(x, off, wt, b, 1, clamp)
        return leaky_relu(y) if lrelu else y

    up = torch.randn(pre.shape, generator=gen, dtype=torch.float64)
    out, want = _twin_grads(plain, (x, off, wt, b), up)
    got = deform64_backward_plain(x, off, wt, out, up, clamp, lrelu)
    _near(got, want, 1e-12)
    d_off = got[1]
    if kind == "beyond":
        assert not d_off.any()
    else:  # outside the zeroed rows most offsets take a gradient
        assert (d_off[1:] != 0).float().mean() > 0.3


@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("clamp", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tap_fields_backward_plain_is_autograd_of_the_twin(shape, clamp, kind):
    gen = torch.Generator().manual_seed(200 + 10 * clamp + OFFSETS.index(kind))
    n, h, w = shape
    z = torch.randn((n, h, w, 9), generator=gen, dtype=torch.float64)
    off = _offsets(gen, (n, h, w, 18), clamp, kind)
    b = torch.tensor([0.3], dtype=torch.float64)
    up = torch.randn((n, h, w, 1), generator=gen, dtype=torch.float64)
    out, want = _twin_grads(lambda z, o, b: sample_tap_fields(z[..., None], o, b, 1, clamp),
                            (z, off, b), up)
    assert out.dtype == torch.float64
    got = tap_fields_backward_plain(z, off, up, clamp)
    _near(got, want, 1e-12)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lrelu_as(y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """LeakyReLU of ``y`` on the branch that the kernel's output ``out``
    took. The kernel's forward (3xTF32) and the float64 twin round a
    pre-activation within ~1e-7 of zero to opposite signs at a few of a
    training step's 10^7 outputs; the backward kernel follows its own
    forward, so the reference takes the branch from it as well
    (``_branches_agree`` checks that the two agree outside that band)."""
    return torch.where(out >= 0, y, 0.2 * y)


def _branches_agree(pre: torch.Tensor, out: torch.Tensor) -> None:
    band = 1e-5 * float(pre.abs().max())
    clear = pre.abs() > band
    assert torch.equal((pre >= 0)[clear], (out >= 0)[clear])


def _check_deform64(card, shape, clamp, kind, lrelu, seed):
    gen = torch.Generator().manual_seed(seed)
    name = "deform64_bwd" if lrelu else "deform_conv_bwd"
    x, off, wt, b = (t.to(card) for t in _deform64_case(gen, shape, clamp, kind))
    leaves = [t.float().requires_grad_() for t in (x, off, wt, b)]
    before = _kernels.launches[name]
    if lrelu:
        out = tail.deform64_lrelu(*leaves, clamp)
    else:
        out = deform_conv2d(*leaves, clamp=clamp, method="pallas")
    assert "PlainTwin" not in type(out.grad_fn).__name__
    up = torch.randn(out.shape, generator=gen).to(card)
    got = torch.autograd.grad(out, leaves, up)
    torch.cuda.synchronize()
    assert _kernels.launches[name] == before + 1
    out = out.detach()
    if lrelu:
        _branches_agree(deform_conv_shifts(x, off, wt, b, 1, clamp), out)

    def plain(x, off, wt, b):
        y = deform_conv_shifts(x, off, wt, b, 1, clamp)
        return _lrelu_as(y, out) if lrelu else y

    _, want = _twin_grads(plain, (x, off, wt, b), up.double())
    _near(got, want, TOL_KERNEL)


def _check_tap_fields(card, shape, clamp, kind, seed, k8: bool = False):
    gen = torch.Generator().manual_seed(seed)
    n, h, w = shape
    name = "deform_conv_zproj1_bwd" if k8 else "deform_zproj1_bwd"
    z = torch.randn((n, h, w, 9), generator=gen, dtype=torch.float64).to(card)
    off = _offsets(gen, (n, h, w, 18), clamp, kind).to(card)
    b = torch.tensor([0.3], dtype=torch.float64, device=card)
    leaves = [t.float().requires_grad_() for t in (z, off, b)]
    before = _kernels.launches[name]
    if k8:
        out = deform_tap_fields(*leaves, clamp, "deform_conv_zproj1")
    else:
        out = tail.deform_zproj1(*leaves, clamp)
    assert "PlainTwin" not in type(out.grad_fn).__name__
    up = torch.randn(out.shape, generator=gen).to(card)
    got = torch.autograd.grad(out, leaves, up)
    torch.cuda.synchronize()
    assert _kernels.launches[name] == before + 1
    _, want = _twin_grads(lambda z, o, b: sample_tap_fields(z[..., None], o, b, 1, clamp),
                          (z, off, b), up.double())
    _near(got, want, TOL_KERNEL)


@pytest.mark.card
@pytest.mark.parametrize("lrelu", [True, False], ids=["K2", "K7"])
@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("clamp", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_deform64_backward_kernel_matches_autograd_of_the_twin(card, shape, clamp, kind, lrelu):
    _check_deform64(card, shape, clamp, kind, lrelu, 300 + 10 * clamp + OFFSETS.index(kind))


@pytest.mark.card
@pytest.mark.parametrize("k8", [False, True], ids=["K3", "K8"])
@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("clamp", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tap_fields_backward_kernel_matches_autograd_of_the_twin(card, shape, clamp, kind, k8):
    _check_tap_fields(card, shape, clamp, kind, 400 + 10 * clamp + OFFSETS.index(kind), k8)


@pytest.mark.card
def test_backward_kernels_at_the_training_shape(card):
    _check_deform64(card, TRAIN_TAIL, 2, "random", True, 500)
    _check_tap_fields(card, TRAIN_TAIL, 2, "random", 501)


@pytest.mark.card
def test_the_fused_tails_gradient_takes_the_backward_kernels(card, monkeypatch):
    def refuse(*args):
        raise AssertionError("the tail recomputed a plain version under autograd")

    monkeypatch.setattr(_autograd._PlainTwinGrad, "apply", refuse)
    gen = torch.Generator().manual_seed(600)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(card).requires_grad_()

    x = randn(2, 20, 21, 64)
    params = [randn(18, 64, 3, 3, scale=0.01), randn(18), randn(64, 64, 3, 3, scale=0.05),
              randn(64, scale=0.1), randn(18, 64, 3, 3, scale=0.01), randn(18),
              randn(1, 64, 3, 3, scale=0.05), randn(1)]
    _kernels.reset_launches()
    out = tail.fused_deform_tail(x, *params)
    grads = torch.autograd.grad(out.square().sum(), [x, *params])
    torch.cuda.synchronize()
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    ran = {k: v for k, v in _kernels.launches.items() if v}
    assert ran == {"deform64_lrelu": 1, "deform_zproj1": 1, "deform64_bwd": 1,
                   "deform_zproj1_bwd": 1}

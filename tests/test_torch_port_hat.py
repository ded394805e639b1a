"""PyTorch port: HAT as the third generator, on the CPU at a tiny size (embed
12, 2 heads, window 4, so an overlap window of 6 and a padding of 1, two
RHAGs of 2 HABs, compress 3, squeeze 4), against the plain reference
``reference/hat.py`` on seeded random weights whose bias tables and
LayerNorm affines are drawn away from their defaults. The crop's 14-px
latent pads to 16, so the pad, the shift, the mask and the border windows'
zero keys all run. On a card (the ``card`` marker): the tiled kernel's two
cases against their plain versions at the published widths.

Tolerances: the program and the reference compute the same fp32 sums in
other orders (other reshapes, an unfold against an index), so they agree to
~1e-6 of the output's range; 1e-5 leaves room for that and none for a
fault: each of the five faults (the bias, the mask or the shift dropped,
the CAB branch left out, the zero-padded keys left out of the softmax)
moves the output by 1e-2 of its range or more."""

import math

import numpy as np
import pytest
import torch

from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.config import HATConfig, check_hat
from deepbedmap_tpu_torch.inference.engine import INPUT_RATIOS
from deepbedmap_tpu_torch.models import build_generator
from deepbedmap_tpu_torch.models import hat as model
from deepbedmap_tpu_torch.ops import window_attn
from deepbedmap_tpu_torch.utils.flops import hat_tile_flops
from reference import hat as reference
from reference import swinir as swinir_reference

TINY = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4, compress_ratio=3,
            squeeze_factor=4)
TOL = 1e-5  # of the range: fp32 summation order only (module docstring)
TILE, HALO, RES = 40, 2, 250.0  # a 16 lr-px crop: a 14 px latent, padded to 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(cfg=TINY, seed=0):
    """Seeded weights by the reference's spec: convs He-normal (the input
    block at 1e-3, so its features are O(1); conv_last at 200, so the
    output is in thousands of metres), linears at 1/sqrt(fan_in), biases
    N(0, 0.1^2), LayerNorm affines 1 + N(0, 0.1^2) and N(0, 0.1^2), bias
    tables N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind, fan_in in reference.param_spec(cfg):
        z = torch.randn(shape, generator=g)
        if kind in ("input", "conv", "cab", "ca", "last"):
            scale = {"input": 1e-3, "last": 200.0}.get(kind, 1.0)
            out[name] = z * scale * math.sqrt(2.0 / fan_in)
        elif kind == "linear":
            out[name] = z / math.sqrt(fan_in)
        elif kind == "norm_weight":
            out[name] = 1.0 + 0.1 * z
        elif kind == "table":
            out[name] = z
        else:
            out[name] = 0.1 * z
    return out


def _canvas(tiles_x=2, seed=1):
    """One band of ``tiles_x`` tiles: NCHW rasters at bed, surface, velocity
    and accumulation scale (W1 partly below 0, so the clip runs)."""
    rs = np.random.RandomState(seed)
    lr = TILE // 4
    lo = {"X": (-1300, 300), "W1": (-200, 1100), "W2": (0, 300), "W3": (0.1, 0.5)}
    chans = {"X": 1, "W1": 1, "W2": 2, "W3": 1}
    return {k: rs.uniform(*lo[k], (1, chans[k], r * lr, r * lr * tiles_x)).astype(np.float32)
            for k, r in INPUT_RATIOS.items()}


def _crop(inputs, tx):
    """Tile (0, tx)'s NCHW crops: edge-padded at the region's borders, the
    conditioning clipped at 0, as the engine cuts them."""
    lr, pad = TILE // 4, HALO + 1
    out = []
    for key, ratio in INPUT_RATIOS.items():
        a = inputs[key]
        rows = np.clip(np.arange(-pad * ratio, (lr + pad) * ratio), 0, a.shape[2] - 1)
        cols = np.clip(np.arange((tx * lr - pad) * ratio, (tx * lr + lr + pad) * ratio), 0,
                       a.shape[3] - 1)
        t = torch.from_numpy(np.ascontiguousarray(a[:, :, rows][:, :, :, cols]))
        out.append(t if key == "X" else t.clamp_min(0.0))
    return out


def _reference_tile(p, inputs, tx, **kw):
    out = reference.hat(p, *_crop(inputs, tx), cfg=TINY, **kw)
    d = 4 * HALO
    return out[0, 0, d:-d, d:-d]


def _plant(monkeypatch, fault):
    """A fault in the program: the same five the reference plants."""
    from deepbedmap_tpu_torch.models import swinir

    if fault in ("bias", "shift"):
        attention = swinir.window_attention

        def faulty(qkv, table, heads, window, shift):
            if fault == "bias":
                table = torch.zeros_like(table)
            return attention(qkv, table, heads, window, 0 if fault == "shift" else shift)

        monkeypatch.setattr(swinir, "window_attention", faulty)
    if fault == "bias":
        overlap = model.overlap_attention
        monkeypatch.setattr(model, "overlap_attention", lambda qkv, table, *a: overlap(
            qkv, torch.zeros_like(table), *a))
    if fault == "mask":
        monkeypatch.setattr(window_attn, "shift_mask",
                            lambda h, w, ws, s, device="cpu": torch.zeros(
                                (h // ws) * (w // ws), ws * ws, ws * ws, device=device))
    if fault == "cab":
        monkeypatch.setattr(model.CAB, "forward", lambda self, x: torch.zeros_like(x))
    if fault == "oca_pad":
        def no_pad_keys(qkv, table, heads, window, overlap):
            """Keys outside the grid left out of the softmax."""
            n, h, w, _ = qkv.shape
            pad = (overlap - window) // 2
            inside = torch.nn.functional.unfold(torch.ones(1, 1, h, w), overlap, stride=window,
                                                padding=pad)[0].t()  # (nW, ow^2)
            return _masked_overlap(qkv, table, heads, window, overlap, inside)

        monkeypatch.setattr(model, "overlap_attention", no_pad_keys)


def _masked_overlap(qkv, table, heads, window, overlap, inside):
    """The plain cross-attention with the keys where ``inside`` is 0 out of
    the softmax."""
    n, h, w, c3 = qkv.shape
    c, ws, ow = c3 // 3, window, overlap
    d = c // heads
    q = qkv[..., :c].reshape(n, h // ws, ws, w // ws, ws, heads, d)
    q = q.permute(0, 1, 3, 5, 2, 4, 6).reshape(n, -1, heads, ws * ws, d) * d ** -0.5
    kv = torch.nn.functional.unfold(qkv[..., c:].permute(0, 3, 1, 2), ow,
                                    padding=(ow - ws) // 2, stride=ws)
    kv = kv.view(n, 2, heads, d, ow * ow, -1).permute(1, 0, 5, 2, 4, 3)
    attn = q @ kv[0].transpose(-2, -1)
    attn = attn + table[window_attn.overlap_position_index(ws, ow)].permute(2, 0, 1)
    attn = attn + torch.where(inside > 0, 0.0, float("-inf"))[None, :, None, None, :]
    o = torch.softmax(attn, dim=-1) @ kv[1]
    o = o.view(n, h // ws, w // ws, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(n, h, w, c)


@pytest.mark.parametrize("fault", [None, "bias", "mask", "shift", "cab", "oca_pad"])
def test_predict_continent_equals_the_reference_tile_by_tile(fault, monkeypatch):
    if fault:
        _plant(monkeypatch, fault)
    p = _weights()
    inputs = _canvas()
    dbm = DeepBedMap(p, cfg=HATConfig(**TINY), device="cpu")
    dem = dbm.predict_continent(inputs, (0.0, 0.0, 2 * TILE * RES, TILE * RES),
                                tile_out=TILE, halo_lr=HALO, tiles_per_dispatch=2)
    assert dem.data.shape == (TILE, 2 * TILE)
    with torch.no_grad():
        gaps = [reference.widest_gap(torch.from_numpy(dem.data[:, tx * TILE:(tx + 1) * TILE]),
                                     _reference_tile(p, inputs, tx)) for tx in (0, 1)]
        if fault is None:
            assert max(gaps) < TOL
            # the control, the reference in TF32, is far outside the tolerance
            lower = reference.widest_gap(_reference_tile(p, inputs, 0, precision="tf32"),
                                         _reference_tile(p, inputs, 0))
            assert lower > 10 * TOL
        else:
            assert max(gaps) > 100 * TOL
            # the reference's own fault of that name lands where the program's does
            planted = reference.widest_gap(_reference_tile(p, inputs, 0, drop=(fault,)),
                                           torch.from_numpy(dem.data[:, :TILE]))
            assert planted < TOL


def _qkv_and_weights(n, h, w, c, heads, table_rows, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g)
    p = {"a.qkv.weight": torch.randn(3 * c, c, generator=g) / math.sqrt(c),
         "a.qkv.bias": 0.1 * torch.randn(3 * c, generator=g),
         "a.proj.weight": torch.eye(c), "a.proj.bias": torch.zeros(c),
         "a.relative_position_bias_table": torch.randn(table_rows, heads, generator=g)}
    return x, p, torch.nn.functional.linear(x, p["a.qkv.weight"], p["a.qkv.bias"])


@pytest.mark.parametrize("shift", [0, 2])
def test_plain_self_attention_equals_the_references_hab_attention(shift):
    """HAB's window attention, shifted and unshifted, on a grid of 2 x 3
    windows (every window an edge window when shifted)."""
    n, h, w, c, heads, ws = 2, 8, 12, 12, 2, 4
    x, p, qkv = _qkv_and_weights(n, h, w, c, heads, (2 * ws - 1) ** 2)
    got = window_attn.window_attention_plain(qkv, p["a.relative_position_bias_table"], heads,
                                             ws, shift)
    shifted = torch.roll(x, (-shift, -shift), (1, 2))
    mask = swinir_reference.calculate_mask(h, w, ws, shift) if shift else None
    windows = swinir_reference.window_attention(swinir_reference.window_partition(
        shifted, ws).view(-1, ws * ws, c), p, "a", heads, ws, mask, "fp32", "fp32", ())
    want = torch.roll(swinir_reference.window_reverse(windows.view(-1, ws, ws, c), ws, h, w),
                      (shift, shift), (1, 2))
    assert (got - want).abs().max() < 1e-5 * want.abs().max()


def _drawn(block, prefix, seed=4):
    """Seeded weights for ``block`` under the reference's names: linears at
    1/sqrt(fan_in), biases N(0, 0.1^2), LayerNorm weights 1 + N(0, 0.1^2),
    bias tables N(0, 1), convs He-normal."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in block.state_dict().items():
        z = torch.randn(t.shape, generator=g)
        if name.endswith("relative_position_bias_table"):
            out[name] = z
        elif name.endswith("bias"):
            out[name] = 0.1 * z
        elif t.dim() == 1:
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = z * math.sqrt((2.0 if t.dim() == 4 else 1.0) / t[0].numel())
    block.load_state_dict(out)
    return {f"{prefix}.{k}": v for k, v in out.items()}


@pytest.mark.parametrize("ws, ow", [(4, 6), (4, 8)])
def test_the_ocab_equals_the_references(ws, ow):
    """The OCAB (its plain cross-attention between its LayerNorm, linears
    and MLP) on a grid of 2 x 3 windows, whose every window reaches the zero
    padding, against the reference's OCAB with its real unfold."""
    n, h, w, c, heads = 2, 8, 12, 12, 2
    block = model.OCAB(c, heads, ws, ow)
    p = _drawn(block, "o")
    x = torch.randn(n, h, w, c, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = block(x)
        want = reference.ocab(x.reshape(n, h * w, c), (h, w), p, "o", heads, ws, ow, "fp32",
                              "fp32", ()).view(n, h, w, c)
    assert (got - want).abs().max() < 1e-5 * want.abs().max()


@pytest.mark.parametrize("shift", [0, 2])
def test_the_hab_equals_the_references(shift):
    """The HAB (Swin attention beside the CAB, both residuals) against the
    reference's, shifted and unshifted."""
    n, h, w, c, heads, ws = 2, 8, 12, 12, 2, 4
    block = model.HAB(c, heads, ws, shift, compress=3, squeeze=4, conv_scale=0.01)
    p = _drawn(block, "b")
    x = torch.randn(n, h, w, c, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = block(x)
        want = reference.hab(x.reshape(n, h * w, c), (h, w), p, "b", heads, ws, shift, 0.01,
                             "fp32", "fp32", ()).view(n, h, w, c)
    assert (got - want).abs().max() < 1e-5 * want.abs().max()


def test_the_tiled_kernels_indexing_is_the_roll_the_partition_and_the_unfold():
    """csrc/window_attn_tiled.cu's index arithmetic, transcribed: a query
    (r, c) of window (wy, wx) reads pixel ((ws wy + r + shift) % H, ...); a
    key (ky, kx) of the cross case pixel (ws wy - pad + ky, ws wx - pad +
    kx) or none; a pair's bias row is the key's part ky (ws + ow - 1) + kx
    plus the query's (ws - 1 - r)(ws + ow - 1) + ws - 1 - c, in a table
    staged as given for the cross case and reversed for self-attention. It
    equals the plain versions' roll, partition, unfold and table indices."""
    h, w = 8, 12
    for ws, ow, shift, cross in [(4, 4, 0, False), (4, 4, 2, False), (4, 6, 0, True),
                                 (4, 8, 0, True)]:
        pad = (ow - ws) // 2
        side = ws + ow - 1
        t = side * side
        ids = torch.arange(h * w).view(1, 1, h, w).float() + 1  # 0 marks the padding
        if cross:
            keys = torch.nn.functional.unfold(ids, ow, padding=pad, stride=ws)[0].t()
            index = window_attn.overlap_position_index(ws, ow)
        else:
            keys = torch.roll(ids[0, 0], (-shift, -shift), (0, 1)).view(
                h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
            index = window_attn.relative_position_index(ws)
        for win in range((h // ws) * (w // ws)):
            wy, wx = divmod(win, w // ws)
            kpix, kkey = [], []
            for j in range(ow * ow):
                ky, kx = divmod(j, ow)
                kkey.append(ky * side + kx)
                if cross:
                    y, x = ws * wy - pad + ky, ws * wx - pad + kx
                    kpix.append(y * w + x + 1 if 0 <= y < h and 0 <= x < w else 0)
                else:
                    kpix.append(((ws * wy + ky + shift) % h) * w + (ws * wx + kx + shift) % w
                                + 1)
            assert keys[win].long().tolist() == kpix
        for i in range(ws * ws):
            r, c = divmod(i, ws)
            qkey = (ws - 1 - r) * side + (ws - 1 - c)
            for j in range(ow * ow):
                staged = kkey_j = (j // ow) * side + j % ow
                row = staged + qkey if cross else t - 1 - (kkey_j + qkey)
                assert int(index[i, j]) == row


def test_state_dict_round_trip_and_the_references_names():
    cfg = HATConfig(**TINY)
    first = build_generator(cfg, seed=7, device="cpu").eval()
    names = [name for name, *_ in reference.param_spec(TINY)]
    assert list(first.state_dict()) == names
    second = DeepBedMap(first.state_dict(), cfg=cfg, device="cpu").model
    xs = [a.permute(0, 2, 3, 1).contiguous() for a in _crop(_canvas(1), 0)]
    with torch.no_grad():
        assert torch.equal(first(*xs), second(*xs))
    assert first(*xs).shape == (1, 4 * 14, 4 * 14, 1)


def test_the_flop_count_by_hand():
    lr, c, ws, ow, hidden, mid, sq = 16, 12, 4, 6, 24, 4, 3
    side = 16  # the 14 px latent padded to the window
    habs, groups = 4, 2
    hab = 4 * c * c + 2 * c * hidden + 2 * ws * ws * c + 9 * 2 * c * mid
    ocab = 4 * c * c + 2 * c * hidden + 2 * ow * ow * c
    convs = (9 * 128 * c + (groups + 1) * 9 * c * c + 9 * c * 64) * side ** 2 \
        + 9 * 64 * 256 * (side ** 2 + (2 * side) ** 2) + 9 * 64 * (4 * side) ** 2
    inputs = 14 ** 2 * (9 + 900 + 72 + 9) * 32
    want = 2 * ((habs * hab + groups * ocab) * side ** 2 + convs + inputs + habs * 2 * c * sq)
    assert hat_tile_flops(HATConfig(**TINY), lr)["total"] == want
    # HAT on a continent crop: ~4.24 TFLOP, against SwinIR-M's 2.20
    assert hat_tile_flops(HATConfig(), 288)["total"] == pytest.approx(4.2429e12, 1e-4)


def test_the_pad_key_count_by_hand():
    # a 16 x 16 grid in windows of 4 with keys of 6: each axis's 4 windows
    # reach 5, 6, 6, 5 keys inside the grid
    inside = [5, 6, 6, 5]
    assert model.pad_keys(16, 16, 4, 6) == sum(36 - a * b for a in inside for b in inside)
    # the continent's 288^2 grid, windows 16, keys 24: the border windows
    # reach 20 keys inside along their axis, the others 24
    inside = [20] + [24] * 16 + [20]
    assert model.pad_keys(288, 288, 16, 24) == sum(576 - a * b for a in inside for b in inside)


def test_the_configuration_refuses_what_the_port_does_not_build():
    with pytest.raises(ValueError, match="divide"):
        model.HAT(HATConfig(embed_dim=12, num_heads=(5,), depths=(2,)))
    with pytest.raises(ValueError, match="compress_ratio 5 does not divide"):
        check_hat(HATConfig(embed_dim=12, num_heads=(2,), depths=(2,), compress_ratio=5))
    with pytest.raises(ValueError, match="squeeze_factor 7 does not divide"):
        check_hat(HATConfig(embed_dim=12, num_heads=(2,), depths=(2,), squeeze_factor=7))
    with pytest.raises(ValueError, match="not whole"):
        check_hat(HATConfig(window_size=16, overlap_ratio=0.25 + 1 / 16))  # 16 + 5
    with pytest.raises(ValueError, match="differ in length"):
        model.HAT(HATConfig(depths=(6, 6)))
    check_hat(HATConfig())
    assert HATConfig().overlap_window == 24
    for flag in ({"fused_rdb": "always"}, {"upsampler": "nearest+conv"}):
        with pytest.raises(TypeError):
            HATConfig(**flag)
    # the tiled kernel refuses what it does not take before it touches a
    # card: windows whose square is no multiple of 128, key windows whose
    # square is no multiple of 64, heads wider than 32 channels
    with pytest.raises(NotImplementedError, match="got window 12 and 6"):
        window_attn._launch(torch.zeros(1, 24, 24, 36), torch.zeros(529, 2), 2, 12, 0)
    with pytest.raises(NotImplementedError, match=r"got window 16 and 6 \(key window 20\)"):
        window_attn._launch(torch.zeros(1, 32, 32, 36), torch.zeros(35 ** 2, 2), 2, 16, 0,
                            overlap=20)
    with pytest.raises(NotImplementedError, match="got window 16 and 60"):
        window_attn._launch(torch.zeros(1, 16, 16, 540), torch.zeros(961, 3), 3, 16, 0)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", ["self", "self_shifted", "cross"])
def test_the_tiled_kernel_equals_its_plain_version_at_the_published_widths(card, case):
    """At (2, 288, 288, 3 x 180), 6 heads, window 16 (keys 24 for the
    cross case): the kernel within 1e-5 of the largest output of the plain
    version in float64 (fp32 products of 30 terms, a softmax over 256 or 576
    keys: ~1e-7); the plain version on q, k and v rounded to TF32 lies
    outside it (~1e-4), so a TF32 kernel would fail. One launch a call,
    counted under the case's name."""
    from deepbedmap_tpu_torch.ops import _kernels

    g = torch.Generator(device=card).manual_seed(17)
    qkv = torch.randn(2, 288, 288, 540, generator=g, device=card)
    if case == "cross":
        table = torch.randn(39 ** 2, 6, generator=g, device=card)
        name = "overlap_attn_tiled"

        def run(x, t):
            return window_attn.overlap_attention(x, t, 6, 16, 24)

        def plain(x, t):
            return window_attn.overlap_attention_plain(x, t, 6, 16, 24)
    else:
        shift = 8 if case == "self_shifted" else 0
        table = torch.randn(31 ** 2, 6, generator=g, device=card)
        name = "window_attn_tiled"

        def run(x, t):
            return window_attn.window_attention(x, t, 6, 16, shift)

        def plain(x, t):
            return window_attn.window_attention_plain(x, t, 6, 16, shift)
    before = dict(_kernels.launches)
    got = run(qkv, table)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _kernels.launches.items() if v != before[k]} == \
        {name: 1}
    want = plain(qkv.double(), table.double())
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) < 1e-5 * scale
    tf32 = plain(swinir_reference.round_to(qkv, "tf32").double(), table.double())
    assert float((tf32 - want).abs().max()) > 1e-5 * scale


@pytest.mark.card
def test_a_hat_forward_launches_one_tiled_kernel_a_block_and_agrees_with_the_cpu(
        card, monkeypatch):
    """HAT at its published widths and depth on a 36-px crop (a 34-px
    latent padded to 48: shifted windows, edge windows, zero keys): 36
    self-attention and 6 cross-attention launches, nothing else of the
    port's kernels, no roll and no unfold on the card; the output within
    1e-4 of the CPU's (fp32 in other orders through 42 blocks)."""
    from deepbedmap_tpu_torch.ops import _kernels

    for module, name in ((torch, "roll"), (torch.nn.functional, "unfold")):
        def refuse_on_card(t, *a, _f=getattr(module, name), **k):
            assert not t.is_cuda, "a roll or an unfold ran on the card"
            return _f(t, *a, **k)

        monkeypatch.setattr(module, name, refuse_on_card)
    model_cpu = build_generator(HATConfig(), seed=3, device="cpu").eval()
    model_card = build_generator(HATConfig(), seed=3, device=card).eval()
    g = torch.Generator().manual_seed(5)
    lr = 36
    xs = [torch.randn(1, lr, lr, 1, generator=g), torch.rand(1, 10 * lr, 10 * lr, 1, generator=g),
          torch.rand(1, 2 * lr, 2 * lr, 2, generator=g), torch.rand(1, lr, lr, 1, generator=g)]
    before = dict(_kernels.launches)
    with torch.no_grad():
        got = model_card(*[x.to(card) for x in xs])
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _kernels.launches.items() if v != before[k]}
        want = model_cpu(*xs)
    assert launched == {"window_attn_tiled": 36, "overlap_attn_tiled": 6}
    span = float(want.max() - want.min())
    assert float((got.cpu() - want).abs().max()) < 1e-4 * span

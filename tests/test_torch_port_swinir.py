"""PyTorch port: SwinIR as the second generator, on the CPU at a tiny size
(embed 12, 2 heads, window 4, two RSTBs of 2 Swin layers), against the plain
reference ``reference/swinir.py`` on seeded random weights whose bias tables
and LayerNorm affines are drawn away from their defaults.

Tolerances: the program and the reference compute the same fp32 sums in
other orders (cuBLAS-free CPU matmuls, other reshapes), so they agree to
~1e-6 of the output's range; 1e-5 leaves room for that and none for a
fault: each of the three faults (the bias, the mask or the shift dropped)
moves the output by 1e-2 of its range or more."""

import math

import numpy as np
import pytest
import torch

from deepbedmap_tpu_torch import DeepBedMap
from deepbedmap_tpu_torch.config import SwinIRConfig
from deepbedmap_tpu_torch.inference.engine import INPUT_RATIOS
from deepbedmap_tpu_torch.models import build_generator
from deepbedmap_tpu_torch.models import swinir as model
from deepbedmap_tpu_torch.ops import window_attn
from deepbedmap_tpu_torch.utils.flops import swinir_tile_flops
from reference import swinir as reference

TINY = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4)
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
        if kind in ("input", "conv", "last"):
            scale = {"input": 1e-3, "conv": 1.0, "last": 200.0}[kind]
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
    out = reference.swinir(p, *_crop(inputs, tx), cfg=TINY, **kw)
    d = 4 * HALO
    return out[0, 0, d:-d, d:-d]


def _plant(monkeypatch, fault):
    attention = model.window_attention

    def faulty(qkv, table, heads, window, shift):
        if fault == "bias":
            table = torch.zeros_like(table)
        if fault == "shift":
            shift = 0
        return attention(qkv, table, heads, window, shift)

    monkeypatch.setattr(model, "window_attention", faulty)
    if fault == "mask":
        monkeypatch.setattr(window_attn, "shift_mask",
                            lambda h, w, ws, s, device="cpu": torch.zeros(
                                (h // ws) * (w // ws), ws * ws, ws * ws, device=device))


@pytest.mark.parametrize("fault", [None, "bias", "mask", "shift"])
def test_predict_continent_equals_the_reference_tile_by_tile(fault, monkeypatch):
    if fault:
        _plant(monkeypatch, fault)
    p = _weights()
    inputs = _canvas()
    dbm = DeepBedMap(p, cfg=SwinIRConfig(**TINY), device="cpu")
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


@pytest.mark.parametrize("shift", [0, 2])
def test_plain_attention_equals_the_references_attention(shift):
    g = torch.Generator().manual_seed(3)
    n, h, w, c, heads, ws = 2, 8, 12, 12, 2, 4
    x = torch.randn(n, h, w, c, generator=g)
    p = {"a.qkv.weight": torch.randn(3 * c, c, generator=g) / math.sqrt(c),
         "a.qkv.bias": 0.1 * torch.randn(3 * c, generator=g),
         "a.proj.weight": torch.randn(c, c, generator=g) / math.sqrt(c),
         "a.proj.bias": 0.1 * torch.randn(c, generator=g),
         "a.relative_position_bias_table": torch.randn((2 * ws - 1) ** 2, heads, generator=g)}
    qkv = torch.nn.functional.linear(x, p["a.qkv.weight"], p["a.qkv.bias"])
    got = window_attn.window_attention_plain(qkv, p["a.relative_position_bias_table"], heads,
                                             ws, shift)
    got = torch.nn.functional.linear(got, p["a.proj.weight"], p["a.proj.bias"])
    shifted = torch.roll(x, (-shift, -shift), (1, 2))
    mask = reference.calculate_mask(h, w, ws, shift) if shift else None
    windows = reference.window_attention(reference.window_partition(shifted, ws).view(
        -1, ws * ws, c), p, "a", heads, ws, mask, "fp32", "fp32", ())
    want = torch.roll(reference.window_reverse(windows.view(-1, ws, ws, c), ws, h, w),
                      (shift, shift), (1, 2))
    assert (got - want).abs().max() < 1e-5 * want.abs().max()


@pytest.mark.parametrize("shift", [0, 2])
def test_the_kernels_indexing_is_the_roll_and_the_partition(shift):
    """csrc/window_attn.cu's index arithmetic, transcribed: window (wy, wx),
    position (r, c) reads and writes pixel ((ws wy + r + shift) % H, ...);
    the mask compares region labels of the rolled grid; the bias row is
    (dr + ws - 1)(2 ws - 1) + dc + ws - 1. It equals the plain version's
    roll, partition, mask and table index."""
    h, w, ws = 8, 12, 4
    ids = torch.arange(h * w).view(1, h, w, 1).float()
    windows = torch.roll(ids, (-shift, -shift), (1, 2)).view(h // ws, ws, w // ws, ws)
    windows = windows.permute(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = window_attn.shift_mask(h, w, ws, shift) if shift else torch.zeros(1)

    def region(a, n):
        return 0 if a < n - ws else (1 if a < n - shift else 2)

    for win in range((h // ws) * (w // ws)):
        wy, wx = divmod(win, w // ws)
        pix, lab = [], []
        for t in range(ws * ws):
            a, b = wy * ws + t // ws, wx * ws + t % ws
            pix.append(((a + shift) % h) * w + (b + shift) % w)
            lab.append(3 * region(a, h) + region(b, w) if shift else 0)
        assert windows[win].long().tolist() == pix
        if shift:
            got = torch.tensor([[0.0 if li == lj else window_attn.MASK_VALUE for lj in lab]
                                for li in lab])
            assert torch.equal(got, mask[win])
    index = [[(i // ws - j // ws + ws - 1) * (2 * ws - 1) + (i % ws - j % ws + ws - 1)
              for j in range(ws * ws)] for i in range(ws * ws)]
    assert window_attn.relative_position_index(ws).tolist() == index


def test_state_dict_round_trip_and_the_references_names():
    cfg = SwinIRConfig(**TINY)
    first = build_generator(cfg, seed=7, device="cpu").eval()
    names = [name for name, *_ in reference.param_spec(TINY)]
    assert list(first.state_dict()) == names
    second = DeepBedMap(first.state_dict(), cfg=cfg, device="cpu").model
    xs = [a.permute(0, 2, 3, 1).contiguous() for a in _crop(_canvas(1), 0)]
    with torch.no_grad():
        assert torch.equal(first(*xs), second(*xs))
    assert first(*xs).shape == (1, 4 * 14, 4 * 14, 1)


def test_the_flop_count_by_hand():
    lr, c, ws, hidden = 16, 12, 4, 24
    side = 16  # the 14 px latent padded to the window
    layers, rstbs = 4, 2
    per_token = 4 * c * c + 2 * c * hidden + 2 * ws * ws * c
    convs = (9 * 128 * c + (rstbs + 1) * 9 * c * c + 9 * c * 64) * side ** 2 \
        + 9 * 64 * 256 * (side ** 2 + (2 * side) ** 2) + 9 * 64 * (4 * side) ** 2
    inputs = 14 ** 2 * (9 + 900 + 72 + 9) * 32
    want = 2 * (layers * per_token * side ** 2 + convs + inputs)
    assert swinir_tile_flops(SwinIRConfig(**TINY), lr)["total"] == want
    # SwinIR-M on a continent crop: ~2.2 TFLOP
    assert swinir_tile_flops(SwinIRConfig(), 288)["total"] == pytest.approx(2.2048e12, 1e-4)


def test_the_configuration_refuses_what_the_port_does_not_build():
    with pytest.raises(ValueError, match="divide"):
        model.SwinIR(SwinIRConfig(embed_dim=12, num_heads=(5,), depths=(2,)))
    with pytest.raises(ValueError, match="differ in length"):
        model.SwinIR(SwinIRConfig(depths=(6, 6)))
    # DeepBedMap's kernel flags and the published options the port does not
    # build are no fields of it
    for flag in ({"fused_rdb": "always"}, {"rdb_resident": "always"},
                 {"upsampler": "nearest+conv"}):
        with pytest.raises(TypeError):
            SwinIRConfig(**flag)
    # the window kernel refuses what it does not take before it touches a
    # card: other windows than 8 x 8, heads wider than 32 channels
    table = torch.zeros(49, 2)
    with pytest.raises(NotImplementedError, match="got window 4 and 6"):
        window_attn._launch(torch.zeros(1, 8, 8, 36), table, 2, 4, 0)
    with pytest.raises(NotImplementedError, match="got window 8 and 60"):
        window_attn._launch(torch.zeros(1, 8, 8, 540), torch.zeros(225, 3), 3, 8, 0)

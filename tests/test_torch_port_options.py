"""PyTorch port: the generator options against the JAX package on the CPU.

The phase convs (``ops/phase_conv.py``), ``deform_conv2d``'s
channels-before-width layouts, the bf16 tail, the plain bf16 dense block,
the whole generator under ``upsample_phase_conv``, ``tail_hcw``,
``fused_rdb='never'`` and ``compute_dtype='bfloat16'`` (2 RRDBs, an 11-px
crop), and the dispatch precedence (``config.trunk_kernel``,
``config.conv_kernel``) against the kernels JAX's own forward reaches. The
same numpy inputs and parameters (through ``bridge.py``) go to both. No JAX
function here reaches a Pallas kernel but ``deform_conv2d(method='pallas')``
(interpreted) and the dispatch test, which only traces.

Tolerances, stated once:
- float32: within ``TOL_FP32`` = 2e-5 of the reference's largest
  magnitude, the bound JAX's own layout tests use
  (``tests/test_models.py:104-125``);
- bfloat16 (``_hold_bf16``): the port's distance from JAX's bf16 result
  must be smaller than JAX-bf16's distance from JAX-fp32, so the port runs
  the bf16 path and not the fp32 one (the measured ratio is printed), and
  both distances within ``TOL_BF16`` = 2e-2 of the range, JAX's own bf16
  bound (``tests/test_models.py:154-194``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbedmap_tpu.config import GeneratorConfig as JaxGeneratorConfig
from deepbedmap_tpu.models import build_generator as jax_build_generator
from deepbedmap_tpu.models.blocks import ResidualDenseBlock as JaxResidualDenseBlock
from deepbedmap_tpu.models.generator import Generator as JaxGenerator
from deepbedmap_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from deepbedmap_tpu.ops.pallas_tail import _tail_reference as jax_tail_reference
from deepbedmap_tpu.ops.phase_conv import phase_kernels_2x as jax_phase_kernels_2x
from deepbedmap_tpu.ops.phase_conv import upsample2_conv3x3 as jax_upsample2_conv3x3
from deepbedmap_tpu_torch.bridge import jax_params_to_state_dict
from deepbedmap_tpu_torch.config import GeneratorConfig, conv_kernel, trunk_kernel
from deepbedmap_tpu_torch.models import Generator
from deepbedmap_tpu_torch.models.blocks import ResidualDenseBlock
from deepbedmap_tpu_torch.ops.deform_conv import deform_conv2d
from deepbedmap_tpu_torch.ops.phase_conv import phase_kernels_2x, upsample2_conv3x3
from deepbedmap_tpu_torch.ops.tail import fused_deform_tail, tail_reference

TOL_FP32 = 2e-5
TOL_BF16 = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _hold_fp32(label, got, want) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, label
    err = np.abs(got - want).max()
    print(f"{label}: {err:.3e} of a range {scale:.3e}")
    assert err <= TOL_FP32 * scale, (label, err, scale)


def _hold_bf16(label, got, want16, want32) -> float:
    """The module docstring's bf16 rule; returns the ratio."""
    got, want16, want32 = _np(got), _np(want16), _np(want32)
    assert got.shape == want16.shape == want32.shape, label
    scale = np.abs(want32).max()
    d_port = np.abs(got - want16).max()
    d_jax = np.abs(want16 - want32).max()
    ratio = d_port / d_jax
    print(f"{label}: port vs JAX-bf16 {d_port:.3e}, JAX-bf16 vs JAX-fp32 {d_jax:.3e}, "
          f"ratio {ratio:.3g}, range {scale:.3e}")
    assert d_jax > 0, label  # the bf16 path changes the result
    assert d_port < d_jax, (label, d_port, d_jax)
    assert d_jax <= TOL_BF16 * scale and d_port <= TOL_BF16 * scale, (label, d_jax, scale)
    return ratio


# --- ops/phase_conv.py --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase_kernels_match_jax(dtype):
    k = np.random.RandomState(0).randn(3, 3, 8, 6).astype(np.float32)
    want = jax_phase_kernels_2x(jnp.asarray(k, getattr(jnp, dtype)))
    got = phase_kernels_2x(_oihw(k).to(getattr(torch, dtype)))
    assert tuple(got.shape) == (24, 8, 2, 2) and got.dtype == getattr(torch, dtype)
    # the same taps summed in the same order and dtype
    np.testing.assert_array_equal(_np(got), _np(want).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("leaky", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample2_conv3x3_matches_jax(dtype, leaky):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 9, 8).astype(np.float32)
    k = (rs.randn(3, 3, 8, 6) * 0.3).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_upsample2_conv3x3(jnp.asarray(x, jt), jnp.asarray(k, jt), jnp.asarray(b, jt),
                                 leaky=leaky)
    got = upsample2_conv3x3(torch.from_numpy(x).to(tt), _oihw(k).to(tt),
                            torch.from_numpy(b).to(tt), leaky=leaky)
    assert tuple(got.shape) == (2, 14, 18, 6) and got.dtype == tt
    if dtype == "float32":
        _hold_fp32("upsample2_conv3x3", got, want)
    else:
        want32 = jax_upsample2_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                       leaky=leaky)
        _hold_bf16("upsample2_conv3x3 bf16", got, want, want32)


# --- ops/deform_conv.py: in_hcw / out_hcw ---------------------------------------

# (method, C_out): the plain samplers, and 'pallas' at both of the kernels'
# widths (K7 64 -> 64 and K8 64 -> 1, their plain versions on the CPU; JAX's
# interpreted)
DEFORM_METHODS = [("shifts", 64), ("zproj", 1), ("gather", 64), ("pallas", 64),
                  ("pallas", 1)]
# (in_hcw, out_hcw, whether the HCW input is a contiguous (N, H, C, W) tensor
# or a permuted view of NHWC memory)
DEFORM_LAYOUTS = [(True, True, "contiguous"), (True, False, "view"), (False, True, None)]


@pytest.mark.parametrize("in_hcw,out_hcw,memory", DEFORM_LAYOUTS)
@pytest.mark.parametrize("method,c_out", DEFORM_METHODS)
def test_deform_conv2d_hcw_matches_jax(method, c_out, in_hcw, out_hcw, memory):
    rs = np.random.RandomState(2)
    x = rs.randn(1, 9, 13, 64).astype(np.float32)
    off = (rs.randn(1, 9, 13, 18) * 1.5).astype(np.float32)
    w = (rs.randn(3, 3, 64, c_out) * 0.05).astype(np.float32)
    b = rs.randn(c_out).astype(np.float32)
    if in_hcw:
        jx, joff = jnp.swapaxes(jnp.asarray(x), 2, 3), jnp.swapaxes(jnp.asarray(off), 2, 3)
        if memory == "contiguous":
            tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 3, 2)))
            toff = torch.from_numpy(np.ascontiguousarray(off.transpose(0, 1, 3, 2)))
        else:
            tx = torch.from_numpy(x).permute(0, 1, 3, 2)
            toff = torch.from_numpy(off).permute(0, 1, 3, 2)
            assert not tx.is_contiguous()
    else:
        jx, joff = jnp.asarray(x), jnp.asarray(off)
        tx, toff = torch.from_numpy(x), torch.from_numpy(off)
    want = jax_deform_conv2d(jx, joff, jnp.asarray(w), jnp.asarray(b), padding=1,
                             method=method, clamp=2, in_hcw=in_hcw, out_hcw=out_hcw)
    got = deform_conv2d(tx, toff, _oihw(w), torch.from_numpy(b), 1, 2, method=method,
                        in_hcw=in_hcw, out_hcw=out_hcw)
    assert tuple(got.shape) == tuple(want.shape) == (
        (1, 9, c_out, 13) if out_hcw else (1, 9, 13, c_out))
    _hold_fp32(f"deform_conv2d {method} -> {c_out}", got, want)


# --- ops/tail.py at bf16 --------------------------------------------------------


def _tail_params(rs):
    def k(shape, scale):
        return (rs.randn(*shape) * scale).astype(np.float32)

    return [k((3, 3, 16, 18), 0.1), k((18,), 0.1), k((3, 3, 16, 16), 0.1), k((16,), 0.1),
            k((3, 3, 16, 18), 0.1), k((18,), 0.1), k((3, 3, 16, 1), 0.1), k((1,), 0.1)]


def test_bf16_tail_matches_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 12, 14, 16).astype(np.float32)
    params = _tail_params(rs)
    jp = [jnp.asarray(p) for p in params]
    want16 = jax_tail_reference(jnp.asarray(x, jnp.bfloat16), *jp, 1, 2, "bfloat16")
    want32 = jax_tail_reference(jnp.asarray(x), *jp, 1, 2, "float32")
    tp = [_oihw(p) if p.ndim == 4 else torch.from_numpy(p) for p in params]
    tx = torch.from_numpy(x).bfloat16()
    for name, fn in (("tail_reference", tail_reference), ("fused_deform_tail",
                                                          fused_deform_tail)):
        got = fn(tx, *tp, clamp=2, compute_dtype="bfloat16")
        assert got.dtype == torch.float32
        _hold_bf16(f"{name} bf16", got, want16, want32)
    # float32 is the default, and a no-op cast
    _hold_fp32("tail_reference float32", tail_reference(torch.from_numpy(x), *tp,
                                                       compute_dtype="float32"), want32)


# --- the plain dense block at a compute dtype ----------------------------------


@pytest.mark.parametrize("input_dtype", ["bfloat16", "float32"])
def test_plain_bf16_dense_block_matches_jax(input_dtype):
    # the block casts each conv's input to bf16, and its output follows the
    # input's dtype (float32 in, float32 out), as JAX's
    rs = np.random.RandomState(4)
    x = rs.randn(1, 12, 12, 16).astype(np.float32)
    jax16 = JaxResidualDenseBlock(16, 8, 0.1, 1.0, jnp.bfloat16, fused="never")
    jax32 = JaxResidualDenseBlock(16, 8, 0.1, 1.0, None, fused="never")
    variables = jax32.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jt = getattr(jnp, input_dtype)
    want16 = jax16.apply(variables, jnp.asarray(x, jt))
    want32 = jax32.apply(variables, jnp.asarray(x))
    block = ResidualDenseBlock(16, 8, 0.1, kernel="plain", dtype=torch.bfloat16)
    block.load_state_dict({
        f"conv_layer{i}.{n}": _oihw(np.asarray(v)) if n == "weight" else torch.tensor(
            np.asarray(v))
        for i in range(1, 6)
        for n, v in (("weight", variables["params"][f"conv_layer{i}"]["kernel"]),
                     ("bias", variables["params"][f"conv_layer{i}"]["bias"]))})
    with torch.inference_mode():
        got = block(torch.from_numpy(x).to(getattr(torch, input_dtype)))
    assert got.dtype == getattr(torch, input_dtype) and want16.dtype == jt
    _hold_bf16(f"plain dense block bf16, {input_dtype} in", got, want16, want32)


# --- the whole generator ------------------------------------------------------

GEN_LR = 11
GEN_OPTIONS = {
    "upsample_phase_conv": dict(upsample_phase_conv=True),
    "tail_hcw": dict(tail_hcw=True, tail_fused=False),
    "fused_rdb_never": dict(fused_rdb="never"),
    "bfloat16": dict(compute_dtype="bfloat16"),
}


@pytest.fixture(scope="module")
def gen_params():
    """The crop's inputs, and one parameter tree per init scale for every
    option (the tree is the same under each). The float32 options are held
    at init scale 1.0, where activations and offsets are O(1) and the
    tolerance bites; bf16 at JAX's own drift test's 0.1: at 1.0 one bf16
    rounding that flips with the summation order of a conv (an ulp, at
    either side's float32 accumulation) moves an offset across an integer
    and the sampler's output with it, and JAX's bf16 output itself lies
    2.5% of the range from its float32 one, beyond JAX's bound."""
    rs = np.random.RandomState(42)
    lr = GEN_LR
    xs = [rs.rand(1, lr, lr, 1), rs.rand(1, 10 * lr, 10 * lr, 1),
          rs.rand(1, 2 * lr, 2 * lr, 2), rs.rand(1, lr, lr, 1)]
    params = {scale: jax_build_generator(
        JaxGeneratorConfig(num_residual_blocks=2, init_scale=scale), lr=GEN_LR)[1]
        for scale in (0.1, 1.0)}
    return params, [a.astype(np.float32) for a in xs]


def _jax_forward(params, xs, **flags):
    model = JaxGenerator(JaxGeneratorConfig(num_residual_blocks=2, **flags))
    return model.apply({"params": params}, *map(jnp.asarray, xs))


@pytest.mark.parametrize("option", list(GEN_OPTIONS))
def test_generator_option_matches_jax(gen_params, option):
    flags = GEN_OPTIONS[option]
    bf16 = flags.get("compute_dtype") == "bfloat16"
    params, xs = gen_params
    params = params[0.1 if bf16 else 1.0]
    want = _jax_forward(params, xs, **flags)
    model = Generator(GeneratorConfig(num_residual_blocks=2, **flags))
    model.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, xs))
    out = 4 * (GEN_LR - 2)
    assert tuple(got.shape) == tuple(want.shape) == (1, out, out, 1)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    if bf16:
        _hold_bf16("generator bf16", got, want, _jax_forward(params, xs))
    else:
        _hold_fp32(f"generator {flags}", got, want)


# --- the dispatch precedence ---------------------------------------------------

# (flags, trunk, K10): what the port's config names for each combination of
# the dispatch flags; the test holds each against what JAX's forward reaches
# where its size rule would take a kernel (a TPU image of at least 256^2)
DISPATCH = [
    ({}, "rdb", False),
    (dict(fused_rdb="never"), "plain", False),
    (dict(fused_rdb="never", rdb_resident="always"), "rdb", False),
    (dict(fused_rdb="never", rrdb_fused=True), "plain", False),
    (dict(rdb_resident="never"), "rdb_banded", False),
    (dict(rdb_resident="never", fused_rdb="never"), "plain", False),
    (dict(rdb_resident="never", fused_rdb="always"), "rdb_banded", False),
    (dict(rdb_resident="never", rrdb_fused=True), "rdb_banded", False),
    (dict(rrdb_fused=True), "rrdb_fused", False),
    (dict(rrdb_sweep=True, rrdb_fused=True), "rrdb_sweep", False),
    (dict(compute_dtype="bfloat16"), "plain", False),
    (dict(compute_dtype="bfloat16", rdb_resident="always"), "rdb", False),
    (dict(compute_dtype="bfloat16", rdb_resident="always", rrdb_fused=True), "rrdb_fused",
     False),
    (dict(compute_dtype="bfloat16", rdb_resident="always", rrdb_sweep=True), "rrdb_sweep",
     False),
    (dict(compute_dtype="bfloat16", fused_rdb="always"), "rdb_banded", False),
    (dict(fused_conv="auto"), "rdb", True),
    (dict(fused_conv="always"), "rdb", True),
    (dict(compute_dtype="bfloat16", fused_conv="auto"), "plain", False),
    (dict(compute_dtype="bfloat16", fused_conv="always"), "plain", True),
]
# the JAX function each port dispatch reaches
JAX_TRUNK = {"rdb": "rdb_fused_flat", "rrdb_fused": "rrdb_fused_flat",
             "rrdb_sweep": "rrdb_sweep_flat", "rdb_banded": "rdb_fused", "plain": None}


@pytest.mark.parametrize("flags,trunk,k10", DISPATCH)
def test_dispatch_matches_jax(monkeypatch, flags, trunk, k10):
    from deepbedmap_tpu.models import generator as jax_generator
    from deepbedmap_tpu.ops import pallas_conv, pallas_rdb
    from deepbedmap_tpu_torch.models import blocks

    cfg = GeneratorConfig(num_residual_blocks=1, **flags)
    assert (trunk_kernel(cfg), conv_kernel(cfg)) == (trunk, k10)

    # JAX: its size rule says yes, as on a TPU image; each kernel entry is
    # spied on while the forward is traced (jax.eval_shape computes nothing).
    # A kernel's float32 output is cast back to the carry's dtype: JAX's scan
    # refuses a carry whose dtype changes (config.py's module docstring)
    seen = set()
    bf16 = flags.get("compute_dtype") == "bfloat16" and flags.get("fused_conv") != "always"

    def spy(module, name, cast):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen.add(name)
            out = fn(*args, **kwargs)
            return out.astype(jnp.bfloat16) if cast and bf16 else out

        monkeypatch.setattr(module, name, wrapped)

    for name in ("rdb_fused_flat", "rrdb_fused_flat", "rrdb_sweep_flat", "rdb_fused"):
        spy(pallas_rdb, name, True)
    for name in ("conv3x3_fused", "conv3x3_res_fused"):
        spy(pallas_conv, name, False)
    monkeypatch.setattr(pallas_rdb, "should_fuse", lambda shape: True)
    monkeypatch.setattr(jax_generator, "should_fuse", lambda shape: True)
    monkeypatch.setattr(pallas_conv, "should_fuse_conv", lambda shape: True)
    lr = 16  # a 14-px latent: the resident layout's (W + 2) % 8 == 0
    xs = [jnp.zeros(s, jnp.float32) for s in
          ((1, lr, lr, 1), (1, 10 * lr, 10 * lr, 1), (1, 2 * lr, 2 * lr, 2), (1, lr, lr, 1))]
    jax.eval_shape(JaxGenerator(JaxGeneratorConfig(num_residual_blocks=1, **flags)).init,
                   jax.random.PRNGKey(0), *xs)
    want_trunk = {JAX_TRUNK[trunk]} - {None}
    assert seen & set(JAX_TRUNK.values()) == want_trunk, (flags, seen)
    assert bool(seen & {"conv3x3_fused", "conv3x3_res_fused"}) == k10, (flags, seen)

    # the port's forward calls what the config names
    called = set()
    for name in ("rdb_fused", "rdb_banded", "rrdb_fused", "rrdb_sweep", "rdb_reference",
                 "conv3x3_fused"):
        def counted(*args, _name=name, _fn=getattr(blocks, name)):
            called.add(_name)
            return _fn(*args)
        monkeypatch.setattr(blocks, name, counted)
    model = Generator(cfg)
    lr = 6
    with torch.inference_mode():
        model(torch.rand(1, lr, lr, 1), torch.rand(1, 10 * lr, 10 * lr, 1),
              torch.rand(1, 2 * lr, 2 * lr, 2), torch.rand(1, lr, lr, 1))
    port_trunk = {"plain": "rdb_reference", "rdb": "rdb_fused"}.get(trunk, trunk)
    assert called - {"conv3x3_fused"} == {port_trunk}, (flags, called)
    assert ("conv3x3_fused" in called) == k10, (flags, called)


# --- the channel-parallel forward at bf16 --------------------------------------

TP_SCRIPT = '''
import os, sys, torch, numpy as np
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
    from deepbedmap_tpu_torch.config import GeneratorConfig
    from deepbedmap_tpu_torch.models import build_generator
    from deepbedmap_tpu_torch.parallel.tp import make_mesh_2d, make_tp_forward, shard_params_tp
    rs = np.random.RandomState(0)
    lr = 8
    args = [torch.from_numpy(rs.rand(2, *s).astype(np.float32)) for s in
            ((lr, lr, 1), (10 * lr, 10 * lr, 1), (2 * lr, 2 * lr, 2), (lr, lr, 1))]
    model = build_generator(GeneratorConfig(num_residual_blocks=1, init_scale=1.0,
                                            compute_dtype="bfloat16"), seed=0, device="cpu")
    mesh = make_mesh_2d(1, 2, device="cpu")
    with torch.no_grad():
        got = make_tp_forward(mesh, model, shard_params_tp(mesh, model.state_dict()))(*args)
        want = model.eval()(*args)
    if rank == 0:
        np.savez(out, got=got.numpy(), want=want.numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1], sys.argv[2]), nprocs=2, join=True)
'''


def test_tp_forward_follows_the_compute_dtype(tmp_path):
    # make_tp_forward on a (1, 2) mesh of two Gloo processes runs each conv
    # at the configuration's compute dtype: a bf16 generator's sharded
    # forward equals its own forward (output channels are independent, so
    # the shards compute the same roundings)
    import os
    import subprocess
    import sys

    script = tmp_path / "tp_bf16.py"
    script.write_text(TP_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "store"),
                           str(tmp_path / "out.npz")], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(res["got"], res["want"])

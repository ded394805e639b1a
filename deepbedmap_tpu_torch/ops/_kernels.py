"""Build, load and launch the hand-written CUDA kernels of the port.

The sources live in ``deepbedmap_tpu_torch/csrc``. On first use each ``.cu``
file is compiled by its own ``nvcc`` process for ``sm_90a`` (all started
together), and the objects are linked into one shared library with a plain C
interface under ``build/kernels/`` (git-ignored; override with
``DEEPBEDMAP_TORCH_BUILD_DIR``), loaded with ``ctypes``. The build runs under
a lock, so threads that make their first launch together (a server's first
requests) build and load the library once. Nothing here runs at import time,
so the CPU-only test suite can import every module.

Each ``launch_*`` function is the one place its kernel is launched: it adds one
to ``launches[name]`` and raises if the C entry point reports a CUDA error.
The five kernels with a bf16-multiplicand route (K1, K4, K5, K6, K10; the TPU
kernels' ``mxu_bf16``) take it through an ``int bf16`` argument of their C
entry and count it under their name with ``_bf16`` appended, and then take
their packed weights in bf16 (``const void*`` in C).
Tensor checks (device, dtype, shape, contiguity) are the callers' job
(``ops.rdb``, ``ops.conv3x3``, ``ops.deform_conv``, ``ops.tail``); outputs
and scratch are allocated by the callers with ``torch.empty``. Kernels run on
``torch.cuda.current_stream()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = ("rdb.cu", "conv3x3.cu", "deform_tail.cu", "rdb_banded.cu",
            "rrdb_sweep.cu", "deform_zform.cu", "window_attn.cu", "rdb_backward.cu",
            "window_attn_tiled.cu")
_HEADERS = ("conv3x3_tc.cuh", "rdb_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# launches of each kernel since the last reset_launches(), by kernel name
# (K8 "deform_conv_zproj1" launches K3's C entry "deform_zproj1" but counts
# under its own name)
launches = {
    "rdb_forward": 0, "deform64_lrelu": 0, "deform_zproj1": 0,
    "rrdb_forward": 0, "conv3x3_forward": 0, "deform_conv": 0,
    "deform_conv_zproj1": 0, "rdb_banded_forward": 0, "rrdb_sweep_forward": 0,
    "deform_zform": 0,
    # the Swin layers' shifted-window attention: SwinIR's 8 x 8 windows, and
    # the tiled kernel's two cases (C entry "window_attn_tiled"): HAT's
    # self-attention and its overlapping cross-attention
    "window_attn": 0, "window_attn_tiled": 0, "overlap_attn_tiled": 0,
    # the bf16-multiplicand routes of K1, K4, K10, K6 and K5
    "rdb_forward_bf16": 0, "rrdb_forward_bf16": 0, "conv3x3_forward_bf16": 0,
    "rdb_banded_forward_bf16": 0, "rrdb_sweep_forward_bf16": 0,
    # the deformable tail's backward kernels, counted as their forwards are:
    # K2's and K7's C entry "deform64_bwd", K3's and K8's "deform_zproj1_bwd"
    "deform64_bwd": 0, "deform_conv_bwd": 0, "deform_zproj1_bwd": 0,
    "deform_conv_zproj1_bwd": 0,
    # K1's backward kernel (fp32 route), C entry "rdb_backward": seven launches
    "rdb_bwd": 0,
}

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()  # launches[name] += 1 is not atomic across threads
build_log = ""  # nvcc's output (with -Xptxas -v) of the build this process made

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, ws, out, w_packed, bias, N, H, W, scaling, bf16, stream
    "rdb_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, ws_a, ws_b, out, w_packed, bias, N, H, W, scaling, bf16, stream
    "rrdb_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, w_packed, bias, res (or NULL), out, N, H, W, cin, leaky, bf16, stream
    "conv3x3_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, off, w_packed, bias, out, N, H, W, clamp, stream
    "deform64_lrelu": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "deform_conv": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # z, off, bias, out, N, H, W, clamp, stream
    "deform_zproj1": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x, off, w, out, grad, dx, doff, dw, db, ds, part, N, H, W, clamp, lrelu,
    # blocks, stream
    "deform64_bwd": (_P,) * 11 + (_I, _I, _I, _F, _I, _I, _P),
    # z, off, grad, dz, doff, db, part, N, H, W, clamp, stream
    "deform_zproj1_bwd": (_P,) * 7 + (_I, _I, _I, _F, _P),
    # ws, g_out, wt, g_ws, g_x, part, grad, N, H, W, scaling, splits, stream
    "rdb_backward": (_P,) * 7 + (_I, _I, _I, _F, _I, _P),
    # x, out, w_packed, bias, N, H, W, scaling, bf16, stream
    "rdb_banded_forward": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, ring1, ring2, out, w_packed, bias, N, H, W, scaling, bf16, stream
    "rrdb_sweep_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, off, w_packed, bias, out, N, H, W, cin, cout, clamp, stream
    "deform_zform": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # qkv, table, out, N, H, W, C, heads, shift, scale, stream
    "window_attn": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # qkv, table, out, N, H, W, C, heads, window, key_window, shift, cross,
    # scale, stream
    "window_attn_tiled": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def check_tensor(t: torch.Tensor, name: str, shape: tuple,
                 dtype: torch.dtype = torch.float32) -> None:
    """What every kernel takes: ``dtype`` (fp32, or bf16 for the bf16
    route's packed weights), contiguous, 16-byte aligned, on the current
    CUDA device, of exactly ``shape``."""
    if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} must be on the current CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_image_shape(n: int, h: int, w: int, channels: int) -> None:
    """The kernels index with 32-bit pixel and element offsets and put rows
    and images on the grid's y and z axes (at most 65535 blocks each)."""
    if min(n, h, w) < 1 or n * h * w * channels >= 2**31 or h > 65535 or n > 32767:
        raise ValueError(f"unsupported image shape {(n, h, w, channels)}")


def _build_dir() -> Path:
    default = Path(__file__).resolve().parents[2] / "build" / "kernels"
    return Path(os.environ.get("DEEPBEDMAP_TORCH_BUILD_DIR", default))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _build(srcs, out_dir: Path, so: Path) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link into
    ``so``. Returns nvcc's output (``-Xptxas -v`` register and spill lines)."""
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [out_dir / f".{src.stem}.{tag}.o" for src in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    log, failed = [], []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n" + "".join(log))
    tmp = out_dir / f".{tag}.so.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log.append(link.stdout + link.stderr)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n" + "".join(log))
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    return "".join(log)


def library():
    """The loaded kernel library, built from ``csrc`` on first use."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        srcs = [_CSRC / s for s in _SOURCES]
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in srcs + [_CSRC / h for h in _HEADERS])
            + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out_dir = _build_dir()
        so = out_dir / f"libdbm_kernels_{digest}.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            build_log = _build(srcs, out_dir, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _call(name: str, *args, entry: str | None = None) -> None:
    """Launch C entry ``entry`` (default ``name``), counted under ``name``."""
    fn = getattr(library(), entry or name)
    stream = torch.cuda.current_stream().cuda_stream
    with _count_lock:
        launches[name] += 1
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def _route(entry: str, *args, bf16: bool) -> None:
    """One of the five kernels with a bf16 route: C entry ``entry`` with its
    ``bf16`` flag, counted under ``entry`` or ``entry + '_bf16'``."""
    _call(entry + "_bf16" if bf16 else entry, *args, int(bool(bf16)), entry=entry)


def launch_rdb_forward(x, ws, out, w_packed, bias, n, h, w, scaling,
                       bf16: bool = False) -> None:
    _route("rdb_forward", x.data_ptr(), ws.data_ptr(), out.data_ptr(),
           w_packed.data_ptr(), bias.data_ptr(), n, h, w, float(scaling), bf16=bf16)


def launch_rdb_backward(ws, g_out, wt, g_ws, g_x, part, grad, n, h, w, scaling,
                        splits: int) -> None:
    """K1's backward kernel, counted as ``rdb_bwd``."""
    _call("rdb_bwd", *(t.data_ptr() for t in (ws, g_out, wt, g_ws, g_x, part, grad)),
          n, h, w, float(scaling), splits, entry="rdb_backward")


def launch_rrdb_forward(x, ws_a, ws_b, out, w_packed, bias, n, h, w, scaling,
                        bf16: bool = False) -> None:
    _route("rrdb_forward", x.data_ptr(), ws_a.data_ptr(), ws_b.data_ptr(),
           out.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), n, h, w,
           float(scaling), bf16=bf16)


def launch_conv3x3_forward(x, w_packed, bias, res, out, n, h, w, cin, leaky,
                           bf16: bool = False) -> None:
    _route("conv3x3_forward", x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(),
           None if res is None else res.data_ptr(), out.data_ptr(), n, h, w, cin,
           int(bool(leaky)), bf16=bf16)


def launch_deform64(x, off, w_packed, bias, out, n, h, w, clamp, lrelu: bool) -> None:
    """K2 ``deform64_lrelu`` (lrelu) or K7 ``deform_conv``: one kernel."""
    _call("deform64_lrelu" if lrelu else "deform_conv", x.data_ptr(),
          off.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
          n, h, w, float(clamp))


def launch_deform_zproj1(z, off, bias, out, n, h, w, clamp,
                         name: str = "deform_zproj1") -> None:
    """K3's C entry, counted as K3 ``deform_zproj1`` or K8
    ``deform_conv_zproj1``."""
    _call(name, z.data_ptr(), off.data_ptr(), bias.data_ptr(), out.data_ptr(),
          n, h, w, float(clamp), entry="deform_zproj1")


def launch_deform64_bwd(x, off, weight, out, grad, dx, doff, dweight, dbias, ds, part, n,
                        h, w, clamp, lrelu: bool, blocks: int) -> None:
    """The backward of K2 (lrelu; counted as ``deform64_bwd``) or K7
    (``deform_conv_bwd``): one C entry, three kernels."""
    _call("deform64_bwd" if lrelu else "deform_conv_bwd",
          *(t.data_ptr() for t in (x, off, weight, out, grad, dx, doff, dweight, dbias, ds,
                                   part)),
          n, h, w, float(clamp), int(bool(lrelu)), blocks, entry="deform64_bwd")


def launch_deform_zproj1_bwd(z, off, grad, dz, doff, db, part, n, h, w, clamp,
                             name: str = "deform_zproj1") -> None:
    """The backward of K3 or K8, counted as ``name + '_bwd'``."""
    _call(name + "_bwd", *(t.data_ptr() for t in (z, off, grad, dz, doff, db, part)),
          n, h, w, float(clamp), entry="deform_zproj1_bwd")


def launch_rdb_banded_forward(x, out, w_packed, bias, n, h, w, scaling,
                              bf16: bool = False) -> None:
    _route("rdb_banded_forward", x.data_ptr(), out.data_ptr(), w_packed.data_ptr(),
           bias.data_ptr(), n, h, w, float(scaling), bf16=bf16)


def launch_rrdb_sweep_forward(x, ring1, ring2, out, w_packed, bias, n, h, w,
                              scaling, bf16: bool = False) -> None:
    _route("rrdb_sweep_forward", x.data_ptr(), ring1.data_ptr(), ring2.data_ptr(),
           out.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), n, h, w,
           float(scaling), bf16=bf16)


def launch_deform_zform(x, off, w_packed, bias, out, n, h, w, cin, cout,
                        clamp) -> None:
    _call("deform_zform", x.data_ptr(), off.data_ptr(), w_packed.data_ptr(),
          bias.data_ptr(), out.data_ptr(), n, h, w, cin, cout, float(clamp))


def launch_window_attn(qkv, table, out, n, h, w, c, heads, shift, scale) -> None:
    _call("window_attn", qkv.data_ptr(), table.data_ptr(), out.data_ptr(), n, h, w, c,
          heads, int(shift), float(scale))


def launch_window_attn_tiled(qkv, table, out, n, h, w, c, heads, window, key_window, shift,
                             cross: bool, scale) -> None:
    """The tiled window attention: self-attention (counted as
    ``window_attn_tiled``) or the overlapping cross-attention
    (``overlap_attn_tiled``), one C entry."""
    _call("overlap_attn_tiled" if cross else "window_attn_tiled", qkv.data_ptr(),
          table.data_ptr(), out.data_ptr(), n, h, w, c, heads, window, key_window,
          int(shift), int(bool(cross)), float(scale), entry="window_attn_tiled")

"""ctypes bindings for the native TIFF LZW codec (``native/tiffcodec.cc``).

Counterpart of ``deepbedmap_tpu/data/_tiffnative.py``. The shared object is
built with g++ on first use, never at import, under a lock so that threads
which need it together build it once. It goes to ``build/native/`` at the
repository root (git-ignored; ``DEEPBEDMAP_TORCH_BUILD_DIR`` overrides the
directory, as for the CUDA kernels), named by a hash of the source and flags.
A failed build raises: ``data.geotiff`` never falls back to its pure-Python
codec, which would take minutes on a continent product. The ctypes calls
release the GIL, so a writer thread encodes while other threads run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "native" / "tiffcodec.cc"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()
path = None  # the shared object this process loaded

_LL = ctypes.c_longlong
_P_LL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "tiff_lzw_encode": (ctypes.c_char_p, _LL, ctypes.c_char_p, _LL),
    "tiff_lzw_decode": (ctypes.c_char_p, _LL, ctypes.c_char_p, _LL),
    # in, in_offsets, n, out, stride, out_lens, n_threads
    "tiff_lzw_encode_blocks": (ctypes.c_char_p, _P_LL, ctypes.c_int, ctypes.c_char_p,
                               _LL, _P_LL, ctypes.c_int),
    # in, in_offsets, n, out, out_offsets, out_lens, n_threads
    "tiff_lzw_decode_blocks": (ctypes.c_char_p, _P_LL, ctypes.c_int, ctypes.c_char_p,
                               _P_LL, _P_LL, ctypes.c_int),
}


def _build_dir() -> Path:
    default = Path(__file__).resolve().parents[2] / "build" / "native"
    return Path(os.environ.get("DEEPBEDMAP_TORCH_BUILD_DIR", default))


def _build(so: Path) -> None:
    """g++ into a temporary file named by the process, then an atomic rename:
    processes that build together each finish with a whole library."""
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the TIFF codec ({proc.returncode}):\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, so)


def library():
    """The loaded codec, built from ``native/tiffcodec.cc`` on first use."""
    global _lib, path
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                                ).hexdigest()[:16]
        out_dir = _build_dir()
        so = out_dir / f"libtiffcodec_{digest}.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            _build(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _LL
        _lib, path = lib, str(so)
        return lib


def lzw_encode_blocks(blocks, n_threads: int = 0):
    """Compress independent TIFF blocks in parallel (0 = hw threads)."""
    if not blocks:
        return []
    n = len(blocks)
    offsets = (ctypes.c_longlong * (n + 1))()
    total = 0
    for i, b in enumerate(blocks):
        offsets[i] = total
        total += len(b)
    offsets[n] = total
    concat = b"".join(blocks)
    stride = max(len(b) for b in blocks)
    stride = stride + (stride >> 1) + 1024
    out = ctypes.create_string_buffer(stride * n)
    lens = (ctypes.c_longlong * n)()
    rc = library().tiff_lzw_encode_blocks(concat, offsets, n, out, stride, lens, n_threads)
    if rc != 0:  # a block overflowed its stride (incompressible): one at a time
        return [lzw_encode(b) for b in blocks]
    raw = out.raw
    return [raw[i * stride : i * stride + lens[i]] for i in range(n)]


def lzw_encode(data: bytes) -> bytes:
    cap = len(data) + (len(data) >> 1) + 1024
    while True:
        out = ctypes.create_string_buffer(cap)
        n = library().tiff_lzw_encode(data, len(data), out, cap)
        if n >= 0:
            return out.raw[:n]
        cap *= 2


def lzw_decode(data: bytes) -> bytes:
    cap = max(4 * len(data), 4096)
    while True:
        out = ctypes.create_string_buffer(cap)
        n = library().tiff_lzw_decode(data, len(data), out, cap)
        if n == -2:
            raise ValueError("malformed LZW stream")
        if n >= 0:
            return out.raw[:n]
        cap *= 2


def lzw_decode_blocks(blocks, out_sizes, n_threads: int = 0) -> bytes:
    """Decompress independent TIFF blocks in parallel into one contiguous
    buffer; ``out_sizes[i]`` is block i's exact decoded byte count (known from
    the strip/tile geometry). Returns the concatenated decoded bytes."""
    if not blocks:
        return b""
    n = len(blocks)
    in_offsets = (ctypes.c_longlong * (n + 1))()
    total_in = 0
    for i, b in enumerate(blocks):
        in_offsets[i] = total_in
        total_in += len(b)
    in_offsets[n] = total_in
    concat = b"".join(blocks)

    out_offsets = (ctypes.c_longlong * (n + 1))()
    total_out = 0
    for i, s in enumerate(out_sizes):
        out_offsets[i] = total_out
        total_out += int(s)
    out_offsets[n] = total_out

    out = ctypes.create_string_buffer(total_out)
    lens = (ctypes.c_longlong * n)()
    rc = library().tiff_lzw_decode_blocks(concat, in_offsets, n, out, out_offsets, lens,
                                          n_threads)
    if rc != 0:
        bad = [i for i in range(n) if lens[i] < 0]
        raise ValueError(f"LZW block decode failed for blocks {bad[:5]}")
    return out.raw

"""Native (C++) runtime support, loaded with ctypes.

Port of isca_tpu/native/__init__.py over the port's own copy of the source,
`fastio.cpp`: the tile combiner of the sharded restarts and diagnostics
(io/distributed.py, the reference's mppnccombine), a strided float32 pack,
the resident set size and a monotonic nanosecond clock (utils/clocks.py).

The library is built at first use with g++ into
`isca_tpu_torch/_build/native/fastio-<key>.so`, the key hashing the source
and the flags, so an edited source builds anew. Unlike isca_tpu, which falls
back to Python when the build fails, a failed build raises: both the
machines the port runs on have g++.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fastio.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


def build_library(src: Path = SRC, out_dir: Path = BUILD) -> Path:
    """Compile `src` into `out_dir` unless that build exists; returns the
    library's path. Raises RuntimeError with the compiler's output when the
    build fails."""
    key = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode() + src.read_bytes())
    lib = Path(out_dir) / f"{src.stem}-{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except OSError as err:
        raise RuntimeError(f"the native library cannot be built: {err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib)     # atomic: ranks that build at once each finish one
    return lib


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.combine_tiles.restype = ctypes.c_int
    lib.combine_tiles.argtypes = [ctypes.POINTER(_F32P), _I64P, _I64P, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64, _F32P]
    lib.pack_f32.restype = None
    lib.pack_f32.argtypes = [_F32P] + [ctypes.c_int64] * 6 + [_F32P]
    lib.rss_kb.restype = ctypes.c_int64
    lib.ns_clock.restype = ctypes.c_int64
    return lib


def native_available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    _load()
    return True


def combine_tiles(tiles, offsets, rows_total: int) -> np.ndarray:
    """Merge shards (a list of (rows_i, ...) float32 arrays) along axis 0 at
    the given row offsets into one (rows_total, ...) array: the
    mppnccombine equivalent. Raises ValueError when a shard falls outside."""
    tiles = [np.ascontiguousarray(t, np.float32) for t in tiles]
    trail = tiles[0].shape[1:]
    if any(t.shape[1:] != trail for t in tiles):
        raise ValueError("combine_tiles: shards differ in their trailing shape")
    cols = int(np.prod(trail)) if trail else 1
    out = np.empty((rows_total,) + trail, np.float32)
    ptrs = (_F32P * len(tiles))(*[t.ctypes.data_as(_F32P) for t in tiles])
    rows = (ctypes.c_int64 * len(tiles))(*[t.shape[0] for t in tiles])
    offs = (ctypes.c_int64 * len(tiles))(*[int(o) for o in offsets])
    rc = _load().combine_tiles(ptrs, rows, offs, len(tiles), rows_total, cols,
                               out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError("combine_tiles: shard out of bounds")
    return out


def pack_f32(a: np.ndarray) -> np.ndarray:
    """A contiguous copy of a (strided, non-negative strides) 3-D float32
    array view."""
    if a.dtype != np.float32 or a.ndim != 3 or min(a.strides) < 0:
        raise ValueError("pack_f32 takes a 3-D float32 view with non-negative strides")
    out = np.empty(a.shape, np.float32)
    s0, s1, s2 = (s // a.itemsize for s in a.strides)
    _load().pack_f32(ctypes.cast(a.ctypes.data, _F32P), *a.shape, s0, s1, s2,
                     out.ctypes.data_as(_F32P))
    return out


def rss_kb() -> int:
    """Peak resident set size of this process in KiB (getrusage)."""
    return int(_load().rss_kb())


def ns_clock() -> int:
    """Monotonic clock in nanoseconds (std::chrono::steady_clock)."""
    return int(_load().ns_clock())

"""Build, load and call the packed wire's host packer (csrc/wire_pack.cc).

The source is compiled with the host C++ compiler at the first pack of a
process into a library of its own under the kernels' ``BUILD_DIR``, named
by a hash of the source and ``CXX_FLAGS``, so an edited source is rebuilt
and a built one is reused by every later process of the same checkout.
It needs no CUDA.  A failed build raises with the compiler's output;
nothing falls back.

The pack is two calls, :func:`layout` (each block's width, each stream's
order, each block's word offset and the total) and :func:`fill` (the
words), so a caller with a budget sees the total before any word is
written.  ctypes releases the GIL for both.  Each runs on the threads its
caller gives, as many as :func:`workers_for` says.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..kernels._build import BUILD_DIR

__all__ = ["CXX_FLAGS", "MIN_BLOCKS_PER_WORKER", "build", "fill", "layout",
           "lib", "library_path", "workers_for"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "wire_pack.cc"
CXX = "c++"
# no -march: the library's AVX2 and baseline clones are chosen at load
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-pthread")
# A worker below this many 4096-sample blocks (~0.5 ms of packing on one
# core) costs more to start than it saves.
MIN_BLOCKS_PER_WORKER = 64

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libprt_wire_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the packer unless this source hash is built already;
    returns the library's path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed with exit code "
                               f"{proc.returncode}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}")
        os.replace(tmp, so)  # atomic: no process loads half a file
    finally:
        tmp.unlink(missing_ok=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded packer (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            # x, S, n, workers, widths, woffs, order -> total words
            handle.prt_wire_widths.argtypes = (_P, _I64, _I64, _I32, _P, _P,
                                               _P)
            handle.prt_wire_widths.restype = _I64
            # x, S, n, workers, widths, woffs, order, words
            handle.prt_wire_words.argtypes = (_P, _I64, _I64, _I32, _P, _P,
                                              _P, _P)
            handle.prt_wire_words.restype = None
            _lib = handle
    return _lib


def workers_for(blocks: int) -> int:
    """Threads for a pack of ``blocks`` blocks: the CPUs this process may
    run on but one (the dispatch thread's), at least
    ``MIN_BLOCKS_PER_WORKER`` blocks each, and at least one."""
    cpus = len(os.sched_getaffinity(0))
    return max(1, min(cpus - 1, blocks // MIN_BLOCKS_PER_WORKER))


def _ptr(a: np.ndarray, dtype, shape) -> int:
    """The address of ``a``, once it is C-contiguous ``dtype`` of
    ``shape``."""
    if a.dtype != dtype or tuple(a.shape) != tuple(shape) or not (
            a.flags.c_contiguous):
        raise ValueError(f"expected C-contiguous {np.dtype(dtype)} of shape "
                         f"{tuple(shape)}, got {a.dtype} {a.shape}")
    return a.ctypes.data


def layout(streams: np.ndarray, widths: np.ndarray, woffs: np.ndarray,
           order: np.ndarray, workers: int) -> int:
    """Pass 1 over (S, n) int16 ``streams``: each block's width into
    ``widths`` and word offset into ``woffs`` (both (S, nb) int32, nb =
    ceil(n / 4096)), each stream's order into ``order`` ((S,) int32);
    returns the total words."""
    S, n = streams.shape
    nb = -(-n // 4096)
    return int(lib().prt_wire_widths(
        _ptr(streams, np.int16, (S, n)), S, n, workers,
        _ptr(widths, np.int32, (S, nb)), _ptr(woffs, np.int32, (S, nb)),
        _ptr(order, np.int32, (S,))))


def fill(streams: np.ndarray, widths: np.ndarray, woffs: np.ndarray,
         order: np.ndarray, words: np.ndarray, total: int,
         workers: int) -> None:
    """Pass 2: the words of :func:`layout`'s blocks into ``words[:total]``
    (int32, C-contiguous)."""
    S, n = streams.shape
    if words.size < total:
        raise ValueError(f"{words.size} words cannot hold {total}")
    lib().prt_wire_words(_ptr(streams, np.int16, (S, n)), S, n, workers,
                         _ptr(widths, np.int32, widths.shape),
                         _ptr(woffs, np.int32, widths.shape),
                         _ptr(order, np.int32, (S,)),
                         _ptr(words, np.int32, words.shape))

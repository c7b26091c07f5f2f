"""Build, load and count the port's CUDA kernels.

The sources under ``phaserotate_tpu_torch/csrc/`` are compiled at first use
with ``nvcc``, one process per source and all at once (the build takes
the time of the slowest source), and linked into one shared library with
a plain C interface, loaded with ``ctypes``.  ``NVCC_FLAGS`` are the
compile flags; the link adds ``-shared``.  The library's file name carries
a hash of the sources and flags, so an edited kernel is rebuilt and a
built one is reused by every later process of the same checkout.  A failed
build raises with the compiler's output; nothing falls back.

``launches`` counts, per wrapper, the kernel launches made on CUDA tensors:
one a call, or each of a call's kernels where the wrapper says so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "build", "check", "count_launch", "launches", "lib",
           "reset_launches"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("fused_conv.cu", "hilbert32k.cu", "pcm24.cu", "rotate_peak.cu",
            "stream_conv.cu", "wire_unpack.cu")
_HEADERS = ("ola_fft.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "phaserotate_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# compile flags; no --use_fast_math: sincosf must stay full precision
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

launches = {"rotate_peak_sweep": 0, "hilbert_small": 0, "rotate_small": 0,
            "stream_mix": 0, "fused_hilbert": 0, "fused_rotate_fir": 0,
            "peak": 0, "pcm24_widen": 0, "hilbert_32k": 0,
            "wire_unpack": 0}

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_SIGNATURES = {
    # b0, b1, row stride b0, row stride b1, cos_sin, out, rows, n, A,
    # tile_len, stream
    "prt_rotate_peak_sweep": (_P, _P, ctypes.c_longlong, ctypes.c_longlong,
                              _P, _P, ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, _P),
    # x, its row stride, n, fir parts, twiddles, (angle, slope) pairs (or
    # NULL), their row and frame strides, out, its row stride, samples
    # written per row, rows, output frames per row, n_segm, output frame
    # offset in the stream, dry delay in frames, grid, stream
    "prt_stream_conv": (_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P,
                        _P, ctypes.c_longlong, ctypes.c_longlong, _P,
                        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P),
    # n_segm, mix, int[5] out: blocks, threads, registers, local bytes,
    # shared memory bytes
    "prt_stream_conv_grid": (ctypes.c_int, ctypes.c_int, _P),
    # frames, FIR spectrum in position order, stage-major pass twiddles,
    # product twiddles, (ca, sa) per row (or NULL), run tails scratch,
    # out, rows, n_blocks, parsiz, dry delay, grid, stream
    "prt_fused_conv": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _P),
    # parsiz, mix, int[4] out: blocks, threads, registers, local bytes
    "prt_fused_conv_grid": (ctypes.c_int, ctypes.c_int, _P),
    # x, n, out, stream
    "prt_peak": (_P, ctypes.c_longlong, _P, _P),
    # x, its row stride, n, aligned, stage-major twiddles, W_M^p, FIR
    # spectrum in position order, product twiddles, run tails scratch,
    # out, rows, frames a row, clusters, stream
    "prt_hilbert32k": (_P, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, _P),
    # int[5] out: clusters, threads, registers, local bytes, shared bytes
    "prt_hilbert32k_grid": (_P,),
    # 24-bit payload, out, rows, channels, frames, stream
    "prt_pcm24_widen": (_P, _P, ctypes.c_int, ctypes.c_int,
                        ctypes.c_longlong, _P),
    # words, their count, widths, woffs, order, sums scratch, out,
    # streams, blocks a stream, samples a stream, stream
    "prt_wire_unpack": (_P, ctypes.c_longlong, _P, _P, _P, _P, _P,
                        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count_launch(name: str, kernels: int = 1) -> None:
    launches[name] += kernels


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to the "
                           "directory that holds bin/nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"libprt_torch_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds) -> str:
    """Run the nvcc commands ``cmds`` all at once; returns their joined
    output, or raises with the first failed command's."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    done = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in procs]
    for cmd, out, code in done:
        if code != 0:
            raise RuntimeError(f"nvcc failed with exit code {code}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(out for _, out, _ in done)


def build() -> Path:
    """Compile the kernels unless this source hash is built already;
    returns the library's path.  ``<lib>.log`` keeps ptxas' report."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in _SOURCES]
    tmp = so.with_name(f"{tag}.tmp")
    try:  # one nvcc per source, all at once, then the link
        log = _nvcc_all([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                         str(_CSRC / name)]
                        for name, obj in zip(_SOURCES, objs))
        _nvcc_all([[_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
                    *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.prt_error_string.argtypes = (ctypes.c_int,)
            handle.prt_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err:
        msg = lib().prt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")

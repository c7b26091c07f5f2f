#!/usr/bin/env python3
"""fused_conv's, the sweep's or stream_conv's Hopper kernel against an
earlier version of it, on one card.

    git show <commit>:phaserotate_tpu_torch/csrc/fused_conv.cu \\
        > build/parent_fused_conv.cu
    python3 fused_conv_ab.py --parent build/parent_fused_conv.cu \
        [--json out.json]

    git show <commit>:phaserotate_tpu_torch/csrc/rotate_peak.cu \\
        > build/parent_rotate_peak.cu
    python3 fused_conv_ab.py --sweep --parent build/parent_rotate_peak.cu \
        [--json out.json]

    git show <commit>:phaserotate_tpu_torch/csrc/stream_conv.cu \\
        > build/parent_stream_conv.cu
    python3 fused_conv_ab.py --stream --parent build/parent_stream_conv.cu \
        [--json out.json]

The parent is a ``fused_conv.cu`` with the earlier two-pass C interface
(one block per frame, a tail buffer the size of the signal).  The script
builds it, this checkout's kernel, and variants of this checkout's kernel
made here from its source (``VARIANTS``, never written into the
checkout): ``global`` reads the stage-major twiddle table from global
memory through ``__ldg`` in place of staging it in shared memory;
``occupancy`` caps the run kernel at 32 registers where a thread carries
two float4 (parsiz 2048-8192), for the parent's blocks per SM.  It then
runs,
at the main path's shapes (64 one-minute stems at parsiz 4096 and 16384,
the 4-minute stereo file's shape at 2048 and 8192, the mix on the stems
with the 3072-tap FIR):

- ``parent``: the parent kernel;
- ``runs``: this checkout's kernel on its persistent grid, as shipped;
- ``runs_<variant>``: each variant on its persistent grid;
- ``frames_global``: the ``global`` variant with one block per frame (every
  frame the first of its run, so the second kernel adds every tail: the
  parent's two passes with stage-major twiddles);

holds every output against the parent's bit for bit (max |diff| printed,
0.0 expected: the butterflies and their twiddle values are the same), and
times each with CUDA events in turns (in that order, then the reverse
order, mean of the two).  It prints the ptxas report of the parent and the
variants, the launch geometry (blocks, threads, registers, spills) of each
build, and the device ms of the run kernel and of the fix-up from
torch.profiler.  The last line is a JSON object of it all, also written
to ``--json`` where given; the exit code is 1 unless every output is
bit-identical.  Without a CUDA device it exits 2.

With ``--sweep`` the parent is a ``rotate_peak.cu`` with the same C
interface (``prt_rotate_peak_sweep``).  The script builds it and this
checkout's ``rotate_peak.cu``, each alone into a temp dir, prints both
ptxas reports, and runs both sweeps on a seeded (2, 11,520,000) pair (the
4-minute stereo file's shape) with: the canonical 360-angle table (the
pair units); each slice of it that a 3-way and a 4-way angle-sharded sweep
passes (120 and 90 angles, the general map); a random 512-angle table;
one angle; and the canonical table on samples with a NaN in every tile
(the general map's bit form throughout).  Each output is held against
the parent's bit for bit (NaN bits too) and against the plain twin (NaN
equal to NaN); each is timed with CUDA events in turns (parent, this
checkout, then the reverse, mean of the two).  The last line is a JSON
object of it all; the exit code is 1 unless every output is
bit-identical to the parent's and equal to the plain twin's.

With ``--stream`` the parent is a ``stream_conv.cu`` with the two-pass C
interface (the earlier ``prt_stream_conv``: a framed copy of the input, a
spectrum buffer of 2,064 bytes per frame, the output in frames).  The
script builds it and this checkout's ``stream_conv.cu``, each alone into a
temp dir (and ``STREAM_VARIANTS`` of this checkout's source, made there),
prints each ptxas report and each build's launch geometry (blocks,
registers, spills, shared memory), and runs, on seeded data: the conv at
(2, 11,520,000) with ns = 32 and ns = 64 and at (2, 11,520,001), an odd
n; the mix (``rotate_small``) on 64 x 2,880,000 with the 3072-tap FIR;
the ramp (``fused_stream_mix``) on a 4-minute mono stream with a target
that changes every 50 plugin blocks; and the ns = 32 conv on samples with
a NaN in every 100,000.  The parent is driven as its own wrapper drove it
(pad into frames, a spectrum buffer, ``rotate_small``'s slice), this
checkout's kernel through its wrapper; each is timed with CUDA events in
turns (parent, change, then the reverse, mean of the two), with the
wrapper's copies and without them (the kernel alone on prepared
operands).  Each output is held against the parent's bit for bit (NaN
bits too; the count of differing elements and the largest difference are
printed) and against the plain twin at the budgets (1e-5 conv and ramp,
2e-5 mix, NaN where the plain twin has NaN).  The ``nofma`` variant and
the parent are also built with ``-fmad=false``, so that no product is
fused into an FMA but where the source says so: those two outputs hold
the data flow alone to bit-identity.  ``clocks`` gives each phase's share
of the cycles.  The last line is a JSON object of it all; the exit code
is 1 unless every output is within its budget and every ``nofma`` output
bit-identical to the parent's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# variants: (old, new, count) replacements of this checkout's source.
# ``global``: the stage-major table read through __ldg, not staged
GLOBAL_TABLE = (
    ("""  float4* tws = smem4 + (m >> 1);  // the twiddle table after the frame
  for (int i = threadIdx.x; i < table_len(m); i += blockDim.x) {
    tws[i] = __ldg(twiddles + i);
  }
""", "  const float4* tws = twiddles;\n", 1),
    ("      const float4 t = tw[j];\n",
     "      const float4 t = __ldg(tw + j);\n", 2),
    ("""  *smem = static_cast<size_t>(m) * sizeof(float2) +
          static_cast<size_t>(table_len(m)) * sizeof(float4);""",
     "  *smem = static_cast<size_t>(m) * sizeof(float2);", 1),
)


# ``occupancy``: at most 32 registers where a thread carries 2 float4
# (parsiz 2048-8192), so as many blocks fit per SM as the parent's had
OCCUPANCY = (
    ("template <int kCarry, bool kMix>\n"
     "__global__ void __launch_bounds__(1024)",
     "template <int kCarry, bool kMix>\n__global__ void "
     "__launch_bounds__(1024, kCarry == 2 ? 2 : 1)", 1),
)
VARIANTS = {"global": GLOBAL_TABLE, "occupancy": OCCUPANCY}


def with_headers(src: str) -> str:
    """``src`` with each ``#include "<header>"`` of ``csrc/`` replaced by
    the header's text, so that it compiles alone in a temp dir."""
    csrc = os.path.join(REPO, "phaserotate_tpu_torch", "csrc")

    def text(m):
        with open(os.path.join(csrc, m.group(1))) as f:
            return f.read().replace("#pragma once\n", "")

    return re.sub(r'^#include "([\w.]+)"$', text, src, flags=re.M)


def variant_source(src: str, edits) -> str:
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"variant edit matched {src.count(old)} "
                               f"times, not {count}: {old!r}")
        src = src.replace(old, new)
    return src


def build_lib(src_text: str, tmp: str, name: str):
    """Compile one source with the port's flags into ``tmp``; returns
    (ctypes handle, ptxas lines)."""
    from phaserotate_tpu_torch.kernels import _build

    cu = os.path.join(tmp, f"{name}.cu")
    so = os.path.join(tmp, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src_text)
    log = _build._nvcc_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                             "-o", so, cu]])
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    return ctypes.CDLL(so), ptxas


def build_libs(builds: dict, tmp: str) -> dict:
    """Compile {name: (source text, extra flags)} with the port's flags,
    all at once, into ``tmp``; prints each ptxas report; returns {name:
    ctypes handle}."""
    from phaserotate_tpu_torch.kernels import _build

    cmds, sos = [], {}
    for name, (text, flags) in builds.items():
        cu = os.path.join(tmp, f"stream_{name}.cu")
        sos[name] = os.path.join(tmp, f"libstream_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared",
                     "-o", sos[name], cu])
    log = _build._nvcc_all(cmds)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("ptxas", line.strip())
    return {name: ctypes.CDLL(so) for name, so in sos.items()}


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sweep_tables(dev):
    """The sweep A/B's tables by name: (cos_sin, samples with a NaN in
    every tile)."""
    import torch

    from phaserotate_tpu_torch.core.angles import all_angle_cos_sin

    cs = all_angle_cos_sin(dev)
    rng = np.random.default_rng(7)
    tables = {"canonical_360": (cs, False)}
    for i in range(3):
        tables[f"slice3_{i}_120"] = (cs[:, 120 * i : 120 * (i + 1)], False)
    for i in range(4):
        tables[f"slice4_{i}_90"] = (cs[:, 90 * i : 90 * (i + 1)], False)
    tables["random_512"] = (torch.from_numpy(rng.uniform(
        -1, 1, (2, 512)).astype(np.float32)).to(dev), False)
    tables["one_angle"] = (cs[:, 37:38], False)
    tables["canonical_360_nan_tiles"] = (cs, True)
    return {k: (v.contiguous(), nan) for k, (v, nan) in tables.items()}


def sweep_ab(args) -> int:
    """The ``--sweep`` mode of the module docstring."""
    import torch

    import chip_smoke as smoke
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.kernels.rotate_peak import (
        rotate_peak_sweep_plain)

    card = card_name()
    print(card)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    with open(os.path.join(REPO, "phaserotate_tpu_torch", "csrc",
                           "rotate_peak.cu")) as f:
        src = f.read()
    with open(args.parent) as f:
        parent_src = f.read()
    report = dict(card=card, tables={})
    with tempfile.TemporaryDirectory(prefix="sweep_ab_") as tmp:
        libs = {}
        for name, text in (("parent", parent_src), ("change", src)):
            libs[name], ptxas = build_lib(text, tmp, f"sweep_{name}")
            fn = libs[name].prt_rotate_peak_sweep
            fn.argtypes = _build._SIGNATURES["prt_rotate_peak_sweep"]
            fn.restype = ctypes.c_int
            for line in ptxas:
                print(f"ptxas {name}:", line)
            for line in smoke.sweep_sass(os.path.join(
                    tmp, f"libsweep_{name}.so")).splitlines():
                print(f"{name} {line}")
        rng = np.random.default_rng(20240917)
        n = 240 * 48000
        b0 = torch.from_numpy(rng.standard_normal(
            (2, n), dtype=np.float32)).to(dev)
        b1 = torch.from_numpy(rng.standard_normal(
            (2, n), dtype=np.float32)).to(dev)
        nan0 = b0.clone()
        nan0[:, 1234::4096] = float("nan")  # one in every 4096-sample tile
        stream = torch.cuda.current_stream(dev).cuda_stream

        def sweep(name, x0, table):
            out = torch.zeros((2, table.shape[1]), device=dev)

            def run():
                out.zero_()
                _build.check(libs[name].prt_rotate_peak_sweep(
                    x0.data_ptr(), b1.data_ptr(), n, n, table.data_ptr(),
                    out.data_ptr(), 2, n, table.shape[1], 4096, stream),
                    name)
            return out, run

        ok = True
        for label, (table, nan) in sweep_tables(dev).items():
            x0 = nan0 if nan else b0
            outs, fns = {}, {}
            for name in libs:
                outs[name], fns[name] = sweep(name, x0, table)
                fns[name]()
            plain = rotate_peak_sweep_plain(x0, b1, table)
            torch.cuda.synchronize()
            same = torch.equal(outs["change"].view(torch.int32),
                               outs["parent"].view(torch.int32))
            equal_plain = bool(torch.isclose(
                outs["change"], plain, rtol=0, atol=0, equal_nan=True).all())
            ok &= same and equal_plain
            ms = {k: 0.0 for k in fns}
            for turn in (list(fns), list(fns)[::-1]):
                for k in turn:
                    ms[k] += smoke.cuda_ms(fns[k], args.reps) / 2
            entry = dict(angles=table.shape[1], nan_tiles=nan, ms=ms,
                         bit_identical_to_parent=same,
                         nofma_bit_identical_to_parent_nofma=same_nofma,
                         max_abs_diff_vs_parent=diff,
                         elements_differing_from_parent=differ,
                         phase_share=phase_share(fns["change_clocks_kernel"]),
                         equal_to_plain=equal_plain,
                         ratio=ms["change"] / ms["parent"])
            report["tables"][label] = entry
            print(f"sweep {label}: {json.dumps(entry)} [{card}]")
    report["bit_identical"] = ok
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if ok else 1


# ``clocks``: thread 0 of each block adds the clock64() cycles of each
# phase between two barriers to prt_phase_clk[k] (k: PHASES), read back
# by prt_phase_clocks
PHASES = ("load_pass1", "dif_passes", "untangle", "mac", "pack_dry",
          "dit_passes", "output", "store_upper")
PHASE_CLOCKS = (
    ("namespace {\n",
     "__device__ unsigned long long prt_phase_clk[8];\n"
     "__shared__ long long ph_last_;\n"
     "#define PH(k) do { if (threadIdx.x == 0) { const long long c_ = "
     "clock64(); atomicAdd(&prt_phase_clk[k], (unsigned long long)(c_ - "
     "ph_last_)); ph_last_ = c_; } } while (0)\n\nnamespace {\n", 1),
    ("  for (int i = t; i < kFftLen; i += kThreads) tw_s[i] = twiddle[i];\n",
     "  for (int i = t; i < kFftLen; i += kThreads) tw_s[i] = twiddle[i];\n"
     "  if (t == 0) ph_last_ = clock64();\n", 1),
    ("  __syncthreads();\n  for (int f = 0; f < lo; ++f) {",
     "  __syncthreads();\n  PH(6);\n  for (int f = 0; f < lo; ++f) {", 1),
    ("  __syncthreads();\n  dif_passes(ring, r0, lo, cnt, R, tw_p);\n",
     "  __syncthreads();\n  PH(0);\n  dif_passes(ring, r0, lo, cnt, R, "
     "tw_p);\n  PH(1);\n", 1),
    ("  }\n  __syncthreads();\n}\n\n// The sums U of one bin",
     "  }\n  __syncthreads();\n  PH(2);\n}\n\n// The sums U of one bin", 1),
    ("      __syncthreads();\n      if (macs && upper) {",
     "      __syncthreads();\n      PH(3);\n      if (macs && upper) {", 1),
    ("      __syncthreads();\n      if (macs && !upper) {",
     "      __syncthreads();\n      PH(7);\n      if (macs && !upper) {", 1),
    ("      __syncthreads();\n      dit_passes(ring, rz, cnt, R, tw_p);\n",
     "      __syncthreads();\n      PH(4);\n      dit_passes(ring, rz, cnt, "
     "R, tw_p);\n      PH(5);\n", 1),
    ("extern \"C\" int prt_stream_conv_grid(",
     "extern \"C\" int prt_phase_clocks(unsigned long long* out) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, prt_phase_clk, "
     "sizeof(prt_phase_clk));\n"
     "  unsigned long long z[8] = {0};\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(prt_phase_clk, z, "
     "sizeof(z));\n"
     "  return static_cast<int>(e);\n}\n\n"
     "extern \"C\" int prt_stream_conv_grid(", 1),
)
# ``plaincmul``: the complex product as plain C (a.x * b.x - a.y * b.y,
# ...), each product's fusion into an FMA left to the compiler, as in the
# parent
PLAIN_CMUL = (
    ("  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),\n"
     "                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));",
     "  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);",
     1),
)
# diagnosis variants of this checkout's stream_conv.cu: name -> (edits,
# extra nvcc flags)
STREAM_VARIANTS = {
    "clocks": (PHASE_CLOCKS, ()),
    "plaincmul": (PLAIN_CMUL, ()),
    # no contraction of a*b+c into an FMA but where the source says fmaf,
    # in this build and the parent's (``parent_nofma``): the data flow
    # alone is compared
    "nofma": (PLAIN_CMUL, ("-fmad=false",)),
}


def stream_cases(dev):
    """The ``--stream`` cases by name: (mode, fir taps, operands)."""
    import torch

    from phaserotate_tpu_torch.core.sizes import stream_geometry_for_rate
    from phaserotate_tpu_torch.stream.engine import (
        _internal_angle_params, angle_sequence)

    rng = np.random.default_rng(20240917)
    n4 = 240 * 48000
    x4 = torch.from_numpy(rng.standard_normal((2, n4 + 1),
                                              dtype=np.float32)).to(dev)
    stems = torch.from_numpy(rng.standard_normal(
        (64, 60 * 48000), dtype=np.float32)).to(dev)
    turns = torch.from_numpy(rng.uniform(-0.5, 0.5, 64).astype(
        np.float32)).to(dev)
    geom = stream_geometry_for_rate(48000)
    n_blocks = -(-(n4 + geom.latency) // geom.parsiz)
    degs = np.repeat(rng.uniform(-180.0, 180.0, -(-n_blocks // 50)),
                     50)[:n_blocks].astype(np.float32)
    angles, das, _, _ = angle_sequence(np.float32(0.0), degs, geom)
    params = torch.from_numpy(
        _internal_angle_params(angles, das, geom)).to(dev)[None]
    mono = torch.nn.functional.pad(
        x4[0, :n4], (0, params.shape[1] * 256 - n4)).reshape(1, -1, 256)
    nan = x4[:, :n4].clone()
    nan[:, 12345::100000] = float("nan")
    return {
        "conv_ns32": ("conv", 8192, (x4[:, :n4].contiguous(),)),
        "conv_ns64": ("conv", 16384, (x4[:, :n4].contiguous(),)),
        "conv_ns32_odd_n": ("conv", 8192, (x4,)),
        "mix_ns12": ("mix", 3072, (stems, turns)),
        "ramp_ns12": ("ramp", geom.firlen, (mono, params)),
        "conv_ns32_nan": ("conv", 8192, (nan,)),
    }


def stream_ab(args) -> int:
    """The ``--stream`` mode of the module docstring."""
    import torch

    import chip_smoke as smoke
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.kernels import stream_conv as sc

    card = card_name()
    print(card)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    with open(os.path.join(REPO, "phaserotate_tpu_torch", "csrc",
                           "stream_conv.cu")) as f:
        src = f.read()
    with open(args.parent) as f:
        parent_src = f.read()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    report = dict(card=card, cases={}, geometry={})
    with tempfile.TemporaryDirectory(prefix="stream_ab_") as tmp:
        builds = {"parent": (parent_src, ()), "change": (src, ()),
                  "parent_nofma": (parent_src, ("-fmad=false",))}
        builds.update({f"change_{k}": (variant_source(src, edits), flags)
                       for k, (edits, flags) in STREAM_VARIANTS.items()})
        libs = build_libs(builds, tmp)
        parents = [k for k in libs if k.startswith("parent")]
        for name in parents:
            libs[name].prt_stream_conv.argtypes = (
                ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr)
            libs[name].prt_stream_conv.restype = i32
        for name in libs:
            if name not in parents:
                for fn in ("prt_stream_conv", "prt_stream_conv_grid"):
                    getattr(libs[name], fn).argtypes = _build._SIGNATURES[fn]
                    getattr(libs[name], fn).restype = i32
        clocks = libs["change_clocks"].prt_phase_clocks
        clocks.argtypes, clocks.restype = (ptr,), i32
        stream = torch.cuda.current_stream(dev).cuda_stream

        def geometry(name, ns, mix):
            info = (ctypes.c_int * 5)()
            _build.check(libs[name].prt_stream_conv_grid(ns, int(mix), info),
                         "geometry")
            return dict(zip(("blocks", "threads", "registers",
                             "local_bytes", "smem_bytes"), info))

        for ns in (12, 32, 64):
            for mix in (False, True):
                for name in libs:
                    if name not in parents:
                        g = geometry(name, ns, mix)
                        report["geometry"][f"{name} ns{ns} mix{int(mix)}"] = g
                        print(f"geometry {name} ns={ns} mix={mix}: "
                              f"{json.dumps(g)}")

        def parent_call(frames, taps, angs, d_frames, name="parent"):
            """The parent's launch on prepared (B, F, 256) frames."""
            b, n_frames, _ = frames.shape
            fir = sc._fir_parts(taps, dev)
            spec = torch.empty((b, n_frames, 258, 2), device=dev)
            out = torch.empty((b, n_frames, 256), device=dev)

            def run():
                _build.check(libs[name].prt_stream_conv(
                    frames.data_ptr(), fir.data_ptr(),
                    sc._twiddles(dev).data_ptr(),
                    None if angs is None else angs.data_ptr(),
                    spec.data_ptr(), out.data_ptr(), b, n_frames,
                    taps // 256, d_frames, stream), name)
                return out
            return run

        def framed(x, n_frames):
            n = x.shape[-1]
            return torch.nn.functional.pad(
                x, (0, n_frames * 256 - n)).reshape(-1, n_frames, 256)

        def calls(mode, taps, ops):
            """{name: fn} of every launch of one case, each returning the
            output in the wrapper's shape."""
            lat = taps // 2
            if mode == "conv":
                (x,) = ops
                n_f = -(-x.shape[-1] // 256) + taps // 256
                frames = framed(x, n_f)
                par = parent_call(frames, taps, None, 0)
                out = torch.empty((x.shape[0], n_f * 256), device=dev)

                def launch(name):
                    def run():
                        sc._launch(x, taps, n_f, out, n_f * 256,
                                   lib=libs[name])
                        return out
                    return run
                par_nofma = parent_call(frames, taps, None, 0, "parent_nofma")
                fns = {"parent_nofma_kernel": lambda: par_nofma().reshape(
                           x.shape[0], -1),
                       "parent_kernel": lambda: par().reshape(
                           x.shape[0], -1),
                       "parent_wrapper": lambda: parent_call(
                           framed(x, n_f), taps, None, 0)().reshape(
                           x.shape[0], -1),
                       "change_wrapper": lambda: sc.hilbert_small(x, taps)}
            elif mode == "mix":
                x, turns = ops
                n = x.shape[-1]
                n_f = -(-(n + lat) // 256)
                frames = framed(x, n_f)
                b = x.shape[0]
                angs_p = torch.stack([turns[:, None].expand(b, n_f),
                                      turns.new_zeros(b, n_f)],
                                     dim=-1).contiguous()
                par = parent_call(frames, taps, angs_p, lat // 256)

                def par_wrapper():
                    fr = framed(x, n_f)
                    a = torch.stack([turns[:, None].expand(b, n_f),
                                     turns.new_zeros(b, n_f)],
                                    dim=-1).contiguous()
                    y = parent_call(fr, taps, a, lat // 256)()
                    return y.reshape(b, -1)[:, lat : lat + n].contiguous()
                angs = torch.stack([turns, torch.zeros_like(turns)], dim=-1)
                out = torch.empty((b, n), device=dev)

                def launch(name):
                    def run():
                        sc._launch(x, taps, -(-n // 256), out, n,
                                   d_out=lat // 256, angs=angs, ang_fs=0,
                                   lib=libs[name])
                        return out
                    return run
                par_nofma = parent_call(frames, taps, angs_p, lat // 256,
                                        "parent_nofma")
                fns = {"parent_nofma_kernel": lambda: par_nofma().reshape(
                           b, -1)[:, lat : lat + n],
                       "parent_kernel": lambda: par().reshape(b, -1)[
                           :, lat : lat + n],
                       "parent_wrapper": par_wrapper,
                       "change_wrapper": lambda: sc.rotate_small(x, turns,
                                                                 taps)}
            else:
                frames, params = ops
                b, n_f, _ = frames.shape
                par = parent_call(frames, taps, params, lat // 256)
                out = torch.empty_like(frames)

                def launch(name):
                    def run():
                        sc._launch(frames.reshape(b, -1), taps, n_f,
                                   out.view(b, -1), n_f * 256,
                                   angs=params.view(b, -1), ang_fs=1,
                                   lib=libs[name])
                        return out
                    return run
                fns = {"parent_nofma_kernel": parent_call(
                           frames, taps, params, lat // 256, "parent_nofma"),
                       "parent_kernel": par,
                       "parent_wrapper": lambda: parent_call(
                           frames.contiguous(), taps, params.contiguous(),
                           lat // 256)(),
                       "change_wrapper": lambda: sc.fused_stream_mix(
                           frames, params, taps)}
            for name in libs:
                if name not in parents:
                    fns[f"{name}_kernel"] = launch(name)
            return fns

        def plain(mode, taps, ops):
            if mode == "conv":
                return sc.hilbert_small_plain(ops[0], taps)
            if mode == "mix":
                return sc.rotate_small_plain(*ops, taps)
            return sc.fused_stream_mix_plain(*ops, taps)

        def phase_share(fn):
            """Share of each phase in the clock64() cycles of thread 0 of
            every block, over one call of the ``clocks`` variant."""
            buf = (ctypes.c_ulonglong * 8)()
            _build.check(clocks(buf), "clocks")  # reset
            fn()
            torch.cuda.synchronize()
            _build.check(clocks(buf), "clocks")
            total = sum(buf[: len(PHASES)])
            return {k: buf[i] / total for i, k in enumerate(PHASES)}

        ok = True
        for label, (mode, taps, ops) in stream_cases(dev).items():
            fns = calls(mode, taps, ops)
            outs = {k: fn().clone() for k, fn in fns.items()}
            torch.cuda.synchronize()
            def bits(a, b):
                return torch.equal(a.contiguous().view(torch.int32),
                                   b.contiguous().view(torch.int32))

            ref = outs["parent_kernel"]
            same = {k: bits(v, ref) for k, v in outs.items()
                    if k not in ("parent_kernel", "parent_nofma_kernel",
                                 "change_nofma_kernel")}
            # the data flow alone: both built without contraction
            same_nofma = bits(outs["change_nofma_kernel"],
                              outs["parent_nofma_kernel"])
            diff = float((outs["change_kernel"] - ref).abs().nan_to_num(
                0.0).max())
            differ = int((outs["change_kernel"].view(torch.int32)
                          != ref.contiguous().view(torch.int32)).sum())
            want = plain(mode, taps, ops)
            okp = ~want.isnan()
            err = float((outs["change_wrapper"][okp] - want[okp]).abs().max())
            nan_equal = torch.equal(outs["change_wrapper"].isnan(),
                                    want.isnan())
            budget = 2e-5 if mode == "mix" else 1e-5
            ok &= same_nofma and err < budget and nan_equal
            ms = {k: 0.0 for k in fns}
            for turn in (list(fns), list(fns)[::-1]):
                for k in turn:
                    ms[k] += smoke.cuda_ms(fns[k], args.reps) / 2
            entry = dict(mode=mode, taps=taps,
                         shape=list(ops[0].shape), ms=ms,
                         bit_identical_to_parent=same,
                         nofma_bit_identical_to_parent_nofma=same_nofma,
                         max_abs_diff_vs_parent=diff,
                         elements_differing_from_parent=differ,
                         phase_share=phase_share(fns["change_clocks_kernel"]),
                         max_abs_err_vs_plain=err, nan_equal_plain=nan_equal,
                         ratio_kernel=ms["change_kernel"]
                         / ms["parent_kernel"],
                         ratio_wrapper=ms["change_wrapper"]
                         / ms["parent_wrapper"])
            report["cases"][label] = entry
            print(f"stream {label}: {json.dumps(entry)} [{card}]")
            del fns, outs
            torch.cuda.empty_cache()
    report["ok"] = ok
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if ok else 1


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the earlier fused_conv.cu (two-pass interface), "
                         "with --sweep the earlier rotate_peak.cu, with "
                         "--stream the earlier stream_conv.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="compare the sweep kernel, not fused_conv")
    ap.add_argument("--stream", action="store_true",
                    help="compare the stream_conv kernel, not fused_conv")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", help="also write the report to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_conv_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.sweep:
        return sweep_ab(args)
    if args.stream:
        return stream_ab(args)
    import chip_smoke as cs
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.kernels import fused_conv as fc

    card = card_name()
    print(card)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    src = with_headers(open(os.path.join(REPO, "phaserotate_tpu_torch",
                                         "csrc", "fused_conv.cu")).read())
    with open(args.parent) as f:
        parent_src = f.read()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory(prefix="fused_conv_ab_") as tmp:
        libs = {"runs": _build.lib()}
        parent, ptxas = build_lib(parent_src, tmp, "parent")
        for line in ptxas:
            print("ptxas parent:", line)
        parent.prt_fused_conv.argtypes = (ptr,) * 7 + (i32,) * 4 + (ptr,)
        parent.prt_fused_conv.restype = i32
        for name, edits in VARIANTS.items():
            handle, ptxas = build_lib(variant_source(src, edits), tmp, name)
            for line in ptxas:
                print(f"ptxas {name}:", line)
            for fn, types in (
                    (handle.prt_fused_conv, (ptr,) * 7 + (i32,) * 5 + (ptr,)),
                    (handle.prt_fused_conv_grid, (i32, i32, ptr))):
                fn.argtypes, fn.restype = types, i32
            libs[f"runs_{name}"] = handle
        report = dict(card=card, parsiz={}, mix={})

        def geometry(handle, parsiz, mix):
            info = (ctypes.c_int * 4)()
            _build.check(handle.prt_fused_conv_grid(parsiz, int(mix), info),
                         "geometry")
            return dict(zip(("blocks", "threads", "registers",
                             "local_bytes"), info))

        def calls(frames, spec_c, parsiz, cs_rows, lat):
            """Every launch on (B, n_blocks, parsiz) frames, by name, with
            its output buffer and its grid."""
            b, n_blocks, _ = frames.shape
            n_frames = b * n_blocks
            spec, wp = fc._product_tables(spec_c, parsiz)
            tw_nat = torch.tensor(fc._twiddles_np(parsiz), device=dev)
            tw_stage = fc._stage_twiddles(parsiz, dev)
            mix = cs_rows is not None
            csp = None if cs_rows is None else cs_rows.data_ptr()
            stream = torch.cuda.current_stream(dev).cuda_stream
            tail = torch.empty_like(frames)  # the parent's: the whole signal
            grids = {k: min(geometry(h, parsiz, mix)["blocks"], n_frames)
                     for k, h in libs.items()}
            # one block per frame: the parent's two passes, stage-major
            grids["frames_global"] = n_frames
            handles = dict(libs, frames_global=libs["runs_global"])
            out = {k: torch.empty((b, n_blocks * parsiz), device=dev)
                   for k in ("parent", *handles)}

            def new(key):
                def run():
                    _build.check(handles[key].prt_fused_conv(
                        frames.data_ptr(), spec.data_ptr(),
                        tw_stage.data_ptr(), wp.data_ptr(), csp,
                        tail.data_ptr(), out[key].data_ptr(), b, n_blocks,
                        parsiz, lat, grids[key], stream), key)
                return run

            def old():
                _build.check(parent.prt_fused_conv(
                    frames.data_ptr(), spec.data_ptr(), tw_nat.data_ptr(),
                    wp.data_ptr(), csp, tail.data_ptr(),
                    out["parent"].data_ptr(), b, n_blocks, parsiz, lat,
                    stream), "parent")

            return out, dict(parent=old, **{k: new(k) for k in handles}), grids

        def measure(label, frames, spec_c, parsiz, cs_rows=None, lat=0):
            out, fns, grids = calls(frames, spec_c, parsiz, cs_rows, lat)
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
            diff = {k: float((out[k] - out["parent"]).abs().max())
                    for k in out if k != "parent"}
            order = list(fns)
            ms = {k: 0.0 for k in order}
            for turn in (order, order[::-1]):
                for k in turn:
                    ms[k] += cs.cuda_ms(fns[k], args.reps) / 2
            mix = cs_rows is not None
            entry = dict(
                shape=list(frames.shape), ms=ms, max_abs_diff_vs_parent=diff,
                grid=grids,
                geometry={k: geometry(h, parsiz, mix)
                          for k, h in libs.items()},
                device_ms_by_kernel={k: cs.device_split(fns[k]) for k in libs})
            print(f"{label}: {json.dumps(entry)} [{card}]")
            return entry

        rng = np.random.default_rng(20240917)
        stems = torch.from_numpy(rng.standard_normal(
            (64, 60 * 48000), dtype=np.float32)).to(dev)
        x4 = torch.from_numpy(rng.standard_normal(
            (2, 240 * 48000), dtype=np.float32)).to(dev)
        for parsiz, firlen, x in ((2048, 2048, x4), (4096, 3072, stems),
                                  (8192, 8192, x4), (16384, 16128, stems)):
            n_f = -(-x.shape[-1] // parsiz) + 1
            frames = torch.nn.functional.pad(
                x, (0, n_f * parsiz - x.shape[-1])).reshape(-1, n_f, parsiz)
            report["parsiz"][str(parsiz)] = measure(
                f"conv parsiz {parsiz}", frames,
                fc.hilbert_fir_spectrum(firlen, parsiz, dev), parsiz)
            del frames
        turns = torch.from_numpy(
            rng.uniform(-0.5, 0.5, 64).astype(np.float32)).to(dev)
        frames, cs_rows, spec_c, parsiz, lat = fc._rotate_operands(
            stems, turns, 3072)
        report["mix"] = measure(f"mix parsiz {parsiz} lat {lat}", frames,
                                spec_c, parsiz, cs_rows.contiguous(), lat)
        worst = max(max(e["max_abs_diff_vs_parent"].values())
                    for e in [*report["parsiz"].values(), report["mix"]])
        report["bit_identical"] = worst == 0.0
        if args.json:
            with open(args.json, "w") as f:
                json.dump(report, f, indent=1)
        print(json.dumps(report))
    return 0 if report["bit_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())

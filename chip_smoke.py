#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from ``phaserotate_tpu_torch/csrc/`` with nvcc,
then, on the first CUDA device:

1. writes a 4-minute stereo 48 kHz 16-bit WAV made from a numpy seed and
   runs the port's CLI on it as a user would: ``-vv in.wav`` (analyze),
   then ``-a <found> in.wav out.wav`` (apply), as subprocesses;
2. with every kernel launch counter at 0, drives the main paths in this
   process: the same two CLI calls, the fleet-shaped search (64 files x 2
   channels x 10 s), the FIR rotate of 64 one-minute mono stems,
   ``hilbert_fir`` of those stems with the plugin's 3072-tap FIR,
   ``OfflineRotator`` with a 16128-tap FIR, ``rotate_streamed`` of the
   4-minute file, a stereo ``PhaseRotator`` over 60 s of it in 1024-sample
   host blocks with meters on, and ``AngleAnalyzer.analyze_many`` on 8
   fleet files with a checkpoint; it fails unless every kernel of those
   paths was launched;
   then, with the counters at 0 again, the library's wider surface on
   the same 4-minute file: ``refine_angle`` (24 steps from each channel's
   table argmin; channel 0 against the same call on the CPU), the
   CLI on 16-bit AIFF, W64 and RF64 copies and a 3 s FLAC cut (analyze,
   apply to an output without an extension, which inherits the container;
   angles and audio against the WAV runs), ``sweep_peaks_aux_pcm16`` on
   ``read_audio_pcm16``'s int16 samples (bit-equal to the float path) and
   one CLI analyze under ``PHASEROTATE_TPU_PROFILE`` (the trace names the
   sweep and stream_conv kernels);
   then, with the counters at 0 a third time, the catalogue path: 48
   stereo WAV files (and two AIFF copies) made from the seed, in two
   length buckets, half of them at -54 dBFS; the fleet CLI on them as
   subprocesses (``--checkpoint --transport pcm16``, then ``--apply
   --outdir`` on eight of them with the default transport) and once in
   this process to hit the checkpoint (every line ``(cached sweep)``, no
   launch); ``fleet.analyze_paths`` per transport
   (pcm16, packed, auto: equal tables and angles, ``auto`` shipping both
   kinds of batch; files/s, wire bytes and peak device memory printed);
   eight 24-bit copies, every batch staged in a pinned slot of the
   process's staging ring, then one ``fleet ring`` line: the
   host-to-device rate from a pinned slot at the 96 kHz catalogue's
   longest batch (8 x 2 x 2^26 frames of pcm24) beside the pageable rate
   of the same payload, and the ring's slot size;
   six files against ``find_min_peak_angle`` and ``_apply_one``; one batch
   step by step (decode, pack, copy, unpack, sweep, selection), after
   the counts are read and with ``hilbert_small`` and the sweep kernel
   held to their plain twins at the fleet's batch shapes (8 x 2 x
   4,194,304 and 8 x 2 x 8,388,608, zero-padded tails included); one
   catalogue-sized batch (8 x 2 x 16,777,216) packed by the port's host
   packer and by ``native/wire_pack.cc``, word for word the same, with
   both packers' MB/s and the port's workers; and the
   ``parallel`` package on meshes that name the card four (three) times:
   sample sharding of the 4-minute file (1-D and 2 x 2) within 2e-5 of
   the unsharded sweep, angle sharding on three and on four shards (the
   sweep kernel's general map) and files sharding of the 64 x 2 x 10 s
   search bit-equal to it, ``batch_rotate`` and ``sharded_rotate`` within
   1e-5 of ``rotate_fir``;
   then, with the counters at 0 a fourth time, the serving path: the
   daemon (``bridge.serve(sock, batch_sessions=8, pipeline=-1,
   ui_port=0)``) in a thread of this process on the card, eight
   ``native/prt_bridge`` stereo sessions (built with ``make -C native
   prt_bridge``) at 1024-sample blocks in its broker and a Python
   ``BridgeClient`` (the ninth, served on its own; it moves its angle and
   sends the UI's CTRL events), the 4-minute file analysed over the socket
   by ``BridgeClient.analyze`` and ``prt_bridge -A`` while they stream,
   the web UI's ``/state``, then two unbatched sessions on a second
   daemon; every output against ``StreamingRotator(pipeline_depth=D)`` on
   the card within 1e-5, the analyses equal to the in-process search; the
   counts of the four runs are added up in the ``kernels`` line;
3. checks the outputs: against the plain PyTorch path (the kernels' plain
   twins) on the card, against the repository's numpy CLI simulator on a
   small input, the streaming rotator against the bulk engine, block-size
   independence, a bit-identical checkpoint resume, and the resumed
   analysis;
4. holds each kernel against its plain twin on the same CUDA tensors at
   the main paths' shapes (sweep table and peak bit-equal, conv < 1e-5,
   mixes < 2e-5, fused_conv at every supported partition size); the two
   kernels no main path calls (``fused_rotate_fir``, ``peak``) have
   ``launches`` 0 and this check's own count under ``check_launches``;
   ``pcm24_widen`` bit-equal on seeded random bytes, the 24-bit extremes
   at both ends of each row, at the 96 kHz catalogue's longest bucket (8
   x 2 x 2^26 frames; ``launches`` the catalogue run's, ``check_launches``
   this check's); ``hilbert_32k`` (blksiz 32768) within 1e-5 of its plain
   twin at 16 x 2^27 samples, the longest bucket's fleet batch of 8 stereo
   192 kHz songs (the twin on all 16 rows at once, or on as many at a
   time as its transients fit, ``plain_rows``; its time and the kernel's
   on that many rows, ``plain_ms`` and ``ms_at_plain_rows``), then three
   stereo 24-bit 192 kHz WAVs from the seed through
   ``fleet.analyze_paths`` (``launches`` this run's) and one through the
   CLI in this process,
   tables within 1e-4 of the benchmark's float64 reference
   (``benchmark/reference/offline.py``), angle 0 exact, and its angles;
   the sweep also with the slices of the table that a 3-way and a 4-way
   angle-sharded sweep passes (120 and 90 angles), a random 512-angle
   table and one angle, at both shapes (the kernel's general map,
   ``rotate_peak_sweep_general``, whose row gives the slowest 3-way
   slice's time and bound, slices within 1 % of it taken as tied and the
   one with the largest bound picked; every slice's time on a line of its
   own), and
   on NaN and inf samples with 360, 120 and 90 angles (equal with NaN
   equal to NaN);
5. prints the wall time of each phase and, per kernel, its time beside its
   plain version's, its bound (``bound_ms``: the larger of its bytes over
   the H100's 3.35 TB/s and its FP32 operations over 67 TFLOP/s,
   ``bound_by`` saying which; a convolution's operations are those its
   function needs, the same for every kernel that computes it, not those
   of the kernel's own algorithm; the sweep's, those its function needs on
   the table passed, whose mirror angles share their products) and, where
   one PyTorch call computes the
   same function, that call's time (``library_ms``: cuFFT through
   ``torch.fft`` for the convolutions, ``torch.linalg.vector_norm`` for
   the peak; timed here only, the port never calls them), with the card's
   name and power limit (fused_conv's entry also carries both times at its
   two main-path partition sizes, 4096 and 16384, under ``ms_by_parsiz``,
   with its persistent grid's blocks and registers per thread; a
   ``fused_conv parsiz ...`` line per size gives the device ms of the run
   kernel and of the fix-up of the run-first frames).

After the build it prints ptxas' registers and spills per kernel and a
``sass:`` line per instantiation of the sweep kernel, the FP32, integer
max and LDS counts of its machine code (``cuobjdump -sass``), and after
the sweep's timing the SM clock beside its maximum.  Before the kernels'
line it prints the script's wall time.

The CLI and the models run without a device argument, so the port's own
default (the CUDA device) places the work.

The line before the last is a JSON object of the kernels; the last is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is not 0 and no result line is printed.  Without a CUDA device the
script stops at once with exit code 2.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
STARTED = time.perf_counter()
RATE = 48000
SEED = 20240917
# published H100 SXM peaks (NVIDIA's data sheet) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sync():
    import torch

    torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str, card: str, times: dict):
    """Wall time of one phase, ended by a device synchronize."""
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    times[name] = time.perf_counter() - t0
    print(f"phase {name}: {times[name]:.6f} s [{card}]")


def music_like(rng, n_ch: int, n: int):
    """Asymmetric multi-tone (the tests' make_signal), band-limited noise
    and a slow envelope: a peak-vs-angle table that is far from flat."""
    t = np.arange(n, dtype=np.float64) / RATE
    out = np.empty((n_ch, n), np.float32)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 0.07 * t + rng.uniform(0, 6)) ** 2
    for c in range(n_ch):
        f0 = 997.0 * rng.uniform(0.8, 1.25)
        x = (0.6 * np.sin(2 * np.pi * f0 * t + c)
             + 0.35 * np.sin(2 * np.pi * 2 * f0 * t + 0.7 + c)
             + 0.15 * np.sin(2 * np.pi * 3 * f0 * t + 1.9))
        noise = rng.standard_normal(n + 15)
        noise = np.convolve(noise, np.hanning(16) / 8.0, mode="valid")[:n]
        out[c] = (0.5 * env * x + 0.08 * noise).astype(np.float32)
    return out


def music_batch(rng, shape, n: int, device):
    """(files, ..., n) music-like clips made on the device from seeded
    per-row parameters (bulk data, so no host loop over rows)."""
    import torch

    rows = int(np.prod(shape))
    f0 = torch.tensor(rng.uniform(200.0, 1500.0, rows), device=device)
    ph = torch.tensor(rng.uniform(0.0, 6.28, (rows, 3)), device=device)
    t = torch.arange(n, device=device, dtype=torch.float64) / RATE
    w = 2 * np.pi * f0[:, None] * t[None]
    x = (0.6 * torch.sin(w + ph[:, :1]) + 0.35 * torch.sin(2 * w + ph[:, 1:2])
         + 0.15 * torch.sin(3 * w + ph[:, 2:]))
    env = 0.55 + 0.45 * torch.sin(2 * np.pi * 0.3 * t) ** 2
    g = torch.Generator(device=device).manual_seed(SEED)
    noise = torch.randn(rows, n, generator=g, device=device, dtype=torch.float64)
    x = 0.5 * env * x + 0.05 * noise
    return x.to(torch.float32).reshape(*shape, n).contiguous()


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over
    the HBM rate and ``flops`` over the FP32 rate, and which one it is."""
    t_bytes = float(1e3 * nbytes / HBM_BYTES_PER_S)
    t_ops = float(1e3 * flops / FP32_FLOPS_PER_S)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fft_flops(m: int) -> float:
    """5 M log2 M, an M-point complex FFT."""
    return 5.0 * m * np.log2(m)


def fused_conv_flops(n_frames: int, parsiz: int, mix_ops: int) -> float:
    """The one-partition FFT overlap-add of csrc/fused_conv.cu per frame:
    two parsiz-point complex FFTs, the untangling and packing (32
    operations per pair of bins each), the spectrum product (6 per bin)
    and the overlap-add (1 per sample) with ``mix_ops`` more per sample
    (sincosf not counted)."""
    return n_frames * (2 * fft_flops(parsiz) + 2 * 32 * (parsiz // 2)
                       + 6 * parsiz + (1 + mix_ops) * parsiz)


def fir_conv_flops(rows: int, n: int, firlen: int, mix_ops: int) -> float:
    """The operations a convolution of ``rows`` signals of ``n`` samples
    with a ``firlen``-tap FIR needs, whichever kernel computes it: the
    one-partition overlap-add at fused_parsiz_for(firlen) over the
    ``n + firlen/2`` input samples of a time-aligned output.  Splitting
    the FIR into smaller partitions saves transform work but adds as much
    multiply-accumulate work at these FIRs, so this is about the fewest;
    stream_conv's 256-sample partitions take more."""
    from phaserotate_tpu_torch.kernels.fused_conv import fused_parsiz_for

    parsiz = fused_parsiz_for(firlen)
    n_frames = rows * -(-(n + firlen // 2) // parsiz)
    return fused_conv_flops(n_frames, parsiz, mix_ops)


def sweep_flops_per_sample(cs) -> int:
    """The operations per sample the sweep's function needs on the table
    ``cs``: two angles whose cos bits differ only in the sign and whose sin
    bits are equal share both products bit for bit (|p + q| and |q - p|),
    6 operations for the pair; every other angle takes 4 (two products, a
    sum and a running max).  The canonical 360-angle table: 179 x 6 + 8."""
    c, s = cs.cpu().contiguous().numpy().view(np.uint32).tolist()
    waiting: dict = {}
    pairs = 0
    for key in zip(c, s):
        mirror = (key[0] ^ 0x80000000, key[1])
        if waiting.get(mirror):
            waiting[mirror] -= 1
            pairs += 1
        else:
            waiting[key] = waiting.get(key, 0) + 1
    return 6 * pairs + 4 * (len(c) - 2 * pairs)


def sweep_bound(b0, b1, table) -> dict:
    """The sweep's bound on (rows, n) signals with ``table``: both signals,
    the table and the (rows, A) table of peaks moved once, and the
    operations ``sweep_flops_per_sample`` counts for every sample."""
    return bound(nbytes(b0, b1, table) + b0.shape[0] * table.shape[1] * 4,
                 sweep_flops_per_sample(table) * b0.numel())


def sweep_sass(so) -> str:
    """The ``sass:`` lines, a report and not a check: for each
    instantiation of the sweep kernel (``sweep_kernel<K>``, K the general
    map's angles per thread) in ``cuobjdump -sass`` of the built library,
    the FMUL/FADD/FFMA/FMNMX/LOP3/(V)IMNMX/LDS counts (by opcode with its
    modifiers); how many FMNMX take an |operand|; and the same counts
    inside each loop that loads from shared memory (a backward branch and
    the code it spans, an outer loop with its inner ones), longest
    first."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return f"sass: cuobjdump not found ({tool})"
    proc = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode:
        return f"sass: cuobjdump exited {proc.returncode}"
    funcs = [f for f in re.split(r"\n\s*Function : ", proc.stdout)[1:]
             if "sweep_kernel" in f.split("\n", 1)[0]]
    if not funcs:
        return "sass: no sweep_kernel in the library"

    def mix(ops):
        counts: dict = {}
        for _, op, _ in ops:
            if op.split(".")[0] in ("FMUL", "FADD", "FFMA", "FMNMX", "LOP3",
                                    "IMNMX", "VIMNMX", "LDS"):
                counts[op] = counts.get(op, 0) + 1
        return dict(sorted(counts.items()))

    lines = []
    for body in funcs:
        k = re.search(r"sweep_kernelILi(\d+)E", body.split("\n", 1)[0])
        name = f"sweep_kernel<{k.group(1)}>" if k else "sweep_kernel"
        code = [(int(addr, 16), op, args) for addr, op, args in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);",
            body)]
        loops = []
        for addr, op, args in code:
            target = re.match(r"\s*(?:`\()?0x([0-9a-f]+)", args)
            if (op.startswith("BRA") and target
                    and int(target.group(1), 16) < addr):
                span = [c for c in code
                        if int(target.group(1), 16) <= c[0] <= addr]
                if any(c[1].startswith("LDS") for c in span):
                    loops.append(dict(instructions=len(span), **mix(span)))
        loops.sort(key=lambda lp: -lp["instructions"])
        abs_max = sum(1 for _, op, args in code
                      if op.startswith("FMNMX") and "|" in args)
        lines.append(f"sass: {name} {len(code)} instructions, "
                     f"{json.dumps(mix(code))}, FMNMX with an |operand| "
                     f"{abs_max}; loops {json.dumps(loops)}")
    return "\n".join(sorted(lines))


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of one call, CUDA events around ``reps`` calls
    after a warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_split(fn) -> dict:
    """Device ms of each CUDA kernel (and copy) that one warm call of
    ``fn`` runs, from the kernel events of a torch.profiler Chrome trace:
    the kernel's own launches and the wrapper's copies apart.
    ``drive`` takes these right after the main path: late in this script
    the profiler's sessions recorded no device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    split: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            key = e["name"][:60]
            split[key] = split.get(key, 0.0) + e.get("dur", 0) / 1e3
    return split


def framed(x, parsiz: int):
    """(..., n) -> (rows, n_frames, parsiz) with one zero frame past the
    signal, as ``fused_hilbert`` frames it."""
    import torch

    n_f = -(-x.shape[-1] // parsiz) + 1
    return torch.nn.functional.pad(
        x, (0, n_f * parsiz - x.shape[-1])).reshape(-1, n_f, parsiz)


@contextlib.contextmanager
def plain_kernels():
    """Route the paths through the kernels' plain twins (for comparison
    runs only: the main path's counted run never takes this)."""
    import importlib

    from phaserotate_tpu_torch.kernels import fused_conv as fc
    from phaserotate_tpu_torch.kernels import rotate_peak as rp
    from phaserotate_tpu_torch.kernels import stream_conv as sc
    from phaserotate_tpu_torch.search import sweep
    from phaserotate_tpu_torch.stream import engine

    # the package re-exports the function rotate over the module's name
    rot = importlib.import_module("phaserotate_tpu_torch.ops.rotate")

    saved = (sweep.hilbert_small, sweep.rotate_peak_sweep_kernel,
             rot.rotate_small, fc.fused_ola_conv, engine.fused_stream_mix)
    sweep.hilbert_small = sc.hilbert_small_plain
    sweep.rotate_peak_sweep_kernel = (
        lambda b0, b1, cs, tile_len=0: rp.rotate_peak_sweep_plain(b0, b1, cs))
    rot.rotate_small = sc.rotate_small_plain
    fc.fused_ola_conv = fc.fused_ola_conv_plain
    engine.fused_stream_mix = sc.fused_stream_mix_plain
    try:
        yield
    finally:
        (sweep.hilbert_small, sweep.rotate_peak_sweep_kernel,
         rot.rotate_small, fc.fused_ola_conv,
         engine.fused_stream_mix) = saved


def push_blocks(rot, x, block: int, targets=None, save_at=None,
                path=None):
    """Push (C, n) host audio through a streaming rotator in ``block``
    sample blocks; ``targets[i]`` is block i's angle (35 deg if None).
    With ``save_at`` the rotator is checkpointed to ``path`` after that
    many blocks.  Returns the (C, n) output."""
    outs = []
    for i, start in enumerate(range(0, x.shape[1], block)):
        deg = 35.0 if targets is None else targets[i]
        outs.append(rot.process(x[:, start : start + block], deg))
        if save_at is not None and i + 1 == save_at:
            rot.save(path)
    return np.concatenate(outs, axis=1)


def result_angles(text: str):
    return [float(a) for a in re.findall(
        r"^Channel: +\d+ Phase: +(-?[\d.]+) deg", text, re.M)]


def run_cli(args, cwd, module="cli"):
    proc = subprocess.run(
        [sys.executable, "-m", f"phaserotate_tpu_torch.{module}", *args],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"{module} {args[:8]} exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    return proc.stdout, proc.stderr


def analyze_inprocess(cli, path):
    """``cli.main([path])`` with its output captured: the angles."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        check(cli.main([path]) == 0, f"analyze {path}")
    return result_angles(out.getvalue())


def drive_wider_surface(tmp, card, times, audio, src, wav_angles,
                        wav_applied, geom) -> dict:
    """The second counted run: the continuous refinement, the CLI on the
    other containers, the int16 ingest and the profile hook, on the
    4-minute stereo file.  Returns the launch counts of this run."""
    import torch

    from phaserotate_tpu_torch import cli
    from phaserotate_tpu_torch import io as pio
    from phaserotate_tpu_torch.io import native
    from phaserotate_tpu_torch.io.audio import _sniff
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.search import refine_angle, sweep_peaks_aux
    from phaserotate_tpu_torch.search.sweep import sweep_peaks_aux_pcm16

    print(f"native host library available: {native.available()}")
    sync()
    _build.reset_launches()

    # ---- refine_angle: 24 steps from each channel's table argmin ----
    table = sweep_peaks_aux(audio, geom)[0].cpu().numpy()
    refined = []
    with phase("refine_angle_4min", card, times):
        for c in range(audio.shape[0]):
            a0 = int(table[c].argmin())
            before = _build.launches["hilbert_small"]
            refine_angle(audio[c], a0, geom, steps=24)  # first call
            sync()
            t0 = time.perf_counter()
            theta, peak = refine_angle(audio[c], a0, geom, steps=24)
            warm = time.perf_counter() - t0
            check(_build.launches["hilbert_small"] == before + 2,
                  "refine_angle did not launch stream_conv")
            refined.append((c, a0, theta, peak, warm))
    # against the same call on the CPU, on the whole of channel 0
    with phase("refine_angle_4min_ch0_on_the_cpu", card, times):
        cpu_theta, cpu_peak = refine_angle(audio[0], refined[0][1], geom,
                                           steps=24, device="cpu")
    for c, a0, theta, peak, warm in refined:
        grid = float(table[c, a0])
        print(f"refine_angle ch{c}: theta {theta!r} units "
              f"({theta / 2:.4f} deg) peak {peak!r}, grid a0 {a0} peak "
              f"{grid!r}, gain {20 * np.log10(grid / peak):.6f} dB over the "
              f"grid, {warm:.6f} s per warm call [{card}]")
        check(np.isfinite(theta) and np.isfinite(peak), "refined values")
        check(peak <= grid + 1e-6, f"refined peak {peak} above grid {grid}")
        check(abs(theta - a0) < 4, f"refined angle {theta} left {a0}")
    card_theta, card_peak = refined[0][2:4]
    print(f"refine_angle, 4 min of ch0: theta {card_theta!r} peak "
          f"{card_peak!r} on the card, theta {cpu_theta!r} peak {cpu_peak!r} "
          f"on the CPU")
    check(abs(card_peak - cpu_peak) < 2e-5,
          f"refined peak on the card {card_peak} vs the CPU {cpu_peak}")

    # ---- the CLI on other containers than WAV ----
    n_cut = 3 * RATE
    cut_wav = os.path.join(tmp, "cut.wav")
    cut_out = os.path.join(tmp, "cut_out.wav")
    pio.write_wav(cut_wav, audio[:, :n_cut], RATE, bits=16,
                  float_format=False)
    cut_angles = analyze_inprocess(cli, cut_wav)
    cut_spec = ",".join(f"{a:g}" for a in cut_angles)
    check(cli.main(["-a", cut_spec, cut_wav, cut_out]) == 0, "apply cut")
    cut_applied = pio.read_audio(cut_out)[0]
    pcm16 = dict(bits=16, float_format=False)
    cases = (  # kind, writer, its keywords, samples, the WAV run's results
        ("aiff", pio.write_aiff, pcm16, audio, wav_angles, wav_applied),
        ("w64", pio.write_w64, pcm16, audio, wav_angles, wav_applied),
        ("rf64", pio.write_rf64, pcm16, audio, wav_angles, wav_applied),
        ("flac", pio.write_flac, dict(bits=16), audio[:, :n_cut],
         cut_angles, cut_applied))
    with phase("cli_formats_aiff_w64_rf64_4min_flac_3s", card, times):
        for kind, writer, kw, x, want_angles, want_y in cases:
            path = os.path.join(tmp, f"in.{kind}")
            out = os.path.join(tmp, f"out_{kind}")  # no extension
            t0 = time.perf_counter()
            writer(path, x, RATE, **kw)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            back, rate, meta = pio.read_audio(path)
            t_read = time.perf_counter() - t0
            check(rate == RATE and np.array_equal(back, x),
                  f"{kind}: the samples did not come back")
            angles = analyze_inprocess(cli, path)
            check(angles == want_angles,
                  f"{kind}: angles {angles}, the WAV's {want_angles}")
            spec = ",".join(f"{a:g}" for a in angles)
            check(cli.main(["-a", spec, path, out]) == 0, f"apply {kind}")
            check(_sniff(out) == kind, f"{kind}: output is {_sniff(out)}")
            y, y_rate, y_meta = pio.read_audio(out)
            check(y_rate == RATE and y.shape == want_y.shape,
                  f"{kind}: applied file's shape or rate")
            err = float(np.abs(y - want_y).max())
            check(err <= 1.0 / 32768, f"{kind}: applied audio off by {err}")
            print(f"cli {kind} ({x.shape[1] / RATE:g} s stereo, 16 bit, "
                  f"{os.path.getsize(path)} bytes): write {t_write:.6f} s, "
                  f"read {t_read:.6f} s (native "
                  f"{native.available()}); angles equal to the WAV's, "
                  f"applied {y_meta.container} output within {err!r} of the "
                  f"WAV run's [{card}]")

    # ---- the int16 ingest ----
    with phase("sweep_pcm16_4min", card, times):
        x16, rate, _ = pio.read_audio_pcm16(src)
        check(x16.dtype == np.int16 and rate == RATE, "read_audio_pcm16")
        t16, r16 = sweep_peaks_aux_pcm16(x16, geom)
    tf, rf = sweep_peaks_aux(pio.read_audio(src)[0], geom)
    check(t16.device.type == "cuda" and torch.equal(t16, tf)
          and torch.equal(r16, rf),
          "sweep_peaks_aux_pcm16 is not bit-equal to the float path")
    print("sweep_peaks_aux_pcm16: table and rot0 bit-equal to "
          "sweep_peaks_aux of read_audio's floats")

    # ---- the profile hook ----
    trace_dir = os.path.join(tmp, "trace")
    os.environ["PHASEROTATE_TPU_PROFILE"] = trace_dir
    try:
        with phase("cli_profile_hook", card, times):
            check(analyze_inprocess(cli, src) == wav_angles,
                  "angles under the profile hook")
    finally:
        del os.environ["PHASEROTATE_TPU_PROFILE"]
    traces = os.listdir(trace_dir)
    check(len(traces) == 1, f"trace files: {traces}")
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = sorted(k for k in ("sweep_kernel", "stream_runs")
                   if any(k in n for n in names))
    print(f"profile hook: {len(events)} events, "
          f"{os.path.getsize(os.path.join(trace_dir, traces[0]))} bytes, "
          f"{len(names)} kernel names, of the port's: {found}")
    check("sweep_kernel" in found, "the trace lacks sweep_kernel")
    check(len(found) > 1, "the trace lacks a stream_conv kernel")
    sync()
    return dict(_build.launches)


def make_catalogue(tmp: str, rng, dev) -> list:
    """48 stereo 48 kHz 16-bit WAV files from the seed, in two buckets of
    the fleet at blksiz 8192: 40 short ones (bucket of 512 blocks, 87.4 s)
    and 8 of 100-120 s (bucket of 1024 blocks).  Half are at -54 dBFS; the
    loud half carries uniform noise of +-0.25 on top, 16 bits a sample at
    any predictor order.  The fleet zero-pads a file to its bucket and
    zeros pack to nothing, so the 20 loud short files are 80-87 s (they
    fill their bucket, and a batch of them ships as pcm16 under ``auto``)
    and the quiet ones 50-80 s; in path order, loud before quiet.  Files 0
    and 20 also get a 16-bit AIFF copy, at the end of the list.  Returns
    the paths."""
    import torch

    from phaserotate_tpu_torch.io import write_aiff, write_wav

    groups = (  # name, files, seconds of the loud half, of the quiet half
        ("short", 40, (80.0, 87.0), (50.0, 80.0)),
        ("long", 8, (100.0, 120.0), (100.0, 120.0)))
    paths, copies = [], []
    pcm16 = dict(bits=16, float_format=False)
    for name, files, loud_s, quiet_s in groups:
        secs = np.concatenate([rng.uniform(*loud_s, files // 2),
                               rng.uniform(*quiet_s, files // 2)])
        n_max = int(secs.max() * RATE) + 1
        audio = music_batch(rng, (files, 2), n_max, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + files)
        audio[: files // 2] += 0.5 * torch.rand(
            (files // 2, 2, n_max), generator=gen, device=dev) - 0.25
        audio[files // 2 :] *= 10.0 ** (-54.0 / 20.0)
        audio = audio.cpu().numpy()
        for i in range(files):
            x = audio[i, :, : int(secs[i] * RATE)]
            path = os.path.join(tmp, f"{name}{i:02d}.wav")
            write_wav(path, x, RATE, **pcm16)
            paths.append(path)
            if name == "short" and i in (0, files // 2):
                copy = os.path.join(tmp, f"{name}{i:02d}.aiff")
                write_aiff(copy, x, RATE, **pcm16)
                copies.append(copy)
        del audio
    return paths + copies


def staging_breakdown(paths, geom, dev, card: str, label: str) -> None:
    """Where one fleet batch's time goes, step by step with a device
    synchronize after each: decode, pack, copy, unpack, sweep, selection.
    The fleet overlaps the first two with the rest; here they run in
    turn.  Then the batch's two kernels against their plain twins at this
    shape, zero-padded tails included: ``hilbert_small`` within 1e-5, the
    sweep table bit-equal."""
    import torch

    from phaserotate_tpu_torch.core.angles import all_angle_cos_sin
    from phaserotate_tpu_torch.fleet import _bucket_key, _probe
    from phaserotate_tpu_torch.io import read_audio_pcm16
    from phaserotate_tpu_torch.search import select_min_peak_angles_batch
    from phaserotate_tpu_torch.search.packed import (
        pack_adaptive, pack_residual, packed_bits_per_sample,
        unpack_residual)
    from phaserotate_tpu_torch.kernels import stream_conv as sc
    from phaserotate_tpu_torch.kernels.rotate_peak import (
        rotate_peak_sweep_kernel, rotate_peak_sweep_plain)
    from phaserotate_tpu_torch.search.sweep import _sweep_impl, aligned_pair

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    n_pad = max(_bucket_key(*_probe(p), geom.parsiz)[2] for p in paths)

    def decode():
        buf = np.zeros((len(paths), 2, n_pad), np.int16)
        for i, p in enumerate(paths):
            audio = read_audio_pcm16(p)[0]
            buf[i, :, : audio.shape[1]] = audio
        return buf

    buf, t_decode = timed(decode)
    pk, t_pack = timed(lambda: pack_residual(buf))
    scratch = np.empty(max(1 << 16, buf.size * 16 // 32), np.int32)
    adaptive, t_adaptive = timed(lambda: pack_adaptive(buf, scratch))
    x16, t_copy16 = timed(lambda: torch.as_tensor(buf, device=dev))
    parts, t_copy_pk = timed(lambda: [
        torch.as_tensor(a, device=dev)
        for a in (pk.words, pk.widths, pk.woffs, pk.order)])
    x_pk, t_unpack = timed(lambda: unpack_residual(*parts, pk.n))
    x_16, t_dequant = timed(
        lambda: x16.to(torch.float32) * (1.0 / 32768.0))
    check(torch.equal(x_pk.reshape(buf.shape), x_16),
          f"{label}: the unpack and the int16 samples differ")
    (table, rot0), t_sweep = timed(lambda: _sweep_impl(x_16, geom, 4096))
    _, t_select = timed(lambda: select_min_peak_angles_batch(
        table.cpu().numpy(), rot0=rot0.cpu().numpy()))
    print(f"fleet batch {label} ({len(paths)} files x 2 x {n_pad} samples, "
          f"{buf.nbytes} bytes as pcm16; packed {pk.wire_bytes} bytes, "
          f"{packed_bits_per_sample(pk):.4f} bits/sample; auto ships "
          f"{'packed' if adaptive is not None else 'pcm16'}): "
          f"decode {t_decode:.6f} s, pack {t_pack:.6f} s (adaptive "
          f"{t_adaptive:.6f} s), copy pcm16 {t_copy16:.6f} s / packed "
          f"{t_copy_pk:.6f} s, unpack {t_unpack:.6f} s (dequantize int16 "
          f"{t_dequant:.6f} s), sweep {t_sweep:.6f} s, selection and "
          f"readback {t_select:.6f} s [{card}]")
    del x_pk, x16, parts, table, rot0
    conv_err = float((sc.hilbert_small(x_16, geom.parsiz)
                      - sc.hilbert_small_plain(x_16, geom.parsiz)
                      ).abs().max())
    check(conv_err < 1e-5, f"{label}: hilbert_small vs plain: {conv_err}")
    b0, b1, _, _ = aligned_pair(x_16, geom)
    cs = all_angle_cos_sin(dev)
    got = rotate_peak_sweep_kernel(b0, b1, cs)
    want, t_plain = timed(lambda: rotate_peak_sweep_plain(b0, b1, cs))
    check(torch.equal(got, want),
          f"{label}: sweep table not bit-equal to the plain twin's")
    print(f"fleet batch {label} {tuple(x_16.shape)}: hilbert_small vs plain "
          f"max err {conv_err!r}; sweep table bit-equal to the plain twin "
          f"(plain sweep {t_plain:.6f} s)")


def ring_copy_rate(dev, card: str, times: dict) -> None:
    """The fleet's host-to-device rate from a pinned slot of its staging
    ring, at the 96 kHz catalogue's longest batch (8 x 2 x 2^26 frames of
    pcm24, 3.2 GB), copied as ``fleet.analyze_paths`` copies it (one
    non-blocking copy and an event), beside the pageable rate of the same
    payload (``torch.as_tensor`` of a numpy array, what a call's own ring
    in plain host memory costs); the best of three each, and the time the
    dispatch thread is held by the ring's copy.  The pinned allocator's
    bytes (active and cached) follow the ring's."""
    import torch

    from phaserotate_tpu_torch import fleet as pfleet

    key = (96000, 2, 1 << 26, 24)
    shape = (8, 1 << 26, 2, 3)
    nbytes = int(np.prod(shape))
    ring = pfleet._RING
    with ring.lock, phase("fleet_ring_copy_3_2_GB", card, times):
        t0 = time.perf_counter()
        ring.reserve(pfleet._slot_bytes(key, 8, "auto"), pinned=True)
        reserve_s = time.perf_counter() - t0
        slot = ring.take()
        buf = slot.view(0, shape, np.uint8)
        buf.fill(0x5A)
        buf[-1, -1, -1] = 0xA5
        page = buf.copy()
        rates = {"pinned": [], "pageable": []}
        held = []
        for _ in range(3):
            for kind in ("pinned", "pageable"):
                sync()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                if kind == "pinned":
                    got = slot.send([buf], dev)[0]
                    held.append(time.perf_counter() - t0)
                else:
                    got = torch.as_tensor(page, device=dev)
                end.record()
                sync()
                rates[kind].append(nbytes / start.elapsed_time(end) / 1e6)
                check(tuple(got.shape) == shape
                      and int(got[-1, -1, -1, -1]) == 0xA5
                      and int(got[0, 0, 0, 0]) == 0x5A,
                      f"the {kind} copy of the ring's payload differs")
                del got
        slot.wait()
        del page
    stats = getattr(torch.cuda, "host_memory_stats", dict)()
    held_pinned = stats.get("allocated_bytes.current")
    print(f"fleet ring: host-to-device {max(rates['pinned'])!r} GB/s from a "
          f"pinned slot ({min(held) * 1e3!r} ms on the dispatch thread) vs "
          f"{max(rates['pageable'])!r} GB/s pageable, {nbytes} bytes (8 x 2 "
          f"x 2^26 frames of pcm24); ring pinned {ring.pinned}, "
          f"{len(ring.slots)} slots of {ring.nbytes} bytes (reserved in "
          f"{reserve_s!r} s), the pinned allocator holding {held_pinned} "
          f"[{card}]")


def drive_hires192(tmp, dev, card: str, times: dict, kernels: list) -> None:
    """blksiz 32768 (176.4 / 192 kHz) on the card: ``hilbert_32k`` held to
    its plain twin at the longest batch of ``search.cli_192k24.resident32``'s
    shape with the fleet's batch of 8 (16 rows x 2^27 samples; the twin
    on as many rows at a time as fit), its kernel entry; then
    three stereo 24-bit 192 kHz WAVs from the seed through
    ``fleet.analyze_paths`` and one through the CLI (``cli.main``),
    tables within the judge's 1e-4 of the benchmark's float64 reference
    (``benchmark/reference/offline.py``) and its angles."""
    import torch

    from phaserotate_tpu_torch import fleet as pfleet
    from phaserotate_tpu_torch.io import write_wav
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.kernels import hilbert32k as hk

    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from reference.offline import peak_table, select_angles

    torch.cuda.empty_cache()
    rows, n = 16, 4096 * hk.BLKSIZ
    gen = torch.Generator(device=dev).manual_seed(SEED + 192)
    x = torch.randn((rows, n), generator=gen, device=dev).mul_(0.25)
    x.clamp_(-1.0, 1.0).mul_(1 << 23).round_().div_(1 << 23)
    before = _build.launches["hilbert_32k"]
    with phase("hilbert_32k_16x2^27", card, times):
        got = hk.hilbert_32k(x)
    checks = _build.launches["hilbert_32k"] - before
    plain_rows = rows
    while True:  # the twin on as many rows at a time as its transients allow
        try:
            err = max(float((got[r : r + plain_rows] - hk.hilbert_32k_plain(
                x[r : r + plain_rows])).abs().max())
                for r in range(0, rows, plain_rows))
            break
        except torch.OutOfMemoryError:
            check(plain_rows > 1, "hilbert_32k_plain does not fit one row")
        plain_rows //= 2  # outside the handler, which holds the transients
        torch.cuda.empty_cache()
    print(f"hilbert_32k {rows} x {n}: max err against the plain twin "
          f"{err!r}; the twin ran on {plain_rows} rows at a time")
    check(err < 1e-5, f"hilbert_32k vs plain: {err}")
    del got
    geo = hk.kernel_geometry(dev)
    kernel_ms = cuda_ms(lambda: hk.hilbert_32k(x), 3)
    part = x[:plain_rows]
    plain_ms = cuda_ms(lambda: hk.hilbert_32k_plain(part), 1)
    entry = dict(
        name="hilbert_32k", route="cuda",
        source="phaserotate_tpu_torch/csrc/hilbert32k.cu", replaces=None,
        launches=0, check_launches=checks, max_abs_err=err,
        shape=[rows, n], ms=kernel_ms,
        plain_ms=plain_ms, plain_rows=plain_rows,
        ms_at_plain_rows=cuda_ms(lambda: hk.hilbert_32k(part), 3),
        **bound(4.0 * rows * (n + hk.out_len(n)),
                fir_conv_flops(rows, n, hk.BLKSIZ, 0)),
        library_ms=plain_ms, grid_clusters=geo["clusters"],
        registers=geo["registers"], local_bytes=geo["local_bytes"])
    kernels.append(entry)
    print(f"hilbert_32k: {json.dumps(entry)} [{card}]")
    del x, part
    torch.cuda.empty_cache()

    rate = 192000
    rng = np.random.default_rng(SEED + 1920)
    hires = os.path.join(tmp, "hires192")
    os.makedirs(hires)
    paths, ints = [], {}
    for i, secs in enumerate((6.3, 11.1, 2.7)):  # three buckets
        x = music_like(rng, 2, int(secs * rate))
        q = np.rint(x / np.abs(x).max() * 0.95 * (1 << 23))
        path = os.path.join(hires, f"m{i}.wav")
        write_wav(path, (q / (1 << 23)).astype(np.float32), rate, bits=24,
                  float_format=False)
        paths.append(path)
        ints[path] = q
    tables = {}
    select = pfleet.select_min_peak_angles_batch
    order = []

    def capture(t, *a, **kw):
        for row, r0 in zip(t, kw["rot0"]):
            tables[len(tables)] = (np.array(row), np.array(r0))
        return select(t, *a, **kw)

    _build.reset_launches()
    pfleet.select_min_peak_angles_batch = capture
    try:
        with phase("fleet_analyze_192k24_3_files", card, times):
            res = pfleet.analyze_paths(
                paths, batch=8,
                progress=lambda p, r, cached: order.append(p))
    finally:
        pfleet.select_min_peak_angles_batch = select
    check(_build.launches["hilbert_32k"] > 0
          and _build.launches["pcm24_widen"] > 0
          and _build.launches["hilbert_small"] == 0,
          f"the 192 kHz fleet run's launches: {dict(_build.launches)}")
    worst = 0.0
    for k, path in enumerate(order):
        table, rot0 = tables[k]
        ref_table, ref_rot0 = peak_table(
            torch.from_numpy(ints[path] / (1 << 23)).to(dev), 32768)
        scale = ref_table.max(axis=-1)
        gap = max(float((np.abs(table - ref_table).max(axis=-1)
                         / scale).max()),
                  float((np.abs(rot0 - ref_rot0) / scale).max()))
        worst = max(worst, gap)
        want = select_angles(ref_table[None], ref_rot0[None], 24, False)[0]
        check(gap < 1e-4, f"{path}: table gap {gap} against the reference")
        check(np.array_equal(table[:, 0], ref_table[:, 0]),
              f"{path}: angle 0 is not the exact input peak")
        check(list(res[path][0].angles_units) == list(want["units"]),
              f"{path}: angles {res[path][0].angles_units} against the "
              f"reference's {want['units']}")
        if path == paths[0]:
            cli_want = [u / 2 if f else 0.0
                        for u, f in zip(want["units"], want["found"])]
    from phaserotate_tpu_torch import cli

    cli_got = analyze_inprocess(cli, paths[0])
    check(cli_got == cli_want,
          f"phase-rotate-torch on a 192 kHz file: {cli_got} against the "
          f"reference's {cli_want}")
    entry["launches"] = _build.launches["hilbert_32k"]
    print(f"fleet 192 kHz 24-bit: {len(paths)} files, tables within "
          f"{worst!r} of the float64 reference (limit 1e-4), angles the "
          f"reference's; hilbert_32k launches {_build.launches['hilbert_32k']}"
          f"; the CLI's angles {cli_got} deg [{card}]")


def drive_catalogue(tmp, dev, card, times, x4, fleet, stems, stem_degs,
                    geom) -> dict:
    """The third counted run: the fleet front end over a catalogue on
    disk, and the ``parallel`` package on meshes that name the one card
    several times over.  Returns this run's launch counts, with the
    general-map launches of the angle-sharded sweeps under
    ``rotate_peak_sweep_general``."""
    import torch

    from phaserotate_tpu_torch import fleet as pfleet
    from phaserotate_tpu_torch import rotate
    from phaserotate_tpu_torch.io import read_audio, write_wav
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.parallel import (
        angle_sharded_sweep_peaks, batch_find_min_peak_angles, batch_rotate,
        batch_sweep_peaks, file_mesh, grid_mesh, sharded_rotate,
        sharded_sweep_peaks)
    from phaserotate_tpu_torch.search import (
        find_min_peak_angle, select_min_peak_angles_batch, sweep_peaks_aux)
    from phaserotate_tpu_torch.utils.profiling import (CountRecord, drain,
                                                       recording)

    rng = np.random.default_rng(SEED + 9)
    cat = os.path.join(tmp, "catalogue")
    os.makedirs(cat)
    t0 = time.perf_counter()
    paths = make_catalogue(cat, rng, dev)
    n_bytes = sum(os.path.getsize(p) for p in paths)
    audio_s = sum(pfleet._probe(p)[2] for p in paths) / RATE
    print(f"catalogue: {len(paths)} files, {n_bytes} bytes, "
          f"{audio_s:.1f} s of stereo audio, made in "
          f"{time.perf_counter() - t0:.6f} s")
    batch = 8
    sync()
    _build.reset_launches()

    # ---- the fleet CLI as a user runs it (subprocesses) ----
    ck_cli = os.path.join(tmp, "fleet_cli.npz")
    # pcm16 by name (the fleet_analyze phases below time all three
    # transports)
    flags = ["--batch", str(batch), "--checkpoint", ck_cli,
             "--transport", "pcm16"]
    with phase("fleet_cli_analyze_subprocess", card, times):
        cli_out, _ = run_cli(flags + paths, REPO, module="fleet")
    shown = re.findall(r"^(\S+)  ch (\d): (?:([+-][\d.]+) deg|no improvement)"
                       r"(  \(cached sweep\))?$", cli_out, re.M)
    check(len(shown) == 2 * len(paths) == len(cli_out.splitlines()),
          f"fleet CLI printed {len(shown)} result lines")
    check(not any(cached for *_, cached in shown),
          "the first fleet run hit a checkpoint")
    cli_angles = {}
    for path, _, deg, _ in shown:
        cli_angles.setdefault(path, []).append(float(deg or 0.0))

    # the second run, in this process so that its launches can be read
    before = dict(_build.launches)
    out = io.StringIO()
    with phase("fleet_cli_cached_inprocess", card, times), \
            contextlib.redirect_stdout(out):
        check(pfleet.main(flags + paths) == 0, "cached fleet run")
    lines = out.getvalue().splitlines()
    check(len(lines) == 2 * len(paths)
          and all(ln.endswith("  (cached sweep)") for ln in lines),
          "the second fleet run did not serve every file from the checkpoint")
    # the first run prints bucket by bucket, the cached one in path order
    check(sorted(ln.replace("  (cached sweep)", "") for ln in lines)
          == sorted(cli_out.splitlines()),
          "cached fleet run printed other angles")
    check(dict(_build.launches) == before,
          "the cached fleet run launched a kernel")

    applied = paths[:3] + paths[20:23] + paths[-2:]
    outdir = os.path.join(tmp, "fleet_out")
    # without --checkpoint and --transport: the analysis runs again, on
    # the default transport (auto), as a user's first call does
    with phase("fleet_cli_apply_subprocess_8_files", card, times):
        apply_out, apply_err = run_cli(
            ["--batch", str(batch), "--apply", "--outdir", outdir] + applied,
            REPO, module="fleet")
    check(apply_err.count("wrote ") == len(applied), "fleet --apply output")
    check(sorted(apply_out.splitlines())
          == sorted(ln for ln in cli_out.splitlines()
                    if ln.split("  ch ")[0] in applied),
          "the fleet CLI on the default transport printed other angles")

    # ---- analyze_paths in this process, once per transport ----
    results, tables = {}, {}
    for transport in ("pcm16", "packed", "auto"):
        ck = os.path.join(tmp, f"fleet_{transport}.npz")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        drain()
        with recording(), phase(f"fleet_analyze_{transport}", card, times):
            results[transport] = pfleet.analyze_paths(
                paths, batch=batch, checkpoint=ck, transport=transport)
        peak = torch.cuda.max_memory_allocated()
        with np.load(ck) as z:
            tables[transport] = {k: z[k] for k in z.files}
        wall = times[f"fleet_analyze_{transport}"]
        # what each batch shipped, from the fleet's own spans and counters
        counted: dict = {}
        kinds = []
        for r in drain():
            if isinstance(r, CountRecord):
                counted.setdefault(r.name, []).append(r.n)
            elif r.name == "fleet.pack":
                kinds.append(r.attrs["transport"])
        wire = sum(counted["fleet.wire_bytes"])
        samples = sum(counted["fleet.pcm16_bytes"]) // 2
        print(f"fleet analyze {transport}: {len(paths) / wall:.2f} files/s, "
              f"{audio_s / wall:.1f}x realtime, {wall:.6f} s; "
              f"{len(kinds)} batches ({kinds.count('packed')} packed, "
              f"{kinds.count('pcm16')} pcm16), decode threads "
              f"{counted['fleet.decode_workers']}, pack workers "
              f"{counted.get('packed.pack_workers', [])}, {wire} wire bytes, "
              f"{8.0 * wire / samples:.4f} bits/sample of the padded batch; "
              f"peak device memory {peak} bytes ({peak - base} above the "
              f"{base} held before) [{card}]")
        if transport == "auto":
            check(0 < kinds.count("packed") < len(kinds),
                  f"auto shipped {kinds}: not both kinds of batch")
    with np.load(ck_cli) as z:
        tables["cli"] = {k: z[k] for k in z.files}
    for transport in ("packed", "auto", "cli"):
        check(tables[transport].keys() == tables["pcm16"].keys()
              and all(np.array_equal(tables[transport][k], v)
                      for k, v in tables["pcm16"].items()),
              f"fleet tables of {transport} differ from pcm16's")
        if transport != "cli":
            check(all(results[transport][p][0].angles_units
                      == results["pcm16"][p][0].angles_units for p in paths),
                  f"fleet angles of {transport} differ from pcm16's")
    for p in paths:
        check(list(results["pcm16"][p][0].angles_deg) == cli_angles[p],
              f"fleet CLI and analyze_paths differ on {p}")
    for wav, copy in zip((paths[0], paths[20]), paths[-2:]):
        check(results["pcm16"][wav][0].angles_units
              == results["pcm16"][copy][0].angles_units,
              f"{copy}: other angles than its WAV twin")
    print(f"fleet: tables of pcm16, packed, auto and the CLI run "
          f"np.array_equal over {len(paths)} files; angles equal")
    # 24-bit copies of eight 16-bit files, every sample given a random low
    # byte: the exact read, the pcm24 wire and the widen kernel must hand
    # the sweep the files' own samples, so the fleet's tables equal
    # sweep_peaks_aux's on those float samples padded as the fleet pads
    low = np.random.default_rng(SEED + 24)
    deep, deep_x = [], []
    for p in paths[:8]:
        audio, rate, _ = read_audio(p)
        q = np.rint(audio.astype(np.float64) * (1 << 23)) + low.integers(
            -128, 128, audio.shape)
        x24 = (np.clip(q, -(1 << 23), (1 << 23) - 1) / (1 << 23)).astype(
            np.float32)
        deep.append(os.path.join(tmp, "deep_" + os.path.basename(p)))
        write_wav(deep[-1], x24, rate, bits=24, float_format=False)
        check(np.array_equal(read_audio(deep[-1])[0], x24),
              f"{deep[-1]}: the 24-bit file does not read back exactly")
        deep_x.append(x24)
    lows = np.concatenate([(np.rint(x * (1 << 23)).astype(np.int64) & 255)
                           .ravel() for x in deep_x])
    check(np.count_nonzero(lows) > 0.99 * lows.size,
          "the 24-bit copies' low bytes are mostly zero")
    deep_tables, deep_order = [], []
    select = pfleet.select_min_peak_angles_batch

    def capture(t, *a, **kw):
        deep_tables.extend(np.array(row) for row in t)
        return select(t, *a, **kw)

    taken = []
    take = pfleet._StagingRing.take

    def take_logged(ring):
        taken.append((ring, ring.pinned))
        return take(ring)

    drain()
    pfleet.select_min_peak_angles_batch = capture
    pfleet._StagingRing.take = take_logged
    try:
        with recording(), phase("fleet_analyze_pcm24_8_files", card, times):
            pfleet.analyze_paths(
                deep, batch=batch,
                progress=lambda p, r, cached: deep_order.append(p))
    finally:
        pfleet.select_min_peak_angles_batch = select
        pfleet._StagingRing.take = take
    records = drain()
    kinds = [r.attrs["transport"] for r in records if r.name == "fleet.pack"]
    check(kinds == ["pcm24"], f"the 24-bit copies shipped {kinds}")
    wire = sum(r.n for r in records if isinstance(r, CountRecord)
               and r.name == "fleet.wire_bytes")
    key = pfleet._bucket_key(RATE, 2, max(x.shape[1] for x in deep_x),
                             24, geom.parsiz)
    check(taken == [(pfleet._RING, True)] * len(kinds)
          and wire <= pfleet._slot_bytes(key, len(deep), "auto")
          <= pfleet._RING.nbytes,
          f"the 24-bit copies did not all ship from a pinned slot of the "
          f"process's ring: {len(taken)} slots taken for {len(kinds)} "
          f"batches, pinned {[pinned for _, pinned in taken]}, {wire} wire "
          f"bytes, slots of {pfleet._RING.nbytes} bytes")
    ring_copy_rate(dev, card, times)
    n_pad = key[2]
    x_pad = np.zeros((len(deep), 2, n_pad), np.float32)
    for i, x in enumerate(deep_x):
        x_pad[i, :, : x.shape[1]] = x
    want, _ = sweep_peaks_aux(torch.from_numpy(x_pad).to(dev), geom)
    want = want.cpu().numpy()
    got = dict(zip(deep_order, deep_tables))
    for i, d in enumerate(deep):
        check(np.array_equal(got[d], want[i]),
              f"{d}: the 24-bit fleet's table differs from sweep_peaks_aux's "
              "on the same samples")
        check(np.array_equal(got[d][:, 0], np.abs(deep_x[i]).max(axis=-1)),
              f"{d}: angle 0 is not the exact input peak")
    print(f"fleet: 8 24-bit copies with random low bytes ({n_pad} frames "
          "padded; pcm24 wire, pcm24_widen): tables np.array_equal to "
          "sweep_peaks_aux on the same float samples, angle 0 the exact "
          "input peak")
    with phase("fleet_per_file_search_6_files", card, times):
        for p in applied[:6]:
            audio, rate, _ = read_audio(p)
            want = find_min_peak_angle(audio, rate=rate)
            check(results["pcm16"][p][0].angles_units == want.angles_units,
                  f"fleet vs find_min_peak_angle on {p}")
    single = os.path.join(tmp, "fleet_single")
    os.makedirs(single)
    apply_err = 0.0
    with phase("fleet_apply_one_6_files", card, times):
        for p in applied[:6]:
            one = pfleet._apply_one(p, single, results["pcm16"][p][0], 0)
            got = read_audio(os.path.join(outdir, os.path.basename(p)))[0]
            apply_err = max(apply_err, float(
                np.abs(got - read_audio(one)[0]).max()))
    print(f"fleet --apply vs _apply_one (6 files): max err {apply_err!r}")
    check(apply_err < 1e-6, "batched apply vs per-file apply")
    moved = sum(any(results["pcm16"][p][0].angles_units) for p in paths)
    print(f"fleet: {moved} of {len(paths)} files with a nonzero angle; 6 "
          f"equal to find_min_peak_angle")

    # ---- the mesh on the card: one device, several mesh positions ----
    mesh4 = file_mesh(devices=[dev] * 4)
    mesh22 = grid_mesh(2, 2, devices=[dev] * 4)
    want_t, want_r = sweep_peaks_aux(x4, geom)
    with phase("sharded_sweep_4min_mono_4_shards", card, times):
        p1, r1 = sharded_sweep_peaks(x4[0], geom, mesh4, axis="files")
    with phase("sharded_sweep_4min_stereo_2x2", card, times):
        p2, r2 = sharded_sweep_peaks(x4, geom, mesh22, axis="samples",
                                     file_axis="files")
    err = max(float((p1 - want_t[0]).abs().max()),
              float((r1 - want_r[0]).abs().max()),
              float((p2 - want_t).abs().max()),
              float((r2 - want_r).abs().max()))
    print(f"sharded_sweep_peaks (4 sample shards; 2 x 2) vs "
          f"sweep_peaks_aux: max err {err!r}")
    check(err < 2e-5, "sample-sharded sweep vs the unsharded sweep")
    before = _build.launches["rotate_peak_sweep"]
    for shards, mesh in ((3, file_mesh(3, devices=[dev] * 3)), (4, mesh4)):
        with phase(f"angle_sharded_sweep_4min_stereo_{shards}_shards", card,
                   times):
            pa, ra = angle_sharded_sweep_peaks(x4, geom, mesh)
        check(torch.equal(pa, want_t) and torch.equal(ra, want_r),
              f"angle-sharded sweep on {shards} shards is not bit-equal to "
              f"the unsharded sweep")
    general = _build.launches["rotate_peak_sweep"] - before
    fleet_t, fleet_r = sweep_peaks_aux(fleet, geom)
    with phase("batch_sweep_64x2x10s_4_shards", card, times):
        bt, br = batch_sweep_peaks(fleet, geom, mesh4)
    check(torch.equal(bt, fleet_t) and torch.equal(br, fleet_r),
          "files-sharded sweep is not bit-equal to the unsharded sweep")
    fleet_host = fleet.cpu().numpy()
    with phase("batch_find_min_64x2x10s_24_files_per_call", card, times):
        found = batch_find_min_peak_angles(fleet_host, geom, mesh4,
                                           max_files_per_call=24)
    want_found = select_min_peak_angles_batch(
        fleet_t.cpu().numpy(), rot0=fleet_r.cpu().numpy())
    check([r.angles_units for r in found]
          == [r.angles_units for r in want_found],
          "batch_find_min_peak_angles vs the unsharded search")
    del fleet_host
    want_y = rotate(stems, stem_degs, method="fir").cpu()
    with phase("batch_rotate_64x60s_4_shards", card, times):
        by = batch_rotate(stems, stem_degs, mesh4)
    rot_err = float((by - want_y).abs().max())
    del by, want_y
    want_y = rotate(x4, [35.0, -120.0], method="fir", firlen=3072).cpu()
    with phase("sharded_rotate_4min_stereo_2x2", card, times):
        sy = sharded_rotate(x4, [35.0, -120.0], mesh22, firlen=3072,
                            axis="samples", file_axis="files")
    srot_err = float((sy - want_y).abs().max())
    print(f"batch_rotate 64x60 s and sharded_rotate 2 x 4 min vs rotate_fir: "
          f"max err {rot_err!r}, {srot_err!r}")
    check(rot_err < 1e-5 and srot_err < 1e-5 and sy.device.type == "cpu",
          "sharded rotations vs rotate_fir")
    check(file_mesh().shape == {"files": torch.cuda.device_count()},
          "file_mesh() does not span the visible cards")
    try:
        file_mesh(torch.cuda.device_count() + 1)
    except ValueError:
        pass
    else:
        check(False, "file_mesh asked for more cards than there are")
    print("parallel: angle and files sharding bit-equal to the unsharded "
          "sweep; chunked fleet search equal; file_mesh() spans "
          f"{torch.cuda.device_count()} card(s) and raises beyond")
    sync()
    counts = dict(_build.launches)
    counts["rotate_peak_sweep"] -= general
    counts["rotate_peak_sweep_general"] = general
    # after the counts are read: these launches compare and time, they are
    # not the fleet's own
    for label, first in (("loud short", 0), ("quiet short", 24),
                         ("long", 40)):
        staging_breakdown(paths[first : first + batch], geom, dev, card,
                          label)
    host_packers(dev, card, times)
    return counts


def host_packers(dev, card: str, times: dict) -> None:
    """One catalogue-sized batch, 8 stereo songs of 200-340 s made from
    the seed and zero-padded to the fleet's bucket of 2^24 samples, packed
    by the port's host packer (``pack_adaptive`` into a fresh scratch, as
    the fleet calls it) and by ``native/wire_pack.cc``: the same words,
    widths, offsets and orders.  Prints both packers' MB/s of pcm16 and
    the workers the port's ran on (its ``packed.pack_workers``)."""
    import torch

    from phaserotate_tpu_torch.io import native
    from phaserotate_tpu_torch.search.packed import _grid_pad, pack_adaptive
    from phaserotate_tpu_torch.utils.profiling import (CountRecord, drain,
                                                       recording)

    rng = np.random.default_rng(SEED + 17)
    n_pad = 1 << 24
    buf = np.zeros((8, 2, n_pad), np.int16)
    for i, secs in enumerate(np.linspace(200.0, 340.0, 8)):
        n = int(secs * RATE)
        x = music_batch(rng, (2,), n, dev)
        x *= 0.9 / x.abs().max()
        buf[i, :, :n] = torch.round(x * 32767.0).to(torch.int16).cpu().numpy()
        del x
    streams = buf.reshape(-1, n_pad)
    S, nb = streams.shape[0], n_pad // 4096
    words = np.empty(_grid_pad(S * nb * 2048 + 1), np.int32)
    widths = np.empty((S, nb), np.int32)
    woffs = np.empty((S, nb), np.int32)
    order = np.empty(S, np.int32)
    t0 = time.perf_counter()
    total = native.pack_residual_raw(streams, words, widths, woffs, order)
    t_cc = time.perf_counter() - t0
    check(total > 0, "native/wire_pack.cc did not pack")
    words = words[: _grid_pad(total + 1)]
    words[total:] = 0
    drain()
    with recording():
        scratch = np.empty(max(1 << 16, buf.size * 16 // 32), np.int32)
        t0 = time.perf_counter()
        pk = pack_adaptive(buf, scratch)
        t_port = time.perf_counter() - t0
    workers = [r.n for r in drain() if isinstance(r, CountRecord)
               and r.name == "packed.pack_workers"]
    check(pk is not None, "the port's packer shipped pcm16")
    check(len(workers) == 1, f"packed.pack_workers counted {workers}")
    check(all(np.array_equal(a, b) for a, b in zip(
        (pk.words, pk.widths, pk.woffs, pk.order),
        (words, widths, woffs, order))),
        "the host packers' wires differ")
    times["host_pack_batch"] = t_port
    mb = buf.nbytes / 1e6
    print(f"host packers, one batch {buf.shape} ({buf.nbytes} bytes of "
          f"pcm16, {pk.wire_bytes} packed), the same words: "
          f"native/wire_pack.cc {t_cc:.6f} s, {mb / t_cc:.1f} MB/s; the "
          f"port's {t_port:.6f} s, {mb / t_port:.1f} MB/s on {workers[0]} "
          f"workers of {len(os.sched_getaffinity(0))} CPUs [{card}]")


SERVE_SESSIONS = 8   # batched prt_bridge sessions on the first daemon
SERVE_SECONDS = 5    # of stereo audio each
SERVE_BLOCK = 1024   # host block of every client
SOLO_SECONDS = 3     # the Python client's and the unbatched sessions'


class ServeLog:
    """What the daemon's sessions did, recorded by wrapping
    ``bridge._Session`` and ``measure_dispatch_rtt_stats`` for this run
    (the daemon keeps no such record): every session made, the host time
    of each PROC it served, and the round trips the daemon measured."""

    def __init__(self, bridge):
        import threading

        self.sessions: list = []
        self.calls: dict = {}
        self.rtts: list = []
        self.cv = threading.Condition()
        self._bridge = bridge
        self._saved = (bridge._Session.__init__, bridge._Session.process,
                       bridge.measure_dispatch_rtt_stats)
        init, process, rtt = self._saved
        log = self

        def logged_init(s, *a, **kw):
            init(s, *a, **kw)
            with log.cv:
                log.calls[id(s)] = []
                log.sessions.append(s)
                log.cv.notify_all()

        def logged_process(s, n, angles, samples):
            t0 = time.perf_counter()
            out = process(s, n, angles, samples)
            log.calls[id(s)].append((t0, time.perf_counter(), n))
            return out

        def logged_rtt(*a, **kw):
            log.rtts.append(rtt(*a, **kw))
            return log.rtts[-1]

        bridge._Session.__init__ = logged_init
        bridge._Session.process = logged_process
        bridge.measure_dispatch_rtt_stats = logged_rtt

    def restore(self):
        b = self._bridge
        (b._Session.__init__, b._Session.process,
         b.measure_dispatch_rtt_stats) = self._saved

    def wait_sessions(self, n: int, timeout: float = 300.0):
        with self.cv:
            check(self.cv.wait_for(lambda: len(self.sessions) >= n, timeout),
                  f"only {len(self.sessions)} of {n} sessions connected")

    def stats(self, session) -> dict:
        calls = self.calls[id(session)]
        ms = [1e3 * (b - a) for a, b, _ in calls]
        wall = calls[-1][1] - calls[0][0]
        return dict(blocks=len(calls),
                    xrt=sum(n for *_, n in calls) / RATE / wall,
                    p50=float(np.percentile(ms, 50)),
                    p99=float(np.percentile(ms, 99)))


def start_daemon(bridge, sock: str, **kw) -> None:
    """``bridge.serve(sock, **kw)`` in a daemon thread of this process (its
    launches count here); returns once it listens."""
    import select
    import threading

    r, w = os.pipe()
    failed: list = []

    def run():
        try:
            bridge.serve(sock, ready_fd=w, **kw)
        except BaseException as e:
            failed.append(e)
            os.write(w, b"E")  # the waiting main thread learns at once
            raise

    threading.Thread(target=run, daemon=True).start()
    ready, _, _ = select.select([r], [], [], 300)
    check(bool(ready) and os.read(r, 1) == b"R",
          f"daemon {kw} did not start: {failed}")
    os.close(r)


def prt_bridge_run(exe, sock, degs, src, dst):
    """A ``prt_bridge`` streaming session as a subprocess: (Popen, t0)."""
    cmd = [exe, "-s", sock, "-b", str(SERVE_BLOCK), "-a",
           ",".join(f"{d:.2f}" for d in degs), src, dst]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), \
        time.perf_counter()


def prt_bridge_done(proc, t0, label):
    """Wait for a ``prt_bridge`` session; returns (wall s, its latency)."""
    _, err = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"prt_bridge {label} exited "
          f"{proc.returncode}:\n{err[-2000:]}")
    m = re.search(r"latency (\d+) frames", err)
    check(m is not None, f"prt_bridge {label} printed no latency:\n{err}")
    return wall, int(m.group(1))


def solo_streams(dev, inputs, degs_per_block, depth):
    """The same sessions through one StreamingRotator(pipeline_depth=depth)
    on the card, their channels side by side (the engine's channels are
    independent), fed the same host blocks with the latency's zeros after:
    returns each session's latency-compensated (2, n) output."""
    from phaserotate_tpu_torch.stream import StreamingRotator

    x = np.concatenate(inputs)  # (2 * sessions, n)
    n = x.shape[1]
    rot = StreamingRotator(rate=RATE, channels=x.shape[0],
                           pipeline_depth=depth, device=dev)
    lat = rot.latency
    x = np.concatenate([x, np.zeros((x.shape[0], lat), np.float32)], axis=1)
    outs = [rot.process(x[:, i : i + SERVE_BLOCK], degs_per_block(i))
            for i in range(0, x.shape[1], SERVE_BLOCK)]
    y = np.concatenate(outs, axis=1)[:, lat : lat + n]
    return [y[2 * s : 2 * s + 2] for s in range(len(inputs))]


def drive_serving(tmp, dev, card, times, audio, src) -> dict:
    """The fourth counted run: the daemon on the card serving the native
    clients and a Python client, with analysis over the socket while it
    streams.  Returns this run's launch counts."""
    import threading
    import urllib.request

    from phaserotate_tpu_torch import bridge
    from phaserotate_tpu_torch.core.sizes import stream_geometry_for_rate
    from phaserotate_tpu_torch.gui import web
    from phaserotate_tpu_torch.io import read_wav, write_wav
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.search import find_min_peak_angle

    sgeom = stream_geometry_for_rate(RATE)
    t0 = time.perf_counter()
    make = subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                           "prt_bridge"], capture_output=True, text=True,
                          timeout=300)
    check(make.returncode == 0, f"make -C native prt_bridge exited "
          f"{make.returncode}:\n{make.stdout[-2000:]}{make.stderr[-3000:]}")
    exe = os.path.join(REPO, "native", "prt_bridge")
    times["build_prt_bridge"] = time.perf_counter() - t0
    print(f"phase build_prt_bridge: {times['build_prt_bridge']:.6f} s "
          f"[{card}]")

    rng = np.random.default_rng(SEED + 10)
    n_srv, n_solo = SERVE_SECONDS * RATE, SOLO_SECONDS * RATE
    inputs = [music_like(rng, 2, n_srv) for _ in range(SERVE_SESSIONS)]
    # as prt_bridge reads them: "%.2f" text, then float
    angles = [np.array([float(f"{a:.2f}") for a in
                        rng.uniform(-180.0, 180.0, 2)])
              for _ in range(SERVE_SESSIONS)]
    srcs, dsts = [], []
    for s, x in enumerate(inputs):
        srcs.append(os.path.join(tmp, f"serve_in{s}.wav"))
        dsts.append(os.path.join(tmp, f"serve_out{s}.wav"))
        write_wav(srcs[-1], x, RATE)
    py_in = music_like(rng, 2, n_solo)
    py_angles = [np.round(rng.uniform(-180.0, 180.0, 2), 2)
                 for _ in range(2)]  # first half, second half

    log = ServeLog(bridge)
    webuis: list = []
    web_start = web.WebUI.start

    def logged_start(ui):
        webuis.append(ui)
        return web_start(ui)

    web.WebUI.start = logged_start
    sync()
    _build.reset_launches()
    try:
        # ---- 1. the batched daemon, on the card, no device argument ----
        sock = os.path.join(tmp, "serve.sock")
        start_daemon(bridge, sock, batch_sessions=SERVE_SESSIONS,
                     pipeline=-1, ui_port=0)
        (rtt_med, rtt_p99), = log.rtts
        auto = bridge.auto_pipeline_depth(rtt_med, RATE, sgeom.parsiz,
                                          rtt_p99_s=rtt_p99)
        print(f"daemon dispatch round trip: median {1e3 * rtt_med:.6f} ms, "
              f"p99 {1e3 * rtt_p99:.6f} ms -> auto pipeline depth {auto} "
              f"[{card}]")
        # ---- 2. eight batched prt_bridge sessions, then a Python one ----
        t_serve = time.perf_counter()
        runs = [prt_bridge_run(exe, sock, angles[s], srcs[s], dsts[s])
                for s in range(SERVE_SESSIONS)]
        log.wait_sessions(SERVE_SESSIONS)
        cl = bridge.BridgeClient(sock, RATE, 2)
        cl.sock.settimeout(300)
        depth = (cl.latency - sgeom.latency) // sgeom.parsiz
        check(depth == auto, f"session depth {depth}, auto {auto}")
        py_x = np.concatenate(
            [py_in, np.zeros((2, cl.latency), np.float32)], axis=1)
        py_out, py_ms, analyses = [], [], {}
        t_py = time.perf_counter()
        for b, i in enumerate(range(0, py_x.shape[1], SERVE_BLOCK)):
            if b == 0:
                cl.ui_on()
            if b == 5:
                cl.set_state(1.25, False)
                cl.ui_on()
            if b == 50:
                cl.reset_peaks()
            t1 = time.perf_counter()
            py_out.append(cl.process(py_x[:, i : i + SERVE_BLOCK],
                                     py_angles[i >= n_solo // 2]))
            py_ms.append(1e3 * (time.perf_counter() - t1))
            if b == 20:
                # ---- 5. the web UI lists every live session ----
                # a session's meters go live with its first metered block,
                # which a session the GIL starves may not have reached
                # yet: read until every one has (60 s at most)
                url = webuis[0].url + "state"
                deadline = time.perf_counter() + 60.0
                while True:
                    with urllib.request.urlopen(url, timeout=60) as r:
                        live = json.loads(r.read())["sessions"]
                    if time.perf_counter() > deadline or (
                            len(live) == SERVE_SESSIONS + 1 and all(
                                any(m["in_peak"] > 0 for m in s["meters"])
                                for s in live.values())):
                        break
                    time.sleep(0.2)
                check(len(live) == SERVE_SESSIONS + 1,
                      f"web UI lists {len(live)} sessions")
                for s in live.values():
                    vals = [v for m in s["meters"] for v in m.values()]
                    check(len(s["meters"]) == 2 and all(
                        np.isfinite(vals)) and max(
                        m["in_peak"] for m in s["meters"]) > 0,
                          f"web UI meters {s['meters']}")
                print(f"web UI /state: {len(live)} live sessions with "
                      f"meters (device {sorted({str(s['device']) for s in live.values()})})")
                # ---- 4. analysis over the socket while the rest stream ----
                def by_client():
                    t2 = time.perf_counter()
                    ca = bridge.BridgeClient(sock, RATE, 2, init=False)
                    ca.sock.settimeout(300)
                    analyses["client"] = (ca.analyze(audio),
                                          time.perf_counter() - t2)
                    ca.close()

                th = threading.Thread(target=by_client)
                th.start()
                t2 = time.perf_counter()
                an_proc = subprocess.Popen([exe, "-s", sock, "-A", src],
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)
        py_wall = time.perf_counter() - t_py
        cl.close()
        an_out, an_err = an_proc.communicate(timeout=600)
        analyses["native"] = (an_out, time.perf_counter() - t2)
        check(an_proc.returncode == 0, f"prt_bridge -A: {an_err[-2000:]}")
        th.join(600)
        check("client" in analyses, "the socket analysis did not finish")
        walls, lats = zip(*[prt_bridge_done(p, t, f"session {s}")
                            for s, (p, t) in enumerate(runs)])
        times["serve_batched"] = time.perf_counter() - t_serve
        sessions = list(log.sessions)
        # ---- 3. two unbatched sessions on a second daemon ----
        sock2 = os.path.join(tmp, "serve2.sock")
        start_daemon(bridge, sock2, batch_sessions=0, pipeline=-1)
        solo_srcs = []
        for s in range(2):
            solo_srcs.append(os.path.join(tmp, f"solo_in{s}.wav"))
            write_wav(solo_srcs[-1], inputs[s][:, :n_solo], RATE)
        t_solo = time.perf_counter()
        runs2 = [prt_bridge_run(exe, sock2, angles[s], solo_srcs[s],
                                os.path.join(tmp, f"solo_out{s}.wav"))
                 for s in range(2)]
        walls2, lats2 = zip(*[prt_bridge_done(p, t, f"unbatched {s}")
                              for s, (p, t) in enumerate(runs2)])
        times["serve_unbatched"] = time.perf_counter() - t_solo
        sync()
        counts = dict(_build.launches)
    finally:
        log.restore()
        web.WebUI.start = web_start
    print(f"phase serve_batched: {times['serve_batched']:.6f} s, "
          f"serve_unbatched: {times['serve_unbatched']:.6f} s [{card}]")

    # ---- the outputs, against the card's own in-process runs ----
    batched = [s for s in sessions if s.batched]
    check(len(batched) == SERVE_SESSIONS and not sessions[-1].batched,
          "the eight prt_bridge sessions share the broker, the ninth is "
          "served on its own")
    broker = batched[0].plugin._broker
    check(all(s.plugin._broker is broker for s in batched), "one broker")
    check(broker.device.type == dev.type, "the broker is not on the card")
    for k, s in enumerate(log.sessions):
        st = log.stats(s)
        print(f"daemon {1 + (k >= len(sessions))} session {k} "
              f"({'batched' if s.batched else 'unbatched'}, depth "
              f"{s.pipeline}): {st['xrt']:.3f}x realtime, daemon ms per "
              f"block p50 {st['p50']:.4f} p99 {st['p99']:.4f} over "
              f"{st['blocks']} blocks [{card}]")
    for s, w in enumerate(walls):
        print(f"prt_bridge session {s}: {SERVE_SECONDS / w:.3f}x realtime "
              f"(client wall {w:.6f} s for {SERVE_SECONDS} s) [{card}]")
    print(f"python client session: {SOLO_SECONDS / py_wall:.3f}x realtime, "
          f"round trip ms per block p50 {np.percentile(py_ms, 50):.4f} p99 "
          f"{np.percentile(py_ms, 99):.4f} [{card}]")
    print(f"broker: {broker.dispatches} dispatches, {broker.frames_served} "
          f"slot-frames, {broker.frames_served / broker.dispatches:.3f} "
          f"frames per dispatch [{card}]")
    for s, w in enumerate(walls2):
        print(f"unbatched prt_bridge session {s}: {SOLO_SECONDS / w:.3f}x "
              f"realtime (client wall {w:.6f} s) [{card}]")

    errs = []
    want = solo_streams(dev, inputs, lambda i: np.concatenate(angles),
                        depth)
    for s in range(SERVE_SESSIONS):
        check(lats[s] == cl.latency, f"session {s} latency {lats[s]}")
        y, rate, _ = read_wav(dsts[s])
        check(rate == RATE and y.shape == (2, n_srv), f"session {s} output")
        errs.append(float(np.abs(y - want[s]).max()))
    py_y = np.concatenate(py_out, axis=1)[:, cl.latency : cl.latency + n_solo]
    (py_want,) = solo_streams(
        dev, [py_in], lambda i: py_angles[i >= n_solo // 2], depth)
    errs.append(float(np.abs(py_y - py_want).max()))
    depth2 = (lats2[0] - sgeom.latency) // sgeom.parsiz
    want2 = solo_streams(dev, [x[:, :n_solo] for x in inputs[:2]],
                         lambda i: np.concatenate(angles[:2]), depth2)
    for s in range(2):
        y, _, _ = read_wav(os.path.join(tmp, f"solo_out{s}.wav"))
        errs.append(float(np.abs(y - want2[s]).max()))
    print(f"served outputs vs StreamingRotator(pipeline_depth) on the card: "
          f"max err per session {errs} (depth {depth}, unbatched {depth2})")
    check(max(errs) < 1e-5, f"served audio vs solo streaming: {errs}")
    check(cl.states == [(1.0, False), (1.25, False)],
          f"STATE echoes {cl.states}")
    check(len(cl.levels) >= 2 * (len(py_out) - 1)
          and np.isfinite(np.asarray(cl.levels)).all(),
          f"{len(cl.levels)} LEVELS entries for {len(py_out)} blocks")

    local = find_min_peak_angle(audio, rate=RATE)
    got, an_wall = analyses["client"]
    for c, g in enumerate(got):
        want_c = [float(np.float32(v)) for v in (
            local.angles_deg[c], local.peak_zero[c], local.peak_min[c])]
        check([g["angle_deg"], g["peak_zero"], g["peak_min"]] == want_c
              and g["found"] == local.found[c],
              f"socket analysis channel {c}: {g} vs {want_c}")
    native_angles = result_angles(analyses["native"][0])
    check(native_angles == [round(a, 2) for a in local.angles_deg],
          f"prt_bridge -A angles {native_angles} vs {local.angles_deg}")
    print(f"analysis of the 4-minute file over the socket while streaming: "
          f"BridgeClient {an_wall:.6f} s, prt_bridge -A "
          f"{analyses['native'][1]:.6f} s; angles {local.angles_deg} equal "
          f"in-process, peaks equal [{card}]")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    check(os.path.isdir(os.path.join(REPO, "phaserotate_tpu_torch")),
          "run from a checkout: phaserotate_tpu_torch/ is missing")
    sys.path.insert(0, REPO)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    card = card_line
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    times: dict = {}

    from phaserotate_tpu_torch.kernels import _build

    # ---- build every kernel from the checkout's sources ----
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    times["build"] = time.perf_counter() - t0
    print(f"phase build: {times['build']:.6f} s [{card}] -> "
          f"{os.path.relpath(so, REPO)}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())
    print(sweep_sass(so))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return drive(tmp, dev, card, times)


def drive(tmp: str, dev, card: str, times: dict) -> int:
    """Phases 1-4 of the module docstring; files go under ``tmp``."""
    import torch

    from phaserotate_tpu_torch import (AngleAnalyzer, OfflineRotator,
                                       PhaseRotator, cli, rotate)
    from phaserotate_tpu_torch.core.angles import (all_angle_cos_sin,
                                                   degrees_to_turns)
    from phaserotate_tpu_torch.core.sizes import (StreamGeometry,
                                                  offline_geometry,
                                                  stream_geometry_for_rate)
    from phaserotate_tpu_torch.io import read_wav, write_wav
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.kernels import fused_conv as fc
    from phaserotate_tpu_torch.kernels import stream_conv as sc
    from phaserotate_tpu_torch.kernels.rotate_peak import (
        peak_kernel, peak_plain, rotate_peak_sweep_kernel,
        rotate_peak_sweep_plain)
    from phaserotate_tpu_torch.ops.rotate import hilbert_fir
    from phaserotate_tpu_torch.search import (
        apply_angles, find_min_peak_angle, select_min_peak_angles_batch,
        sweep_peaks_aux)
    from phaserotate_tpu_torch.search.sweep import aligned_pair
    from phaserotate_tpu_torch.stream import rotate_streamed
    from phaserotate_tpu_torch.stream.engine import (
        _internal_angle_params, angle_sequence, init_state,
        stream_process_bulk)

    rng = np.random.default_rng(SEED)
    src = os.path.join(tmp, "in.wav")
    out_sub = os.path.join(tmp, "out_subprocess.wav")
    out_inp = os.path.join(tmp, "out_inprocess.wav")
    n_4min = 4 * 60 * RATE
    audio = music_like(rng, 2, n_4min)
    write_wav(src, audio, RATE, bits=16, float_format=False)
    audio, rate, _ = read_wav(src)  # the quantized samples the CLI sees
    check(rate == RATE and audio.shape == (2, n_4min), "WAV round trip")

    # ---- 1. the CLI as a user runs it (subprocesses) ----
    with phase("cli_analyze_subprocess", card, times):
        _, sub_err = run_cli(["-vv", src], REPO)
    sub_angles = result_angles(sub_err)
    check(len(sub_angles) == 2, f"analysis printed no result:\n{sub_err}")
    spec = ",".join(f"{a:g}" for a in sub_angles)
    print(f"cli analyze: angles {sub_angles} deg")
    with phase("cli_apply_subprocess", card, times):
        run_cli(["-a", spec, src, out_sub], REPO)

    # ---- 2. the main path in-process, launches counted ----
    geom = offline_geometry(RATE)
    check(geom.blksiz == 8192 and geom.parsiz // sc.P == 32, "geometry")
    fleet = music_batch(rng, (64, 2), 10 * RATE, dev)
    stems = music_batch(rng, (64,), 60 * RATE, dev)
    stem_degs = torch.tensor(rng.uniform(-180.0, 180.0, 64),
                             dtype=torch.float32, device=dev)
    sync()
    _build.reset_launches()
    with phase("cli_analyze_inprocess", card, times):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(["-vv", src]) == 0, "in-process analyze")
    check(result_angles(err.getvalue()) == sub_angles,
          "in-process and subprocess analyses differ")
    with phase("cli_apply_inprocess", card, times):
        check(cli.main(["-a", spec, src, out_inp]) == 0, "in-process apply")
    with phase("fleet_search_64x2x10s", card, times):
        table, rot0 = sweep_peaks_aux(fleet, geom)
        fleet_res = select_min_peak_angles_batch(
            table.cpu().numpy(), rot0=rot0.cpu().numpy())
    with phase("rotate_fir_64x60s", card, times):
        rotated = rotate(stems, stem_degs, method="fir")
    # the plugin's 48 kHz FIR: fused_conv at parsiz 4096
    with phase("hilbert_fir_64x60s", card, times):
        h3072 = hilbert_fir(stems, 3072)
    # a FIR the small kernel cannot frame: fused_conv at parsiz 16384
    geom16k = StreamGeometry(48000.0, 512, 16128)
    with phase("offline_rotator_firlen16128_64x60s", card, times):
        off16k = OfflineRotator(rate=RATE, method="fir", geom=geom16k)(
            stems, stem_degs)
    x4 = torch.from_numpy(audio).to(dev)
    with phase("rotate_streamed_4min", card, times):
        streamed = torch.stack([rotate_streamed(x4[c], 35.0)
                                for c in range(2)])
    # the plugin role: stereo, 1024-sample host blocks, meters on, the
    # target changing once a second at a block boundary
    sgeom = stream_geometry_for_rate(RATE)
    n_rt = 2813 * 1024  # 60.01 s
    rt_audio = np.ascontiguousarray(audio[:, :n_rt])
    per_second = rng.uniform(-180.0, 180.0, n_rt // RATE + 1)
    block_degs = [float(per_second[(i * 1024) // RATE])
                  for i in range(n_rt // 1024)]
    rt_rot = PhaseRotator(rate=RATE, channels=2)
    with phase("phase_rotator_stereo_60s", card, times):
        rt_out = push_blocks(rt_rot, rt_audio, 1024, block_degs)
    rt_levels = [rt_rot.levels(c) for c in range(2)]
    ckpt = os.path.join(tmp, "sweeps.npz")
    fleet8 = {f"f{i}": fleet[i] for i in range(8)}
    analyzer = AngleAnalyzer(rate=RATE)
    with phase("analyzer_8x2x10s", card, times):
        an_first = analyzer.analyze_many(fleet8, checkpoint=ckpt)
    sync()
    launches = dict(_build.launches)
    print(f"launches: {json.dumps(launches)}")
    check(rt_rot.device.type == "cuda", "PhaseRotator's default device")
    for name, count in launches.items():
        # no production caller; the catalogue run drives pcm24_widen and
        # wire_unpack, the 192 kHz run hilbert_32k
        if name not in ("fused_rotate_fir", "peak", "pcm24_widen",
                        "hilbert_32k", "wire_unpack"):
            check(count > 0,
                  f"kernel {name} was not launched by the main path")
    # the ramp: a target that changes every 50 plugin blocks
    n_blocks = -(-(n_4min + sgeom.latency) // sgeom.parsiz)
    ramp_degs = np.repeat(rng.uniform(-180.0, 180.0, -(-n_blocks // 50)),
                          50)[:n_blocks].astype(np.float32)
    angles, das, _, _ = angle_sequence(np.float32(0.0), ramp_degs, sgeom)
    check(bool((das != 0).any()), "the ramp schedule has no slope")
    params = torch.from_numpy(
        _internal_angle_params(angles, das, sgeom)).to(dev)[None]
    fr256 = torch.nn.functional.pad(
        x4[0], (0, params.shape[1] * sc.P - n_4min)).reshape(1, -1, sc.P)
    # where the convolutions' device time goes, by kernel, at the main
    # path's shapes (outside every counted run)
    turns = degrees_to_turns(stem_degs)
    splits = {
        "stream_conv_hilbert": device_split(
            lambda: sc.hilbert_small(x4, geom.parsiz)),
        "stream_conv_mix": device_split(
            lambda: sc.rotate_small(stems, turns, 3072)),
        "stream_conv_stream_mix": device_split(
            lambda: sc.fused_stream_mix(fr256, params, sgeom.firlen))}
    for parsiz, firlen in ((4096, 3072), (16384, 16128)):
        frames_p = framed(stems, parsiz)
        spec_p = fc.hilbert_fir_spectrum(firlen, parsiz, dev)
        splits[f"fused_conv_{parsiz}"] = device_split(
            lambda: fc.fused_ola_conv(frames_p, spec_p, parsiz))
        del frames_p

    # ---- 2b. the wider surface, counted from 0 again ----
    y_inp, _, _ = read_wav(out_inp)
    launches_wide = drive_wider_surface(tmp, card, times, audio, src,
                                        sub_angles, y_inp, geom)
    print(f"launches of the wider surface: {json.dumps(launches_wide)}")
    for name in ("hilbert_small", "rotate_peak_sweep"):
        check(launches_wide[name] > 0,
              f"kernel {name} was not launched by the wider surface")
    launches_cat = drive_catalogue(tmp, dev, card, times, x4, fleet, stems,
                                   stem_degs, geom)
    print(f"launches of the catalogue run: {json.dumps(launches_cat)}")
    for name in ("hilbert_small", "rotate_peak_sweep", "rotate_small",
                 "rotate_peak_sweep_general", "pcm24_widen", "wire_unpack"):
        check(launches_cat[name] > 0,
              f"kernel {name} was not launched by the catalogue run")
    general_launches = launches_cat.pop("rotate_peak_sweep_general")
    t0 = time.perf_counter()
    launches_srv = drive_serving(tmp, dev, card, times, audio, src)
    times["serving_run"] = time.perf_counter() - t0
    print(f"phase serving_run (all of drive_serving): "
          f"{times['serving_run']:.6f} s [{card}]")
    print(f"launches of the serving run: {json.dumps(launches_srv)}")
    for name in ("hilbert_small", "rotate_peak_sweep"):
        check(launches_srv[name] > 0,
              f"kernel {name} was not launched by the serving run")
    launches = {k: launches[k] + launches_wide[k] + launches_cat[k]
                + launches_srv[k] for k in launches}

    # ---- outputs are right ----
    y_sub, _, _ = read_wav(out_sub)
    check(y_sub.shape == audio.shape and np.isfinite(y_sub).all(),
          "applied file: shape or finiteness")
    check(np.array_equal(y_sub, y_inp), "subprocess and in-process apply")
    with plain_kernels():
        units = [int(round(a * 2)) for a in sub_angles]
        y_plain = apply_angles(x4, units, geom).cpu().numpy()
        t_plain, r_plain = sweep_peaks_aux(fleet, geom)
        plain_res = select_min_peak_angles_batch(
            t_plain.cpu().numpy(), rot0=r_plain.cpu().numpy())
        plain_4min = find_min_peak_angle(x4, rate=RATE)
        rot_plain = rotate(stems, stem_degs, method="fir")
    apply_err = float(np.abs(y_sub - y_plain).max())
    print(f"apply 4 min stereo: max|kernel - plain| {apply_err!r}")
    check(apply_err < 1e-5, "applied audio vs plain path")
    check(plain_4min.angles_deg == sub_angles,
          f"4-minute angles: kernel {sub_angles} plain {plain_4min.angles_deg}")
    k_angles = [r.angles_units for r in fleet_res]
    p_angles = [r.angles_units for r in plain_res]
    check(k_angles == p_angles, "fleet angles: kernel path != plain path")
    n_moved = sum(any(a) for a in k_angles)
    print(f"fleet search: {len(k_angles)} files, {n_moved} with a nonzero "
          f"angle; chosen angles equal to the plain path")
    check(rotated.shape == stems.shape and torch.isfinite(rotated).all(),
          "rotate output")
    rot_err = float((rotated - rot_plain).abs().max())
    print(f"rotate 64x60 s: max|kernel - plain| {rot_err!r}")
    check(rot_err < 2e-5, "rotate vs plain path")
    gain = [r.peak_zero[0] - r.peak_min[0] for r in fleet_res]
    check(all(g >= 0 for g in gain), "a chosen angle raised the peak")

    # ---- the streaming and model paths: outputs against the plain path ----
    with plain_kernels():
        h3072_plain = hilbert_fir(stems, 3072)
        off16k_plain = OfflineRotator(rate=RATE, method="fir",
                                      geom=geom16k)(stems, stem_degs)
        streamed_plain = torch.stack([rotate_streamed(x4[c], 35.0)
                                      for c in range(2)])
    for name, got, want, tol in (
            ("hilbert_fir 64x60 s", h3072, h3072_plain, 3e-6),
            ("OfflineRotator firlen 16128", off16k, off16k_plain, 2e-5),
            ("rotate_streamed 4 min", streamed, streamed_plain, 1e-5)):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name}: shape or finiteness")
        err = float((got - want).abs().max())
        print(f"{name}: max|kernel - plain| {err!r}")
        check(err < tol, f"{name} vs plain path: {err}")
    # the streamed 4-minute file equals the offline FIR rotate once the
    # 35 deg ramp-in (2 plugin blocks) has passed
    settled = rotate(x4, 35.0, method="fir")
    st_err = float((streamed - settled)[:, 1024 : -4096].abs().max())
    print(f"rotate_streamed vs rotate(fir) after the ramp-in: {st_err!r}")
    check(st_err < 2e-5, "streamed vs offline FIR rotation")

    # PhaseRotator: the bulk engine once over the whole signal with the
    # same per-frame targets, delayed by the shell's one-frame staging
    frame_degs = np.repeat(np.asarray(block_degs, np.float32),
                           1024 // sgeom.parsiz)
    frames = torch.from_numpy(rt_audio).to(dev).reshape(2, -1, sgeom.parsiz)
    bulk = torch.stack([stream_process_bulk(
        init_state(sgeom, device=dev), frames[c], frame_degs, sgeom)[1]
        for c in range(2)]).reshape(2, -1).cpu().numpy()
    p = sgeom.parsiz
    rt_err = float(np.abs(rt_out[:, p:] - bulk[:, :-p]).max())
    check(np.all(rt_out[:, :p] == 0), "PhaseRotator staging delay")
    print(f"PhaseRotator 60 s vs bulk engine: max err {rt_err!r}")
    check(rt_err < 1e-5, "PhaseRotator vs stream_process_bulk")
    for c, lv in enumerate(rt_levels):
        vals = [float(getattr(lv, f.name)) for f in
                lv.__dataclass_fields__.values()]
        check(all(np.isfinite(vals)), f"meters of channel {c} not finite")
        print(f"meters ch{c}: " + " ".join(
            f"{f.name}={float(getattr(lv, f.name)):.6g}"
            for f in lv.__dataclass_fields__.values()))
    # block-size independence and a bit-identical mid-stream resume over
    # 10 s at a constant angle
    n10 = 10 * RATE
    x10 = np.ascontiguousarray(audio[:, :n10])
    r1024 = PhaseRotator(rate=RATE, channels=2, meters=False)
    with phase("phase_rotator_10s_1024", card, times):
        y1024 = push_blocks(r1024, x10, 1024)
    resume = os.path.join(tmp, "stream.npz")
    save_at = 721  # 240093 samples: mid-frame
    r333 = PhaseRotator(rate=RATE, channels=2, meters=False)
    with phase("phase_rotator_10s_333", card, times):
        y333 = push_blocks(r333, x10, 333, save_at=save_at, path=resume)
    check(np.array_equal(y333, y1024), "333- vs 1024-sample host blocks")
    r_res = PhaseRotator(rate=RATE, channels=2, meters=False)
    r_res.load(resume)
    check(r_res._offset != 0, "the resume point is not mid-frame")
    y_res = push_blocks(r_res, x10[:, save_at * 333 :], 333)
    check(np.array_equal(y_res, y333[:, save_at * 333 :]),
          "resumed stream is not bit-identical")
    print("PhaseRotator: 333- and 1024-sample blocks bit-equal over 10 s; "
          "mid-frame checkpoint resume bit-identical")
    # AngleAnalyzer: the resume reads the checkpoint (zeroed input)
    an_second = analyzer.analyze_many(
        {k: torch.zeros_like(v) for k, v in fleet8.items()}, checkpoint=ckpt)
    for i, k in enumerate(fleet8):
        check(an_first[k].angles_units == fleet_res[i].angles_units,
              f"analyzer {k} vs sweep_peaks_aux")
        check(an_second[k].angles_units == an_first[k].angles_units,
              f"analyzer resume {k}")
    print("AngleAnalyzer: 8 files, angles equal to sweep_peaks_aux and "
          "equal after the checkpoint resume")

    # small input against the numpy CLI simulator (tests/ref_cli_sim.py)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from ref_cli_sim import RefRotate
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry

    small = music_like(np.random.default_rng(SEED + 1), 2, 3 * 1024)
    g1k = OfflineGeometry(1024)
    sim = RefRotate(1024, 2)
    sim.analyze_file(small, 0, 360, 1)
    tab_small, _ = sweep_peaks_aux(torch.from_numpy(small).to(dev), g1k)
    sim_err = float(np.abs(tab_small.cpu().numpy() - sim.peak).max())
    sim2 = RefRotate(1024, 2)
    want = sim2.apply_file(small, [70, -44])
    got = apply_angles(torch.from_numpy(small).to(dev), [70, -44], g1k)
    sim_err = max(sim_err, float(np.abs(got.cpu().numpy() - want).max()))
    print(f"vs numpy CLI simulator (2 x 3072 samples): max err {sim_err!r}")
    check(sim_err < 3e-5, "CLI simulator parity")

    # ---- 3. each kernel against its plain twin at the main path's shapes
    kernels = []
    b0, b1, _, _ = aligned_pair(x4, geom)
    cs = all_angle_cos_sin(dev)
    fb0, fb1, _, _ = aligned_pair(fleet, geom)
    # the angle slices the angle-sharded sweep passes on 3 and 4 cards, a
    # random 512-angle table and one angle: the kernel's general map (the
    # canonical table runs its mirror-pair units)
    slices3 = [cs[:, 120 * i : 120 * (i + 1)].contiguous() for i in range(3)]
    cs90 = cs[:, :90].contiguous()
    general_tables = {
        **{f"3-way slice {i} (120 angles)": t
           for i, t in enumerate(slices3)},
        "4-way slice 0 (90 angles)": cs90,
        "random 512 angles": torch.from_numpy(np.random.default_rng(
            SEED + 12).uniform(-1, 1, (2, 512)).astype(np.float32)).to(dev),
        "1 angle": cs[:, 37:38].contiguous()}

    def sweep_equal(table, table_name):
        for shape_name, (u0, u1) in (("4min stereo", (b0, b1)),
                                     ("fleet 64x2x10s", (fb0, fb1))):
            check(torch.equal(rotate_peak_sweep_kernel(u0, u1, table),
                              rotate_peak_sweep_plain(u0, u1, table)),
                  f"sweep table not bit-equal ({shape_name}, {table_name})")

    with phase("sweep_equal_check", card, times):
        sweep_equal(cs, "360 angles")
        for table_name, table in general_tables.items():
            sweep_equal(table, table_name)
    # NaN and inf samples: NaN propagates to the row's angles as in the
    # plain twin (and JAX); the other rows stay bit-equal
    with phase("sweep_nan_inf_check", card, times):
        nb0 = fb0.reshape(-1, fb0.shape[-1]).clone()  # (128 rows, n)
        nb1 = fb1.reshape(-1, fb1.shape[-1]).clone()
        nb0[0, 1000] = float("nan")
        nb1[1, 300_000] = float("inf")
        nb0[2, 400_000], nb1[2, 400_000] = float("inf"), float("-inf")
        for table in (cs, slices3[1], cs90):
            k = rotate_peak_sweep_kernel(nb0, nb1, table)
            p = rotate_peak_sweep_plain(nb0, nb1, table)
            check(bool(torch.isclose(k, p, rtol=0, atol=0,
                                     equal_nan=True).all()),
                  "sweep table on NaN/inf samples differs from the plain "
                  "twin's")
        k = rotate_peak_sweep_kernel(nb0, nb1, cs)
        check(bool(torch.isnan(k[0]).all()) and bool(torch.isnan(k[1, 0]))
              and bool(torch.isposinf(k[1, 1:]).all())
              and not bool(k[2].isfinite().any())
              and bool(k[3:].isfinite().all()),
              "NaN/inf rows of the sweep table")
        del nb0, nb1
    print("sweep: bit-equal to the plain twin at both shapes with 360 "
          f"angles and {', '.join(general_tables)}; NaN/inf samples equal "
          "with NaN equal to NaN (360, 120 and 90 angles)")
    sweep_ms = cuda_ms(lambda: rotate_peak_sweep_kernel(b0, b1, cs), 20)
    sweep_fleet_ms = cuda_ms(lambda: rotate_peak_sweep_kernel(fb0, fb1, cs),
                             20)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"clocks after the sweep timing (sm, max sm): "
          f"{clocks.stdout.strip()} [{card}]")
    sweep_plain_ms = cuda_ms(lambda: rotate_peak_sweep_plain(b0, b1, cs), 2)
    print(f"kernel rotate_peak_sweep at the fleet shape "
          f"{tuple(fb0.shape)}: {sweep_fleet_ms!r} ms [{card}]")
    kernels.append(dict(
        name="rotate_peak_sweep", route="cuda",
        source="phaserotate_tpu_torch/csrc/rotate_peak.cu",
        replaces="phaserotate_tpu/kernels/rotate_peak.py:110",
        launches=launches["rotate_peak_sweep"], max_abs_err=0.0,
        ms=sweep_ms, plain_ms=sweep_plain_ms,
        **sweep_bound(b0, b1, cs), library_ms=None, fleet_ms=sweep_fleet_ms))
    # the general map at the 4-minute shape: every 3-way slice and a 4-way
    # one; the row reports the slowest 3-way slice (the one that sets a
    # 3-card sharded sweep's wall), with its own bound
    general_ms = {name: cuda_ms(
        lambda t=table: rotate_peak_sweep_kernel(b0, b1, t), 20)
        for name, table in general_tables.items()}
    for name, ms in general_ms.items():
        tb = sweep_bound(b0, b1, general_tables[name])
        print(f"kernel rotate_peak_sweep general map, {name}: {ms!r} ms, "
              f"bound {tb['bound_ms']!r} ms ({tb['bound_by']}) [{card}]")
    # the three slices run the same instructions, so their times differ by
    # noise: of those within 1 % of the slowest, the row takes the one with
    # the largest bound (an outer slice, which has no mirror pairs)
    ms3 = [general_ms[f"3-way slice {i} (120 angles)"] for i in range(3)]
    slowest = max((i for i in range(3) if ms3[i] >= 0.99 * max(ms3)),
                  key=lambda i: (sweep_flops_per_sample(slices3[i]), ms3[i]))
    cs_slow = slices3[slowest]
    kernels.append(dict(
        name="rotate_peak_sweep_general", route="cuda",
        source="phaserotate_tpu_torch/csrc/rotate_peak.cu",
        replaces="phaserotate_tpu/kernels/rotate_peak.py:110",
        launches=general_launches, max_abs_err=0.0,
        ms=ms3[slowest],
        plain_ms=cuda_ms(lambda: rotate_peak_sweep_plain(b0, b1, cs_slow),
                         2),
        **sweep_bound(b0, b1, cs_slow), library_ms=None,
        slice=f"{120 * slowest}:{120 * (slowest + 1)}"))

    def conv_yardstick(x, firlen):
        """The same convolution as one torch.fft overlap-add at
        fused_parsiz_for(firlen): cuFFT on the card."""
        parsiz = fc.fused_parsiz_for(firlen)
        n_f = -(-x.shape[-1] // parsiz) + 1
        frames_l = torch.nn.functional.pad(
            x, (0, n_f * parsiz - x.shape[-1])).reshape(-1, n_f, parsiz)
        return fc.fused_ola_conv_plain(
            frames_l, fc.hilbert_fir_spectrum(firlen, parsiz, x.device),
            parsiz).reshape(*x.shape[:-1], -1)

    conv_err = 0.0
    for xin in (x4, fleet):
        conv_err = max(conv_err, float(
            (sc.hilbert_small(xin, geom.parsiz)
             - sc.hilbert_small_plain(xin, geom.parsiz)).abs().max()))
    check(conv_err < 1e-5, f"hilbert_small vs plain: {conv_err}")
    h_small = sc.hilbert_small(x4, geom.parsiz)
    h_lib = conv_yardstick(x4, geom.parsiz)[..., : h_small.shape[-1]]
    check(float((h_small - h_lib).abs().max()) < 1e-5,
          "stream_conv conv and its cuFFT yardstick differ")
    kernels.append(dict(
        name="stream_conv_hilbert", route="cuda",
        source="phaserotate_tpu_torch/csrc/stream_conv.cu",
        replaces="phaserotate_tpu/kernels/stream_conv.py:261",
        launches=launches["hilbert_small"], max_abs_err=conv_err,
        ms=cuda_ms(lambda: sc.hilbert_small(x4, geom.parsiz)),
        plain_ms=cuda_ms(lambda: sc.hilbert_small_plain(x4, geom.parsiz), 2),
        **bound(nbytes(x4, h_small),
                fir_conv_flops(x4.shape[0], n_4min, geom.parsiz, 0)),
        library_ms=cuda_ms(lambda: conv_yardstick(x4, geom.parsiz), 2),
        grid=sc.kernel_geometry(geom.parsiz // sc.P, False, dev)))
    del h_small, h_lib

    mix_out = sc.rotate_small(stems, turns, 3072)
    mix_err = float((mix_out - sc.rotate_small_plain(stems, turns, 3072)
                     ).abs().max())
    check(mix_err < 2e-5, f"rotate_small vs plain: {mix_err}")
    check(float((mix_out - fc.fused_rotate_fir_plain(stems, turns, 3072)
                 ).abs().max()) < 2e-5,
          "stream_conv mix and its cuFFT yardstick differ")
    kernels.append(dict(
        name="stream_conv_mix", route="cuda",
        source="phaserotate_tpu_torch/csrc/stream_conv.cu",
        replaces="phaserotate_tpu/kernels/stream_conv.py:291",
        launches=launches["rotate_small"], max_abs_err=mix_err,
        ms=cuda_ms(lambda: sc.rotate_small(stems, turns, 3072)),
        plain_ms=cuda_ms(lambda: sc.rotate_small_plain(stems, turns, 3072),
                         2),
        # cos*dry + sin*h per sample
        **bound(nbytes(stems, turns, mix_out),
                fir_conv_flops(stems.shape[0], stems.shape[-1], 3072, 3)),
        library_ms=cuda_ms(lambda: fc.fused_rotate_fir_plain(stems, turns,
                                                             3072), 2),
        grid=sc.kernel_geometry(3072 // sc.P, True, dev)))
    del mix_out

    sm_err = float((sc.fused_stream_mix(fr256, params, sgeom.firlen)
                    - sc.fused_stream_mix_plain(fr256, params, sgeom.firlen)
                    ).abs().max())
    check(sm_err < 1e-5, f"fused_stream_mix vs plain: {sm_err}")
    kernels.append(dict(
        name="stream_conv_stream_mix", route="cuda",
        source="phaserotate_tpu_torch/csrc/stream_conv.cu",
        replaces="phaserotate_tpu/kernels/stream_conv.py:329",
        launches=launches["stream_mix"], max_abs_err=sm_err,
        ms=cuda_ms(lambda: sc.fused_stream_mix(fr256, params, sgeom.firlen)),
        plain_ms=cuda_ms(lambda: sc.fused_stream_mix_plain(
            fr256, params, sgeom.firlen), 2),
        # the ramp (angle + slope*i) * 2*pi, then cos*dry + sin*h
        **bound(2 * nbytes(fr256) + nbytes(params),
                fir_conv_flops(1, fr256.shape[1] * sc.P, sgeom.firlen, 6)),
        library_ms=None))
    # where a stream_conv call's time goes: its one kernel and whatever
    # else the wrapper launches
    for name in ("stream_conv_hilbert", "stream_conv_mix",
                 "stream_conv_stream_mix"):
        print(f"{name} device ms by kernel: {json.dumps(splits[name])} "
              f"[{card}]")

    # fused_conv conv mode at every supported partition size: the two
    # main-path shapes (64 stems at 4096 and 16384) and the 4-minute
    # stereo file at 2048 and 8192
    fc_err, fc_ms, fc_bound, fc_geo = 0.0, {}, {}, {}
    for parsiz, firlen, xin in ((2048, 2048, x4), (4096, 3072, stems),
                                (8192, 8192, x4), (16384, 16128, stems)):
        frames_p = framed(xin, parsiz)
        spec = fc.hilbert_fir_spectrum(firlen, parsiz, dev)
        err = float((fc.fused_ola_conv(frames_p, spec, parsiz)
                     - fc.fused_ola_conv_plain(frames_p, spec, parsiz)
                     ).abs().max())
        print(f"fused_conv parsiz {parsiz} (firlen {firlen}, "
              f"{tuple(frames_p.shape)}): max err {err!r}")
        check(err < (3e-6 if parsiz <= 4096 else 1e-5),
              f"fused_conv parsiz {parsiz} vs plain: {err}")
        fc_err = max(fc_err, err)
        if xin is stems:
            fc_ms[parsiz] = (
                cuda_ms(lambda: fc.fused_ola_conv(frames_p, spec, parsiz)),
                cuda_ms(lambda: fc.fused_ola_conv_plain(frames_p, spec,
                                                        parsiz), 2))
            fc_bound[parsiz] = bound(
                2 * nbytes(frames_p) + nbytes(spec),
                fused_conv_flops(frames_p.shape[0] * frames_p.shape[1],
                                 parsiz, 0))
            print(f"fused_conv parsiz {parsiz} 64x60 s: kernel "
                  f"{fc_ms[parsiz][0]!r} ms, plain {fc_ms[parsiz][1]!r} ms "
                  f"[{card}]")
            # the run kernel against the fix-up of the run-first frames,
            # and the persistent grid
            fc_geo[parsiz] = dict(
                **fc.kernel_geometry(parsiz, False, dev),
                device_ms_by_kernel=splits[f"fused_conv_{parsiz}"])
            print(f"fused_conv parsiz {parsiz} 64x60 s: "
                  f"{json.dumps(fc_geo[parsiz])} [{card}]")
        del frames_p
    # the plain twin is the library call here: torch.fft, cuFFT
    kernels.append(dict(
        name="fused_conv_hilbert", route="cuda",
        source="phaserotate_tpu_torch/csrc/fused_conv.cu",
        replaces="phaserotate_tpu/kernels/fused_conv.py:375",
        launches=launches["fused_hilbert"], max_abs_err=fc_err,
        ms=fc_ms[4096][0], plain_ms=fc_ms[4096][1], **fc_bound[4096],
        library_ms=fc_ms[4096][1],
        ms_by_parsiz={str(p): dict(ms=k, plain_ms=pl, **fc_bound[p],
                                   grid_blocks=fc_geo[p]["blocks"],
                                   registers=fc_geo[p]["registers"])
                      for p, (k, pl) in fc_ms.items()}))

    # the two kernels no main path calls (``launches`` 0): this check's
    # own launches go under ``check_launches``
    _build.reset_launches()
    mixf_err = float((fc.fused_rotate_fir(stems, turns, 3072)
                      - fc.fused_rotate_fir_plain(stems, turns, 3072)
                      ).abs().max())
    check(mixf_err < 2e-5, f"fused_rotate_fir vs plain: {mixf_err}")
    flat4, flat_stems = x4.reshape(-1), stems.reshape(-1)
    for name, v in (("4-minute stereo", flat4), ("stems", flat_stems)):
        check(torch.equal(peak_kernel(v), peak_plain(v)),
              f"peak not bit-equal ({name})")
    check(torch.equal(peak_kernel(flat_stems),
                      torch.linalg.vector_norm(flat_stems, float("inf"))),
          "peak and torch.linalg.vector_norm differ")
    direct = dict(_build.launches)
    check(direct["fused_rotate_fir"] > 0 and direct["peak"] > 0,
          f"direct checks did not launch: {direct}")
    mixf_plain_ms = cuda_ms(lambda: fc.fused_rotate_fir_plain(stems, turns,
                                                              3072), 2)
    kernels.append(dict(
        name="fused_conv_mix", route="cuda",
        source="phaserotate_tpu_torch/csrc/fused_conv.cu",
        replaces="phaserotate_tpu/kernels/fused_conv.py:422",
        launches=launches["fused_rotate_fir"],
        check_launches=direct["fused_rotate_fir"], max_abs_err=mixf_err,
        ms=cuda_ms(lambda: fc.fused_rotate_fir(stems, turns, 3072)),
        plain_ms=mixf_plain_ms,
        # the same function as stream_conv_mix, so the same bound
        **bound(2 * nbytes(stems) + nbytes(turns),
                fir_conv_flops(stems.shape[0], stems.shape[-1], 3072, 3)),
        library_ms=mixf_plain_ms))
    kernels.append(dict(
        name="peak", route="cuda",
        source="phaserotate_tpu_torch/csrc/rotate_peak.cu",
        replaces="phaserotate_tpu/kernels/rotate_peak.py:56",
        launches=launches["peak"], check_launches=direct["peak"],
        max_abs_err=0.0,
        ms=cuda_ms(lambda: peak_kernel(flat_stems)),
        plain_ms=cuda_ms(lambda: peak_plain(flat_stems), 2),
        **bound(nbytes(flat_stems) + 4, 1.0 * flat_stems.numel()),
        library_ms=cuda_ms(lambda: torch.linalg.vector_norm(
            flat_stems, float("inf")), 2)))

    # pcm24_widen at the 96 kHz catalogue's longest bucket (8 files x 2
    # channels x 2^26 frames) on seeded random bytes, the 24-bit extremes
    # at both ends of every row; no one PyTorch call computes it
    from phaserotate_tpu_torch.kernels.pcm24 import (pcm24_widen,
                                                     pcm24_widen_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    raw24 = torch.randint(0, 256, (8, 1 << 26, 2, 3), generator=gen,
                          dtype=torch.uint8, device=dev)
    ext = torch.tensor([[0x00, 0x00, 0x80], [0xFF, 0xFF, 0xFF],
                        [0x00, 0x00, 0x00], [0xFF, 0xFF, 0x7F]],
                       dtype=torch.uint8, device=dev)  # -2^23, -1, 0, 2^23-1
    raw24[:, :2] = ext.reshape(2, 2, 3)
    raw24[:, -2:] = ext.flip(0).reshape(2, 2, 3)
    before = _build.launches["pcm24_widen"]
    with phase("pcm24_widen_check", card, times):
        widened = pcm24_widen(raw24)
        check(torch.equal(widened, pcm24_widen_plain(raw24)),
              "pcm24_widen not bit-equal to its plain twin")
        edges = torch.tensor([-1.0, -2.0 ** -23, 0.0, 1.0 - 2.0 ** -23],
                             device=dev)
        check(torch.equal(widened[:, :, :2].transpose(1, 2).reshape(8, 4),
                          edges.expand(8, 4))
              and torch.equal(widened[:, :, -2:].transpose(1, 2)
                              .reshape(8, 4), edges.flip(0).expand(8, 4)),
              "pcm24_widen: the 24-bit extremes")
    widen_checks = _build.launches["pcm24_widen"] - before
    del widened
    samples24 = raw24.numel() // 3
    kernels.append(dict(
        name="pcm24_widen", route="cuda",
        source="phaserotate_tpu_torch/csrc/pcm24.cu", replaces=None,
        launches=launches["pcm24_widen"], check_launches=widen_checks,
        max_abs_err=0.0, shape=list(raw24.shape),
        ms=cuda_ms(lambda: pcm24_widen(raw24), 20),
        plain_ms=cuda_ms(lambda: pcm24_widen_plain(raw24), 2),
        # 3 bytes read and 4 written a sample, one multiply
        **bound(7 * samples24, samples24), library_ms=None))
    del raw24
    drive_hires192(tmp, dev, card, times, kernels)

    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']!r} ms, plain {k['plain_ms']!r} "
              f"ms, bound {k['bound_ms']!r} ms ({k['bound_by']}), library "
              f"{k['library_ms']!r} ms, max_abs_err {k['max_abs_err']!r} "
              f"[{card}]")
    secs_4min = n_4min / RATE
    print(f"cli analyze in-process: "
          f"{secs_4min / times['cli_analyze_inprocess']:.1f}x realtime "
          f"(4 min stereo) [{card}]")
    print(f"fleet search: {64 / times['fleet_search_64x2x10s']:.1f} files/s "
          f"[{card}]")
    print(f"rotate fir: {64 * 60 / times['rotate_fir_64x60s']:.1f}x realtime "
          f"(64 mono 60 s stems) [{card}]")
    for name in ("hilbert_fir_64x60s", "offline_rotator_firlen16128_64x60s"):
        print(f"{name}: {64 * 60 / times[name]:.1f}x realtime [{card}]")
    print(f"rotate_streamed: {2 * 240 / times['rotate_streamed_4min']:.1f}x "
          f"realtime (2 x 4 min) [{card}]")
    rt_secs = n_rt / RATE
    rt_wall = times["phase_rotator_stereo_60s"]
    print(f"PhaseRotator stereo: {rt_secs / rt_wall:.2f}x realtime, "
          f"{1e3 * rt_wall / len(block_degs):.4f} "
          f"ms per 1024-sample host block (budget "
          f"{1e3 * 1024 / RATE:.4f} ms) [{card}]")
    check("jax" not in sys.modules and "phaserotate_tpu" not in sys.modules,
          "JAX was imported")
    print(f"peak device memory: {torch.cuda.max_memory_allocated()} bytes")
    print(f"chip_smoke wall time: {time.perf_counter() - STARTED:.6f} s "
          f"[{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

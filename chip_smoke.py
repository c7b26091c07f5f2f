#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from ``phaserotate_tpu_torch/csrc/`` with nvcc,
then, on the first CUDA device:

1. writes a 4-minute stereo 48 kHz 16-bit WAV made from a numpy seed and
   runs the port's CLI on it as a user would: ``-vv in.wav`` (analyze),
   then ``-a <found> in.wav out.wav`` (apply), as subprocesses;
2. runs the same two CLI calls in this process with every kernel launch
   counter at 0, then the fleet-shaped search (64 files x 2 channels x
   10 s, ``sweep_peaks_aux`` + ``select_min_peak_angles_batch``) and the
   FIR rotate of 64 one-minute mono stems at independent angles, and
   fails unless every kernel was launched;
3. holds each kernel against its plain PyTorch version on the same CUDA
   tensors at those shapes (sweep table bit-equal, convolution < 1e-5,
   rotation mix < 2e-5, chosen angles equal) and the slice against the
   repository's numpy CLI simulator on a small input (3e-5);
4. prints the wall time of each phase and each kernel's time beside its
   plain version's, with the card's name and power limit.

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
RATE = 48000
SEED = 20240917


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


@contextlib.contextmanager
def plain_kernels():
    """Route the slice through the kernels' plain twins (for comparison
    runs only: the main path's counted run never takes this)."""
    import importlib

    from phaserotate_tpu_torch.kernels import rotate_peak as rp
    from phaserotate_tpu_torch.kernels import stream_conv as sc
    from phaserotate_tpu_torch.search import sweep

    # the package re-exports the function rotate over the module's name
    rot = importlib.import_module("phaserotate_tpu_torch.ops.rotate")

    saved = (sweep.hilbert_small, sweep.rotate_peak_sweep_kernel,
             rot.rotate_small)
    sweep.hilbert_small = sc.hilbert_small_plain
    sweep.rotate_peak_sweep_kernel = (
        lambda b0, b1, cs, tile_len=0: rp.rotate_peak_sweep_plain(b0, b1, cs))
    rot.rotate_small = sc.rotate_small_plain
    try:
        yield
    finally:
        (sweep.hilbert_small, sweep.rotate_peak_sweep_kernel,
         rot.rotate_small) = saved


def result_angles(text: str):
    return [float(a) for a in re.findall(
        r"^Channel: +\d+ Phase: +(-?[\d.]+) deg", text, re.M)]


def run_cli(args, cwd):
    proc = subprocess.run([sys.executable, "-m", "phaserotate_tpu_torch.cli",
                           *args], cwd=cwd, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0,
          f"cli {args} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout, proc.stderr


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
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return drive(tmp, dev, card, times)


def drive(tmp: str, dev, card: str, times: dict) -> int:
    """Phases 1-4 of the module docstring; files go under ``tmp``."""
    import torch

    from phaserotate_tpu_torch import cli, rotate
    from phaserotate_tpu_torch.core.angles import (all_angle_cos_sin,
                                                   degrees_to_turns)
    from phaserotate_tpu_torch.core.sizes import offline_geometry
    from phaserotate_tpu_torch.io import read_wav, write_wav
    from phaserotate_tpu_torch.kernels import _build
    from phaserotate_tpu_torch.kernels import stream_conv as sc
    from phaserotate_tpu_torch.kernels.rotate_peak import (
        rotate_peak_sweep_kernel, rotate_peak_sweep_plain)
    from phaserotate_tpu_torch.search import (
        apply_angles, find_min_peak_angle, select_min_peak_angles_batch,
        sweep_peaks_aux)
    from phaserotate_tpu_torch.search.sweep import aligned_pair

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
    sync()
    launches = dict(_build.launches)
    print(f"launches: {json.dumps(launches)}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the main path")

    # ---- outputs are right ----
    y_sub, _, _ = read_wav(out_sub)
    y_inp, _, _ = read_wav(out_inp)
    check(y_sub.shape == audio.shape and np.isfinite(y_sub).all(),
          "applied file: shape or finiteness")
    check(np.array_equal(y_sub, y_inp), "subprocess and in-process apply")
    with plain_kernels():
        x4 = torch.from_numpy(audio).to(dev)
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
    x4 = torch.from_numpy(audio).to(dev)
    b0, b1, _, _ = aligned_pair(x4, geom)
    cs = all_angle_cos_sin(dev)
    fb0, fb1, _, _ = aligned_pair(fleet, geom)
    for shape_name, (u0, u1) in (("4min stereo", (b0, b1)),
                                 ("fleet 64x2x10s", (fb0, fb1))):
        k = rotate_peak_sweep_kernel(u0, u1, cs)
        p = rotate_peak_sweep_plain(u0, u1, cs)
        check(torch.equal(k, p), f"sweep table not bit-equal ({shape_name})")
    sweep_ms = cuda_ms(lambda: rotate_peak_sweep_kernel(b0, b1, cs))
    sweep_plain_ms = cuda_ms(lambda: rotate_peak_sweep_plain(b0, b1, cs), 2)
    kernels.append(dict(
        name="rotate_peak_sweep", route="cuda",
        source="phaserotate_tpu_torch/csrc/rotate_peak.cu",
        replaces="phaserotate_tpu/kernels/rotate_peak.py:110",
        launches=launches["rotate_peak_sweep"], max_abs_err=0.0,
        ms=sweep_ms, plain_ms=sweep_plain_ms))

    conv_err = 0.0
    for xin in (x4, fleet):
        conv_err = max(conv_err, float(
            (sc.hilbert_small(xin, geom.parsiz)
             - sc.hilbert_small_plain(xin, geom.parsiz)).abs().max()))
    check(conv_err < 1e-5, f"hilbert_small vs plain: {conv_err}")
    kernels.append(dict(
        name="stream_conv_hilbert", route="cuda",
        source="phaserotate_tpu_torch/csrc/stream_conv.cu",
        replaces="phaserotate_tpu/kernels/stream_conv.py:261",
        launches=launches["hilbert_small"], max_abs_err=conv_err,
        ms=cuda_ms(lambda: sc.hilbert_small(x4, geom.parsiz)),
        plain_ms=cuda_ms(lambda: sc.hilbert_small_plain(x4, geom.parsiz), 2)))

    turns = degrees_to_turns(stem_degs)
    mix_err = float((sc.rotate_small(stems, turns, 3072)
                     - sc.rotate_small_plain(stems, turns, 3072)).abs().max())
    check(mix_err < 2e-5, f"rotate_small vs plain: {mix_err}")
    kernels.append(dict(
        name="stream_conv_mix", route="cuda",
        source="phaserotate_tpu_torch/csrc/stream_conv.cu",
        replaces="phaserotate_tpu/kernels/stream_conv.py:291",
        launches=launches["rotate_small"], max_abs_err=mix_err,
        ms=cuda_ms(lambda: sc.rotate_small(stems, turns, 3072)),
        plain_ms=cuda_ms(lambda: sc.rotate_small_plain(stems, turns, 3072),
                         2)))

    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']!r} ms, plain {k['plain_ms']!r} "
              f"ms, max_abs_err {k['max_abs_err']!r} [{card}]")
    secs_4min = n_4min / RATE
    print(f"cli analyze in-process: "
          f"{secs_4min / times['cli_analyze_inprocess']:.1f}x realtime "
          f"(4 min stereo) [{card}]")
    print(f"fleet search: {64 / times['fleet_search_64x2x10s']:.1f} files/s "
          f"[{card}]")
    print(f"rotate fir: {64 * 60 / times['rotate_fir_64x60s']:.1f}x realtime "
          f"(64 mono 60 s stems) [{card}]")
    check("jax" not in sys.modules and "phaserotate_tpu" not in sys.modules,
          "JAX was imported")
    print(f"peak device memory: {torch.cuda.max_memory_allocated()} bytes")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drivers of the analysis traffic: a catalogue on disk through
``fleet.analyze_paths``, and songs resident on the card through
``search.sweep.sweep_peaks_aux`` and the selection.

Both run the program in this process.  The window runs whole calls and
starts none after ``seconds``; ``analyze_xrt`` (the catalogue) and
``search_xrt`` (the resident songs) are the unpadded audio seconds of the
window's calls over their wall time.  Every answer of the
window is then held against the reference (``reference/offline.py``) on
the same samples the benchmark made, at the depth the configuration
states (``bits``)."""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from reference.dsp import MAXSAMPLE, cli_blksiz, cos_sin_table
from reference.offline import peak_table, select_angles

from . import roofline
from .outcome import Outcome
from .signals import music_device, sample_bits, song_seconds, write_wav
from .trace import DeviceTrace, Patches, Trace, span_wrapper

_SWEEP_FPS = roofline.sweep_flops_per_sample(cos_sin_table())


def _bucket_samples(n: int, blksiz: int) -> int:
    blocks = max(1, -(-n // blksiz))
    return (1 << (blocks - 1).bit_length()) * blksiz


def _prepare_program(clock, device, gate):
    """Import the program, start the card, load its kernel library and
    its host library: the set-up every analysis run pays.  Returns the
    device as a ``torch.device``."""
    if gate is not None:
        gate()
    import torch

    device = torch.device(device.type, device.index)

    import phaserotate_tpu_torch  # noqa: F401
    clock.mark("import")
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device).sum().item()
        clock.mark("cuda_context")
        from phaserotate_tpu_torch.kernels import _build

        _build.lib()
        clock.mark("kernel_library")
    from phaserotate_tpu_torch.io import native

    native.available()
    clock.mark("native_make")
    return device


def _kernel_calls(trace: Trace, patches: Patches) -> None:
    """Record each sweep and Hilbert launch of the search with its bound."""
    from phaserotate_tpu_torch.search import sweep

    def on_sweep(args, kwargs, out, ev):
        b0, cs = args[0], args[2]
        if cs.shape[1] != MAXSAMPLE:
            raise ValueError("the analysis cells sweep the CLI's table")
        n = b0.shape[-1]
        rows = b0.numel() // n
        trace.calls.append(dict(
            kind="sweep", rows=rows, n=n, events=ev,
            bound_ms=roofline.sweep_bound_ms(rows, n, MAXSAMPLE,
                                             _SWEEP_FPS)))

    def on_hilbert(args, kwargs, out, ev):
        x = args[0]
        taps = kwargs.get("fir_taps", args[1] if len(args) > 1 else None)
        n = x.shape[-1]
        rows = x.numel() // n
        trace.calls.append(dict(
            kind="hilbert", rows=rows, n=n, events=ev,
            bound_ms=roofline.conv_bound_ms(rows, n, out.shape[-1], taps)))

    patches.set(sweep, "rotate_peak_sweep_kernel", span_wrapper(
        sweep.rotate_peak_sweep_kernel, "sweep", trace, on_sweep))
    patches.set(sweep, "hilbert_small", span_wrapper(
        sweep.hilbert_small, "hilbert", trace, on_hilbert))


def _close_calls(trace: Trace) -> None:
    import torch

    torch.cuda.synchronize()
    for c in trace.calls:
        start, end = c.pop("events")
        c["event_ms"] = start.elapsed_time(end)


def _reference(keys_x, blksiz, stride, link) -> Dict[object, dict]:
    ref = {}
    for key, x in keys_x:
        table, rot0 = peak_table(x, blksiz)
        sel = select_angles(table[None], rot0[None], stride, link)[0]
        ref[key] = dict(table=table, rot0=rot0, units=sel["units"],
                        found=sel["found"])
    return ref


def catalogue(cell, seed: int, seconds: float, traced: bool, device,
              clock, tmpdir: str, gate=None) -> Outcome:
    """``fleet.analyze_paths`` over consecutive slices of a catalogue of
    PCM WAVs at the configuration's depth: distinct songs, each under
    several hard-linked names."""
    import torch

    cfg, tr = cell.config, cell.traffic
    bits = sample_bits(cfg)
    device = _prepare_program(clock, device, gate)
    from phaserotate_tpu_torch import fleet

    rate, ch = cfg["rate"], cfg["channels"]
    blksiz = cli_blksiz(rate, cfg["blksiz"])
    masters = cfg["masters"]
    secs = song_seconds(tr["files"], **masters["song_seconds"])
    n = [int(s * rate) for s in secs]
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 3])
    # the set of lengths is the same for every seed; the seed makes the
    # music, its peak level and the order of the catalogue
    pcm = {}
    base = os.path.join(tmpdir, "catalogue")
    os.makedirs(base)
    for i, ni in enumerate(n):
        x, q = music_device(seed, i, ch, ni, rate, masters["peak_dbfs"],
                            device, bits)
        pcm[i] = q.cpu().numpy()
        del x, q
        first = os.path.join(base, f"s{i:02d}_0.wav")
        write_wav(first, pcm[i], rate, bits)
        for k in range(1, tr["links"]):
            os.link(first, os.path.join(base, f"s{i:02d}_{k}.wav"))
    groups: Dict[int, List[int]] = {}
    for i, ni in enumerate(n):
        groups.setdefault(_bucket_samples(ni, blksiz), []).append(i)
    per_slice = tr["slice"] // len(n)
    batch = cfg["batch"]
    slices = []
    for s in range(tr["links"] // per_slice):
        paths = []
        for key in sorted(groups):
            names = [(i, os.path.join(base, f"s{i:02d}_{s * per_slice + k}"
                                      ".wav"))
                     for i in groups[key] for k in range(per_slice)]
            paths += [names[j] for j in rng.permutation(len(names))]
        slices.append(paths)
    clock.mark("catalogue_write")

    rows: List[dict] = []
    order: List[str] = []
    key_of = {p: i for sl in slices for i, p in sl}
    patches = Patches()
    select = fleet.select_min_peak_angles_batch

    def capture(tables, *a, **kw):
        res = select(tables, *a, **kw)
        r0 = kw.get("rot0")
        for t, r, s in zip(tables, r0, res):
            rows.append(dict(table=np.array(t), rot0=np.array(r),
                             units=list(s.angles_units), found=list(s.found)))
        return res

    def call(paths, transport=tr["transport"]) -> Dict[str, tuple]:
        return fleet.analyze_paths(
            [p for _, p in paths], blksiz=cfg["blksiz"], stride=cfg["stride"],
            link_channels=cfg["link"], batch=batch,
            transport=transport, device=device,
            progress=lambda p, _res, cached: order.append(p))

    patches.set(fleet, "select_min_peak_angles_batch", capture)
    try:
        # warm-up: a batch of each bucket's shape, the first through the
        # window's transport (the packer and the unpack on the card); at 16
        # bits the others as pcm16, which skips the host packer's seconds.
        # Deeper masters warm every bucket through the window's transport:
        # pcm16 is not the path measured, and a sound read of them may
        # refuse it
        for b, key in enumerate(sorted(groups)):
            first = [q for q in slices[0] if _bucket_samples(
                n[q[0]], blksiz) == key][:batch]
            call(first, tr["transport"] if b == 0 or bits != 16
                 else "pcm16")
        rows.clear()
        order.clear()
        clock.mark("warmup")

        trace = Trace()
        dev_trace = None
        if traced:
            from phaserotate_tpu_torch.io import audio as io_audio
            import phaserotate_tpu_torch.io as io_pkg
            from phaserotate_tpu_torch.search import packed

            patches.set(io_pkg, "read_audio_pcm16", span_wrapper(
                io_audio.read_audio_pcm16, "decode", trace))
            patches.set(packed, "pack_adaptive", span_wrapper(
                packed.pack_adaptive, "pack", trace))
            patches.set(fleet, "select_min_peak_angles_batch", span_wrapper(
                capture, "select", trace))
            if device.type == "cuda":
                _kernel_calls(trace, patches)
                dev_trace = DeviceTrace(tmpdir)
                dev_trace.start()
        t_start = time.monotonic()
        setup_s = clock.total(t_start)
        calls = []
        k = 0
        while time.monotonic() - t_start < seconds:
            sl = slices[k % len(slices)]
            t0 = time.monotonic()
            res = call(sl)
            calls.append((t0, time.monotonic(), len(sl),
                          sum(n[i] for i, p in sl if p in res) / rate,
                          sum(1 for _, p in sl if p not in res)))
            k += 1
        if dev_trace is not None:
            trace.device, trace.window = dev_trace.stop()
            _close_calls(trace)
    finally:
        patches.restore()
    wall = calls[-1][1] - calls[0][0]
    audio_s = sum(c[3] for c in calls)
    attempted = sum(c[2] for c in calls)
    failed = sum(c[4] for c in calls) + max(0, attempted - len(rows))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    for r, p in zip(rows, order):
        r["key"] = key_of[p]
    t_ref = time.monotonic()
    full = float(1 << (bits - 1))
    ref = _reference(
        ((i, torch.from_numpy(pcm[i]).to(device).to(torch.float64) / full)
         for i in sorted(pcm)), blksiz, cfg["stride"], cfg["link"])
    from .judge import analysis_numbers

    numbers = analysis_numbers(rows, ref)
    return Outcome(
        e2e={"analyze_xrt": audio_s / wall}, setup_s=setup_s,
        attempted=attempted, failed=failed, numbers=numbers,
        memory_peak=int(peak), trace=trace if traced else None,
        info=dict(calls=len(calls), call_s=[c[1] - c[0] for c in calls],
                  window_s=wall, audio_s=audio_s,
                  rows=len(rows), reference_s=time.monotonic() - t_ref))


def resident(cell, seed: int, seconds: float, traced: bool, device,
             clock, tmpdir: str, gate=None) -> Outcome:
    """``sweep_peaks_aux`` and the selection over batches of songs that
    stay on the card, zero-padded to their bucket as the fleet pads, on
    the configuration's grid."""
    import torch

    cfg, tr = cell.config, cell.traffic
    bits = sample_bits(cfg)
    device = _prepare_program(clock, device, gate)
    from phaserotate_tpu_torch.core.sizes import offline_geometry
    from phaserotate_tpu_torch.search.minimize import (
        select_min_peak_angles_batch)
    from phaserotate_tpu_torch.search.sweep import sweep_peaks_aux

    rate, ch = cfg["rate"], cfg["channels"]
    blksiz = cli_blksiz(rate, cfg["blksiz"])
    geom = offline_geometry(rate, cfg["blksiz"])
    masters = cfg["masters"]
    secs = song_seconds(tr["songs"], **masters["song_seconds"])
    n = [int(s * rate) for s in secs]
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 4])
    groups: Dict[int, List[int]] = {}
    for i, ni in enumerate(n):
        groups.setdefault(_bucket_samples(ni, blksiz), []).append(i)
    batches = []  # (songs, tensor)
    for key in sorted(groups):
        songs = [groups[key][j] for j in rng.permutation(len(groups[key]))]
        for b in range(0, len(songs), tr["batch"]):
            part = songs[b : b + tr["batch"]]
            x = torch.zeros((len(part), ch, key), dtype=torch.float32,
                            device=device)
            for r, i in enumerate(part):
                x[r, :, : n[i]] = music_device(
                    seed, i, ch, n[i], rate, masters["peak_dbfs"], device,
                    bits)[0]
            batches.append((part, x))
    clock.mark("songs_on_card")

    rows: List[dict] = []
    trace = Trace()
    spans = [False]

    def span(name, t0, t1):
        if spans[0]:
            trace.spans.append((name, t0, t1))

    def call(part, x):
        t0 = time.time_ns()
        table, rot0 = sweep_peaks_aux(x, geom, device=device)
        t1 = time.time_ns()
        table, rot0 = table.cpu().numpy(), rot0.cpu().numpy()
        t2 = time.time_ns()
        res = select_min_peak_angles_batch(
            table, stride=cfg["stride"], link_channels=cfg["link"], rot0=rot0)
        t3 = time.time_ns()
        span("sweep_peaks_aux", t0, t1)
        span("readback", t1, t2)
        span("select", t2, t3)
        for i, t, r, s in zip(part, table, rot0, res):
            rows.append(dict(key=i, table=t, rot0=r,
                             units=list(s.angles_units), found=list(s.found)))

    shapes = {}
    for part, x in batches:
        shapes.setdefault(tuple(x.shape), (part, x))
    for part, x in shapes.values():
        call(part, x)
    rows.clear()
    clock.mark("warmup")

    patches = Patches()
    dev_trace = None
    spans[0] = traced
    try:
        if traced and device.type == "cuda":
            _kernel_calls(trace, patches)
            dev_trace = DeviceTrace(tmpdir)
            dev_trace.start()
        t_start = time.monotonic()
        setup_s = clock.total(t_start)
        k = 0
        audio_s = 0.0
        while time.monotonic() - t_start < seconds:
            part, x = batches[k % len(batches)]
            call(part, x)
            audio_s += sum(n[i] for i in part) / rate
            k += 1
        t_end = time.monotonic()
        if dev_trace is not None:
            trace.device, trace.window = dev_trace.stop()
            _close_calls(trace)
    finally:
        patches.restore()
    attempted = sum(len(batches[j % len(batches)][0]) for j in range(k))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    songs = {}
    for part, x in batches:
        for r, i in enumerate(part):
            songs[i] = x[r, :, : n[i]]
    t_ref = time.monotonic()
    ref = _reference(((i, songs[i].to(torch.float64)) for i in sorted(songs)),
                     blksiz, cfg["stride"], cfg["link"])
    from .judge import analysis_numbers

    numbers = analysis_numbers(rows, ref)
    return Outcome(
        e2e={"search_xrt": audio_s / (t_end - t_start)}, setup_s=setup_s,
        attempted=attempted, failed=attempted - len(rows), numbers=numbers,
        memory_peak=int(peak), trace=trace if traced else None,
        info=dict(calls=k, window_s=t_end - t_start, audio_s=audio_s,
                  rows=len(rows), reference_s=time.monotonic() - t_ref))

"""Fleet CLI: minimum-peak analysis/apply over MANY files at once (torch).

Counterpart of ``phaserotate_tpu/fleet.py``: the same flags, the same
printed lines, the same checkpoint files.  The reference processes one
file per invocation (cli/phase-rotate.cc main); batch jobs shell-loop
over it, paying a full coarse+fine pass per file serially.  On an accelerator the economics invert — the sweep
batches hundreds of files into one device pass — so the framework ships
a first-class fleet front end:

    python -m phaserotate_tpu_torch.fleet *.wav  # analyze, print angles
    python -m phaserotate_tpu_torch.fleet -l --checkpoint s.npz *.flac
    python -m phaserotate_tpu_torch.fleet --apply --outdir out/ *.wav

The work runs on the CUDA device, one device as in the JAX package;
without one the command exits with an error unless the CPU is asked for
(``main(argv, device="cpu")``).

Pipeline per batch: read -> decode straight to int16 PCM
(io.read_audio_pcm16 — no host floats for 16-bit sources) -> ship
as int16 or bit-packed to the device -> batched sweep (all 360
angle-table entries at once) -> vectorized CLI-parity selection.  A
24-bit integer PCM WAV is read exactly instead (io/pcm24.py: its data
payload straight into the batch buffer, 3 bytes a sample) and shipped as
it is (the ``pcm24`` wire), widened on the device
(search.sweep_peaks_aux_pcm24); the 16-bit transports would drop its low
8 bits, so ``pcm16`` and ``packed`` refuse such a file.  Every other
source (24-bit FLAC or AIFF among them) takes the int16 path.  CUDA
launches are asynchronous, so the decode of batch k+1 overlaps the device
pass of batch k; a batch's only synchronisation is the readback of its
tables.

Files bucket by (rate, channels, padded length, depth read); padding with
silence is EXACT for the peak table: beyond the flush block the Hilbert
FIR has fully rung out (its support is one partition), so zero blocks
contribute zero pairs — same tables as per-file runs (tested).

Sweeps persist via --checkpoint (utils/checkpoint.SweepCheckpoint):
interrupted fleets resume, and selection reruns (different stride/-l)
reuse stored tables without touching the device.  A checkpoint written
by either package resumes in the other.

Tracing (utils/profiling): the staging thread (``fleet-stage``) records
``fleet.stage`` per batch, ``fleet.decode`` per file and ``fleet.pack``
per batch (attribute ``transport``: packed, pcm16 or pcm24); the dispatch
loop records ``fleet.stage_wait`` (waiting for the staging thread),
``fleet.dispatch`` (transfer, unpack or widen, sweep enqueue) and
``fleet.readback``; each batch counts ``fleet.wire_bytes`` and
``fleet.pcm16_bytes`` (a 24-bit batch only the former), and
``search.sweep_peaks_aux_pcm24`` records ``pcm24.widen``.  They record
only under a ``torch.profiler`` session or a ``recording()`` scope;
``PHASEROTATE_TPU_PROFILE=<dir>`` writes a profile of the whole command
as a Chrome trace into ``<dir>``, the spans of both threads beside the
kernels.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core.angles import SUBSAMPLE
from .core.device import resolve_device
from .core.sizes import offline_geometry
from .search.minimize import SearchResult, select_min_peak_angles_batch
from .utils.profiling import count, device_trace, span

__all__ = ["analyze_paths", "apply_paths", "main"]


def _bucket_key(rate: int, channels: int, n: int, bits: int, parsiz: int):
    """Pad the block count to the next power of two: a homogeneous
    fleet runs at ONE device shape per (rate, channels, depth) group."""
    blocks = max(1, -(-n // parsiz))
    padded = 1 << (blocks - 1).bit_length()
    return rate, channels, padded * parsiz, bits


def _probe(path: str) -> Tuple[int, int, int, int]:
    """(rate, channels, samples, bits) from headers where possible — pass
    1 must not hold (or even produce) decoded audio for the whole fleet:
    a 1k-file job would pin ~10 GB, and lossy inputs would pay their
    decode twice (probe + stage).  A RIFF/WAVE file's chunk headers are
    walked without reading its audio (io/pcm24.py); io.probe_audio reads
    FLAC headers and Ogg Vorbis/Opus identification + final-granule data;
    only headerless formats fall back to a decode.  ``bits`` is the depth
    the fleet reads the file at: 24 for 24-bit integer PCM WAV, else 16."""
    from .io.audio import probe_audio
    from .io.pcm24 import is_pcm24, read_header

    with open(path, "rb") as f:
        riff = f.read(4) == b"RIFF"
    if riff:
        h = read_header(path)
        return h.rate, h.channels, h.frames, 24 if is_pcm24(h) else 16
    return (*probe_audio(path), 16)


def analyze_paths(
    paths: Sequence[str],
    blksiz: int = 0,
    stride: int = 12 * SUBSAMPLE,
    link_channels: bool = False,
    batch: int = 64,
    checkpoint: Optional[str] = None,
    progress=None,
    transport: str = "auto",
    device=None,
) -> Dict[str, Tuple[SearchResult, int]]:
    """Analyze many files -> {path: (SearchResult, rate)}.

    Files are decoded to int16 PCM on a background thread (overlapped
    with the device sweep of the previous batch), bucketed by geometry,
    zero-padded to the bucket length, and swept ``batch`` files per
    device dispatch.

    ``transport`` picks the host->device wire format: "pcm16" ships the
    raw 16-bit bitcast; "packed" ships the lossless residual transport
    (search/packed.py); "auto" packs on the staging thread and ships
    whichever is smaller per batch — compressible masters ride the
    packed wire, noisy ones skip the overhead.  All three are
    value-identical (the unpack is bit-exact).  A 24-bit PCM WAV rides
    neither 16-bit wire: "auto" ships its batch as the files' 3-byte
    samples (pcm24), and "pcm16" or "packed" raise ``ValueError`` for it
    before anything is decoded.

    ``device`` is where the sweeps run (default: the CUDA device;
    ``"cpu"`` for the CPU).
    """
    from .io import read_audio_pcm16
    from .io.pcm24 import read_pcm24_into
    from .search.packed import (
        pack_adaptive,
        pack_residual,
        sweep_peaks_aux_packed,
    )
    from .search.sweep import sweep_peaks_aux_pcm16, sweep_peaks_aux_pcm24
    from .utils.checkpoint import SweepCheckpoint

    if transport not in ("auto", "pcm16", "packed"):
        raise ValueError(f"unknown transport {transport!r}")
    device = resolve_device(device)

    ckpt = None
    results: Dict[str, Tuple[SearchResult, int]] = {}

    # pass 1: header probes only — audio decodes lazily per batch, so
    # fleet memory stays O(batch), not O(fleet)
    buckets: Dict[tuple, List[str]] = {}
    meta: Dict[str, tuple] = {}
    for p in paths:
        rate, channels, n, bits = _probe(p)
        if bits == 24 and transport != "auto":
            raise ValueError(f"{p}: 24-bit PCM; transport {transport!r} "
                             "carries 16 bits (use 'auto')")
        geom = offline_geometry(rate, blksiz)
        if ckpt is None and checkpoint:
            ckpt = SweepCheckpoint(checkpoint, blksiz=geom.blksiz)
        key = _bucket_key(rate, channels, n, bits, geom.parsiz)
        meta[p] = (rate, geom)
        if ckpt is not None and p in ckpt:
            table, rot0 = ckpt.get(p)
            results[p] = (select_min_peak_angles_batch(
                table[None], stride=stride, link_channels=link_channels,
                rot0=rot0[None])[0], rate)
            if progress:
                progress(p, results[p][0], cached=True)
            continue
        buckets.setdefault(key, []).append(p)

    pool = ThreadPoolExecutor(1, thread_name_prefix="fleet-stage")

    def stage(group: List[str], key):
        """Decode a batch; returns the transport object to dispatch —
        an int16 array (pcm16), a PackedChunk, or at 24 bits a (files,
        n_pad, channels, 3) uint8 array of the files' samples (pcm24).
        Runs on the staging thread (numpy and the host library only; no
        torch call but the spans' ``record_function`` under a profiler
        session), so the pack overlaps the previous batch's device pass."""
        with span("fleet.stage"):
            rate, channels, n_pad, bits = key
            if bits == 24:
                buf = np.zeros((len(group), n_pad, channels, 3), np.uint8)
                for i, p in enumerate(group):
                    with span("fleet.decode"):
                        read_pcm24_into(p, buf[i])
                # nothing to pack: the span records the wire shipped
                with span("fleet.pack", transport="pcm24"):
                    pass
                count("fleet.wire_bytes", buf.nbytes)
                return buf
            buf = np.zeros((len(group), channels, n_pad), np.int16)
            for i, p in enumerate(group):
                with span("fleet.decode"):
                    audio = read_audio_pcm16(p)[0]
                buf[i, :, : min(audio.shape[1], n_pad)] = \
                    audio[:, :n_pad]
            with span("fleet.pack") as packing:
                obj = buf
                if transport == "packed":
                    obj = pack_residual(buf)
                elif transport == "auto":
                    scratch = np.empty(
                        max(1 << 16, buf.size * 16 // 32), np.int32)
                    pk = pack_adaptive(buf, scratch)
                    if pk is not None:
                        obj = pk
                packed = obj is not buf
                packing.set(transport="packed" if packed else "pcm16")
            count("fleet.wire_bytes",
                  obj.wire_bytes if packed else buf.nbytes)
            count("fleet.pcm16_bytes", buf.nbytes)
            return obj

    def dispatch(obj, geom):
        from .search.packed import PackedChunk

        with span("fleet.dispatch"):
            if isinstance(obj, PackedChunk):
                return sweep_peaks_aux_packed(obj, geom, device=device)
            if obj.dtype == np.uint8:
                return sweep_peaks_aux_pcm24(obj, geom, device=device)
            return sweep_peaks_aux_pcm16(obj, geom, device=device)

    def finish(pending, rate) -> None:
        """Read one in-flight sweep back (the batch's only
        synchronisation) and emit its selections."""
        names, handles = pending
        with span("fleet.readback"):
            tables = handles[0].cpu().numpy()
            rot0 = handles[1].cpu().numpy()
        sel = select_min_peak_angles_batch(
            tables, stride=stride, link_channels=link_channels,
            rot0=rot0)
        for i, p in enumerate(names):
            results[p] = (sel[i], rate)
            if ckpt is not None:
                ckpt.put(p, tables[i], rot0[i])
            if progress:
                progress(p, sel[i], cached=False)

    try:
        for key, group in buckets.items():
            rate = key[0]
            geom = meta[group[0]][1]
            batches = [group[i : i + batch]
                       for i in range(0, len(group), batch)]
            fut = pool.submit(stage, batches[0], key)
            # one batch of readback slack: batch k's sweep is read back
            # only after batch k+1's transfer+sweep were dispatched, so
            # the card always has the next batch queued (the copy from
            # stage's fresh pageable buffer has ended when dispatch
            # returns, so the buffer need not outlive it)
            pending = None
            for bi, names in enumerate(batches):
                with span("fleet.stage_wait"):
                    obj = fut.result()
                if bi + 1 < len(batches):
                    fut = pool.submit(stage, batches[bi + 1], key)
                handles = dispatch(obj, geom)
                if pending is not None:
                    finish(pending, rate)
                pending = (names, handles)
            if pending is not None:
                finish(pending, rate)
    finally:
        pool.shutdown()
    return results


def _apply_one(path: str, outdir: str, result: SearchResult,
               blksiz: int, device=None) -> str:
    from .io import read_audio, write_audio
    from .search.sweep import apply_angles

    audio, rate, meta = read_audio(path)
    geom = offline_geometry(rate, blksiz)
    y = apply_angles(
        np.atleast_2d(np.asarray(audio, np.float32)),
        np.asarray(result.angles_units), geom, device=device).cpu().numpy()
    dst = os.path.join(outdir, os.path.basename(path))
    write_audio(dst, y, rate, meta, like=path)
    return dst


def apply_paths(
    paths: Sequence[str],
    results: Dict[str, Tuple[SearchResult, int]],
    outdir: str,
    blksiz: int = 0,
    batch: int = 16,
    progress=None,
    device=None,
) -> Dict[str, str]:
    """Write rotated copies of many files with BATCHED device passes.

    The analyze pass is batched (analyze_paths); a per-file apply would
    undo that — one small dispatch per file.  Here files bucket by
    (rate, channels, padded length)
    exactly like the sweep (zero-padding is EXACT for apply too: the
    Hilbert FIR is causal with one-partition support, so outputs at
    m < n never see the pad — parity-tested against per-file
    apply_angles), decode/encode ride a staging thread, and one device
    pass rotates ``batch`` files.

    Returns {path: written path}.
    """
    from .io import read_audio, write_audio
    from .search.sweep import apply_angles

    device = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    written: Dict[str, str] = {}

    buckets: Dict[tuple, List[str]] = {}
    meta: Dict[str, tuple] = {}
    for p in paths:
        rate, channels, n, bits = _probe(p)
        geom = offline_geometry(rate, blksiz)
        key = _bucket_key(rate, channels, n, bits, geom.parsiz)
        meta[p] = (rate, geom)
        buckets.setdefault(key, []).append(p)

    pool = ThreadPoolExecutor(1)

    def stage(group: List[str], key):
        rate, channels, n_pad, _bits = key
        buf = np.zeros((len(group), channels, n_pad), np.float32)
        lens = []
        metas = []
        for i, p in enumerate(group):
            audio, _rate, m = read_audio(p)
            audio = np.atleast_2d(np.asarray(audio, np.float32))
            lens.append(audio.shape[1])
            metas.append(m)
            buf[i, :, : min(audio.shape[1], n_pad)] = audio[:, :n_pad]
        units = np.stack([
            np.broadcast_to(
                np.asarray(results[p][0].angles_units, np.int32),
                (channels,))
            for p in group])
        return buf, units, lens, metas

    def finish(pending, rate) -> None:
        names, handle, lens, metas = pending
        y = handle.cpu().numpy()
        for i, p in enumerate(names):
            dst = os.path.join(outdir, os.path.basename(p))
            write_audio(dst, y[i, :, : lens[i]], rate, metas[i],
                        like=p)
            written[p] = dst
            if progress:
                progress(p, dst)

    try:
        for key, group in buckets.items():
            rate = key[0]
            geom = meta[group[0]][1]
            parts = [group[i : i + batch]
                     for i in range(0, len(group), batch)]
            fut = pool.submit(stage, parts[0], key)
            pending = None
            for bi, names in enumerate(parts):
                buf, units, lens, metas = fut.result()
                if bi + 1 < len(parts):
                    fut = pool.submit(stage, parts[bi + 1], key)
                handle = apply_angles(buf, units, geom, device=device)
                if pending is not None:
                    finish(pending, rate)
                pending = (names, handle, lens, metas)
            if pending is not None:
                finish(pending, rate)
    finally:
        pool.shutdown()
    return written


def main(argv=None, device=None) -> int:
    """Run the command line ``argv``; ``device`` is where the audio is
    processed (default: the CUDA device).  ``PHASEROTATE_TPU_PROFILE=<dir>``
    writes a ``torch.profiler`` Chrome trace of the run into ``<dir>``, the
    ``fleet.*`` spans beside the kernels, as the CLI does."""
    profile_dir = os.environ.get("PHASEROTATE_TPU_PROFILE")
    if profile_dir:
        with device_trace(profile_dir):
            return _main(argv, device)
    return _main(argv, device)


def _main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="phase-rotate-fleet",
        description="Batched minimum-peak analysis over many files "
                    "(one device pass sweeps a whole batch).")
    ap.add_argument("files", nargs="+")
    ap.add_argument("-f", "--fftlen", type=int, default=0,
                    help="block size (as phase-rotate -f; 0 = rate/8)")
    ap.add_argument("-s", "--stride", type=int, default=12 * SUBSAMPLE,
                    help="coarse step in half-degrees (default 24)")
    ap.add_argument("-l", "--link", action="store_true",
                    help="link channels (cross-channel max)")
    ap.add_argument("--batch", type=int, default=64,
                    help="files per device dispatch (default 64)")
    ap.add_argument("--checkpoint", default=None,
                    help="sweep-table store for resumable fleets")
    ap.add_argument("--transport", default="auto",
                    choices=("auto", "pcm16", "packed"),
                    help="host->device wire format (auto: ship the "
                         "smaller of packed residuals / raw pcm16; a "
                         "24-bit PCM WAV ships its raw 24-bit samples, "
                         "which pcm16 and packed refuse)")
    ap.add_argument("--apply", action="store_true",
                    help="write rotated copies of every file")
    ap.add_argument("--outdir", default=None,
                    help="output directory for --apply")
    args = ap.parse_args(argv)
    if args.apply and not args.outdir:
        ap.error("--apply requires --outdir")
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    def show(path, res: SearchResult, cached: bool):
        note = "  (cached sweep)" if cached else ""
        for c, (deg, found) in enumerate(zip(res.angles_deg, res.found)):
            if found:
                print(f"{path}  ch {c + 1}: {deg:+.2f} deg{note}")
            else:
                print(f"{path}  ch {c + 1}: no improvement{note}")

    results = analyze_paths(
        args.files, blksiz=args.fftlen, stride=args.stride,
        link_channels=args.link, batch=args.batch,
        checkpoint=args.checkpoint, progress=show,
        transport=args.transport, device=device)

    if args.apply:
        apply_paths(
            args.files, results, args.outdir, blksiz=args.fftlen,
            batch=args.batch, device=device,
            progress=lambda _p, dst: print(f"wrote {dst}",
                                           file=sys.stderr))
    return 0


if __name__ == "__main__":
    sys.exit(main())

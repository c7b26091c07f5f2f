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

Pipeline per batch: read -> decode straight to int16 PCM (a 16-bit PCM
WAV's samples read from the file into the batch buffer, io/pcm16.py;
any other source through io.read_audio_pcm16 — no host floats for
16-bit sources) -> ship as int16 or bit-packed to the device (unpacked
there by one kernel, csrc/wire_unpack.cu) -> batched sweep (all 360
angle-table entries at once) -> vectorized CLI-parity selection.  A
24-bit integer PCM WAV is read exactly instead (io/pcm24.py: its data
payload straight into the batch buffer, 3 bytes a sample) and shipped as
it is (the ``pcm24`` wire), widened on the device
(search.sweep_peaks_aux_pcm24); the 16-bit transports would drop its low
8 bits, so ``pcm16`` and ``packed`` refuse such a file.  Every other
source (24-bit FLAC or AIFF among them) takes the int16 path.

Every batch is staged the same way: the staging thread takes one of two
reused host slots of a ``_StagingRing``, the batch's files are decoded
into their rows of it at once on the call's decode threads (as many as
the files, but at most the CPUs the process may run on less one, which
the dispatch thread keeps; one file, or one such CPU, decodes on the
staging thread), and the dispatch thread copies the slot's wire to the
device in one non-blocking copy, then records a CUDA event that tells
the staging thread when it may write that slot again.  The process
keeps one ring (``_RING``), pinned where the sweeps run on a card and
used by one call at a time; each of its slots holds at most half of a
quarter of the host's memory, so the batch plan splits a batch over that
share into the fewest consecutive batches that fit, the files in their
order.  A call that finds the ring
taken, or whose plan still holds a batch over the share (one file alone
over it, or a host that does not say its memory size), stages through a
ring of its own in plain host memory, dropped when it returns.  CUDA
launches are asynchronous, so the decode of batch k+1 overlaps the copy
and device pass of batch k, across a bucket's edge too; a batch's only
synchronisation is the readback of its tables.  ``apply_paths`` shares
the batch plan and the run-ahead loop, and stages its float32 batches
in fresh host arrays.

Files bucket by (rate, channels, padded length, depth read); padding with
silence is EXACT for the peak table: beyond the flush block the Hilbert
FIR has fully rung out (its support is one partition), so zero blocks
contribute zero pairs — same tables as per-file runs (tested).

Sweeps persist via --checkpoint (utils/checkpoint.SweepCheckpoint):
interrupted fleets resume, and selection reruns (different stride/-l)
reuse stored tables without touching the device.  A checkpoint written
by either package resumes in the other.

Tracing (utils/profiling): the staging thread (``fleet-stage``) records
``fleet.stage`` and ``fleet.pack`` per batch (attribute ``transport``:
packed, pcm16 or pcm24) and counts ``fleet.decode_workers``, the threads
that decoded the batch, and ``fleet.decode_copied``, its files that took
``read_audio_pcm16`` (every 16-bit file but a 16-bit PCM WAV); each
file's decode thread (``fleet-stage-decode``, or the staging thread)
records its ``fleet.decode``; the dispatch
loop records ``fleet.stage_wait`` (waiting for the staging thread),
``fleet.dispatch`` (transfer, unpack or widen, sweep enqueue) and
``fleet.readback``; each batch counts ``fleet.wire_bytes`` and
``fleet.pcm16_bytes`` (not for a 24-bit batch), and
``search.sweep_peaks_aux_pcm24`` records ``pcm24.widen``.  They record
only under a ``torch.profiler`` session or a ``recording()`` scope;
``PHASEROTATE_TPU_PROFILE=<dir>`` writes a profile of the whole command
as a Chrome trace into ``<dir>``, the spans of both threads beside the
kernels.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from operator import itemgetter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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


# where each array of a slot starts: a multiple of this many bytes, so
# its copy on the card is aligned for its dtype and for vector loads
_ALIGN = 256
_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _ring_cap_bytes() -> int:
    """The most host memory the staging ring may hold: a quarter of the
    host's physical memory (0 where the host does not say)."""
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4
    except (ValueError, OSError):
        return 0


def _decode_workers(files: int) -> int:
    """Threads that decode a batch of ``files`` files: the CPUs this
    process may run on but one (the dispatch thread's), no more than the
    files, and at least one."""
    return max(1, min(files, len(os.sched_getaffinity(0)) - 1))


def _wire_layout(key, files: int, transport: str) -> Tuple[int, int]:
    """(pcm bytes, scratch words) of a batch's slot.

    A 24-bit batch is its (files, n_pad, channels, 3) bytes alone.  A
    16-bit batch is its int16 samples, then the packer's scratch, which
    holds the whole packed wire, so a packed batch ships as one range of
    the slot.  pcm16 lays out the scratch of auto, whose batches it warms
    up."""
    from .search.packed import scratch_words

    _rate, channels, n_pad, bits = key
    if bits == 24:
        return files * n_pad * channels * 3, 0
    return (files * channels * n_pad * 2,
            scratch_words((files, channels, n_pad),
                          None if transport == "packed" else 0.9))


def _slot_bytes(key, files: int, transport: str) -> int:
    pcm, words = _wire_layout(key, files, transport)
    return _aligned(pcm) + _aligned(words * 4)


class _Slot:
    """One host buffer of the ring: a (bytes,) uint8 tensor, its numpy
    view, and the CUDA event recorded after the last copy from it."""

    def __init__(self) -> None:
        self.host: Optional[torch.Tensor] = None
        self.array: Optional[np.ndarray] = None
        self.copied = None

    def wait(self) -> None:
        """Return once the last copy from the slot has ended (the wait
        releases the GIL)."""
        done, self.copied = self.copied, None
        if done is not None:
            done.synchronize()

    def view(self, offset: int, shape, dtype) -> np.ndarray:
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return self.array[offset : offset + nbytes].view(dtype).reshape(shape)

    def send(self, arrays, device) -> list:
        """``arrays`` (contiguous views of the slot) on ``device``: one
        non-blocking copy of the byte range that holds them, then an event
        the staging thread waits on before it writes the slot again."""
        offs = [a.ctypes.data - self.array.ctypes.data for a in arrays]
        lo = min(offs)
        hi = max(o + a.nbytes for o, a in zip(offs, arrays))
        wire = self.host[lo:hi].to(device, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record(torch.cuda.current_stream(device))
        return [wire[o - lo : o - lo + a.nbytes]
                .view(_TORCH_DTYPE[a.dtype]).view(a.shape)
                for o, a in zip(offs, arrays)]


class _StagingRing:
    """Two host buffers the staging thread writes each batch's wire into,
    in turn.

    Pinned where the sweeps run on a card, so the copy to it is a
    non-blocking DMA; plain host memory on the CPU and in a call's own
    ring.  Both slots grow together, to the largest batch of a call, at
    the call's start while nothing is copied from them, and never shrink.
    The process's ring, ``_RING``, serves one call at a time (``lock``)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.slots = [_Slot(), _Slot()]
        self.nbytes = 0          # each slot's size
        self.pinned = False
        self._next = 0

    def reserve(self, nbytes: int, pinned: bool) -> None:
        """Grow every slot to hold ``nbytes`` (rounded up to a power of
        two, as the pinned host allocator rounds), pinned or not."""
        size = _pow2(nbytes)
        if pinned == self.pinned and size <= self.nbytes:
            return
        for slot in self.slots:
            slot.wait()
            slot.host = slot.array = None
        if self.pinned:
            # hand the old slots' pages back rather than keep them cached
            empty = getattr(torch._C, "_host_emptyCache", None)
            if empty is not None:
                empty()
        for slot in self.slots:
            slot.host = torch.empty(size, dtype=torch.uint8,
                                    pin_memory=pinned)
            slot.array = slot.host.numpy()
        self.nbytes, self.pinned = size, pinned

    def take(self) -> _Slot:
        """The next slot, once the last copy from it has ended."""
        slot = self.slots[self._next]
        self._next = (self._next + 1) % len(self.slots)
        slot.wait()
        return slot


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


_RING = _StagingRing()


def _plan(paths: Sequence[str], blksiz: int, batch: int, keep=None,
          fits=None) -> List[tuple]:
    """A call's batches, bucket after bucket: (names, key, geometry).

    Pass 1 probes headers only — audio decodes lazily per batch, so
    fleet memory stays O(batch), not O(fleet) — and buckets the files by
    ``_bucket_key``; ``keep(path, rate, bits, geometry)`` False leaves a
    file out.  Where ``fits(key, files)`` says a batch's slot is over the
    ring's share, the batch is split into the fewest consecutive batches
    that fit; one whose single file does not fit stays whole."""
    buckets: Dict[tuple, tuple] = {}
    for p in paths:
        rate, channels, n, bits = _probe(p)
        geom = offline_geometry(rate, blksiz)
        if keep is None or keep(p, rate, bits, geom):
            key = _bucket_key(rate, channels, n, bits, geom.parsiz)
            buckets.setdefault(key, (geom, []))[1].append(p)
    plan = []
    for key, (geom, group) in buckets.items():
        for i in range(0, len(group), batch):
            names = group[i : i + batch]
            step = len(names)
            if fits is not None:
                step = next((k for k in range(step, 0, -1) if fits(key, k)),
                            step)
            plan += [(names[j : j + step], key, geom)
                     for j in range(0, len(names), step)]
    return plan


def _run_ahead(plan: List[tuple], stage, dispatch, finish) -> None:
    """Run the batches of ``plan`` one ahead: the staging thread stages
    batch k+1 (``stage(*batch)``) while batch k is dispatched
    (``dispatch(batch, staged)`` enqueues it and returns its handles),
    and only then is batch k-1 finished (``finish(batch, handles)``, its
    only synchronisation), so the device always has the next batch
    queued; a bucket's edge is no different."""
    pool = ThreadPoolExecutor(1, thread_name_prefix="fleet-stage")
    try:
        fut = pool.submit(stage, *plan[0]) if plan else None
        pending = None
        for k, item in enumerate(plan):
            with span("fleet.stage_wait"):
                staged = fut.result()
            if k + 1 < len(plan):
                fut = pool.submit(stage, *plan[k + 1])
            handles = dispatch(item, staged)
            if pending is not None:
                finish(*pending)
            pending = (item, handles)
        if pending is not None:
            finish(*pending)
    finally:
        pool.shutdown()


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

    Files are bucketed by geometry, decoded to int16 PCM into the staging
    ring by a background thread and its decode threads, a batch's files
    at once (overlapped with the copy and device sweep of the previous
    batch), zero-padded to the bucket length, and
    swept ``batch`` files per device dispatch (fewer where a batch would
    not fit a slot of the ring).

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
    from .io.pcm16 import read_pcm16_into
    from .io.pcm24 import read_pcm24_into
    from .io.wav import WavFormatError
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

    def keep(p: str, rate: int, bits: int, geom) -> bool:
        """False for a file whose sweep the checkpoint holds: its
        selection is made here."""
        nonlocal ckpt
        if bits == 24 and transport != "auto":
            raise ValueError(f"{p}: 24-bit PCM; transport {transport!r} "
                             "carries 16 bits (use 'auto')")
        if ckpt is None and checkpoint:
            ckpt = SweepCheckpoint(checkpoint, blksiz=geom.blksiz)
        if ckpt is None or p not in ckpt:
            return True
        table, rot0 = ckpt.get(p)
        results[p] = (select_min_peak_angles_batch(
            table[None], stride=stride, link_channels=link_channels,
            rot0=rot0[None])[0], rate)
        if progress:
            progress(p, results[p][0], cached=True)
        return False

    share = _ring_cap_bytes() // len(_RING.slots)
    plan = _plan(paths, blksiz, batch, keep, lambda key, files: _pow2(
        _slot_bytes(key, files, transport)) <= share)
    if not plan:
        return results
    # the call's own decode threads: they start as batches need them
    decoders = ThreadPoolExecutor(
        max(_decode_workers(len(names)) for names, _, _ in plan),
        thread_name_prefix="fleet-stage-decode")
    largest = max(_slot_bytes(key, len(names), transport)
                  for names, key, _ in plan)
    # the process's ring where it is free and holds every batch; else a
    # ring of the call's own, in plain host memory
    shared = (_pow2(largest) <= share
              and _RING.lock.acquire(blocking=False))
    ring = _RING if shared else _StagingRing()

    def pcm16_into(p: str, rows: np.ndarray, copied: List[str]) -> int:
        """The file's int16 samples into ``rows`` (frames, channels);
        returns the frames written.  A 16-bit PCM WAV's go straight from
        the file into the rows (io/pcm16.py); every other file, which that
        reader refuses by its header, goes through ``read_audio_pcm16`` and
        is appended to ``copied``."""
        try:
            return read_pcm16_into(p, rows.T)
        except WavFormatError:
            pass  # not a 16-bit PCM WAV
        copied.append(p)
        audio = read_audio_pcm16(p)[0]
        frames = min(audio.shape[1], len(rows))
        rows[:frames] = audio[:, :frames].T
        return frames

    def decode(names: List[str], rows: np.ndarray, read) -> int:
        """Each file of ``names`` into its row of ``rows`` (``read(path,
        row)`` returns the frames it wrote) with the row's tail past them
        zeroed, so a reused slot never leaks an earlier batch into the
        pad; returns the threads that decoded them.  The files are handed
        out in order, to ``_decode_workers`` threads of ``decoders`` at
        once, or on this thread where that is one.  A failed file stops
        the handing out, and once every thread has stopped the error of
        the first failed file in batch order is raised, as a serial loop
        would raise it."""
        todo = iter(range(len(names)))
        lock = threading.Lock()
        failed: Dict[int, Exception] = {}

        def work() -> None:
            while not failed:
                with lock:
                    i = next(todo, None)
                if i is None:
                    return
                try:
                    with span("fleet.decode"):
                        frames = read(names[i], rows[i])
                    rows[i, frames:] = 0
                except Exception as e:  # raised below, in batch order
                    failed[i] = e

        workers = _decode_workers(len(names))
        if workers == 1:
            work()
        else:
            for fut in [decoders.submit(work) for _ in range(workers)]:
                fut.result()
        if failed:
            raise failed[min(failed)]
        return workers

    def stage(names: List[str], key, _geom):
        """Decode a batch into the ring's next slot; returns the slot,
        the wire's arrays in it (the int16 samples for pcm16, a
        PackedChunk's arrays, or at 24 bits the (files, n_pad, channels,
        3) bytes of the files' samples for pcm24), the function that
        makes the wire of those arrays or of their copies, and the sweep
        that reads that wire.  Runs on the staging thread, the decode on
        the decode threads (numpy, file reads and the host library only;
        no torch call but the slot's event wait and the spans'
        ``record_function`` under a profiler session), so the decode and
        pack overlap the previous batch's copy and device pass."""
        with span("fleet.stage"):
            _rate, channels, n_pad, bits = key
            pcm, words = _wire_layout(key, len(names), transport)
            slot = ring.take()
            copied: List[str] = []
            if bits == 24:
                buf = slot.view(0, (len(names), n_pad, channels, 3),
                                np.uint8)
                rows, read = buf, read_pcm24_into
            else:
                buf = slot.view(0, (len(names), channels, n_pad), np.int16)
                rows = buf.transpose(0, 2, 1)
                read = functools.partial(pcm16_into, copied=copied)
            count("fleet.decode_workers", decode(names, rows, read))
            count("fleet.decode_copied", len(copied))
            with span("fleet.pack") as packing:
                pk = None
                if bits == 16 and transport != "pcm16":
                    scratch = slot.view(_aligned(pcm), (words,), np.int32)
                    pk = (pack_residual(buf, scratch) if transport == "packed"
                          else pack_adaptive(buf, scratch))
                packing.set(transport="pcm24" if bits == 24
                            else "pcm16" if pk is None else "packed")
            if pk is not None:
                arrays, wire_of = pk.arrays(), pk.with_arrays
                sweep = sweep_peaks_aux_packed
            else:
                arrays, wire_of = (buf,), itemgetter(0)
                sweep = (sweep_peaks_aux_pcm24 if bits == 24
                         else sweep_peaks_aux_pcm16)
            count("fleet.wire_bytes", sum(a.nbytes for a in arrays))
            if bits == 16:
                count("fleet.pcm16_bytes", buf.nbytes)
            return slot, arrays, wire_of, sweep

    def dispatch(item, staged):
        slot, arrays, wire_of, sweep = staged
        with span("fleet.dispatch"):
            if device.type == "cuda":
                arrays = slot.send(arrays, device)
            return sweep(wire_of(arrays), item[2], device=device)

    def finish(item, handles) -> None:
        """Read one in-flight sweep back (the batch's only
        synchronisation) and emit its selections."""
        names, key, _geom = item
        with span("fleet.readback"):
            tables = handles[0].cpu().numpy()
            rot0 = handles[1].cpu().numpy()
        sel = select_min_peak_angles_batch(
            tables, stride=stride, link_channels=link_channels,
            rot0=rot0)
        for i, p in enumerate(names):
            results[p] = (sel[i], key[0])
            if ckpt is not None:
                ckpt.put(p, tables[i], rot0[i])
            if progress:
                progress(p, sel[i], cached=False)

    try:
        ring.reserve(largest, shared and device.type == "cuda")
        _run_ahead(plan, stage, dispatch, finish)
    finally:
        decoders.shutdown()
        if shared:
            ring.lock.release()
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

    def stage(group: List[str], key, _geom):
        _rate, channels, n_pad, _bits = key
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

    def dispatch(item, staged):
        buf, units, lens, metas = staged
        return apply_angles(buf, units, item[2], device=device), lens, metas

    def finish(item, handles) -> None:
        names, key, _geom = item
        handle, lens, metas = handles
        y = handle.cpu().numpy()
        for i, p in enumerate(names):
            dst = os.path.join(outdir, os.path.basename(p))
            write_audio(dst, y[i, :, : lens[i]], key[0], metas[i],
                        like=p)
            written[p] = dst
            if progress:
                progress(p, dst)

    _run_ahead(_plan(paths, blksiz, batch), stage, dispatch, finish)
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

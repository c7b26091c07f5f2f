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
source (24-bit FLAC or AIFF among them) takes the int16 path.

The staging thread decodes each batch into one of two reused host slots
(``_StagingRing``, kept for the life of the process): pinned where the
sweeps run on a card, so the wire goes over in one non-blocking copy
from the slot, and the dispatch thread only enqueues it.  A CUDA event
after the copy tells the staging thread when it may write that slot
again.  CUDA launches are asynchronous, so the decode of batch k+1
overlaps the copy and device pass of batch k, across a bucket's edge
too; a batch's only synchronisation is the readback of its tables.  A
batch larger than a slot's share of the ring's cap (a quarter of the
host's memory) is staged in a fresh pageable array and copied as it was
before the ring.

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
``fleet.readback``; each batch counts ``fleet.wire_bytes``,
``fleet.pinned_bytes`` (the wire bytes copied from a pinned slot: 0 on
the CPU and for a batch staged pageable) and ``fleet.pcm16_bytes`` (not
for a 24-bit batch), and
``search.sweep_peaks_aux_pcm24`` records ``pcm24.widen``.  They record
only under a ``torch.profiler`` session or a ``recording()`` scope;
``PHASEROTATE_TPU_PROFILE=<dir>`` writes a profile of the whole command
as a Chrome trace into ``<dir>``, the spans of both threads beside the
kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
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


def _wire_layout(key, files: int, transport: str) -> Tuple[int, int, int]:
    """(pcm bytes, scratch words, metadata bytes) of a batch's slot.

    A 24-bit batch is its (files, n_pad, channels, 3) bytes alone.  A
    16-bit batch is its int16 samples, then the packer's scratch, then
    room for the packed wire's per-block widths and offsets and
    per-stream orders, so a packed batch ships as one range of the slot.
    pcm16 lays out the scratch of auto, whose batches it warms up."""
    from .search.packed import BLOCK, scratch_words

    _rate, channels, n_pad, bits = key
    if bits == 24:
        return files * n_pad * channels * 3, 0, 0
    shape = (files, channels, n_pad)
    streams = files * channels
    meta = (2 * _aligned(streams * -(-n_pad // BLOCK) * 4)
            + _aligned(streams * 4))
    return (files * channels * n_pad * 2,
            scratch_words(shape, None if transport == "packed" else 0.9),
            meta)


def _slot_bytes(layout: Tuple[int, int, int]) -> int:
    pcm, words, meta = layout
    return _aligned(pcm) + _aligned(words * 4) + meta


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

    def offset(self, a: np.ndarray) -> int:
        """The byte offset in the slot of ``a``, a contiguous view of it."""
        return a.ctypes.data - self.array.ctypes.data

    def send(self, obj, device):
        """``obj`` (an array, or a PackedChunk of arrays, all inside the
        slot) on ``device``: one non-blocking copy of the byte range that
        holds them, then an event the staging thread waits on before it
        writes the slot again."""
        from .search.packed import PackedChunk

        fields = ("words", "widths", "woffs", "order")
        arrays = ([getattr(obj, f) for f in fields]
                  if isinstance(obj, PackedChunk) else [obj])
        offs = [self.offset(a) for a in arrays]
        lo = min(offs)
        hi = max(o + a.nbytes for o, a in zip(offs, arrays))
        wire = self.host[lo:hi].to(device, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record(torch.cuda.current_stream(device))
        moved = [wire[o - lo : o - lo + a.nbytes]
                 .view(_TORCH_DTYPE[a.dtype]).view(a.shape)
                 for o, a in zip(offs, arrays)]
        if isinstance(obj, PackedChunk):
            return dataclasses.replace(obj, **dict(zip(fields, moved)))
        return moved[0]


class _StagingRing:
    """Two host buffers the staging thread writes each batch's wire into,
    in turn, for the life of the process.

    Pinned where the sweeps run on a card, so the copy to it is a
    non-blocking DMA; plain host memory on the CPU.  Both slots grow
    together, to the largest batch of an ``analyze_paths`` call, at the
    call's start while nothing is copied from them, and never shrink.
    Each slot holds at most half of :func:`_ring_cap_bytes`; a batch
    larger than that is staged in a fresh pageable array instead.  One
    call uses the ring at a time (``lock``); a concurrent call stages
    pageable."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.slots = [_Slot(), _Slot()]
        self.nbytes = 0          # each slot's size
        self.pinned = False
        self._next = 0

    def fits(self, nbytes: int) -> bool:
        return _pow2(nbytes) <= _ring_cap_bytes() // len(self.slots)

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

    @property
    def pinned_bytes(self) -> int:
        return self.nbytes * len(self.slots) if self.pinned else 0


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


_RING = _StagingRing()


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

    Files are bucketed by geometry, decoded to int16 PCM on a background
    thread into the staging ring (overlapped with the copy and device
    sweep of the previous batch), zero-padded to the bucket length, and
    swept ``batch`` files per device dispatch.

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

    # every batch of the call, bucket after bucket: the staging thread
    # runs one batch ahead across a bucket's edge too
    batches = [(group[i : i + batch], key)
               for key, group in buckets.items()
               for i in range(0, len(group), batch)]
    pool = ThreadPoolExecutor(1, thread_name_prefix="fleet-stage")
    ring = _RING if batches and _RING.lock.acquire(blocking=False) else None
    pinned = ring is not None and device.type == "cuda"

    def stage(names: List[str], key, on_ring: bool):
        """Decode a batch into the ring's next slot (a fresh pageable
        array where the batch does not fit one); returns the wire to
        dispatch, an int16 array (pcm16), a PackedChunk, or at 24 bits a
        (files, n_pad, channels, 3) uint8 array of the files' samples
        (pcm24), and the slot that holds it (None).  Each row's tail past
        the file is zeroed, so a reused slot never leaks an earlier batch
        into the pad.  Runs on the staging thread (numpy and the host
        library only; no torch call but the slot's event wait and the
        spans' ``record_function`` under a profiler session), so the pack
        overlaps the previous batch's copy and device pass."""
        with span("fleet.stage"):
            _rate, channels, n_pad, bits = key
            layout = _wire_layout(key, len(names), transport)
            slot = ring.take() if on_ring else None
            if bits == 24:
                shape = (len(names), n_pad, channels, 3)
                buf = (slot.view(0, shape, np.uint8) if slot is not None
                       else np.empty(shape, np.uint8))
                for i, p in enumerate(names):
                    with span("fleet.decode"):
                        frames = read_pcm24_into(p, buf[i])
                    buf[i, frames:] = 0
                # nothing to pack: the span records the wire shipped
                with span("fleet.pack", transport="pcm24"):
                    pass
                count("fleet.wire_bytes", buf.nbytes)
                count("fleet.pinned_bytes", buf.nbytes if pinned and on_ring
                      else 0)
                return buf, slot
            shape = (len(names), channels, n_pad)
            buf = (slot.view(0, shape, np.int16) if slot is not None
                   else np.empty(shape, np.int16))
            for i, p in enumerate(names):
                with span("fleet.decode"):
                    audio = read_audio_pcm16(p)[0]
                m = min(audio.shape[1], n_pad)
                buf[i, :, :m] = audio[:, :n_pad]
                buf[i, :, m:] = 0
            with span("fleet.pack") as packing:
                obj = buf
                if transport != "pcm16":
                    words = layout[1]
                    scratch = (slot.view(_aligned(buf.nbytes), (words,),
                                         np.int32)
                               if slot is not None
                               else np.empty(words, np.int32))
                    if transport == "packed":
                        obj = pack_residual(buf, scratch)
                    else:
                        obj = pack_adaptive(buf, scratch) or buf
                packed = obj is not buf
                packing.set(transport="packed" if packed else "pcm16")
            if packed and slot is not None:
                obj = _metadata_into(slot, obj)
            wire = obj.wire_bytes if packed else buf.nbytes
            count("fleet.wire_bytes", wire)
            count("fleet.pinned_bytes", wire if pinned and on_ring else 0)
            count("fleet.pcm16_bytes", buf.nbytes)
            return obj, slot

    def dispatch(wire, slot: Optional[_Slot], geom):
        from .search.packed import PackedChunk

        with span("fleet.dispatch"):
            if isinstance(wire, PackedChunk):
                sweep = sweep_peaks_aux_packed
            elif wire.dtype == np.uint8:
                sweep = sweep_peaks_aux_pcm24
            else:
                sweep = sweep_peaks_aux_pcm16
            if pinned and slot is not None:
                wire = slot.send(wire, device)
            return sweep(wire, geom, device=device)

    def finish(pending) -> None:
        """Read one in-flight sweep back (the batch's only
        synchronisation) and emit its selections."""
        names, rate, handles = pending
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
        sizes = [_slot_bytes(_wire_layout(key, len(names), transport))
                 for names, key in batches]
        plan = [(names, key, ring is not None and ring.fits(n))
                for (names, key), n in zip(batches, sizes)]
        fitting = [n for n, (_, _, on) in zip(sizes, plan) if on]
        if fitting:
            ring.reserve(max(fitting), pinned)
        # one batch of readback slack: batch k's sweep is read back only
        # after batch k+1's transfer and sweep were enqueued, so the card
        # always has the next batch queued; the staging thread fills the
        # other slot meanwhile, once batch k-1's copy from it has ended
        # (the event that ``send`` recorded), and a bucket's edge is no
        # different
        fut = pool.submit(stage, *plan[0]) if plan else None
        pending = None
        for bi, (names, key, _) in enumerate(plan):
            with span("fleet.stage_wait"):
                wire, slot = fut.result()
            if bi + 1 < len(plan):
                fut = pool.submit(stage, *plan[bi + 1])
            handles = dispatch(wire, slot, meta[names[0]][1])
            if pending is not None:
                finish(pending)
            pending = (names, key[0], handles)
        if pending is not None:
            finish(pending)
    finally:
        pool.shutdown()
        if ring is not None:
            ring.lock.release()
    return results


def _metadata_into(slot: _Slot, pk):
    """``pk`` with its widths, offsets and orders copied into ``slot``
    right after its words, which the packer wrote there: the packed wire
    is then one range of the slot."""
    off = slot.offset(pk.words) + _aligned(pk.words.nbytes)
    moved = {}
    for name in ("widths", "woffs", "order"):
        a = getattr(pk, name)
        moved[name] = slot.view(off, a.shape, a.dtype)
        moved[name][...] = a
        off += _aligned(a.nbytes)
    return dataclasses.replace(pk, **moved)


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

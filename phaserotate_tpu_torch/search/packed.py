"""Packed lossless wire transport for fleet ingest (torch).

Counterpart of ``phaserotate_tpu/search/packed.py``, with the same wire
format bit for bit: a :class:`PackedChunk` made by either package unpacks
in the other.  The raw-PCM ingest (``sweep_peaks_aux_pcm16``) ships 16 bits
per sample over the host-to-device link; this transport ships fewer,
*losslessly*:

  host side   fixed-order residual (iterated first difference, orders
              0..3 — the same family as FLAC's fixed predictors) +
              per-4096-sample-block minimal bit width, packed little-
              endian into an int32 word stream (numpy, or the host
              packer csrc/wire_pack.cc, block by block on the host's
              cores; the pack rides the fleet's staging thread, under
              the device pass of the previous batch)
  device side unpack with shifts and masks (a funnel shift of 2 words
              per sample), reconstruct with k nested prefix sums (the
              exact inverse of the k-th difference), dequantize to
              float32: one hand-written kernel over the whole batch on
              the card (csrc/wire_unpack.cu), where the JAX package's
              unpack is plain XLA

Reconstruction is bit-exact: residuals of int16 data stay within int32
at every order <= 3, and each prefix sum of a k-th difference is again
a (k-1)-th difference of the original, so no intermediate overflows.
The transport therefore feeds the sweep with values identical to the
pcm16 path (tests/test_torch_packed.py asserts bitwise equality).

Why not Rice/arithmetic coding: their decode is bit-serial (unary
prefixes), which no batch of tensor operations expresses.
Fixed-width-per-block costs ~1.5-2 bits/sample over the entropy of a
Gaussian residual (the block max sits ~4 sigma up) — the price of a
decode that is a funnel shift and a scan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.unpack import BLOCK, MAX_ORDER, wire_unpack
from ..utils.profiling import count, span
from . import _wirepack

__all__ = ["PackedChunk", "pack_residual", "pack_adaptive",
           "unpack_residual", "sweep_peaks_aux_packed",
           "packed_bits_per_sample", "BLOCK", "MAX_ORDER"]

# BLOCK, samples per width block (defined with MAX_ORDER beside the unpack,
# kernels/unpack.py), is a multiple of 32 so every block's packed payload
# is word-aligned (4096 * w bits = 128*w words exactly), which keeps the
# unpack's bit addressing to one add + shift.

# Padded word counts snap to a geometric grid (5-bit mantissa): at most
# 1/16 extra wire.  The JAX package pads so to bound its compiled
# programs; the port compiles nothing but shares the format.
_GRID_MANTISSA_BITS = 5
# In a scratch, each array of the wire starts at a multiple of this many
# int32 words (256 bytes), so its copy on a device is aligned for vector
# loads.
_ALIGN_WORDS = 64


def _aligned_words(n: int) -> int:
    return -(-n // _ALIGN_WORDS) * _ALIGN_WORDS


def _meta_words(streams: int, nb: int) -> int:
    """Scratch words of a chunk's widths, offsets and orders."""
    return 2 * _aligned_words(streams * nb) + _aligned_words(streams)


def _grid_pad(need: int) -> int:
    """Smallest m * 2^e >= need with m in [16, 32)."""
    if need <= (1 << _GRID_MANTISSA_BITS):
        return 1 << _GRID_MANTISSA_BITS
    e = need.bit_length() - _GRID_MANTISSA_BITS
    return -(-need >> e) << e


@dataclasses.dataclass(frozen=True)
class PackedChunk:
    """One chunk's packed transport, ready for the copy to the device.

    words:  (W,) int32 — the bit stream (W padded to the word grid + 1
            slack word so the unpack's straddle gather never reads
            out of bounds).
    widths: (S, NB) int32 — bits/sample of each stream's blocks.
    woffs:  (S, NB) int32 — word offset of each block's payload.
    order:  (S,) int32 — fixed-predictor order per stream (0..3).
    n:      true samples per stream (NB*BLOCK >= n).
    shape:  the original (..., n) leading shape, restored by consumers.
    """

    words: np.ndarray
    widths: np.ndarray
    woffs: np.ndarray
    order: np.ndarray
    n: int
    shape: Tuple[int, ...]

    def arrays(self) -> tuple:
        """The wire's arrays, in order: words, widths, woffs, order."""
        return self.words, self.widths, self.woffs, self.order

    def with_arrays(self, arrays) -> "PackedChunk":
        """This chunk over ``arrays`` in place of :meth:`arrays` (their
        copies on a device, say)."""
        return PackedChunk(*arrays, n=self.n, shape=self.shape)

    @property
    def wire_bytes(self) -> int:
        return sum(a.nbytes for a in self.arrays())


def _signed_width(mx: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Minimal signed bit width holding every value in [mn, mx]."""
    # need 2^(w-1) - 1 >= mx  and  -2^(w-1) <= mn
    hi = np.maximum(mx, 0).astype(np.int64)
    lo = np.maximum(-mn.astype(np.int64) - 1, 0)
    m = np.maximum(hi, lo)
    # w-1 bits of magnitude: smallest w-1 with 2^(w-1) > m
    return (np.where(m > 0,
                     np.floor(np.log2(np.maximum(m, 1))).astype(np.int64)
                     + 2,
                     1)).astype(np.int32)


def _pack_fixed_width(vals: np.ndarray, w: int) -> np.ndarray:
    """(m, BLOCK) int32 residuals -> (m, BLOCK*w//32) int32 words.

    Little-endian bit order: sample i occupies bits [i*w, (i+1)*w) of
    the block's stream.  Vectorized over all m blocks: the inner loop
    runs over the <= g sample slots of one word-group (g = lcm(w,32)/w
    samples fill g*w/32 words exactly), each slot a full-array shift+or.
    """
    g = 32 // math.gcd(w, 32)          # samples per word-group
    wpg = g * w // 32                  # words per group
    m = vals.shape[0]
    u = vals.astype(np.uint32) & np.uint32((1 << w) - 1)
    u = u.reshape(m, BLOCK // g, g)
    out = np.zeros((m, BLOCK // g, wpg), np.uint32)
    for s in range(g):
        bit = s * w
        k, sh = bit >> 5, bit & 31
        out[:, :, k] |= u[:, :, s] << np.uint32(sh)
        if sh + w > 32:
            out[:, :, k + 1] |= u[:, :, s] >> np.uint32(32 - sh)
    return out.reshape(m, BLOCK * w // 32).view(np.int32)


def pack_residual(x16: np.ndarray,
                  out_words: np.ndarray | None = None,
                  native: bool | None = None) -> PackedChunk:
    """Pack int16 PCM (..., n) into the residual wire format.

    ``out_words`` optionally supplies a preallocated int32 scratch
    buffer (>= worst case: 17 bits/sample + grid padding) that a staging
    ring can reuse.  The returned ``words`` is a VIEW into it — callers
    must not rewrite the buffer while a device transfer of the view may
    be in flight.  The host packer takes it where it holds
    :func:`scratch_words` ``(shape, None)`` and then writes the whole
    wire there, metadata included.

    ``native`` selects the host packer (csrc/wire_pack.cc: bit-identical
    to the numpy path, far faster, GIL released): None uses it, True
    requires it (the same: a failed build of it raises), False takes the
    numpy reference path.
    """
    x16 = np.ascontiguousarray(x16, np.int16)
    shape = x16.shape
    n = shape[-1]
    if native is not False:
        return _pack_residual_host(x16.reshape(-1, n), out_words, shape)
    streams = x16.reshape(-1, n).astype(np.int32)
    S = streams.shape[0]
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    if pad:
        streams = np.pad(streams, ((0, 0), (0, pad)))

    # residuals r_k = k-th difference; per-stream order choice by
    # total packed bits (FLAC's fixed-predictor selection, order cap
    # 3).  Two passes over the diffs instead of materializing all four
    # orders at once: the width tables are tiny, the residual arrays
    # are ~BLOCK*nb*S*4 bytes each.
    widths_k = []
    r = streams
    for k in range(MAX_ORDER + 1):
        if k:
            r = np.diff(r, axis=-1, prepend=0)
        blocks = r.reshape(S, nb, BLOCK)
        widths_k.append(
            _signed_width(blocks.max(axis=-1), blocks.min(axis=-1)))
    cost = np.stack([w.sum(axis=-1, dtype=np.int64) for w in widths_k])
    order = np.argmin(cost, axis=0).astype(np.int32)     # (S,)
    widths = np.take_along_axis(
        np.stack(widths_k), order[None, :, None], axis=0)[0]  # (S, nb)
    resid = np.empty_like(streams)
    r = streams
    for k in range(MAX_ORDER + 1):
        if k:
            r = np.diff(r, axis=-1, prepend=0)
        rows = order == k
        if rows.any():
            resid[rows] = r[rows]

    # word layout: blocks in (stream, block) order, each word-aligned
    lens = (widths.astype(np.int64) * (BLOCK // 32)).reshape(-1)
    woffs_flat = np.zeros(S * nb, np.int64)
    np.cumsum(lens[:-1], out=woffs_flat[1:])
    total = int(woffs_flat[-1] + lens[-1])
    # +1 slack word (the unpack's straddle gather reads wi+1), then
    # pad up to the grid
    wpad = _grid_pad(total + 1)
    if out_words is not None and out_words.size >= wpad:
        words = out_words[:wpad]
        words.fill(0)
    else:
        words = np.zeros(wpad, np.int32)
    woffs = woffs_flat.astype(np.int32).reshape(S, nb)

    rblocks = resid.reshape(S * nb, BLOCK)
    wflat = widths.reshape(-1)
    for w_val in np.unique(wflat):
        idx = np.nonzero(wflat == w_val)[0]
        packed = _pack_fixed_width(rblocks[idx], int(w_val))
        pos = woffs_flat[idx, None] + np.arange(packed.shape[1])[None, :]
        words[pos] = packed
    return PackedChunk(words=words, widths=widths, woffs=woffs,
                       order=order, n=n, shape=shape)


def _host_layout(streams16: np.ndarray):
    """Pass 1 of the host packer on (S, n) int16: (widths, woffs, order,
    total words, workers), the workers counted as ``packed.pack_workers``
    once per pack."""
    S, n = streams16.shape
    nb = -(-n // BLOCK)
    workers = max(1, min(_wirepack.workers_for(S * nb), S * nb))
    count("packed.pack_workers", workers)
    widths = np.empty((S, nb), np.int32)
    woffs = np.empty((S, nb), np.int32)
    order = np.empty(S, np.int32)
    total = _wirepack.layout(streams16, widths, woffs, order, workers)
    return widths, woffs, order, total, workers


def _pack_residual_host(streams16: np.ndarray,
                        out_words: np.ndarray | None,
                        shape) -> PackedChunk:
    """The host packer's path of :func:`pack_residual`."""
    layout = _host_layout(streams16)
    if (out_words is None
            or out_words.size < scratch_words(streams16.shape, None)):
        out_words = np.empty(_grid_pad(layout[3] + 1), np.int32)
    return _fill(streams16, out_words, layout, shape)


def _fill(streams16: np.ndarray, scratch: np.ndarray, layout,
          shape) -> PackedChunk:
    """Pass 2 of the host packer, after pass 1's ``layout``: the chunk
    whose words are the start of ``scratch``.  Where the scratch has room,
    the widths, offsets and orders are copied in right after the words,
    each aligned, so the whole wire is one range of the scratch and one
    copy ships it."""
    widths, woffs, order, total, workers = layout
    wpad = _grid_pad(total + 1)
    words = scratch[:wpad]
    _wirepack.fill(streams16, widths, woffs, order, words, total, workers)
    words[total:] = 0  # slack word + grid padding
    meta = [widths, woffs, order]
    off = _aligned_words(wpad)
    if off + _meta_words(*widths.shape) <= scratch.size:
        for i, a in enumerate(meta):
            meta[i] = scratch[off : off + a.size].reshape(a.shape)
            meta[i][...] = a
            off += _aligned_words(a.size)
    return PackedChunk(words, *meta, n=shape[-1], shape=shape)


def packed_bits_per_sample(chunk: PackedChunk) -> float:
    """Achieved wire bits per audio sample, metadata included."""
    n_samples = int(np.prod(chunk.shape[:-1])) * chunk.n
    return chunk.wire_bytes * 8.0 / max(1, n_samples)


def _budget_words(shape, threshold: float) -> int:
    """Words of ``threshold`` x the pcm16 wire of int16 PCM of ``shape``."""
    S, n = math.prod(shape[:-1]), shape[-1]
    return int(threshold * S * n * 16) // 32


def scratch_words(shape, threshold: float | None = 0.9) -> int:
    """Int32 words of scratch that a pack of int16 PCM of ``shape`` (...,
    n) may write: the padded words of :func:`pack_adaptive`'s budget at
    ``threshold``, or with ``threshold`` None those of
    :func:`pack_residual`'s worst case, in which the chosen order never
    beats order 0's <= 16 bits a sample; then the chunk's widths, offsets
    and orders, so that the whole wire lands in the scratch."""
    streams, nb = math.prod(shape[:-1]), -(-shape[-1] // BLOCK)
    if threshold is not None:
        words = _grid_pad(_budget_words(shape, threshold) + 1)
    else:
        words = _grid_pad(streams * nb * (BLOCK // 2) + 1)
    return _aligned_words(words) + _meta_words(streams, nb)


def pack_adaptive(x16: np.ndarray, scratch: np.ndarray,
                  threshold: float = 0.9) -> PackedChunk | None:
    """Adaptive transport decision: pack iff it beats pcm16 by margin.

    Runs the host packer's first pass, which gives the packed size
    before any word is written, against a budget of ``threshold`` x the
    pcm16 wire size: content whose residuals don't compress (fully
    noise-dominated material) stops there and ships the plain 16-bit
    samples instead, so the fleet never pays wire for a transport that
    doesn't win.  The margin is there because a pack that saves only a
    few percent of the bytes costs more in pack and unpack time than the
    link gives back.  Otherwise the words are written into ``scratch``
    (int32), which must hold the padded words, and the metadata after
    them where it holds :func:`scratch_words` ``(shape, threshold)``.
    Returns None when pcm16 should be shipped: over the budget, or more
    words than ``scratch`` holds.
    """
    shape = x16.shape
    n = shape[-1]
    streams = np.ascontiguousarray(x16.reshape(-1, n), np.int16)
    layout = _host_layout(streams)
    total = layout[3]
    if (total > _budget_words(streams.shape, threshold)
            or _grid_pad(total + 1) > scratch.size):
        return None
    return _fill(streams, scratch, layout, shape)


def unpack_residual(words: torch.Tensor, widths: torch.Tensor,
                    woffs: torch.Tensor, order: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Inverse of :func:`pack_residual` on the tensors' device.

    (W,) int32 words + (S, NB) metadata -> (S, n) float32 in [-1, 1):
    each block's fixed-width residuals decoded, then k prefix sums invert
    the k-th difference, exact by the argument in the module docstring.
    On the card one hand-written kernel (``kernels.unpack.wire_unpack``,
    csrc/wire_unpack.cu) unpacks the whole batch; on the CPU its plain
    twin does.  Raises ``TypeError`` unless all four are int32 on one
    device.
    """
    return wire_unpack(words, widths, woffs, order, n)


def sweep_peaks_aux_packed(pk: PackedChunk, geom, chunk: int = 4096,
                           device=None):
    """sweep.sweep_peaks_aux over the packed wire format.

    Value-identical to ``sweep_peaks_aux_pcm16`` of the same PCM (the
    unpack reproduces the int16 values exactly, then dequantizes with
    the same 1/32768).  The chunk's arrays go to ``device`` (default: the
    CUDA device; ``"cpu"`` for the CPU) and are unpacked there, under
    the span ``packed.unpack`` (its device time on a card).
    """
    from .sweep import _sweep_impl

    dev = resolve_device(device)
    wire = [torch.as_tensor(a, device=dev) for a in pk.arrays()]
    with span("packed.unpack", device=dev):
        x = unpack_residual(*wire, pk.n)
    return _sweep_impl(x.reshape(pk.shape), geom, chunk)

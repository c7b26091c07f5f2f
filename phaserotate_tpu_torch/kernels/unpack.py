"""The packed wire's unpack: CUDA kernel wrapper and plain twin.

No counterpart among the JAX package's kernels: its unpack
(``phaserotate_tpu/search/packed.py`` ``unpack_residual``) is plain XLA.
:func:`wire_unpack` turns the packed wire of ``search/packed.py`` back
into the float32 samples the sweep reads; the kernel is
``csrc/wire_unpack.cu`` (three launches a call: the blocks' sums, each
stream's carries, the samples).  On a CPU tensor the wrapper runs
:func:`wire_unpack_plain`; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["BLOCK", "MAX_ORDER", "wire_unpack", "wire_unpack_plain"]

# The wire format's residuals a block (csrc/wire_unpack.cu kBlock) and its
# highest fixed-predictor order, which search/packed.py packs by.
BLOCK = 4096
MAX_ORDER = 3


def _check(words, widths, woffs, order, n: int) -> None:
    for t in (words, widths, woffs, order):
        if t.dtype != torch.int32 or t.device != words.device:
            raise TypeError("words, widths, woffs and order must be int32 "
                            "on one device")
    if words.ndim != 1 or widths.ndim != 2 or widths.shape != woffs.shape or (
            order.shape != widths.shape[:1]):
        raise ValueError("expected (W,) words, (S, NB) widths and woffs and "
                         f"(S,) order, got {tuple(words.shape)}, "
                         f"{tuple(widths.shape)}, {tuple(woffs.shape)}, "
                         f"{tuple(order.shape)}")
    if not 0 <= n <= widths.shape[1] * BLOCK:
        raise ValueError(f"{n} samples a stream in {widths.shape[1]} blocks "
                         f"of {BLOCK}")


def wire_unpack_plain(words: torch.Tensor, widths: torch.Tensor,
                      woffs: torch.Tensor, order: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Plain twin of :func:`wire_unpack`: int32 gathers, shifts and masks,
    then ``MAX_ORDER`` cumsums over all the streams at once."""
    _check(words, widths, woffs, order, n)
    g, nb = widths.shape
    w = widths[:, :, None]                               # (g, NB, 1)
    i_in = torch.arange(BLOCK, dtype=torch.int32, device=words.device)
    bit = i_in * w                                       # (g, NB, BLOCK)
    wi = woffs[:, :, None] + (bit >> 5)
    sh = bit & 31
    del bit
    # torch has no logical right shift: shift arithmetically and clear
    # the sh copies of the sign bit ((-2 << 31) wraps to 0 for sh == 0)
    v = (words[wi] >> sh) & ~(-2 << (31 - sh))
    # the straddling word's low bits; 1 slack word is guaranteed by the
    # pack's grid pad, and for sh == 0 the two shifts clear it entirely
    v |= (words[wi + 1] << (31 - sh)) << 1
    del wi, sh
    s = 32 - w
    x = ((v << s) >> s).reshape(g, nb * BLOCK)           # sign extend
    del v
    out = x
    for k in range(1, MAX_ORDER + 1):
        x = torch.cumsum(x, dim=-1, dtype=torch.int32)
        out = torch.where(order[:, None] == k, x, out)
    return out[:, :n].to(torch.float32) * (1.0 / 32768.0)


def wire_unpack(words: torch.Tensor, widths: torch.Tensor,
                woffs: torch.Tensor, order: torch.Tensor,
                n: int) -> torch.Tensor:
    """(W,) int32 words and (S, NB) int32 ``widths`` and ``woffs``, (S,)
    int32 ``order`` -> (S, n) float32: each stream's residuals decoded,
    ``order`` nested prefix sums taken, over 2^15.  Integer-exact, so
    bit-equal to the plain version; counts three ``wire_unpack`` launches
    a call on the card."""
    if words.device.type == "cpu":
        return wire_unpack_plain(words, widths, woffs, order, n)
    if words.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {words.device}")
    _check(words, widths, woffs, order, n)
    words, widths, woffs, order = (t.contiguous()
                                   for t in (words, widths, woffs, order))
    S, nb = widths.shape
    dev = words.device
    out = torch.empty((S, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    sums = torch.empty((S, nb, 4), dtype=torch.int32, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):  # the C launch goes to the current one
        err = lib.prt_wire_unpack(
            words.data_ptr(), words.numel(), widths.data_ptr(),
            woffs.data_ptr(), order.data_ptr(), sums.data_ptr(),
            out.data_ptr(), S, nb, n,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "wire_unpack")
    _build.count_launch("wire_unpack", 3)
    return out

"""The CLI's offline search: Hilbert signal, peak table and selection.

Semantics of cli/phase-rotate.cc:181-232, 389-428 and 779-948, computed
plainly: one FFT convolution per file in float64, the peak of every
candidate rotation over every aligned sample, and the coarse-then-fine
selection with the CLI's visit order and tie-breaking.

Alignment: stream position ``m = k*blksiz + i``; the Hilbert output
``h[m] = sum_j fir[j] x[m - j]`` (``blksiz`` taps) pairs with the dry
sample ``x[m - blksiz/2]`` for ``m`` in ``[blksiz, (B+1)*blksiz)``, ``B``
blocks of the file plus one flush block of silence; the first block adds
``|sin| * max|h[blksiz/2 : blksiz]|``; angle 0 is the raw input peak and
the "rotated by 0" value of the aligned pairs is kept beside the table.

``precision`` is ``"float64"`` for the reference, or ``"bfloat16"`` for
the control: the samples, the taps, the Hilbert signal and the rotated
samples rounded to bfloat16.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .dsp import MAXSAMPLE, SUBSAMPLE, cos_sin_table, hilbert_fir


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def hilbert(x: torch.Tensor, blksiz: int, precision: str = "float64"
            ) -> torch.Tensor:
    """(C, n) samples -> (C, (B+1)*blksiz) Hilbert signal ``fir * x``."""
    n = x.shape[-1]
    total = (-(-n // blksiz) + 1) * blksiz
    dt = torch.float64 if precision == "float64" else torch.float32
    fir = _round(torch.from_numpy(hilbert_fir(blksiz)).to(x.device), precision)
    size = 1 << (n + blksiz - 1).bit_length()
    spec = torch.fft.rfft(_round(x.to(dt), precision), n=size)
    spec *= torch.fft.rfft(fir.to(dt), n=size)
    h = torch.fft.irfft(spec, n=size)[..., :total]
    return _round(h, precision)


def peak_table(x: torch.Tensor, blksiz: int, precision: str = "float64",
               chunk: int = 1 << 18):
    """(C, n) samples -> ((C, MAXSAMPLE) float64 table, (C,) rot0)."""
    C, n = x.shape
    firlen = blksiz // 2
    h = hilbert(x, blksiz, precision)
    total = h.shape[-1]
    dt = torch.float64 if precision == "float64" else torch.bfloat16
    xp = torch.nn.functional.pad(x.to(h.dtype), (0, total - n))
    b0 = _round(xp[:, blksiz - firlen : total - firlen], precision)
    b1 = h[:, blksiz:]
    cs = torch.from_numpy(cos_sin_table()).to(x.device)
    csd = cs.T.to(dt)  # (MAXSAMPLE, 2)
    peaks = torch.zeros(C, MAXSAMPLE, dtype=torch.float64, device=x.device)
    for c in range(C):
        for s in range(0, b0.shape[1], chunk):
            pair = torch.stack([b0[c, s : s + chunk], b1[c, s : s + chunk]])
            rot = csd @ pair.to(dt)  # (MAXSAMPLE, chunk)
            peaks[c] = torch.maximum(peaks[c], torch.linalg.vector_norm(
                rot, ord=math.inf, dim=1).to(torch.float64))
    h_start = h[:, firlen:blksiz].abs().amax(dim=1).to(torch.float64)
    peaks = torch.maximum(peaks, cs[1].abs().to(torch.float64)[None]
                          * h_start[:, None])
    rot0 = peaks[:, 0].clone()
    peaks[:, 0] = xp.abs().amax(dim=1).to(torch.float64)
    return peaks.cpu().numpy(), rot0.cpu().numpy()


def select_angles(tables: np.ndarray, rot0: np.ndarray, stride: int,
                  link: bool) -> List[dict]:
    """The CLI's selection over (files, C, MAXSAMPLE) tables: per file the
    unwrapped angle units and found flags per channel.

    Written as the CLI runs it, one candidate at a time: a coarse scan at
    ``stride``, candidates within 7 % of the coarse range, a fine scan of
    each candidate's neighbourhood in ascending order with ``<=`` keeping
    the last minimum, then the unwrap towards the channels' mean
    (cli/phase-rotate.cc:779-948)."""
    out = []
    M = MAXSAMPLE
    for tab, r0 in zip(np.asarray(tables, np.float64),
                       np.asarray(rot0, np.float64)):
        C = tab.shape[0]

        def un(c, a):  # the fine pass reads the rotated-at-0 value
            return r0[c] if (a % M == 0 and a != 0) else tab[c, a % M]

        def lk(a):
            return (r0.max() if (a % M == 0 and a != 0)
                    else tab[:, a % M].max())

        def coarse(c, a):
            return tab[:, a].max() if link else tab[c, a]

        mins: dict = {}
        for c in range(C):
            vals = [coarse(c, a) for a in range(0, M, stride)]
            lo, hi = min(vals), max(vals)
            if hi - lo == 0:
                continue
            for a, v in zip(range(0, M, stride), vals):
                if (v == lo) if stride == 1 else \
                        (v <= lo + (hi - lo) * 0.07):
                    mins.setdefault(a, []).append(c)
        angle = [0] * C
        found = [False] * C
        p_min = [math.inf] * C
        half = (stride + 1) // 2
        offs = [0] if stride == 1 else list(range(-half, half + 1))
        for a in sorted(mins):
            chans = mins[a]
            for c in chans:
                for o in offs:
                    if stride == 1:
                        p = coarse(c, a)
                    elif link and len(chans) > 1:
                        p = lk(a + o)
                    else:
                        p = un(c, a + o)
                    if p <= p_min[c]:
                        p_min[c], angle[c], found[c] = p, (a + o) % M, True
        cnt = sum(found)
        if cnt:
            avg = sum(a for a, f in zip(angle, found) if f) / cnt
            dist = M / cnt
            for c in range(C):
                if found[c] and (avg > 90 * SUBSAMPLE or (
                        angle[c] > 90 * SUBSAMPLE
                        and abs(angle[c] - avg) > dist)):
                    angle[c] -= M
        out.append(dict(units=[a if f else 0 for a, f in zip(angle, found)],
                        found=found))
    return out

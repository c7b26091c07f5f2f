"""phase-rotate compatible command-line interface (torch).

Same flags, validation, analysis semantics and output as
``phaserotate_tpu/cli.py`` (itself the reference CLI's workflow,
cli/phase-rotate.cc:489-1011).  The work runs on the CUDA device;
without one the command exits with an error unless the CPU is asked for
(``main(argv, device="cpu")``).  Reads every container and codec of
``io.read_audio`` (sniffed by content) and writes by the output's
extension; an output without one inherits the input's container.

    python -m phaserotate_tpu_torch.cli -vv in.flac             # analyze
    python -m phaserotate_tpu_torch.cli -a 10,20 in.wav out.wav  # apply

``PHASEROTATE_TPU_PROFILE=<dir>`` (the JAX CLI's variable, so scripts
carry over) captures a ``torch.profiler`` trace of the whole run.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from . import __version__
from .core.angles import MAXSAMPLE, SUBSAMPLE, angle_units_from_degrees
from .core.device import resolve_device
from .core.sizes import MAX_BLKSIZ, MIN_BLKSIZ, OfflineGeometry, default_blksiz
from .io import WavFormatError, read_audio, write_audio
from .search import apply_angles, select_min_peak_angles, sweep_peaks_aux
from .search.minimize import coeff_to_db

__all__ = ["main"]


def _usage_epilog() -> str:
    return (
        "This utility analyzes the given audio file to find a "
        "phase-rotation\nangle that results in minimal digital-peak, "
        "while retaining overall\nsound and loudness.\n"
    )


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phase-rotate",
        description="Audio File Phase Rotation Util (PyTorch/CUDA).",
        epilog=_usage_epilog(),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-a", "--angle", metavar="<n>[,<n>]*", default=None,
                   help="specify phase angle to apply")
    p.add_argument("-f", "--fftlen", type=int, default=0, metavar="<num>",
                   help="process-block size, freq. resolution")
    p.add_argument("-l", "--link-channels", action="store_true",
                   help="use downmixed mono peak for analysis")
    p.add_argument("-s", "--stride", type=int, default=12 * SUBSAMPLE,
                   metavar="<num>", help="analysis step-size")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="show processing information")
    p.add_argument("-V", "--version", action="store_true",
                   help="print version information and exit")
    p.add_argument("file", nargs="?", help="input audio file")
    p.add_argument("out_file", nargs="?", help="output audio file")
    return p


def _die(msg: str) -> "NoReturn":  # noqa: F821
    print(f"Error: {msg}", file=sys.stderr)
    sys.exit(1)


def _parse_angles(spec: str, n_channels: int) -> List[int]:
    """-a list parsing (cli/phase-rotate.cc:718-747)."""
    angles: List[int] = []
    for tok in spec.split(","):
        try:
            a = float(tok)
        except ValueError:
            _die("Invalid angle specified, value needs to be -180 .. +180.")
        if a < -180 or a > 180:
            _die("Invalid angle specified, value needs to be -180 .. +180.")
        angles.append(angle_units_from_degrees(a))  # C round() semantics
    if len(angles) == 1:
        angles = angles * n_channels
    if len(angles) < n_channels:
        _die("file has more channels than angles were specified.")
    return angles[:n_channels]


def _print_gnuplot_header(n_channels: int) -> None:
    print("# Angle mono-peak", end="")
    for c in range(n_channels):
        print(f" chn-{c + 1}", end="")
    print()


def _print_gnuplot_row(table: np.ndarray, a: int, n_channels: int) -> None:
    aw = (a + MAXSAMPLE) % MAXSAMPLE
    peak_all = float(table[:, aw].max())
    print(f"{aw / SUBSAMPLE:.2f} {coeff_to_db(peak_all):.4f}", end="")
    for c in range(n_channels):
        print(f" {coeff_to_db(float(table[c, aw])):.4f}", end="")
    print()


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run the command line ``argv``; ``device`` is where the audio is
    processed (default: the CUDA device)."""
    # PHASEROTATE_TPU_PROFILE=<dir> captures a torch.profiler trace of
    # the whole run (Chrome trace format): the tracing hook, without
    # adding flags the reference CLI lacks.
    profile_dir = os.environ.get("PHASEROTATE_TPU_PROFILE")
    if profile_dir:
        from .utils.profiling import device_trace

        with device_trace(profile_dir):
            return _main(argv, device)
    return _main(argv, device)


def _main(argv: Optional[List[str]] = None, device=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.version:
        print(f"phase-rotate version {__version__} (phaserotate-tpu-torch)")
        return 0
    if not args.file:
        _die("Missing parameter. See --help for usage information.")

    stride = args.stride
    if stride < 1 or stride > 45 * SUBSAMPLE or MAXSAMPLE % stride != 0:
        _die("180 deg is not evenly dividable by given stride.")
    blksiz = args.fftlen
    if blksiz != 0 and (blksiz < MIN_BLKSIZ or blksiz > MAX_BLKSIZ):
        _die("fft-len is out of bounds; valid range 1024..32768")
    if args.angle is not None and not args.out_file:
        _die("-a, --angle option requires an output file to be given.")

    verbose = args.verbose
    verbose_fd = sys.stderr if verbose > 1 else sys.stdout

    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    try:
        audio, rate, meta = read_audio(args.file)
    except (OSError, WavFormatError) as e:
        print(f"Cannot open '{args.file}' for reading: {e}", file=sys.stderr)
        return 1
    n_channels = audio.shape[0]
    x = torch.as_tensor(audio, device=device)

    if verbose > 2:
        # file-log dump, the role of the reference's libsndfile log
        # (cli/phase-rotate.cc:704-716)
        n_frames = audio.shape[1]
        dur = n_frames / rate
        print(f"File: {args.file}", file=verbose_fd)
        print(f"{meta.container}, {n_channels} channels @ {rate} Hz, "
              f"{n_frames} frames ({dur:.3f} s)", file=verbose_fd)
        for cid, text in meta.info.items():
            print(f"  {cid.decode()}: {text}", file=verbose_fd)
        if meta.cues is not None:
            print(f"  cue chunk: {len(meta.cues)} bytes", file=verbose_fd)
        if meta.bext is not None:
            print(f"  broadcast info (bext): {len(meta.bext)} bytes",
                  file=verbose_fd)
        for cid, payload in meta.other:
            print(f"  chunk {cid.decode(errors='replace')!r}: "
                  f"{len(payload)} bytes", file=verbose_fd)
    elif verbose:
        print(f"Input File      : {args.file}", file=verbose_fd)
        print(f"Sample Rate     : {rate} Hz", file=verbose_fd)
        print(f"Channels        : {n_channels}", file=verbose_fd)

    geom = OfflineGeometry(blksiz=default_blksiz(rate, blksiz))
    if verbose > 1:
        print(f"Process block-size {geom.blksiz}", file=verbose_fd)

    find_min = args.angle is None
    if not find_min:
        angles = _parse_angles(args.angle, n_channels)
        if verbose:
            print("# Apply phase-shift", file=verbose_fd)
            for c in range(n_channels):
                print(
                    f"Channel: {c + 1:2d} Phase: "
                    f"{angles[c] / SUBSAMPLE:5.2f} deg", file=verbose_fd)
    else:
        if verbose > 1:
            print(f"Analyzing on device, stride = {stride}", file=verbose_fd)
        table_t, rot0_t = sweep_peaks_aux(x, geom)
        table = table_t.cpu().numpy()
        rot0 = rot0_t.cpu().numpy()

        if verbose > 1:
            _print_gnuplot_header(n_channels)
            for a in range(0, MAXSAMPLE, stride):
                _print_gnuplot_row(table, a, n_channels)
            res_dbg = select_min_peak_angles(
                table, stride=stride, link_channels=args.link_channels,
                rot0=rot0)
            for ma, chans in sorted(res_dbg.coarse_considered.items()):
                for c in chans:
                    p = (table.max(axis=0) if args.link_channels
                         else table[c])[(ma + MAXSAMPLE) % MAXSAMPLE]
                    print(
                        f"Consider min: {p:f} chn: {c} @ "
                        f"{ma / SUBSAMPLE:.2f} deg", file=verbose_fd)

        res = select_min_peak_angles(
            table, stride=stride, link_channels=args.link_channels,
            rot0=rot0)
        angles = res.angles_units

        if verbose > 1 and stride > 1:
            stride_2 = (stride + 1) // 2
            for ma in sorted(res.coarse_considered):
                for a in range(ma - stride_2, ma + stride_2 + 1):
                    _print_gnuplot_row(table, a, n_channels)

        if not args.out_file or verbose:
            print("# Result -- Minimize digital peak", file=verbose_fd)
            for c in range(n_channels):
                if not res.found[c]:
                    print(
                        f"Channel: {c + 1:2d} Phase:   0 deg "
                        "# cannot find min.", file=verbose_fd)
                else:
                    line = (
                        f"Channel: {c + 1:2d} Phase: "
                        f"{res.angles_units[c] / SUBSAMPLE:5.2f} deg")
                    if res.angles_units[c] != 0:
                        line += (
                            f", gain: {res.gain_db(c):5.2f} dB "
                            f"(att. {coeff_to_db(res.peak_zero[c]):4.2f} "
                            f"to {coeff_to_db(res.peak_min[c]):4.2f} dBFS)")
                    print(line, file=verbose_fd)

    if args.out_file:
        y = apply_angles(x, angles, geom).cpu().numpy()
        try:
            write_audio(args.out_file, y, rate, meta, like=args.file)
        except OSError as e:
            print(f"Cannot open '{args.out_file}' for writing: {e}",
                  file=sys.stderr)
            return 1

    return 0


if __name__ == "__main__":
    sys.exit(main())

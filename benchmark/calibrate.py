"""Upper readings for the limits of ``harness/judge.py``: the control and
the faults, each put in the program's place, at each cell's own size.

    python3 benchmark/calibrate.py --seeds 11 12 13 [--cells NAME ...]

For every cell and seed it makes the cell's inputs as a run does, works
out the reference, and reads the judge's numbers for:

* ``control``: the reference computed in bfloat16 (the precision below
  the configurations' float32);
* ``shallow_read``, for a configuration deeper than 16 bits: the
  reference on the 16-bit-rounded copy of the same masters, as a program
  that reads them one grid coarser would see them (``input_peak_gap``
  must fail it where ``table_gap`` and ``angle_regret`` pass it);
* each fault of ``harness/faults.py`` the cell can have, planted in the
  reference's answers: half of a batch's files answered with nothing,
  every angle moved by 45 degrees; for the served stream, half of the
  sessions served silence, the engine state never advancing, the first
  sample of every block moved by 0.25.

It prints one JSON line per reading and a summary of the least reading of
each number per cell.  The lower readings come from the runs of the
program itself (each run prints its numbers)."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import judge  # noqa: E402
from harness.analysis import _bucket_samples  # noqa: E402
from harness.signals import (music_device, music_host,  # noqa: E402
                             sample_bits, song_seconds)
from harness.spec import HELD, Cell, load_spec  # noqa: E402
from reference import offline, stream  # noqa: E402
from reference.dsp import cli_blksiz, hilbert_fir, plugin_geometry  # noqa


def analysis_readings(cell, seed, device):
    import torch

    cfg, tr = cell.config, cell.traffic
    rate, ch = cfg["rate"], cfg["channels"]
    blksiz = cli_blksiz(rate, cfg["blksiz"])
    bits = sample_bits(cfg)
    count = tr.get("files", tr.get("songs"))
    secs = song_seconds(count, **cfg["masters"]["song_seconds"])
    ref, ctl, shallow = {}, {}, {}

    def answers(table, rot0):
        return dict(table=table, rot0=rot0, **offline.select_angles(
            table[None], rot0[None], cfg["stride"], cfg["link"])[0])

    for i, s in enumerate(secs):
        x = music_device(seed, i, ch, int(s * rate), rate,
                         cfg["masters"]["peak_dbfs"], device, bits)[0]
        ref[i] = answers(*offline.peak_table(x.to(torch.float64), blksiz))
        ctl[i] = answers(*offline.peak_table(x, blksiz,
                                             precision="bfloat16"))
        if bits > 16:
            x16 = torch.clamp(torch.round(x.to(torch.float64) * 32768.0),
                              -32768, 32767) / 32768.0
            shallow[i] = answers(*offline.peak_table(x16, blksiz))

    def rows(src):
        return [dict(key=i, **src[i]) for i in src]

    out = {"control": judge.analysis_numbers(rows(ctl), ref)}
    if shallow:
        out["shallow_read"] = judge.analysis_numbers(rows(shallow), ref)
    # half of each batch answered with nothing (zeros), in fleet's groups
    groups = {}
    for i, s in enumerate(secs):
        groups.setdefault(_bucket_samples(int(s * rate), blksiz), []).append(i)
    half = []
    for g in groups.values():
        half += g[len(g) // 2 :]
    broken = rows(ref)
    for r in broken:
        if r["key"] in half:
            r["table"] = np.zeros_like(r["table"])
            r["rot0"] = np.zeros_like(r["rot0"])
    out["half_batch"] = judge.analysis_numbers(broken, ref)
    moved = rows(ref)
    for r in moved:
        r["units"] = [u + 90 for u in r["units"]]
    out["altered_answer"] = judge.analysis_numbers(moved, ref)
    return out


def _stuck(x, targets, block, rate, depth):
    """The served stream of an engine whose state never advances: each
    frame sees no history (no earlier spectra, no delayed dry samples)."""
    g = plugin_geometry(rate)
    P = g["parsiz"]
    C, N = x.shape
    fir0 = hilbert_fir(g["firlen"])[:P].astype(np.float64)
    frames = x[:, : N // P * P].reshape(C, -1, P).astype(np.float64)
    h = np.fft.irfft(np.fft.rfft(frames, 2 * P) * np.fft.rfft(fir0, 2 * P),
                     2 * P)[..., :P]
    ang, slope = stream.frame_angles(targets, N // P, block, P)
    r = ang[..., None] + slope[..., None] * np.arange(P)
    mix = (np.sin(2 * np.pi * r) * h).reshape(C, -1)
    out = np.zeros((C, N))
    lag = (1 + depth) * P
    out[:, lag:] = mix[:, : N - lag]
    return out


def serving_readings(cell, seed, seconds, depth):
    cfg, tr = cell.config, cell.traffic
    rate, ch, block = cfg["rate"], cfg["channels"], cfg["block"]
    k = tr["sessions"]
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 5])
    angles = [round(float(a), 1) for a in rng.uniform(-170.0, 170.0, k)]
    # as many blocks as a session of this cell streams in a run
    blocks = tr["warm_blocks"] + int(seconds * rate / block * min(
        tr["max_xrt"], 1.0 if tr["pacing"] == "open" else 0.6))
    latency = plugin_geometry(rate)["latency"] + depth * 256
    sessions = {name: [] for name in ("control", "half_batch",
                                      "state_unchanged", "altered_answer")}
    for i in range(k):
        x = music_host(seed, i, ch, blocks * block, rate)
        tg = np.full((blocks, ch), angles[i], np.float32)
        y = stream.served(x, tg, block, rate, depth)
        lv = stream.levels(x, y, tg, block, rate, latency)
        variants = {
            "control": stream.served(x, tg, block, rate, depth,
                                     precision="bfloat16"),
            "half_batch": np.zeros_like(y) if i >= k // 2 else y,
            "state_unchanged": _stuck(x, tg, block, rate, depth),
            "altered_answer": y.copy(),
        }
        variants["altered_answer"][:, ::block] += 0.25
        for name, yv in variants.items():
            sessions[name].append(dict(
                out=yv, ref=y, ref_levels=lv,
                levels=stream.levels(x, yv, tg, block, rate, latency)))
    return {name: judge.serving_numbers(s) for name, s in sessions.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cells", nargs="*", default=None)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--depth", type=int, default=3,
                    help="the daemon's pipeline depth in frames")
    ap.add_argument("--spec", action="append", default=None,
                    help="files of BENCHMARK.json's shape to take cells "
                         "from (default: BENCHMARK.json and "
                         "benchmark/held.json)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tests' cut-down cells (a CPU rehearsal)")
    args = ap.parse_args()
    import torch

    specs = ([load_spec(path=p) for p in args.spec] if args.spec
             else [load_spec(), load_spec(path=HELD)])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    least: dict = {}
    for spec, w in [(s, w) for s in specs for w in s["workloads"]]:
        if args.cells and w["name"] not in args.cells:
            continue
        seconds = args.seconds or spec["run_seconds"]
        if args.tiny:
            from bench_tiny import tiny

            cell = tiny(w["name"])
        else:
            cell = Cell(spec, w["name"])
        for seed in args.seeds:
            if cell.traffic["kind"] == "daemon_sessions":
                got = serving_readings(cell, seed, seconds, args.depth)
            else:
                got = analysis_readings(cell, seed, device)
            for variant, numbers in got.items():
                print(json.dumps(dict(cell=cell.name, seed=seed,
                                      variant=variant, **numbers)),
                      flush=True)
                for k, v in numbers.items():
                    key = f"{cell.name} {variant} {k}"
                    least[key] = min(least.get(key, np.inf), v)
    print(json.dumps({"least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

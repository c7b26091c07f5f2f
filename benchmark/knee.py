"""The knee of the real-time serving cell: the most sessions the daemon
serves at real-time pacing with every block's reply inside the block
period (1024 samples at 48 kHz: 21.333 ms) at the 99th percentile and
with no session falling behind its schedule.

    python3 benchmark/knee.py --sessions 1 2 3 4 6 8 --seconds 20 --seed N

Each count runs the ``serve.lv2_48k.rt`` traffic once with that many
sessions and a daemon of its own.  It prints one JSON line per count,
then the knee and the session count at four fifths of it (at least 1),
which ``traffic/rt.json`` takes."""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.common import SetupClock, card_power  # noqa: E402
from harness.spec import HELD, Cell, load_spec  # noqa: E402

import run as bench_run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, nargs="+",
                    default=[1, 2, 3, 4, 6, 8])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 77)
    ap.add_argument("--cell", default="serve.lv2_48k.rt")
    ap.add_argument("--spec", default=str(HELD),
                    help="the file of BENCHMARK.json's shape with the cell")
    args = ap.parse_args()
    cell = Cell(load_spec(path=args.spec), args.cell)
    period_ms = 1e3 * cell.config["block"] / cell.config["rate"]
    print(f"card: {card_power()}", flush=True)
    knee = 0
    for k in args.sessions:
        cell.traffic = dict(cell.traffic, sessions=k)
        out = bench_run.run_cell(
            cell, args.seed + k, args.seconds, False,
            types.SimpleNamespace(type="cuda", index=0), SetupClock())
        res, checked = bench_run.result_line(cell, out, False, "card", 1)
        lag = max(out.info["last_send_lag_ms"])
        ok = (out.info["serve_block_ms_p99"] < period_ms and lag < period_ms
              and res["correct"])
        print(json.dumps(dict(
            sessions=k, p50_ms=out.info["serve_block_ms_p50"],
            p99_ms=out.info["serve_block_ms_p99"], last_send_lag_ms=lag,
            serve_xrt=out.e2e["serve_xrt"], correct=res["correct"],
            under_limit=ok)), flush=True)
        if ok:
            knee = max(knee, k)
    print(json.dumps(dict(knee=knee, sessions=max(1, int(0.8 * knee)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

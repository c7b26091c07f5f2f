"""One streaming session against the engine daemon, in a process of its
own (numpy and a socket only), as a DAW's plugin shim speaks to it.

Run by the serving driver as ``python client.py '<json>'``; it talks to
the driver over its stdin and stdout:

    -> READY <latency>     after INIT_OK
    <- WARM                stream the warm-up blocks back to back
    -> WARMED
    <- GO <t_start> <seconds>
    -> DONE                after the window, with the record written

Pacing ``open``: block j of the window is due at ``t_start + j*block/rate``
and sent then, or when the previous reply arrives if that is later (the
shim waits for each reply); ``closed``: each block goes as soon as the
last reply is in.  No block is sent once the window has passed.  The
record (an .npz) holds every reply's samples and meter levels and, per
window block, when it was due, sent and answered (``time.monotonic``)."""

from __future__ import annotations

import json
import os
import struct
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import wire  # noqa: E402
from harness.signals import music_host  # noqa: E402


def _die_with_parent() -> None:
    """Ask Linux to end this process when the run that started it ends."""
    import ctypes
    import signal

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)
    except (OSError, AttributeError):
        pass


def main() -> int:
    _die_with_parent()
    p = json.loads(sys.argv[1])
    rate, ch, block = p["rate"], p["channels"], p["block"]
    warm, max_blocks = p["warm_blocks"], p["max_blocks"]
    x = music_host(p["seed"], p["index"], ch, max_blocks * block, rate)
    inter = np.ascontiguousarray(x.T)
    angles = np.full(ch, p["angle_deg"], np.float32).tobytes()
    out = np.full((max_blocks * block, ch), np.nan, np.float32)
    lv = np.full((max_blocks, ch, 9), np.nan, np.float32)
    conn = wire.Conn(p["socket"])
    conn.send(wire.INIT, struct.pack("<II", rate, ch))
    mtype, payload = conn.recv()
    if mtype != wire.INIT_OK:
        print(f"ERROR {payload!r}", flush=True)
        return 1
    latency = struct.unpack_from("<I", payload, 0)[0]
    print(f"READY {latency}", flush=True)
    error = ""

    def one(j: int) -> bool:
        nonlocal error
        conn.send(wire.PROC, struct.pack("<I", block) + angles
                  + inter[j * block : (j + 1) * block].tobytes())
        while True:
            mtype, payload = conn.recv()
            if mtype == wire.PROC_OK:
                n = struct.unpack_from("<I", payload, 0)[0]
                out[j * block : j * block + n] = np.frombuffer(
                    payload, np.float32, n * ch, 4).reshape(n, ch)
                return True
            if mtype == wire.LEVELS:
                cnt = struct.unpack_from("<I", payload, 0)[0]
                for e in range(cnt):
                    c = struct.unpack_from("<I", payload, 4 + 40 * e)[0]
                    lv[j, c] = np.frombuffer(payload, np.float32, 9,
                                             8 + 40 * e)
            elif not wire.INFO_FIRST <= mtype <= wire.INFO_LAST:
                error = payload.decode(errors="replace")
                return False

    sys.stdin.readline()  # WARM
    ok = all(one(j) for j in range(warm))
    print("WARMED", flush=True)
    _, t_start, seconds = sys.stdin.readline().split()
    t_start, seconds = float(t_start), float(seconds)
    t_end = t_start + seconds
    period = block / rate
    due, sent, got = [], [], []
    j = warm
    while ok and j < max_blocks:
        if p["pacing"] == "open":
            d = t_start + (j - warm) * period
            if d >= t_end:
                break
            now = time.monotonic()
            if d > now:
                time.sleep(d - now)
        else:
            d = time.monotonic()
            if d >= t_end:
                break
            if d < t_start:
                time.sleep(t_start - d)
                d = t_start
        s = time.monotonic()
        ok = one(j)
        due.append(d)
        sent.append(s)
        got.append(time.monotonic())
        j += 1
    conn.close()
    np.savez(p["out"], out=out[: j * block].T, levels=lv[:j],
             due=np.array(due), sent=np.array(sent), got=np.array(got),
             latency=latency, warm=warm, blocks=j,
             exhausted=j >= max_blocks, error=error)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

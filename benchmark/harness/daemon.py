"""Start the program's engine daemon as users run it
(``python -m phaserotate_tpu_torch.bridge ...``, the arguments after
``--``), in this process, with what the benchmark reads from it.

    python daemon.py --control R --ack W [--trace] [--plant F] -- <daemon args>

The serving driver writes commands to the pipe ``R``; each is answered
with one byte on ``W`` once done:

    start   (traced runs) begin the device trace and the window's spans
    stop    end them
    stats   write the stats JSON (path follows the word): the card, the
            peak of its allocator, modules that must not be here, and
            the traced window (spans, device intervals, the brokers'
            dispatch and frame counters over it)

SIGTERM ends the daemon.  ``--plant`` breaks the program on purpose, for
the benchmark's own tests and its calibration of the limits."""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(1, os.path.dirname(HERE))

from harness.common import forbidden_modules  # noqa: E402
from harness.trace import DeviceTrace, Patches, Trace, span_wrapper  # noqa


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--control", type=int, required=True)
    ap.add_argument("--ack", type=int, required=True)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--plant", default=None)
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    daemon_args = args.rest[1:] if args.rest[:1] == ["--"] else args.rest

    import torch

    from phaserotate_tpu_torch import bridge
    from phaserotate_tpu_torch.plugin import lifecycle
    from phaserotate_tpu_torch.stream import broker as broker_mod

    patches = Patches()
    brokers = []
    init = broker_mod.StreamBroker.__init__

    def registered(self, *a, **kw):
        init(self, *a, **kw)
        brokers.append(self)

    patches.set(broker_mod.StreamBroker, "__init__", registered)
    trace = Trace()
    if args.trace:
        patches.set(broker_mod.StreamBroker, "_step", span_wrapper(
            broker_mod.StreamBroker._step, "broker_step", trace))
        patches.set(lifecycle, "host_meter_block", span_wrapper(
            lifecycle.host_meter_block, "meter", trace))
        patches.set(bridge, "_recv_msg", span_wrapper(
            bridge._recv_msg, "socket_recv", trace))
        patches.set(bridge, "_send_msg", span_wrapper(
            bridge._send_msg, "socket_send", trace))
        gc_start = {}

        def gc_span(phase, info):  # collections as spans: they hold the GIL
            if phase == "start":
                gc_start[info["generation"]] = time.time_ns()
            elif info["generation"] in gc_start:
                trace.spans.append((f"gc_gen{info['generation']}",
                                    gc_start.pop(info["generation"]),
                                    time.time_ns()))

        gc.callbacks.append(gc_span)
    if args.plant:
        from harness import faults

        faults.plant_serving(args.plant, patches)

    cuda = "cpu" not in daemon_args
    dev_trace = DeviceTrace(os.getcwd()) if cuda else None
    state = {}

    def counters():
        return dict(dispatches=sum(b.dispatches for b in brokers),
                    frames_served=sum(b.frames_served for b in brokers))

    def control():
        with os.fdopen(args.control) as cmds, os.fdopen(args.ack, "wb",
                                                       0) as ack:
            for line in cmds:
                word, *rest = line.split()
                if word == "start":
                    if dev_trace is not None:
                        dev_trace.start()
                    state["c0"] = counters()
                    state["w0"] = time.time_ns()
                elif word == "stop":
                    w1 = time.time_ns()
                    if dev_trace is not None:
                        trace.device, trace.window = dev_trace.stop()
                    else:
                        trace.window = (state["w0"], w1)
                    c1 = counters()
                    trace.counters = {k: c1[k] - state["c0"][k] for k in c1}
                    w0, w1 = trace.window
                    trace.spans = [s for s in trace.spans
                                   if s[1] >= w0 and s[2] <= w1]
                    state["traced"] = True
                elif word == "stats":
                    stats = dict(
                        forbidden=forbidden_modules(),
                        counters=counters(),
                        trace=trace.to_json() if state.get("traced") else None)
                    if cuda:
                        stats.update(
                            device_name=torch.cuda.get_device_name(0),
                            count=1,
                            memory_peak_bytes=torch.cuda.max_memory_allocated(
                                0))
                    with open(rest[0], "w") as f:
                        json.dump(stats, f)
                ack.write(b"A")

    threading.Thread(target=control, daemon=True).start()
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    return bridge.main(daemon_args)


if __name__ == "__main__":
    sys.exit(main())

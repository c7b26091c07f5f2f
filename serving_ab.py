#!/usr/bin/env python3
"""Where the daemon's host time goes, on one CUDA card.

    python3 serving_ab.py

The daemon (phaserotate_tpu_torch/bridge.py) serves every session from a
thread of one Python process, and every torch op a thread issues releases
the GIL and takes it back.  This script measures what that costs:

1. the broker's step (``stream/broker._slot_step``, 8 stereo slots on the
   card) alone, then while 8 threads run the plugin's meters on the host
   CPU in a loop, once with the meter module's torch functions and once
   with its numpy twins (``host_meter_block``, what the plugin runs);
2. ``chip_smoke.drive_serving`` (eight batched ``prt_bridge`` sessions and
   the rest of that run, with batched sessions of 10 s and the others of
   5 s, longer than chip_smoke's own, to steady the rates) with the
   plugin's meters as shipped (numpy) and with the torch functions
   patched in, in the order numpy, torch, torch, numpy.

Every line carries the card's name and power limit.  Without a CUDA
device it exits 2.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def step_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from phaserotate_tpu_torch import meter
    from phaserotate_tpu_torch.core.sizes import stream_geometry_for_rate
    from phaserotate_tpu_torch.io import read_wav, write_wav
    from phaserotate_tpu_torch.plugin import lifecycle
    from phaserotate_tpu_torch.stream import broker
    from phaserotate_tpu_torch.stream.engine import init_state

    cs.SERVE_SECONDS, cs.SOLO_SECONDS = 10, 5

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")

    # ---- 1. the broker's step, alone and beside 8 metering threads ----
    geom = stream_geometry_for_rate(cs.RATE)
    state = init_state(geom, (8, 2), dev)
    frames = torch.randn(8, 2, geom.parsiz, device=dev)
    targets = torch.full((8, 2), 35.0, device=dev)
    every = torch.ones(8, dtype=torch.bool, device=dev)
    none = torch.zeros(8, dtype=torch.bool, device=dev)

    def step():
        broker._slot_step(state, frames, targets, every, none, geom)

    print(f"broker step (8 x 2 slots) alone: {step_ms(step, 300)!r} ms "
          f"[{card}]")
    cfg = meter.MeterConfig(float(cs.RATE), geom.latency + 3 * geom.parsiz)
    block = np.random.default_rng(cs.SEED).standard_normal(
        (2, 1024)).astype(np.float32)
    changed = np.zeros(2, bool)
    falloff = meter.meter_falloff(cs.RATE, 1024)
    variants = {
        "torch": (lambda: meter.init_meter_state(cfg, (2,), "cpu"),
                  lambda s: meter.meter_block(
                      s, torch.from_numpy(block), torch.from_numpy(block),
                      falloff, cfg.hold_samples, torch.from_numpy(changed))),
        "numpy": (lambda: meter.host_meter_state(cfg, (2,)),
                  lambda s: meter.host_meter_block(
                      s, block, block, falloff.item(), cfg.hold_samples,
                      changed)),
    }
    for name, (init, run) in variants.items():
        stop = threading.Event()
        counts = [0] * 8

        def spin(i, init=init, run=run):
            s = init()
            while not stop.is_set():
                s, _ = run(s)
                counts[i] += 1

        threads = [threading.Thread(target=spin, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        ms = step_ms(step, 50)
        rate = sum(counts) / (time.perf_counter() - t0)
        stop.set()
        for t in threads:
            t.join()
        print(f"broker step beside 8 threads metering with the {name} "
              f"functions: {ms!r} ms ({rate:.0f} meter blocks/s) [{card}]")

    # ---- 2. the serving run, the plugin's meters numpy or torch ----
    shipped = (lifecycle.host_meter_state, lifecycle.host_meter_block,
               lifecycle.host_reset_peaks)

    def torch_meters():
        lifecycle.host_meter_state = (
            lambda c, ch: meter.init_meter_state(c, ch, "cpu"))
        lifecycle.host_meter_block = (
            lambda s, i, o, f, h, c: meter.meter_block(
                s, torch.from_numpy(i), torch.from_numpy(o),
                torch.tensor(f, dtype=torch.float32), h,
                torch.from_numpy(c)))
        lifecycle.host_reset_peaks = meter.reset_peaks

    with tempfile.TemporaryDirectory(prefix="serving_ab_") as tmp:
        audio = cs.music_like(np.random.default_rng(cs.SEED), 2,
                              4 * 60 * cs.RATE)
        src = os.path.join(tmp, "in.wav")
        write_wav(src, audio, cs.RATE, bits=16, float_format=False)
        audio, _, _ = read_wav(src)
        for k, name in enumerate(("numpy", "torch", "torch", "numpy")):
            (lifecycle.host_meter_state, lifecycle.host_meter_block,
             lifecycle.host_reset_peaks) = shipped
            if name == "torch":
                torch_meters()
            run_dir = os.path.join(tmp, f"run{k}")
            os.makedirs(run_dir)
            print(f"---- serving with the plugin's meters in {name} "
                  f"(run {k + 1} of 4) ----", flush=True)
            t0 = time.perf_counter()
            cs.drive_serving(run_dir, dev, card, {}, audio, src)
            print(f"serving run {k + 1} ({name} meters): "
                  f"{time.perf_counter() - t0:.6f} s [{card}]", flush=True)
        (lifecycle.host_meter_state, lifecycle.host_meter_block,
         lifecycle.host_reset_peaks) = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())

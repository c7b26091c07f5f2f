"""Driver of the serving traffic: the engine daemon in its own process,
and one client process per session (``client.py``).

Set-up starts the daemon (``daemon.py`` around the program's
``bridge.main``), connects the sessions and streams their warm-up blocks
together, so the broker's batched step has run at its shape before the
window.  The window then runs ``seconds`` of blocks at the traffic's
pacing.  Every served sample and meter level of every session, warm-up
included, is then held against the reference (``reference/stream.py``)
on the host; this process never touches the card."""

from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import sys
import time
from typing import List

import numpy as np

from reference.dsp import plugin_geometry
from reference.stream import levels as ref_levels
from reference.stream import served as ref_served

from .common import cache_env
from .outcome import Outcome
from .signals import music_host
from .spec import BENCH
from .trace import Trace

HARNESS = BENCH / "harness"


class _Daemon:
    """The daemon process and its command pipes."""

    def __init__(self, cfg, device: str, traced: bool, tmpdir: str,
                 plant=None):
        ready_r, ready_w = os.pipe()
        ctl_r, self.ctl_w = os.pipe()
        self.ack_r, ack_w = os.pipe()
        self.log = open(os.path.join(tmpdir, "daemon.log"), "w+")
        cmd = [sys.executable, str(HARNESS / "daemon.py"),
               "--control", str(ctl_r), "--ack", str(ack_w)]
        cmd += ["--trace"] if traced else []
        cmd += ["--plant", plant] if plant else []
        cmd += ["--", "--socket", "bench.sock", "--batch-sessions",
                str(cfg["batch_sessions"]), "--pipeline",
                str(cfg["pipeline"]), "--device", device,
                "--ready-fd", str(ready_w)]
        cmd += ["--meters"] if cfg["meters"] else []
        self.proc = subprocess.Popen(
            cmd, cwd=tmpdir, pass_fds=(ready_w, ctl_r, ack_w),
            stdout=self.log, stderr=subprocess.STDOUT, env=cache_env())
        for fd in (ready_w, ctl_r, ack_w):
            os.close(fd)
        self.ready_r = ready_r

    def wait_ready(self) -> None:
        ok, _, _ = select.select([self.ready_r], [], [], 600)
        byte = os.read(self.ready_r, 1) if ok else b""
        os.close(self.ready_r)
        if byte != b"R":
            raise RuntimeError("the daemon did not start:\n" + self.tail())

    def tail(self) -> str:
        self.log.flush()
        self.log.seek(0)
        return self.log.read()[-4000:]

    def command(self, line: str, timeout: float = 300.0) -> None:
        os.write(self.ctl_w, (line + "\n").encode())
        ok, _, _ = select.select([self.ack_r], [], [], timeout)
        if not ok or os.read(self.ack_r, 1) != b"A":
            raise RuntimeError(f"the daemon did not answer {line!r}:\n"
                               + self.tail())

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        for fd in (self.ctl_w, self.ack_r):
            try:
                os.close(fd)
            except OSError:
                pass
        self.log.close()


def _expect(procs, word: str, timeout: float) -> List[str]:
    deadline = time.monotonic() + timeout
    got = []
    for p in procs:
        left = deadline - time.monotonic()
        ok, _, _ = select.select([p.stdout], [], [], max(0.0, left))
        line = p.stdout.readline() if ok else ""
        if not line.startswith(word):
            raise RuntimeError(f"a client said {line!r}, not {word}")
        got.append(line.split()[1:])
    return got


def _tell(procs, line: str) -> None:
    for p in procs:
        p.stdin.write(line + "\n")
        p.stdin.flush()


def sessions(cell, seed: int, seconds: float, traced: bool, device,
             clock, tmpdir: str, gate=None, plant=None) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    rate, ch, block = cfg["rate"], cfg["channels"], cfg["block"]
    k = tr["sessions"]
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 5])
    angles = [round(float(a), 1) for a in rng.uniform(-170.0, 170.0, k)]
    per_s = rate / block
    warm = tr["warm_blocks"]
    max_blocks = warm + int(np.ceil(seconds * per_s * tr["max_xrt"])) + 1
    dev = "cpu" if device.type == "cpu" else f"cuda:{device.index or 0}"
    daemon = _Daemon(cfg, dev, traced, tmpdir, plant)
    clients = []
    try:
        if gate is not None:
            gate()
        daemon.wait_ready()
        clock.mark("daemon_start")
        for i in range(k):
            params = dict(socket="bench.sock", rate=rate, channels=ch,
                          block=block, seed=seed, index=i,
                          angle_deg=angles[i], warm_blocks=warm,
                          max_blocks=max_blocks, pacing=tr["pacing"],
                          out=os.path.join(tmpdir, f"session{i}.npz"))
            clients.append(subprocess.Popen(
                [sys.executable, str(HARNESS / "client.py"),
                 json.dumps(params)], cwd=tmpdir, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True, env=cache_env()))
        latency = [int(r[0]) for r in _expect(clients, "READY", 300)]
        clock.mark("sessions_init")
        _tell(clients, "WARM")
        _expect(clients, "WARMED", 300)
        clock.mark("warmup")
        if traced:
            daemon.command("start")
        t_start = time.monotonic() + 0.05
        setup_s = clock.total(t_start)
        _tell(clients, f"GO {t_start!r} {seconds!r}")
        _expect(clients, "DONE", seconds * tr["max_xrt"] + 120)
        if traced:
            daemon.command("stop")
        stats_path = os.path.join(tmpdir, "daemon_stats.json")
        daemon.command(f"stats {stats_path}")
        with open(stats_path) as f:
            stats = json.load(f)
    finally:
        for p in clients:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        daemon.close()
    if stats["forbidden"]:
        raise RuntimeError(f"the daemon loaded {stats['forbidden']}")

    recs = [dict(np.load(os.path.join(tmpdir, f"session{i}.npz")))
            for i in range(k)]
    lat_ms, sent_blocks, last = [], 0, t_start
    for r in recs:
        lat_ms += list(1e3 * (r["got"] - r["due"]))
        sent_blocks += len(r["got"])
        if len(r["got"]):
            last = max(last, float(r["got"].max()))
    attempted = sum(int(r["blocks"]) for r in recs)
    failed = sum(int(np.isnan(r["out"][0, ::block]).sum()) for r in recs)
    e2e = {"serve_block_ms_p99": float(np.percentile(lat_ms, 99)),
           "serve_xrt": sent_blocks * block / rate / (last - t_start)}
    geom = plugin_geometry(rate)
    t_ref = time.monotonic()
    judged = []
    for i, r in enumerate(recs):
        nb = int(r["blocks"])
        x = music_host(seed, i, ch, max_blocks * block, rate)[:, : nb * block]
        targets = np.full((nb, ch), angles[i], np.float32)
        depth, rem = divmod(latency[i] - geom["latency"], geom["parsiz"])
        if rem or depth < 0:
            judged.append(dict(out=r["out"], ref=np.full_like(r["out"], 1e9),
                               levels=r["levels"], ref_levels=r["levels"]))
            continue
        y = ref_served(x, targets, block, rate, depth)
        judged.append(dict(
            out=r["out"], ref=y, levels=r["levels"],
            ref_levels=ref_levels(x, y, targets, block, rate, latency[i])))
    from .judge import serving_numbers

    numbers = serving_numbers(judged)
    lag = [float(1e3 * (r["sent"][-1] - r["due"][-1])) for r in recs
           if len(r["sent"])]
    info = dict(sessions=k, angles=angles, latency=latency,
                blocks=[int(r["blocks"]) for r in recs],
                window_blocks=sent_blocks,
                serve_block_ms_p50=float(np.percentile(lat_ms, 50)),
                serve_block_ms_p99=e2e["serve_block_ms_p99"],
                last_send_lag_ms=lag,
                exhausted=[bool(r["exhausted"]) for r in recs],
                errors=[str(r["error"]) for r in recs if str(r["error"])],
                reference_s=time.monotonic() - t_ref)
    trace = Trace.from_json(stats["trace"]) if stats.get("trace") else None
    info["device_name"] = stats.get("device_name")
    return Outcome(
        e2e=e2e, setup_s=setup_s, attempted=attempted, failed=failed,
        numbers=numbers, memory_peak=int(stats.get("memory_peak_bytes", 0)),
        trace=trace if traced else None, info=info)

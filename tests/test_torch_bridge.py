"""The port's engine daemon (phaserotate_tpu_torch/bridge.py) against the
JAX package's, on the CPU.

Both daemons run in threads of this process (the port's with
``device="cpu"``) and get the same streams: ``PROC`` replies agree within
1e-5, ``LEVELS`` within 1e-5, ``STATE`` and ``INIT_OK`` exactly, the
analysis angles are equal, and the malformed-input ``ERR`` replies are the
same strings.  Each package's ``BridgeClient`` drives the other's daemon
through a recording proxy, and the two send the same bytes; the native
``prt_bridge`` gets the same output from either daemon.  One test starts
``python -m phaserotate_tpu_torch.bridge --device cpu`` as a subprocess.
The rest pins the lifecycle properties ``tests/test_bridge.py`` pins for
the JAX daemon.  Every socket read has a timeout; nothing sleeps to order
events.
"""

import json
import os
import select
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import urllib.request

import numpy as np
import pytest
import torch

from phaserotate_tpu import bridge as jb
from phaserotate_tpu.search import find_min_peak_angle as j_find
from phaserotate_tpu_torch import bridge as pb
from phaserotate_tpu_torch.io import read_wav, write_wav
from phaserotate_tpu_torch.stream import StreamingRotator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
RATE = 48000
TIMEOUT = 60.0  # seconds any socket read or wait may take


def _free_ports(n: int):
    """``n`` distinct free TCP ports (all bound at once, then released)."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _serve(mod, **kw) -> str:
    """Start ``mod.serve`` in a daemon thread on a fresh socket; returns
    the socket path once the daemon listens."""
    sock = os.path.join(tempfile.mkdtemp(prefix="prt"), "e.sock")
    r, w = os.pipe()

    def run():
        try:
            mod.serve(sock, ready_fd=w, timeout=TIMEOUT, **kw)
        except Exception:
            os.write(w, b"E")  # a daemon that fails to start says so
            raise

    threading.Thread(target=run, daemon=True).start()
    ready, _, _ = select.select([r], [], [], TIMEOUT)
    assert ready and os.read(r, 1) == b"R", "daemon failed to start"
    os.close(r)
    return sock


@pytest.fixture(scope="module")
def daemons():
    """(port daemon, JAX daemon) pairs, started on first use, by config."""
    made = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            made[key] = (_serve(pb, device="cpu", **kw), _serve(jb, **kw))
        return made[key]

    return get


def _client(mod, sock, channels=1, **kw):
    cl = mod.BridgeClient(sock, RATE, channels, **kw)
    cl.sock.settimeout(TIMEOUT)
    return cl


def _raw(sock):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(TIMEOUT)
    s.connect(sock)
    return s


def _session_script(cl, rng_seed, n_blocks=10, block=1024):
    """Stream seeded stereo blocks with the angle moving and the UI
    events of a GUI session; returns the output blocks."""
    rng = np.random.default_rng(rng_seed)
    outs = []
    for i in range(n_blocks):
        if i == 1:
            cl.ui_on()
        if i == 4:
            cl.set_state(1.5, True)
        if i == 6:
            cl.reset_peaks()
        if i == 8:
            cl.ui_off()
            cl.ui_on()
        x = (0.4 * rng.standard_normal((cl.channels, block))
             ).astype(np.float32)
        deg = [0.0, 35.0, 35.0, 160.0, -160.0][min(i, 4)]
        outs.append(cl.process(x, [deg, -deg / 2][: cl.channels]))
    outs += cl.drain()
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("config", [
    dict(),
    dict(pipeline=2),
    dict(pipeline=2, batch_sessions=2),
], ids=["sync", "pipelined", "batched"])
def test_proc_levels_and_state_match_jax_daemon(daemons, config):
    port_sock, jax_sock = daemons(**config)
    res = {}
    for name, sock in (("port", port_sock), ("jax", jax_sock)):
        cl = _client(pb, sock, channels=2)
        res[name] = (cl.latency, cl.parsiz, _session_script(cl, 7),
                     list(cl.levels), list(cl.states))
        cl.close()
    (pl, pp_, py, plv, pst), (jl, jp_, jy, jlv, jst) = res["port"], res["jax"]
    assert (pl, pp_) == (jl, jp_)
    np.testing.assert_allclose(py, jy, atol=1e-5)
    assert np.abs(py[:, pl:]).max() > 0.1
    assert pst == jst == [(1.0, False), (1.5, True)]
    assert len(plv) == len(jlv) > 0
    for a, b in zip(plv, jlv):
        assert a[0] == b[0]  # channel
        np.testing.assert_allclose(a[1:], b[1:], atol=1e-5)


@pytest.mark.parametrize("link", [False, True], ids=["channels", "linked"])
def test_analyze_replies_match_jax_daemon(daemons, link):
    port_sock, jax_sock = daemons()
    t = np.arange(RATE // 2) / RATE
    x = np.stack([0.5 * np.sin(2 * np.pi * 100 * t)
                  + 0.3 * np.sin(2 * np.pi * 200 * t),
                  0.4 * np.sin(2 * np.pi * 150 * t)
                  + 0.25 * np.sin(2 * np.pi * 450 * t + 1.0)]
                 ).astype(np.float32)
    got = {}
    for name, sock in (("port", port_sock), ("jax", jax_sock)):
        cl = _client(pb, sock, channels=2, init=False)
        got[name] = cl.analyze(x, link_channels=link, chunk=7777)
        cl.close()
    assert len(got["port"]) == 2
    for p, j in zip(got["port"], got["jax"]):
        assert (p["angle_deg"], p["found"]) == (j["angle_deg"], j["found"])
        assert p["peak_zero"] == pytest.approx(j["peak_zero"], abs=1e-5)
        assert p["peak_min"] == pytest.approx(j["peak_min"], abs=1e-5)
    local = j_find(x, rate=RATE, link_channels=link)
    assert [r["angle_deg"] for r in got["port"]] == \
        [float(np.float32(a)) for a in local.angles_deg]


class _Recorder:
    """A Unix-socket proxy in front of a daemon that records the bytes of
    one connection each way."""

    def __init__(self, upstream: str):
        self.path = os.path.join(tempfile.mkdtemp(prefix="prt"), "p.sock")
        self.up, self.down = bytearray(), bytearray()
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(self.path)
        self._srv.listen(1)
        self._upstream = upstream
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _pump(src, dst, log):
        while True:
            chunk = src.recv(1 << 16)
            if not chunk:
                break
            log.extend(chunk)
            dst.sendall(chunk)
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def _run(self):
        self._srv.settimeout(TIMEOUT)
        conn, _ = self._srv.accept()
        conn.settimeout(TIMEOUT)
        up = _raw(self._upstream)
        back = threading.Thread(target=self._pump,
                                args=(up, conn, self.down), daemon=True)
        back.start()
        self._pump(conn, up, self.up)
        back.join(TIMEOUT)
        conn.close()
        up.close()
        self._srv.close()

    def join(self):
        self._thread.join(TIMEOUT)
        assert not self._thread.is_alive()


def _messages(blob: bytes):
    out, pos = [], 0
    while pos < len(blob):
        mtype, mlen = struct.unpack_from("<II", blob, pos)
        out.append((mtype, bytes(blob[pos + 8 : pos + 8 + mlen])))
        pos += 8 + mlen
    return out


def test_each_client_drives_the_other_daemon_byte_for_byte(daemons):
    """The JAX BridgeClient against the port's daemon and the port's
    BridgeClient against the JAX daemon, through recording proxies: the
    two clients send the same bytes, and the replies are the same
    messages (audio and levels within 1e-5, the rest byte for byte)."""
    port_sock, jax_sock = daemons()
    t = np.arange(RATE // 4) / RATE
    xa = (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)[None]
    runs = {}
    for name, mod, sock in (("jax_client", jb, port_sock),
                            ("port_client", pb, jax_sock)):
        rec = _Recorder(sock)
        cl = _client(mod, rec.path, channels=1, slack=1)
        y = _session_script(cl, 11, n_blocks=6, block=700)
        res = cl.analyze(xa)
        cl.close()
        rec.join()
        runs[name] = (rec, y, res)
    (rj, yj, aj), (rp, yp, ap) = runs["jax_client"], runs["port_client"]
    assert rj.up == rp.up and len(rj.up) > 6 * 700 * 4
    np.testing.assert_allclose(yj, yp, atol=1e-5)
    assert [r["angle_deg"] for r in aj] == [r["angle_deg"] for r in ap]
    mj, mp = _messages(rj.down), _messages(rp.down)
    assert [m[0] for m in mj] == [m[0] for m in mp]
    for (t_, a), (_, b) in zip(mj, mp):
        if t_ in (pb.T_PROC_OK, pb.T_LEVELS):
            assert len(a) == len(b) and a[:4] == b[:4]
            fa = np.frombuffer(a, np.float32)[1:]
            fb = np.frombuffer(b, np.float32)[1:]
            if t_ == pb.T_LEVELS:  # skip the u32 channel of each entry
                fa, fb = fa.reshape(-1, 10)[:, 1:], fb.reshape(-1, 10)[:, 1:]
            np.testing.assert_allclose(fa, fb, atol=1e-5)
        elif t_ == pb.T_ANALYZE_OK:
            assert a[:8] == b[:8] and a[16:20] == b[16:20]
        else:
            assert a == b, t_


def test_raw_replies_byte_identical_at_angle_zero(daemons):
    """At 0 degrees the rotation is the delayed input exactly: INIT_OK
    and PROC_OK are the same bytes from both daemons."""
    port_sock, jax_sock = daemons()
    rng = np.random.default_rng(3)
    x = (0.5 * rng.standard_normal((3000, 2))).astype(np.float32)
    replies = []
    for sock in (port_sock, jax_sock):
        s = _raw(sock)
        s.sendall(struct.pack("<I", pb.MAGIC))
        pb._send_msg(s, pb.T_INIT, struct.pack("<II", RATE, 2))
        got = [pb._recv_msg(s)]
        for i in range(0, 3000, 1000):
            pb._send_msg(s, pb.T_PROC, struct.pack("<I", 1000)
                         + np.zeros(2, np.float32).tobytes()
                         + x[i : i + 1000].tobytes())
            got.append(pb._recv_msg(s))
        pb._send_msg(s, pb.T_BYE)
        s.close()
        replies.append(got)
    assert replies[0] == replies[1]
    assert replies[0][0] == (pb.T_INIT_OK,
                             struct.pack("<III", 1792, 256, 2))


def _init(rate=RATE, channels=1):
    return struct.pack("<II", pb.T_INIT, 8) + struct.pack("<II", rate,
                                                          channels)


def _msg(mtype, payload=b""):
    return struct.pack("<II", mtype, len(payload)) + payload


_BEGIN = struct.pack("<IIIII", RATE, 1, 0, 24, 0)
# malformed sessions: bytes after the magic word, and whether the daemon
# answers INIT_OK first
MALFORMED = {
    "bad_magic": (None, False),
    "proc_before_init": (_msg(pb.T_PROC, struct.pack("<I", 0)), False),
    "ctrl_before_init": (_msg(pb.T_CTRL, struct.pack("<I", 1)), False),
    "data_before_begin": (_msg(pb.T_ANALYZE_DATA, struct.pack("<I", 0)),
                          False),
    "end_before_begin": (_msg(pb.T_ANALYZE_END), False),
    "init_3_channels": (_init(channels=3), False),
    "init_bad_rate": (_init(rate=100), False),
    "begin_bad_channels": (_msg(pb.T_ANALYZE_BEGIN, struct.pack(
        "<IIIII", RATE, 99, 0, 24, 0)), False),
    "begin_bad_rate": (_msg(pb.T_ANALYZE_BEGIN, struct.pack(
        "<IIIII", 7999, 1, 0, 24, 0)), False),
    "short_proc": (_init() + _msg(pb.T_PROC, b"\x00\x00"), True),
    "bad_proc": (_init() + _msg(pb.T_PROC, struct.pack("<I", 10)
                                + bytes(8)), True),
    "unknown_ctrl": (_init() + _msg(pb.T_CTRL, struct.pack("<I", 99)),
                     True),
    "unknown_type": (_msg(42), False),
    "bad_data_payload": (_msg(pb.T_ANALYZE_BEGIN, _BEGIN)
                         + _msg(pb.T_ANALYZE_DATA, struct.pack("<I", 3)),
                         False),
    "over_sample_cap": (_msg(pb.T_ANALYZE_BEGIN, struct.pack(
        "<IIIII", RATE, 8, 0, 24, 0)) + _msg(pb.T_ANALYZE_DATA, struct.pack(
            "<I", pb.MAX_ANALYZE_SAMPLES // 8 + 1)), False),
    "empty_analysis": (_msg(pb.T_ANALYZE_BEGIN, _BEGIN)
                       + _msg(pb.T_ANALYZE_END), False),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_input_replies_equal_jax(daemons, case):
    """Each malformed session gets the same reply from both daemons (the
    same ERR string; an empty analysis is answered, not refused)."""
    port_sock, jax_sock = daemons()
    body, has_init = MALFORMED[case]
    replies = []
    for sock in (port_sock, jax_sock):
        s = _raw(sock)
        if body is None:
            s.sendall(struct.pack("<I", 0xDEADBEEF))
        else:
            s.sendall(struct.pack("<I", pb.MAGIC) + body)
        if has_init:
            assert pb._recv_msg(s)[0] == pb.T_INIT_OK
        replies.append(pb._recv_msg(s))
        s.close()
    assert replies[0] == replies[1]
    if case == "empty_analysis":
        assert replies[0][0] == pb.T_ANALYZE_OK
    else:
        assert replies[0][0] == pb.T_ERR


def test_native_prt_bridge_same_through_either_daemon(daemons, tmp_path):
    """native/prt_bridge streams a stereo file and runs -A through the
    port's daemon and through the JAX daemon: the same audio within 1e-5,
    the same printed analysis."""
    subprocess.run(["make", "-C", NATIVE, "prt_bridge"], check=True,
                   capture_output=True, timeout=180)
    exe = os.path.join(NATIVE, "prt_bridge")
    rng = np.random.default_rng(21)
    x = (0.4 * rng.standard_normal((2, RATE // 2))).astype(np.float32)
    src = str(tmp_path / "in.wav")
    write_wav(src, x, RATE)
    port_sock, jax_sock = daemons()
    outs, texts = [], []
    for name, sock in (("port", port_sock), ("jax", jax_sock)):
        dst = str(tmp_path / f"out_{name}.wav")
        r = subprocess.run([exe, "-s", sock, "-b", "1024", "-m", "-a",
                            "30,-45", src, dst], capture_output=True,
                           text=True, timeout=TIMEOUT)
        assert r.returncode == 0, r.stderr
        assert "dBFS" in r.stderr  # meter lines from LEVELS
        outs.append(read_wav(dst)[0])
        a = subprocess.run([exe, "-s", sock, "-A", src], capture_output=True,
                           text=True, timeout=TIMEOUT)
        assert a.returncode == 0, a.stderr
        texts.append(a.stdout)
    assert outs[0].shape == x.shape
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
    assert texts[0] == texts[1] and "Channel:  2 Phase:" in texts[0]


def test_batched_sessions_match_solo_streaming(daemons):
    """Two concurrent clients of a batched daemon each get the stream of a
    solo StreamingRotator with the session's pipeline depth."""
    port_sock, _ = daemons(pipeline=2, batch_sessions=2)
    rng = np.random.default_rng(23)
    xs = [(0.4 * rng.standard_normal((1, 512))).astype(np.float32)
          for _ in range(2)]
    outs, errs = [[], []], []

    def client(i):
        try:
            cl = _client(pb, port_sock)
            for _ in range(8):
                outs[i].append(cl.process(xs[i], 15.0 * (i + 1)))
            cl.close()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not errs
    for i in (0, 1):
        rot = StreamingRotator(rate=RATE, channels=1, pipeline_depth=2,
                               device="cpu")
        want = [rot.process(xs[i], 15.0 * (i + 1)) for _ in range(8)]
        np.testing.assert_allclose(np.concatenate(outs[i], axis=1),
                                   np.concatenate(want, axis=1), atol=1e-5)


def test_ctrl_events_levels_state_and_reset(daemons):
    """ui_on starts LEVELS and echoes STATE once; a state event persists
    and is echoed on the next ui_on; reset_peaks clears the hold; ui_off
    stops the stream (tests/test_bridge.py's CTRL properties)."""
    port_sock, _ = daemons()
    rng = np.random.default_rng(24)
    cl = _client(pb, port_sock)
    x = (0.3 * rng.standard_normal((1, 512))).astype(np.float32)
    cl.process(x, 0.0)
    assert not cl.levels and not cl.states
    cl.set_state(1.25, True)
    cl.ui_on()
    cl.process(0.9 * np.sign(x), 0.0)
    assert cl.states == [(1.25, True)] and len(cl.levels) == 1
    quiet = (1e-3 * x).astype(np.float32)
    for _ in range(4):
        cl.process(quiet, 0.0)
    assert cl.levels[-1][3] > 0.5  # in_peak holds the loud block
    cl.reset_peaks()
    for _ in range(12):  # the input meter reads a latency delay line
        cl.process(quiet, 0.0)
    assert cl.levels[-1][3] < 0.1
    n = len(cl.levels)
    cl.ui_off()
    cl.process(quiet, 0.0)
    assert len(cl.levels) == n and len(cl.states) == 1
    cl.close()


def test_concurrent_clients_interleaved(daemons):
    """Two sessions with interleaved blocks each come out as if alone."""
    port_sock, _ = daemons()
    rng = np.random.default_rng(25)
    n, blk = 4000, 500
    xs = [(0.5 * rng.standard_normal(n)).astype(np.float32)
          for _ in range(2)]
    cls = [_client(pb, port_sock) for _ in range(2)]
    lat = cls[0].latency
    totals = [np.concatenate([x, np.zeros(lat, np.float32)]) for x in xs]
    outs = [[], []]
    for i in range(0, n + lat, blk):
        for k in (0, 1):
            outs[k].append(cls[k].process(totals[k][None, i : i + blk], 0.0))
    for cl in cls:
        cl.close()
    for k in (0, 1):
        y = np.concatenate(outs[k], axis=1)[0]
        np.testing.assert_allclose(y[lat : lat + n], xs[k], atol=1e-6)


def test_client_slack_is_the_delayed_stream(daemons):
    port_sock, _ = daemons()
    rng = np.random.default_rng(26)
    x = (0.5 * rng.standard_normal((1, 12 * 512))).astype(np.float32)
    streams = {}
    for slack in (0, 2):
        cl = _client(pb, port_sock, slack=slack)
        outs = [cl.process(x[:, i * 512 : (i + 1) * 512], 25.0)
                for i in range(12)]
        outs += cl.drain()
        cl.close()
        streams[slack] = np.concatenate(outs, axis=1)
    np.testing.assert_array_equal(streams[2][:, :1024], 0.0)
    np.testing.assert_array_equal(streams[2][:, 1024:], streams[0])


def test_analyze_chunking_and_sample_cap(daemons):
    port_sock, _ = daemons()
    rng = np.random.default_rng(27)
    x = (0.4 * rng.standard_normal((1, 40000))).astype(np.float32)
    cl = _client(pb, port_sock, init=False)
    assert cl.analyze(x, chunk=1 << 18) == cl.analyze(x, chunk=777)
    cl.close()
    cl = _client(pb, port_sock, channels=8, init=False)
    pb._send_msg(cl.sock, pb.T_ANALYZE_BEGIN,
                 struct.pack("<IIIII", RATE, 8, 0, 24, 0))
    pb._send_msg(cl.sock, pb.T_ANALYZE_DATA,
                 struct.pack("<I", pb.MAX_ANALYZE_SAMPLES // 8 + 1))
    mtype, payload = pb._recv_msg(cl.sock)
    # the declared length is checked against the payload first, as in JAX
    assert mtype == pb.T_ERR and (b"exceeds" in payload
                                  or b"bad ANALYZE_DATA" in payload)
    cl.sock.close()


def test_analysis_slots_bounded_and_returned(daemons):
    """MAX_CONCURRENT_ANALYSES BEGINs hold every slot of the port's own
    semaphore; the test waits until they are all taken (BEGIN has no
    reply) before the extra BEGIN, which is refused as busy; the slots
    come back when the holders drop."""
    port_sock, _ = daemons()
    slots = pb._analyze_slots
    holders = []
    try:
        for _ in range(pb.MAX_CONCURRENT_ANALYSES):
            s = _raw(port_sock)
            s.sendall(struct.pack("<I", pb.MAGIC))
            pb._send_msg(s, pb.T_ANALYZE_BEGIN, _BEGIN)
            holders.append(s)
        done = threading.Event()
        for _ in range(int(TIMEOUT / 0.01)):
            if slots._value == 0:
                break
            done.wait(0.01)
        assert slots._value == 0, "the holders' BEGINs were not handled"
        extra = _raw(port_sock)
        extra.sendall(struct.pack("<I", pb.MAGIC))
        pb._send_msg(extra, pb.T_ANALYZE_BEGIN, _BEGIN)
        mtype, payload = pb._recv_msg(extra)
        assert mtype == pb.T_ERR and b"busy" in payload
        extra.close()
    finally:
        for s in holders:
            s.close()
    for _ in range(int(TIMEOUT / 0.01)):
        if slots._value == pb.MAX_CONCURRENT_ANALYSES:
            break
        threading.Event().wait(0.01)
    assert slots._value == pb.MAX_CONCURRENT_ANALYSES
    assert pb._analyze_slots is not jb._analyze_slots


def test_auto_pipeline_depth_equals_jax():
    for rtt, p99, rate, parsiz in ((1e-4, None, 48000, 256),
                                   (0.030, None, 48000, 256),
                                   (0.030, 0.2, 48000, 256),
                                   (5.0, None, 48000, 256),
                                   (0.030, 0.05, 96000, 512),
                                   (0.0, 0.0, 44100, 256)):
        assert pb.auto_pipeline_depth(rtt, rate, parsiz, rtt_p99_s=p99) == \
            jb.auto_pipeline_depth(rtt, rate, parsiz, rtt_p99_s=p99)
    assert pb.auto_pipeline_depth(1e-4, 48000, 256) == 3
    assert pb.auto_pipeline_depth(5.0, 48000, 256) == 64


def test_auto_pipeline_daemon_and_rtt_measurement(daemons):
    med, p99 = pb.measure_dispatch_rtt_stats(5, device="cpu")
    assert 0.0 < med <= p99
    port_sock, _ = daemons(pipeline=-1)
    cl = _client(pb, port_sock)
    assert 1792 + 256 <= cl.latency <= 1792 + 64 * 256
    cl.close()


def test_web_ui_lists_live_sessions_like_jax():
    """--ui-port: a session appears with its angles and live meters, the
    same as on the JAX daemon, and leaves with its client."""
    ports = _free_ports(2)
    socks = (_serve(pb, device="cpu", ui_port=ports[0]),
             _serve(jb, ui_port=ports[1]))
    rng = np.random.default_rng(28)
    x = (0.5 * rng.standard_normal((2, 2048))).astype(np.float32)
    states = []
    for sock, port in zip(socks, ports):
        url = f"http://127.0.0.1:{port}/state"
        cl = _client(pb, sock, channels=2)
        for _ in range(4):
            cl.process(x, [12.0, -7.5])
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            (_, s), = json.loads(r.read())["sessions"].items()
        states.append(s)
        cl.close()
    ps, js = states
    assert ps["device"] == "cpu"
    for key in ("channels", "rate", "link", "ui_scale", "angles"):
        assert ps[key] == js[key], key
    assert ps["angles"] == [12.0, -7.5]
    for pm, jm in zip(ps["meters"], js["meters"]):
        assert pm.keys() == jm.keys()
        np.testing.assert_allclose([pm[k] for k in pm], [jm[k] for k in pm],
                                   atol=1e-5)
    assert ps["meters"][0]["in_peak"] > 0.1
    # the session unregisters when its client leaves (the client thread
    # unwinds on its own: wait for that, bounded)
    gone = threading.Event()
    for _ in range(int(TIMEOUT / 0.01)):
        with urllib.request.urlopen(f"http://127.0.0.1:{ports[0]}/state",
                                    timeout=TIMEOUT) as r:
            if not json.loads(r.read())["sessions"]:
                break
        gone.wait(0.01)
    else:
        raise AssertionError("the session outlived its client")


def test_device_pool_and_refusal_without_a_card():
    pool = pb.DevicePool(4, device="cpu")
    assert pool.assign()[0] == "cpu" and pool.n == 1
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.DevicePool()
    path = os.path.join(tempfile.mkdtemp(prefix="prt"), "never.sock")
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.serve(path)
    assert not os.path.exists(path)  # refused before binding


class _Stop(Exception):
    pass


def _two_cards(monkeypatch):
    """Pretend the host has two cards; the daemon's auto-depth round trip
    records the device it is given and stops ``serve`` before it binds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    pools, rtt = [], []

    class Pool(pb.DevicePool):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pools.append(self)

    def stop(reps=40, device=None):
        rtt.append(pb.indexed_device(device))
        raise _Stop

    monkeypatch.setattr(pb, "DevicePool", Pool)
    monkeypatch.setattr(pb, "measure_dispatch_rtt_stats", stop)
    return pools, rtt


@pytest.mark.parametrize("n_devices,device,targets", [
    (1, "cuda:1", [1]), (0, "cuda:1", [1]), (4, torch.device("cuda", 1), [1]),
    (1, "cuda:0", [0]), (1, None, [0]), (0, "cuda", [0, 1]),
    (2, "cuda", [0, 1])])
def test_device_pool_starts_at_the_named_card(monkeypatch, n_devices,
                                              device, targets):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    pool = pb.DevicePool(n_devices, device=device)
    assert pool.targets == targets and pool.n == len(targets)
    assert [pool.assign()[0] for _ in range(3)] == (targets * 3)[:3]


def test_device_pool_refuses_a_card_the_host_lacks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="cuda:2 out of range"):
        pb.DevicePool(1, device="cuda:2")


def test_serve_on_a_named_card(monkeypatch):
    pools, rtt = _two_cards(monkeypatch)
    path = os.path.join(tempfile.mkdtemp(prefix="prt"), "never.sock")
    with pytest.raises(_Stop):
        pb.serve(path, pipeline=-1, device="cuda:1")
    assert pools[0].targets == [1] and pools[0].assign()[0] == 1
    assert rtt == [torch.device("cuda", 1)]
    assert not os.path.exists(path)


def test_main_serves_on_the_named_card(monkeypatch, capsys):
    pools, rtt = _two_cards(monkeypatch)
    path = os.path.join(tempfile.mkdtemp(prefix="prt"), "never.sock")
    with pytest.raises(_Stop):
        pb.main(["--socket", path, "--pipeline", "-1", "--device", "cuda:1"])
    assert pools[-1].targets == [1]
    assert rtt == [torch.device("cuda", 1)]
    capsys.readouterr()
    assert pb.main(["--socket", path, "--device", "cuda:2"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err == ["Error: device cuda:2 out of range (2 available)"]


def test_main_without_a_card_prints_one_error_line(capsys):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    path = os.path.join(tempfile.mkdtemp(prefix="prt"), "never.sock")
    assert pb.main(["--socket", path]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("Error: no CUDA device")


def test_module_daemon_subprocess_on_the_cpu(tmp_path):
    """python -m phaserotate_tpu_torch.bridge --device cpu serves a
    batched, pipelined session whose stream is the solo rotator's."""
    sock = os.path.join(tempfile.mkdtemp(prefix="prt"), "e.sock")
    r, w = os.pipe()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "phaserotate_tpu_torch.bridge", "--device",
         "cpu", "--socket", sock, "--ready-fd", str(w), "--pipeline", "2",
         "--batch-sessions", "2"],
        pass_fds=(w,), cwd=REPO, env=env, stderr=subprocess.PIPE)
    os.close(w)
    try:
        ready, _, _ = select.select([r], [], [], TIMEOUT)
        assert ready and os.read(r, 1) == b"R", "daemon failed to start"
        x = (0.4 * np.random.default_rng(29).standard_normal((2, 1024))
             ).astype(np.float32)
        cl = _client(pb, sock, channels=2)
        got = [cl.process(x, [20.0, 40.0]) for _ in range(4)]
        cl.close()
        rot = StreamingRotator(rate=RATE, channels=2, pipeline_depth=2,
                               device="cpu")
        want = [rot.process(x, [20.0, 40.0]) for _ in range(4)]
        np.testing.assert_allclose(np.concatenate(got, axis=1),
                                   np.concatenate(want, axis=1), atol=1e-5)
    finally:
        os.close(r)
        proc.terminate()
        _, err = proc.communicate(timeout=TIMEOUT)
    assert b"phaserotate_tpu_torch bridge: listening on" in err
    assert b"jax" not in err.lower()

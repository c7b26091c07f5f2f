"""The port's recorder (utils/profiling.py ``span`` / ``count``) and the
spans and counters the analysis path records with it.

Off, a span is one shared null context that records nothing and makes no
CUDA event; on (a ``recording()`` scope or a ``torch.profiler`` session)
it records name, thread, wall-clock ends and attributes into one bounded
buffer that ``drain()`` empties.  A CPU ``fleet.analyze_paths`` under each
transport records one ``fleet.decode`` per file, one ``fleet.stage``,
``fleet.pack``, ``fleet.stage_wait``, ``fleet.dispatch`` and
``fleet.readback`` per batch, ``packed.unpack`` per packed batch,
counters whose bytes equal what was shipped, ``fleet.decode_workers``
and ``fleet.decode_copied`` once per batch and ``packed.pack_workers``
once per host pack; on 24-bit
WAVs it records a ``pcm24`` ``fleet.pack`` and a
``pcm24.widen`` per batch and counts the payload in ``fleet.wire_bytes``.
At blksiz 32768 the Hilbert convolution records
``hilbert.one_partition``.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from phaserotate_tpu_torch import fleet
from phaserotate_tpu_torch.io import write_wav
from phaserotate_tpu_torch.search import minimize, packed, sweep
from phaserotate_tpu_torch.utils import profiling
from phaserotate_tpu_torch.utils.profiling import (RECORDS_MAX, CountRecord,
                                                   SpanRecord, count, drain,
                                                   recording, span)

torch.set_num_threads(1)

RATE = 48000
STAGING = ("fleet.stage", "fleet.decode", "fleet.pack")
LOOP = ("fleet.stage_wait", "fleet.dispatch", "fleet.readback")


@pytest.fixture(autouse=True)
def empty_buffer():
    drain()
    yield
    drain()


class _NoEvent:
    def __init__(self, *a, **k):
        raise AssertionError("a CUDA event was made")


def test_off_is_one_shared_null_context(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    first = span("a")
    assert span("b", device=True, x=1) is first
    with span("c", device=True) as s:
        s.set(transport="packed")
    count("n", 3)
    assert drain() == []


def test_torch_keeps_the_profiler_flag():
    """The off check reads torch's own flag; a torch without it must fail
    here, not stop recording quietly."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_recording_scope_records_spans_and_counts():
    with recording():
        with span("outer", kind="x") as s:
            with span("inner"):
                pass
            s.set(transport="pcm16")
        count("bytes", 7)
    got = drain()
    assert [type(r) for r in got] == [SpanRecord, SpanRecord, CountRecord]
    inner, outer, n = got
    me = threading.current_thread().name
    assert (inner.name, inner.thread, inner.attrs) == ("inner", me, {})
    assert (outer.name, outer.attrs) == ("outer",
                                         {"kind": "x", "transport": "pcm16"})
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    assert (n.name, n.n) == ("bytes", 7) and n.t_ns >= outer.t1_ns
    with span("after"):
        count("after", 1)
    assert drain() == []


def test_recording_scopes_nest_and_end():
    with recording():
        with recording():
            count("a", 1)
        count("b", 1)
    count("c", 1)
    assert [r.name for r in drain()] == ["a", "b"]


def test_a_profiler_session_records_and_names_the_spans(tmp_path):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with span("port.step"):
            torch.ones(8).sum()
        count("port.items", 2)
    assert [r.name for r in drain()] == ["port.step", "port.items"]
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "port.step" in names


def test_a_span_that_raises_is_recorded():
    with recording():
        with pytest.raises(KeyError):
            with span("fails"):
                raise KeyError("boom")
    (r,) = drain()
    assert r.name == "fails" and r.t0_ns <= r.t1_ns


class _FakeStream:
    def __init__(self, device):
        self.device = device


class _FakeEvent:
    """An event whose time is the order in which it was recorded."""

    made = []
    ticks = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        assert isinstance(stream, _FakeStream)
        _FakeEvent.ticks += 1
        self.t = _FakeEvent.ticks

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_spans_resolve_at_drain_with_one_synchronize(monkeypatch):
    """One synchronize per device that events were recorded on, and none
    before drain: a span on a second card (not the current one) resolves
    too."""
    syncs = []
    _FakeEvent.made, _FakeEvent.ticks = [], 0
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: _FakeStream(cards[0] if device is None
                                        else torch.device(device)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    with recording():
        with span("a", device=True):
            with span("b", device=cards[0]):
                pass
        with span("c", device="cuda:1"):
            pass
        with span("cpu", device=torch.device("cpu")):
            pass
        with span("none"):
            pass
    assert len(_FakeEvent.made) == 6 and syncs == []
    b, a, c, cpu, none = drain()
    assert sorted(syncs, key=str) == cards
    assert a.attrs == {"device_ms": 3.0} and b.attrs == {"device_ms": 1.0}
    assert c.attrs == {"device_ms": 1.0}
    assert cpu.attrs == {} and none.attrs == {}


def test_the_buffer_keeps_the_newest_records():
    assert profiling._records.maxlen == RECORDS_MAX == 1 << 20
    with recording():
        for i in range(RECORDS_MAX + 3):
            count("c", i)
    got = drain()
    assert len(got) == RECORDS_MAX
    assert got[0].n == 3 and got[-1].n == RECORDS_MAX + 2
    assert drain() == []


def test_search_select_once_per_call():
    tables = np.random.default_rng(1).random((3, 2, 720)).astype(np.float32)
    with recording():
        minimize.select_min_peak_angles_batch(tables)
        minimize.select_min_peak_angles(tables[0])
    got = drain()
    assert [r.name for r in got] == ["search.select"] * 2
    assert all(r.t0_ns <= r.t1_ns for r in got)


def test_hilbert_at_32768_records_one_partition(monkeypatch):
    """``hilbert_offline`` at blksiz 32768 records one
    ``hilbert.one_partition`` with ``rows``, ``n`` (input samples a row)
    and ``n_out`` (no device time on the CPU; on the card
    ``tests/test_torch_cuda.py``); 16384 records none; off, nothing is
    recorded and no CUDA event is made."""
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry

    x = torch.from_numpy(np.random.default_rng(32).uniform(
        -0.5, 0.5, (1, 2, 40000)).astype(np.float32))
    with recording():
        sweep.hilbert_offline(x, OfflineGeometry(32768))
        sweep.hilbert_offline(x, OfflineGeometry(16384))
    got = drain()
    assert [r.name for r in got] == ["hilbert.one_partition"]
    assert got[0].attrs == dict(rows=2, n=40000, n_out=3 * 32768)
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    sweep.hilbert_offline(x, OfflineGeometry(32768))
    assert drain() == []


def _catalogue(tmp_path):
    """Two tones (bucket of 16 blocks at blksiz 2048, they pack) and two
    noise files (bucket of 32 blocks, nearly full: auto ships them as
    pcm16)."""
    rng = np.random.default_rng(3)
    t = np.arange(20000) / RATE
    paths = []
    for i in range(2):
        p = str(tmp_path / f"tone{i}.wav")
        write_wav(p, (0.4 * np.sin(2 * np.pi * (100 + 37 * i) * t)
                      ).astype(np.float32), RATE, bits=16, float_format=False)
        paths.append(p)
    for i in range(2):
        p = str(tmp_path / f"noise{i}.wav")
        write_wav(p, rng.uniform(-0.9, 0.9, 65000).astype(np.float32), RATE,
                  bits=16, float_format=False)
        paths.append(p)
    return paths


@pytest.mark.parametrize("transport,batch", [
    pytest.param(t, b, id=t if b == 1 else f"{t}-batch{b}")
    for b in (1, 2) for t in ("auto", "packed", "pcm16")])
def test_fleet_records_its_batches(tmp_path, monkeypatch, transport, batch):
    shipped = []
    for mod, name, kind in ((packed, "sweep_peaks_aux_packed", "packed"),
                            (sweep, "sweep_peaks_aux_pcm16", "pcm16")):
        orig = getattr(mod, name)

        def logged(obj, *a, _orig=orig, _kind=kind, **k):
            shipped.append((_kind, obj.wire_bytes if _kind == "packed"
                            else obj.nbytes, 2 * int(np.prod(obj.shape))))
            return _orig(obj, *a, **k)

        monkeypatch.setattr(mod, name, logged)
    paths = _catalogue(tmp_path)
    with recording():
        fleet.analyze_paths(paths, batch=batch, blksiz=2048,
                            transport=transport, device="cpu")
    got = drain()
    spans = [r for r in got if isinstance(r, SpanRecord)]
    counts = [r for r in got if isinstance(r, CountRecord)]

    def named(name):
        return [r for r in spans if r.name == name]

    # each bucket holds two files: batches of two fill one batch a bucket
    batches = len(paths) // batch
    workers = fleet._decode_workers(batch)
    assert len(named("fleet.decode")) == len(paths)
    for name in STAGING + LOOP:
        if name != "fleet.decode":
            assert len(named(name)) == batches, name
    kinds = [r.attrs["transport"] for r in named("fleet.pack")]
    assert kinds == [k for k, _, _ in shipped]
    if transport == "auto":
        assert kinds == ["packed"] * (batches // 2) + ["pcm16"] * (
            batches // 2)
    else:
        assert kinds == [transport] * batches
    assert len(named("packed.unpack")) == kinds.count("packed")
    assert all("device_ms" not in r.attrs for r in named("packed.unpack"))
    assert len(named("search.select")) == batches
    main = threading.current_thread().name
    for r in spans:
        assert r.t0_ns <= r.t1_ns
        if r.name in STAGING:
            assert r.thread.startswith("fleet-stage"), r
        else:
            assert r.thread == main, r
    # a batch of several files decodes on the decode threads, one file
    # alone on the staging thread
    stage_threads = {r.thread for r in named("fleet.stage")}
    decode_threads = {r.thread for r in named("fleet.decode")}
    if workers > 1:
        assert all(t.startswith("fleet-stage-decode") for t in
                   decode_threads), decode_threads
    else:
        assert decode_threads == stage_threads

    def values(name):
        return [c.n for c in counts if c.name == name]

    assert values("fleet.decode_workers") == [workers] * batches
    # every file is a 16-bit PCM WAV: none takes the copied reader
    assert values("fleet.decode_copied") == [0] * batches
    assert values("fleet.wire_bytes") == [b for _, b, _ in shipped]
    assert values("fleet.pcm16_bytes") == [n for _, _, n in shipped]
    # each batch counts its decode threads, its copied files, its wire,
    # then its pcm16 bytes
    assert [c.name for c in counts if c.name.startswith("fleet.")] == [
        "fleet.decode_workers", "fleet.decode_copied", "fleet.wire_bytes",
        "fleet.pcm16_bytes"] * batches
    # every pack, shipped or not, counts its workers once
    assert len(values("packed.pack_workers")) == (
        0 if transport == "pcm16" else batches)


def test_fleet_records_its_24bit_batches(tmp_path, monkeypatch):
    """A 24-bit fleet: one ``fleet.decode`` per file, per batch a
    ``fleet.pack`` whose ``transport`` is pcm24 and a ``pcm24.widen`` with
    the samples it widened and the batch's files (``device_ms`` on a card
    only), ``fleet.decode_workers`` the threads that decoded the batch,
    ``fleet.decode_copied`` 0 and ``fleet.wire_bytes`` the staged
    payload's bytes; no pcm16 counter and
    no pack.  Off, the same call records nothing and makes no
    CUDA event."""
    rng = np.random.default_rng(24)
    paths = []
    for i, n in enumerate((20000, 21001, 50000)):
        x = rng.integers(-(1 << 23), 1 << 23, (2, n)) / float(1 << 23)
        p = str(tmp_path / f"hi{i}.wav")
        write_wav(p, x.astype(np.float32), RATE, bits=24, float_format=False)
        paths.append(p)
    staged = []
    orig = sweep.sweep_peaks_aux_pcm24

    def logged(buf, *a, **k):
        staged.append((buf.nbytes, buf.nbytes // 3, buf.shape[0]))
        return orig(buf, *a, **k)

    monkeypatch.setattr(sweep, "sweep_peaks_aux_pcm24", logged)
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    fleet.analyze_paths(paths, batch=2, blksiz=2048, device="cpu")
    assert drain() == [] and len(staged) == 2
    staged.clear()
    with recording():
        fleet.analyze_paths(paths, batch=2, blksiz=2048, device="cpu")
    got = drain()
    spans = [r for r in got if isinstance(r, SpanRecord)]

    def named(name):
        return [r for r in spans if r.name == name]

    assert len(named("fleet.decode")) == len(paths)
    assert all(r.thread.startswith("fleet-stage")
               for r in named("fleet.decode") + named("fleet.pack"))
    assert [r.attrs["transport"] for r in named("fleet.pack")] == [
        "pcm24"] * len(staged)
    widen = named("pcm24.widen")
    assert [(r.attrs["samples"], r.attrs["batch"]) for r in widen] == [
        (samples, files) for _, samples, files in staged]
    assert all("device_ms" not in r.attrs for r in widen)
    assert not named("packed.unpack")
    counts = [(r.name, r.n) for r in got if isinstance(r, CountRecord)]
    assert [files for _, _, files in staged] == [2, 1]
    assert counts == [c for nbytes, _, files in staged
                      for c in (("fleet.decode_workers",
                                 fleet._decode_workers(files)),
                                ("fleet.decode_copied", 0),
                                ("fleet.wire_bytes", nbytes))]


def test_fleet_profile_variable_traces_the_spans(tmp_path, monkeypatch,
                                                 capsys):
    """``PHASEROTATE_TPU_PROFILE=<dir>`` writes a Chrome trace naming the
    fleet's spans, those of the staging thread too, records the spans and
    counters, and changes nothing printed."""
    paths = _catalogue(tmp_path)[:2]
    argv = ["-f", "2048", "--transport", "packed"] + paths
    assert fleet.main(argv, device="cpu") == 0
    want = capsys.readouterr().out
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PHASEROTATE_TPU_PROFILE", str(trace_dir))
    assert fleet.main(argv, device="cpu") == 0
    assert capsys.readouterr().out == want
    (trace,) = os.listdir(trace_dir)
    with open(trace_dir / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(STAGING + LOOP + ("packed.unpack", "search.select")) <= names
    got = drain()
    assert [r.attrs["transport"] for r in got
            if r.name == "fleet.pack"] == ["packed"]
    assert [r.name for r in got if isinstance(r, CountRecord)] == [
        "fleet.decode_workers", "fleet.decode_copied", "packed.pack_workers",
        "fleet.wire_bytes", "fleet.pcm16_bytes"]


@pytest.mark.parametrize("workers", [None, 1, 3, "more"])
def test_a_pack_counts_its_workers_once(monkeypatch, workers):
    """Under ``recording()`` each host pack counts ``packed.pack_workers``
    once, with the workers it ran on (between 1 and its blocks; a forced
    count above the blocks is cut to them): ``pack_residual``, and
    ``pack_adaptive`` whether it packs or ships pcm16.  The numpy pack
    counts nothing; off, nothing is recorded."""
    from phaserotate_tpu_torch.search import _wirepack

    if workers is not None:
        monkeypatch.setattr(
            _wirepack, "workers_for",
            lambda blocks: blocks + 5 if workers == "more" else workers)
    rng = np.random.default_rng(3)
    noise = rng.integers(-32768, 32768, (2, 5 * packed.BLOCK + 7), np.int16)
    tone = np.rint(20000 * np.sin(np.arange(noise.shape[1]) / 300.0)
                   ).astype(np.int16)[None].repeat(2, 0)
    blocks = 2 * 6
    scratch = np.empty(noise.size, np.int32)
    with recording():
        packed.pack_residual(noise)
        assert packed.pack_adaptive(noise, scratch) is None
        assert packed.pack_adaptive(tone, scratch) is not None
        packed.pack_residual(noise, native=False)
    got = drain()
    assert [r.name for r in got] == ["packed.pack_workers"] * 3
    want = {None: _wirepack.workers_for(blocks), 1: 1, 3: 3,
            "more": blocks}[workers]
    assert 1 <= want <= blocks
    assert [r.n for r in got] == [want] * 3
    packed.pack_residual(noise)
    packed.pack_adaptive(tone, scratch)
    assert drain() == []


def test_device_trace_records_without_a_session_flag(tmp_path, monkeypatch):
    """``device_trace`` opens a recording scope of its own: counters record
    in it even where the profiler's flag reads off."""
    from torch.autograd import profiler as autograd_profiler

    with profiling.device_trace(str(tmp_path)):
        monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", False)
        count("inside", 1)
        monkeypatch.undo()
    count("outside", 1)
    assert [r.name for r in drain()] == ["inside"]

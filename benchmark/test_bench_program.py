"""The readers of the program's own spans and counters
(``harness/program.py``) on hand-built traces: each reads the records
inside the window and drops those outside it, the recorder is drained once
per trace, a program without the recorder gives nothing and raises
nothing, and every other reader reads the same with the program's records
present."""

import pytest

import bench_tiny  # noqa: F401  (puts the benchmark on the path)
from harness import program
from harness.spec import HELD, load_spec, metric_reader
from harness.trace import Trace

MS = 1_000_000
W0, W1 = 10_000 * MS, 20_000 * MS
NEW = {"stage_wait_ms_per_batch": 3.0, "unpack_ms_per_batch": 2.0,
       "wire_share_pct": 50.0, "select_ms_per_call": 2.0}


def _span(name, t0_ms, dur_ms, thread="MainThread", **attrs):
    t0 = W0 + int(t0_ms * MS)
    return (name, thread, t0, t0 + int(dur_ms * MS), attrs)


def _count(name, t_ms, n):
    return (name, W0 + int(t_ms * MS), n)


RECORDS = [
    _span("fleet.stage_wait", -5, 10),        # starts before the window
    _span("fleet.stage_wait", 100, 2),
    _span("fleet.stage_wait", 300, 4),
    _span("fleet.stage_wait", 9_999, 5),      # ends after it
    _span("packed.unpack", 110, 3, device_ms=1.5),
    _span("packed.unpack", 310, 3, device_ms=2.5),
    _span("packed.unpack", 500, 3),           # no device time (a CPU run)
    _span("packed.unpack", 20_000, 3, device_ms=100.0),
    _count("fleet.wire_bytes", 100, 40),
    _count("fleet.pcm16_bytes", 100, 100),
    _count("fleet.wire_bytes", 300, 60),
    _count("fleet.pcm16_bytes", 300, 100),
    _count("fleet.wire_bytes", -1, 1_000),
    _count("fleet.pcm16_bytes", 10_001, 1_000),
    _span("search.select", 200, 1),
    _span("search.select", 400, 3),
    _span("search.select", -2, 1),
    # the program's spans beside the harness's own names
    _span("fleet.decode", 50, 7, thread="fleet-stage_0"),
    _span("fleet.pack", 60, 70, thread="fleet-stage_0", transport="packed"),
    _span("fleet.dispatch", 105, 9),
]


def _trace():
    """A window with harness spans, kernel calls, device intervals and
    counters as the traced drivers record them."""
    return Trace(
        spans=[("decode", W0 + 50 * MS, W0 + 57 * MS),
               ("pack", W0 + 60 * MS, W0 + 130 * MS),
               ("select", W0 + 200 * MS, W0 + 201 * MS),
               ("broker_step", W0 + 600 * MS, W0 + 602 * MS),
               ("sweep", W0 + 140 * MS, W0 + 141 * MS)],
        calls=[dict(kind="sweep", rows=16, n=1 << 22, bound_ms=2.0,
                    event_ms=5.0),
               dict(kind="hilbert", rows=16, n=1 << 22, bound_ms=1.0,
                    event_ms=9.0)],
        device=[("void sweep_kernel<9>(...)", W0 + 140 * MS, W0 + 145 * MS),
                ("stream_runs", W0 + 150 * MS, W0 + 158 * MS),
                ("Memcpy HtoD", W0 + 100 * MS, W0 + 104 * MS)],
        window=(W0, W1),
        counters={"frames_served": 60, "dispatches": 10})


@pytest.fixture
def drained(monkeypatch):
    """The recorder replaced by RECORDS; counts the drains."""
    calls = []

    def fake():
        calls.append(1)
        return list(RECORDS)

    monkeypatch.setattr(program, "_drain", fake)
    return calls


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_keeps_the_window(name, drained):
    assert metric_reader(name)(_trace()) == pytest.approx(NEW[name])


def test_drained_once_per_trace(drained):
    trace = _trace()
    for name in NEW:
        metric_reader(name)(trace)
    assert len(drained) == 1
    assert "program_records" not in trace.to_json()
    metric_reader("select_ms_per_call")(_trace())
    assert len(drained) == 2


def test_no_window_reads_nothing(drained):
    trace = _trace()
    trace.window = None
    for name in NEW:
        assert metric_reader(name)(trace) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    from phaserotate_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "drain")
    for name in NEW:
        assert metric_reader(name)(_trace()) is None


def test_reads_the_port_recorder():
    import time

    from phaserotate_tpu_torch.utils.profiling import (count, drain,
                                                       recording, span)

    drain()
    with recording():
        count("fleet.wire_bytes", 5)          # before the window
        t0 = time.time_ns()
        with span("fleet.stage_wait"):
            time.sleep(0.002)
        with span("search.select"):
            pass
        count("fleet.wire_bytes", 30)
        count("fleet.pcm16_bytes", 120)
        t1 = time.time_ns()
        count("fleet.pcm16_bytes", 1)         # after it
    trace = Trace(window=(t0, t1))
    assert metric_reader("stage_wait_ms_per_batch")(trace) >= 2.0
    assert metric_reader("select_ms_per_call")(trace) >= 0.0
    assert metric_reader("wire_share_pct")(trace) == 25.0
    assert metric_reader("unpack_ms_per_batch")(trace) is None
    assert drain() == []


EXISTING = sorted({m["name"] for spec in (load_spec(), load_spec(path=HELD))
                   for m in spec["per_layer"]} - set(NEW))


@pytest.mark.parametrize("name", EXISTING)
def test_other_readers_read_the_same(name, monkeypatch):
    monkeypatch.setattr(program, "_drain", lambda: [])
    alone = metric_reader(name)(_trace())
    assert alone is not None
    monkeypatch.setattr(program, "_drain", lambda: list(RECORDS))
    beside = _trace()
    for new in NEW:
        metric_reader(new)(beside)
    assert metric_reader(name)(beside) == alone

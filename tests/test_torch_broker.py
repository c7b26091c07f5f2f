"""The port's cross-session broker (phaserotate_tpu_torch/stream/broker.py)
against the JAX package's and against the port's dedicated pipelined
engine, on the CPU.

Besides the parity, it pins what ``tests/test_broker.py`` pins for the JAX
broker: coalescing, the slot lifecycle, reset, the generation check on a
close and reopen during an in-flight dispatch, and the failure path that
releases stranded submitters.  Where those tests hold a dispatch with a
sleep, these hold it on an event and wait for the broker's own state, so
no ordering rests on timing.
"""

import threading

import numpy as np
import pytest
import torch

from phaserotate_tpu.core.sizes import stream_geometry_for_rate as j_geom
from phaserotate_tpu.stream.broker import StreamBroker as JBroker
from phaserotate_tpu_torch.core.sizes import stream_geometry_for_rate
from phaserotate_tpu_torch.hostapp import StandaloneHost
from phaserotate_tpu_torch.stream import StreamingRotator
from phaserotate_tpu_torch.stream import broker as broker_mod
from phaserotate_tpu_torch.stream.broker import StreamBroker
from phaserotate_tpu_torch.stream.engine import init_state

torch.set_num_threads(1)

RATE = 48000
GEOM = stream_geometry_for_rate(RATE)
PARSIZ = GEOM.parsiz
DEPTH = 3
WAIT = 30.0  # seconds any wait here may take before the test fails


def _broker(channels=1, capacity=4, depth=DEPTH, **kw):
    return StreamBroker(GEOM, channels, capacity=capacity, depth=depth,
                        device="cpu", **kw)


def _stream(broker, slot, x, degs):
    out = np.empty_like(x)
    for j in range(x.shape[1] // PARSIZ):
        sl = slice(j * PARSIZ, (j + 1) * PARSIZ)
        out[:, sl] = broker.submit(slot, x[:, sl], degs)
    return out


def _wait_pending(broker, n):
    with broker._cv:
        assert broker._cv.wait_for(lambda: len(broker._pending) >= n,
                                   timeout=WAIT), "frames never queued"


@pytest.mark.parametrize("channels", [1, 2])
def test_broker_matches_jax_broker(channels):
    """One slot, changing targets: the port's broker and the JAX broker
    emit the same stream within 1e-5."""
    rng = np.random.default_rng(41 + channels)
    n_frames = DEPTH + 9
    x = (0.5 * rng.standard_normal((channels, n_frames * PARSIZ))
         ).astype(np.float32)
    jb = JBroker(j_geom(RATE), channels, capacity=2, depth=DEPTH)
    pb = _broker(channels, capacity=2)
    js, ps = jb.open(), pb.open()
    for j in range(n_frames):
        degs = np.full(channels, [0.0, 35.0, -170.0, 170.0][j % 4],
                       np.float32)
        sl = slice(j * PARSIZ, (j + 1) * PARSIZ)
        np.testing.assert_allclose(pb.submit(ps, x[:, sl], degs),
                                   jb.submit(js, x[:, sl], degs),
                                   atol=1e-5, err_msg=f"frame {j}")
    assert pb.dispatches == jb.dispatches == n_frames


def test_broker_matches_dedicated_pipelined():
    """One slot through the broker is StreamingRotator with the same
    pipeline depth, one frame earlier (the rotator emits cur_out)."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((1, (DEPTH + 6) * PARSIZ)).astype(np.float32)
    rot = StreamingRotator(rate=RATE, channels=1, pipeline_depth=DEPTH,
                           device="cpu")
    want = rot.process(x, 35.0)
    b = _broker(capacity=4)
    got = _stream(b, b.open(), x, np.array([35.0], np.float32))
    np.testing.assert_allclose(got[:, :-PARSIZ], want[:, PARSIZ:],
                               atol=1e-5)


def test_concurrent_sessions_match_solo():
    """N sessions submitting from N threads each get the stream a solo
    session gets (coalescing must not mix slots)."""
    rng = np.random.default_rng(32)
    n_sessions, n_frames = 4, DEPTH + 5
    xs = [rng.standard_normal((1, n_frames * PARSIZ)).astype(np.float32)
          for _ in range(n_sessions)]
    degs = [np.array([10.0 * (s + 1)], np.float32)
            for s in range(n_sessions)]
    refs = []
    for s in range(n_sessions):
        solo = _broker(capacity=1)
        refs.append(_stream(solo, solo.open(), xs[s], degs[s]))
    b = _broker(capacity=n_sessions)
    slots = [b.open() for _ in range(n_sessions)]
    outs, errors = [None] * n_sessions, []

    def worker(s):
        try:
            outs[s] = _stream(b, slots[s], xs[s], degs[s])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,))
               for s in range(n_sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not errors and not any(t.is_alive() for t in threads)
    for s in range(n_sessions):
        np.testing.assert_allclose(outs[s], refs[s], atol=1e-5)
    assert b.frames_served == n_sessions * n_frames


def test_coalesces_frames_queued_behind_a_dispatch(monkeypatch):
    """Frames that arrive while a dispatch is in flight ride the next
    dispatch together: the first dispatch is held until the other two
    sessions' frames are queued."""
    real_step = broker_mod._slot_step
    entered, release = threading.Event(), threading.Event()

    def held_step(*args, **kwargs):
        if not entered.is_set():
            entered.set()
            assert release.wait(WAIT)
        return real_step(*args, **kwargs)

    monkeypatch.setattr(broker_mod, "_slot_step", held_step)
    b = _broker(capacity=3, depth=1, hold_frac=0.0)
    a, s1, s2 = b.open(), b.open(), b.open()
    x = np.ones((1, PARSIZ), np.float32)
    degs = np.array([10.0], np.float32)
    first = threading.Thread(target=b.submit, args=(a, x, degs))
    first.start()
    assert entered.wait(WAIT)
    others = [threading.Thread(target=b.submit, args=(k, x, degs))
              for k in (s1, s2)]
    for t in others:
        t.start()
    _wait_pending(b, 2)
    release.set()
    for t in [first] + others:
        t.join(WAIT)
    assert (b.dispatches, b.frames_served) == (2, 3)


def test_slot_lifecycle_and_unopened_submit():
    b = _broker(capacity=2, depth=1)
    a, c = b.open(), b.open()
    assert b.in_use() == 2
    with pytest.raises(RuntimeError, match="full"):
        b.open()
    b.close(a)
    assert b.open() == a  # a freed slot is reused
    x = np.zeros((1, PARSIZ), np.float32)
    degs = np.zeros(1, np.float32)
    b.close(c)
    with pytest.raises(RuntimeError, match="unopened"):
        b.submit(c, x, degs)
    b.close(a)
    assert b.in_use() == 0
    with pytest.raises(RuntimeError, match="unopened"):
        b.submit(0, x, degs)


def test_reset_gives_a_fresh_slot():
    rng = np.random.default_rng(33)
    b = _broker(capacity=2, depth=1)
    slot = b.open()
    x = rng.standard_normal((1, PARSIZ)).astype(np.float32)
    degs = np.array([25.0], np.float32)
    first = [b.submit(slot, x, degs).copy() for _ in range(4)]
    b.reset(slot)
    again = [b.submit(slot, x, degs).copy() for _ in range(4)]
    for u, v in zip(first, again):
        np.testing.assert_array_equal(u, v)


def test_slot_step_masks():
    """The step's masks: a reset slot starts from zero state, an inactive
    slot keeps its state and returns zeros, and with every slot active and
    none reset the step is the engine's own stream_step."""
    rng = np.random.default_rng(34)
    state = init_state(GEOM, (3, 2), "cpu")
    for f in ("spec_hist", "time_hist", "tail", "angle"):
        t = getattr(state, f)
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype))
    frames = torch.from_numpy(
        rng.standard_normal((3, 2, PARSIZ)).astype(np.float32))
    targets = torch.tensor([[10.0, 20.0], [30.0, 40.0], [50.0, 60.0]])
    active = torch.tensor([True, False, True])
    reset = torch.tensor([False, False, True])
    new, y = broker_mod._slot_step(state, frames, targets, active, reset,
                                   GEOM)
    assert torch.equal(y[1], torch.zeros_like(y[1]))
    for f in ("spec_hist", "time_hist", "tail", "angle"):
        assert torch.equal(getattr(new, f)[1], getattr(state, f)[1]), f
    fresh = init_state(GEOM, (2,), "cpu")
    _, solo_y = broker_mod.stream_step(fresh, frames[2], targets[2], GEOM)
    assert torch.equal(y[2], solo_y)
    everyone = torch.ones(3, dtype=torch.bool)
    nobody = torch.zeros(3, dtype=torch.bool)
    masked = broker_mod._slot_step(state, frames, targets, everyone, nobody,
                                   GEOM)
    plain = broker_mod.stream_step(state, frames, targets, GEOM)
    assert torch.equal(masked[1], plain[1])
    assert all(torch.equal(getattr(masked[0], f), getattr(plain[0], f))
               for f in ("spec_hist", "time_hist", "tail", "angle"))


def test_packed_operands_round_trip():
    """A dispatch's operands ride one packed array: frames, targets, then
    the two masks as 0/1."""
    k, c = 3, 2
    frames = np.arange(k * c * PARSIZ, dtype=np.float32)
    targets = np.array([1.5, -2.0, 3.0, 4.0, 5.0, -6.5], np.float32)
    packed = np.concatenate([frames, targets, [1, 0, 1], [0, 0, 1]]).astype(
        np.float32)
    f, t, a, r = broker_mod._operands(torch.from_numpy(packed), k, c, PARSIZ)
    assert torch.equal(f.reshape(-1), torch.from_numpy(frames))
    assert torch.equal(t, torch.from_numpy(targets).view(k, c))
    assert a.tolist() == [True, False, True]
    assert r.tolist() == [False, False, True]


def test_plugin_on_broker_matches_pipelined_plugin():
    """A plugin bound to a broker slot produces the stream of a dedicated
    instance with option {'pipeline': depth}, at the same latency, and
    gives its slot back on cleanup."""
    rng = np.random.default_rng(35)
    n = 4 * PARSIZ
    x = rng.standard_normal((2, n)).astype(np.float32)
    ded = StandaloneHost(RATE, 2, block=n, pipeline=DEPTH, device="cpu")
    ded.set_angles(30.0)
    want = ded.process(x)
    b = _broker(channels=2, capacity=2)
    bat = StandaloneHost(RATE, 2, block=n, broker=b)
    assert bat.plugin.device == b.device
    bat.set_angles(30.0)
    np.testing.assert_allclose(bat.process(x), want, atol=1e-5)
    assert bat.plugin.latency == ded.plugin.latency
    bat.plugin.cleanup()
    assert b.in_use() == 0
    with pytest.raises(ValueError, match="geometry/channels"):
        StandaloneHost(RATE, 1, broker=b)


def test_close_reopen_during_inflight_dispatch_no_stale_output(monkeypatch):
    """A slot closed and reopened while its dispatch is on the device must
    not receive the dead session's output (the new stream would shift by
    one frame)."""
    real_step = broker_mod._slot_step
    entered, release = threading.Event(), threading.Event()

    def held_step(*args, **kwargs):
        entered.set()
        assert release.wait(WAIT)
        return real_step(*args, **kwargs)

    monkeypatch.setattr(broker_mod, "_slot_step", held_step)
    rng = np.random.default_rng(36)
    b = _broker(capacity=1, depth=1)
    degs = np.array([10.0], np.float32)
    slot_a = b.open()
    t = threading.Thread(target=b.submit, args=(
        slot_a, rng.standard_normal((1, PARSIZ)).astype(np.float32), degs))
    t.start()
    assert entered.wait(WAIT)  # A's frame is in the device step
    b.close(slot_a)
    slot_b = b.open()
    assert slot_b == slot_a
    release.set()
    t.join(WAIT)
    monkeypatch.setattr(broker_mod, "_slot_step", real_step)
    xb = [rng.standard_normal((1, PARSIZ)).astype(np.float32)
          for _ in range(4)]
    got = [b.submit(slot_b, f, degs) for f in xb]
    ref = _broker(capacity=1, depth=1)
    k = ref.open()
    for g, f in zip(got, xb):
        np.testing.assert_array_equal(g, ref.submit(k, f, degs))


def test_dispatch_failure_releases_queued_submitters(monkeypatch):
    """A failed dispatch releases its own waiters and the frames that
    queued while it was in flight, surfaces the error to the dispatcher,
    and leaves the broker usable."""
    entered, release = threading.Event(), threading.Event()

    def failing_step(*args, **kwargs):
        entered.set()
        assert release.wait(WAIT)
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(broker_mod, "_slot_step", failing_step)
    b = _broker(capacity=2, depth=1, hold_frac=0.0)
    a, c = b.open(), b.open()
    x = np.ones((1, PARSIZ), np.float32)
    degs = np.array([10.0], np.float32)
    results, errors = {}, {}

    def run(tag, slot):
        try:
            results[tag] = b.submit(slot, x, degs)
        except RuntimeError as e:
            errors[tag] = e

    ta = threading.Thread(target=run, args=("a", a))
    ta.start()
    assert entered.wait(WAIT)  # A is the dispatcher, held in the step
    tc = threading.Thread(target=run, args=("c", c))
    tc.start()
    _wait_pending(b, 1)  # C's frame queued behind the failing dispatch
    release.set()
    ta.join(WAIT)
    tc.join(WAIT)
    assert not ta.is_alive() and not tc.is_alive()
    assert "a" in errors
    np.testing.assert_array_equal(results["c"], 0.0)
    b.close(a)
    b.close(c)
    assert b.in_use() == 0


def test_broker_device_default_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamBroker(GEOM, 1)

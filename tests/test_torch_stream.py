"""The port's streaming engine, host shell and stream checkpoint against
the JAX package's, on the same numpy-seeded inputs."""

import numpy as np
import pytest
import torch

from phaserotate_tpu.core.angles import degrees_to_turns as j_turns
from phaserotate_tpu.core.sizes import stream_geometry_for_rate as j_geom_for
from phaserotate_tpu.kernels import stream_conv as j_sc
from phaserotate_tpu.stream import StreamingRotator as JRotator
from phaserotate_tpu.stream import engine as je
from phaserotate_tpu.stream import load_stream_state as j_load
from phaserotate_tpu.stream import save_stream_state as j_save
from phaserotate_tpu_torch.core.sizes import stream_geometry_for_rate
from phaserotate_tpu_torch.kernels import stream_conv as p_sc
from phaserotate_tpu_torch.stream import StreamingRotator
from phaserotate_tpu_torch.stream import engine as pe
from phaserotate_tpu_torch.stream import load_stream_state, save_stream_state

torch.set_num_threads(1)

RATES = [48000, 96000, 192000]


def _targets(n_frames):
    """Changing targets: steady, a wrap-around swing, small steps."""
    t = np.zeros(n_frames, np.float32)
    t[n_frames // 5:] = 90.0
    t[2 * n_frames // 5:] = -170.0
    t[3 * n_frames // 5:] = 170.0
    t[4 * n_frames // 5:] = -33.0
    return t


def _frames(rng, n_frames, parsiz, lead=()):
    return (0.5 * rng.standard_normal(
        (*lead, n_frames, parsiz))).astype(np.float32)


def _state_np(state):
    from phaserotate_tpu_torch.core.convert import stream_state_to_jax

    return stream_state_to_jax(state)


def _assert_state_close(pstate, jstate, atol=1e-5):
    p = _state_np(pstate)
    for f in ("spec_hist", "time_hist", "tail", "angle"):
        np.testing.assert_allclose(p[f], np.asarray(getattr(jstate, f)),
                                   atol=atol * (100 if f == "spec_hist"
                                                else 1), err_msg=f)


@pytest.mark.parametrize("rate", RATES)
def test_stream_process_matches_jax(rng, rate):
    geom = stream_geometry_for_rate(rate)
    frames = _frames(rng, 30, geom.parsiz)
    targets = _targets(30)
    js, jy = je.stream_process(je.init_state(j_geom_for(rate)), frames,
                               targets, j_geom_for(rate))
    ps, py = pe.stream_process(pe.init_state(geom), torch.from_numpy(frames),
                               targets, geom)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5)
    _assert_state_close(ps, js)


def test_stream_step_batched_matches_jax(rng):
    geom = stream_geometry_for_rate(48000)
    jg = j_geom_for(48000)
    js = je.init_state(jg, (2,))
    ps = pe.init_state(geom, (2,))
    for i, degs in enumerate(([0.0, 0.0], [35.0, -90.0], [35.0, -90.0],
                              [180.0, 10.0], [180.0, 10.0])):
        frame = _frames(rng, 2, geom.parsiz)
        tgt = np.asarray(degs, np.float32)
        js, jy = je.stream_step_batched(js, frame, tgt, jg)
        ps, py = pe.stream_step_batched(ps, torch.from_numpy(frame),
                                        torch.from_numpy(tgt), geom)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5)
    _assert_state_close(ps, js)


@pytest.mark.parametrize("rate", RATES)
def test_stream_process_bulk_matches_jax_and_loop(rng, rate):
    geom = stream_geometry_for_rate(rate)
    jg = j_geom_for(rate)
    frames = _frames(rng, 40, geom.parsiz)
    targets = _targets(40)
    js, jy = je.stream_process_bulk(je.init_state(jg), frames, targets, jg)
    ps, py = pe.stream_process_bulk(pe.init_state(geom),
                                    torch.from_numpy(frames), targets, geom)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5)
    _assert_state_close(ps, js)
    ls, ly = pe.stream_process(pe.init_state(geom), torch.from_numpy(frames),
                               targets, geom)
    np.testing.assert_allclose(py.numpy(), ly.numpy(), atol=2e-6)
    torch.testing.assert_close(ps.time_hist, ls.time_hist, rtol=0, atol=0)
    assert ps.angle.item() == ls.angle.item()
    # split continuation: two bulk calls equal one
    s1, o1 = pe.stream_process_bulk(pe.init_state(geom),
                                    torch.from_numpy(frames[:17]),
                                    targets[:17], geom)
    _, o2 = pe.stream_process_bulk(s1, torch.from_numpy(frames[17:]),
                                   targets[17:], geom)
    torch.testing.assert_close(torch.cat([o1, o2]), py, rtol=0, atol=0)


@pytest.mark.parametrize("rate", RATES)
def test_angle_sequence_matches_jax(rate):
    geom = stream_geometry_for_rate(rate)
    jg = j_geom_for(rate)
    targets = np.concatenate([_targets(60), np.full(5, 179.5, np.float32),
                              np.full(5, -179.5, np.float32)])
    ja, jd, ji, jf = je.angle_sequence(np.float32(0.0), targets, jg)
    pa, pd, pi, pf = pe.angle_sequence(np.float32(0.0), targets, geom)
    np.testing.assert_allclose(pa, np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(pd, np.asarray(jd), atol=1e-9)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    assert abs(float(pf) - float(jf)) < 1e-6


def test_host_angle_step_bit_equal_jax():
    geom = stream_geometry_for_rate(48000)
    jg = j_geom_for(48000)
    plan = ([0.0] + [179.5] * 3 + [-179.5] * 3 + [10.0] * 40
            + [10.0001] * 3 + [-170.0] * 40)
    pa = ja = np.zeros(2, np.float32)
    for deg in plan:
        tgt = np.asarray(j_turns(np.full(2, deg, np.float32)))
        ja = je.host_angle_step(ja, tgt, jg)
        pa = pe.host_angle_step(pa, tgt, geom)
        np.testing.assert_array_equal(pa, ja)


def test_device_step_angle_equals_host_recursion(rng):
    """The torch angle step and the numpy recursion agree bit for bit."""
    geom = stream_geometry_for_rate(48000)
    targets = _targets(50)
    angles, _, _, final = pe.angle_sequence(np.float32(0.0), targets, geom)
    state = pe.init_state(geom)
    zero = torch.zeros(geom.parsiz)
    for i, t in enumerate(targets):
        assert state.angle.item() == angles[i], i
        state, _ = pe.stream_step(state, zero, t, geom)
    assert state.angle.item() == final


@pytest.mark.parametrize("rate", RATES)
def test_rotate_streamed_matches_jax(rng, rate):
    geom = stream_geometry_for_rate(rate)
    x = (0.5 * rng.standard_normal(4 * geom.latency + 77)).astype(np.float32)
    want = np.asarray(je.rotate_streamed(x, -70.0, geom=j_geom_for(rate)))
    got = pe.rotate_streamed(torch.from_numpy(x), -70.0, geom=geom)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    raw = pe.rotate_streamed(torch.from_numpy(x), -70.0, geom=geom,
                             trim_latency=False, chunk_frames=5)
    assert raw.shape == (x.shape[0] + geom.latency,)
    assert torch.all(raw[: geom.parsiz] == 0)
    torch.testing.assert_close(raw[geom.latency:], got, rtol=0, atol=0)


def test_fused_stream_mix_plain_matches_jax_kernel(rng):
    geom = stream_geometry_for_rate(48000)
    targets = np.repeat([0.0, 35.0, -150.0, 120.0], 10).astype(np.float32)
    angles, das, _, _ = pe.angle_sequence(np.float32(0.0), targets, geom)
    params = pe._internal_angle_params(angles, das, geom)[None]
    frames = _frames(rng, params.shape[1], p_sc.P, (1,))
    want = np.asarray(j_sc.fused_stream_mix(frames, params, geom.firlen,
                                            t_blocks=16))
    got = p_sc.fused_stream_mix(torch.from_numpy(frames),
                                torch.from_numpy(params), geom.firlen)
    assert got.shape == want.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("rate", RATES)
def test_rotate_streamed_fused_path_equals_bulk(rng, rate):
    """The CUDA path of rotate_streamed (the stream_mix kernel's plain twin
    here), chunked with its prelude, equals the bulk engine."""
    geom = stream_geometry_for_rate(rate)
    x = (0.5 * rng.standard_normal(9 * geom.parsiz + 100)).astype(np.float32)
    n = x.shape[0]
    pad_frames = -(-(n + geom.latency) // geom.parsiz)
    frames = torch.nn.functional.pad(
        torch.from_numpy(x), (0, pad_frames * geom.parsiz - n)).reshape(
        pad_frames, geom.parsiz)
    targets = np.where(np.arange(pad_frames) < 4, 0.0, 70.0).astype(
        np.float32)
    whole = pe._rotate_streamed_fused(frames, targets, geom, 1 << 14)
    chunked = pe._rotate_streamed_fused(frames, targets, geom, 3)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    _, bulk = pe.stream_process_bulk(pe.init_state(geom), frames, targets,
                                     geom)
    np.testing.assert_allclose(whole.numpy(), bulk.reshape(-1).numpy(),
                               atol=1e-5)


def _push(rot, x, block, deg):
    outs = []
    for i in range(0, x.shape[-1], block):
        outs.append(rot.process(x[..., i : i + block], deg))
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("block", [1, 64, 333, 256, 4096])
def test_streaming_rotator_matches_jax_any_block(rng, block):
    geom = stream_geometry_for_rate(48000)
    x = (0.5 * rng.standard_normal((2, 8192 if block > 1 else 2600))
         ).astype(np.float32)
    want = _push(JRotator(rate=48000, channels=2), x, block, [77.0, -20.0])
    got = _push(StreamingRotator(rate=48000, channels=2, device="cpu"), x,
                block, [77.0, -20.0])
    np.testing.assert_allclose(got, want, atol=1e-5)
    # block-size independence within the port: one host block
    whole = StreamingRotator(geom=geom, channels=2, device="cpu").process(
        x, [77.0, -20.0])
    np.testing.assert_array_equal(got, whole)


def test_streaming_rotator_mono_and_latency(rng):
    x = rng.standard_normal(6000).astype(np.float32)
    rot = StreamingRotator(rate=48000, device="cpu")
    y = rot.process(x, 0.0)
    lat = rot.latency
    assert y.shape == x.shape and lat == 256 + 1536
    np.testing.assert_allclose(y[lat:], x[: len(x) - lat], atol=1e-6)
    np.testing.assert_array_equal(y[:lat], 0.0)
    with pytest.raises(ValueError, match="channels"):
        rot.process(np.zeros((2, 10), np.float32), 0.0)


@pytest.mark.parametrize("depth", [1, 4])
def test_pipelined_rotator_is_exact_delay(rng, depth):
    geom = stream_geometry_for_rate(48000)
    x = (rng.standard_normal((depth + 24) * geom.parsiz + 37)
         * 0.5).astype(np.float32)
    sizes = [64, 700, 3 * geom.parsiz, 129, 2048]

    def run(rot):
        outs, pos, bi = [], 0, 0
        while pos < len(x):
            n = min(sizes[bi % len(sizes)], len(x) - pos)
            bi += 1
            outs.append(rot.process(x[pos : pos + n],
                                    35.0 if pos < 5000 else -60.0))
            pos += n
        return np.concatenate(outs)

    base = StreamingRotator(geom=geom, device="cpu")
    piped = StreamingRotator(geom=geom, pipeline_depth=depth, device="cpu")
    d = depth * geom.parsiz
    assert piped.latency == base.latency + d
    y0, y1 = run(base), run(piped)
    np.testing.assert_array_equal(y1[:d], 0.0)
    np.testing.assert_array_equal(y1[d:], y0[: len(y0) - d])


def test_checkpoint_jax_to_port(rng, tmp_path):
    """A JAX-saved stream continues in the port within 1e-5 of JAX
    continuing it."""
    geom = stream_geometry_for_rate(48000)
    jg = j_geom_for(48000)
    frames = _frames(rng, 30, geom.parsiz, (2,))
    tgt = np.asarray([42.0, -100.0], np.float32)
    js, _ = je.stream_process_batched(je.init_state(jg, (2,)), frames[:, :15],
                                      tgt, jg)
    path = str(tmp_path / "j.npz")
    j_save(path, js, jg, host={"offset": np.int64(3)})
    ps, pgeom, host = load_stream_state(path)
    assert pgeom == geom and int(host["offset"]) == 3
    assert ps.spec_hist.dtype == torch.complex64
    _, jy = je.stream_process_batched(js, frames[:, 15:], tgt, jg)
    _, py = pe.stream_process_batched(ps, torch.from_numpy(frames[:, 15:]),
                                      torch.from_numpy(tgt), geom)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5)


def test_checkpoint_port_to_jax(rng, tmp_path):
    geom = stream_geometry_for_rate(96000)
    jg = j_geom_for(96000)
    frames = _frames(rng, 20, geom.parsiz)
    targets = _targets(20)
    ps, _ = pe.stream_process(pe.init_state(geom),
                              torch.from_numpy(frames[:9]), targets[:9], geom)
    path = str(tmp_path / "p.npz")
    save_stream_state(path, ps, geom)
    js, jgeom, host = j_load(path)
    assert jgeom == jg and host == {}
    assert np.asarray(js.spec_hist).shape == (geom.n_segm, geom.parsiz + 1, 2)
    _, jy = je.stream_process(js, frames[9:], targets[9:], jg)
    _, py = pe.stream_process(ps, torch.from_numpy(frames[9:]), targets[9:],
                              geom)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5)
    # and the port reloads its own file bit for bit
    ps2, _, _ = load_stream_state(path)
    for f in ("spec_hist", "time_hist", "tail", "angle"):
        assert torch.equal(getattr(ps2, f), getattr(ps, f)), f

"""The fleet's exact 24-bit path on the CPU.

A 24-bit integer PCM WAV is read exactly (``io/pcm24.py``: the chunk
headers walked, the data payload read into the batch buffer as the file
holds it), shipped as those bytes (the ``pcm24`` wire) and widened to
``int / 2^23`` (``kernels/pcm24.py``'s plain twin here), which float32
holds exactly.  So the fleet's tables are bit-equal to the float path on
``read_audio``'s samples, agree with the benchmark's float64 reference
(``benchmark/reference/offline.py``), and keep a peak that differs from
its neighbour in the low byte alone, which a read rounded to 16 bits
loses.  16-bit files keep their own buckets and path; the 16-bit
transports refuse 24-bit files before anything is decoded.
"""

import importlib
import importlib.util
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phaserotate_tpu import fleet as j_fleet
from phaserotate_tpu_torch import fleet
from phaserotate_tpu_torch.core.sizes import offline_geometry
from phaserotate_tpu_torch.io import (WavFormatError, read_audio,
                                      read_audio_pcm16, write_flac,
                                      write_wav)
from phaserotate_tpu_torch.io.audio import probe_audio
from phaserotate_tpu_torch.io.pcm24 import (is_pcm24, read_header,
                                            read_pcm24_into)
from phaserotate_tpu_torch.kernels.pcm24 import (pcm24_widen,
                                                 pcm24_widen_plain)
from phaserotate_tpu_torch.search import (find_min_peak_angle, packed,
                                          sweep, sweep_peaks_aux)

torch.set_num_threads(1)

FULL = 1 << 23
REPO = Path(__file__).resolve().parents[1]


def _music(rng, channels, n, rate, peak):
    """(channels, n) int32 on the 24-bit grid: two partials and a little
    noise, scaled so the loudest sample is ``peak``."""
    t = np.arange(n) / rate
    x = np.stack([
        0.6 * np.sin(2 * np.pi * rng.uniform(150, 900) * t
                     + rng.uniform(0, 6))
        + 0.3 * np.sin(2 * np.pi * rng.uniform(150, 900) * t)
        + 0.05 * rng.standard_normal(n) for _ in range(channels)])
    return np.rint(x * (peak / np.abs(x).max())).astype(np.int32)


def _write24(path, q, rate):
    """A format-1 24-bit PCM WAV of the (channels, n) integers ``q``
    (float32 ``q / 2^23`` is exact, and the writer's rounding gives ``q``
    back)."""
    write_wav(str(path), (q / FULL).astype(np.float32), rate, bits=24,
              float_format=False)
    return str(path)


def _payload(q):
    """The data bytes of ``q``: interleaved, 3 bytes a sample."""
    v = q.T.reshape(-1).astype("<i4").view(np.uint8).reshape(-1, 4)
    return np.ascontiguousarray(v[:, :3]).reshape(-1)


def _riff(chunks):
    body = b"WAVE" + b"".join(
        cid + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1)
        for cid, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _fmt(tag, channels, rate, bits, sub=None):
    align = channels * bits // 8
    f = struct.pack("<HHIIHH", tag, channels, rate, rate * align, align, bits)
    if sub is not None:  # WAVE_FORMAT_EXTENSIBLE: cbSize, valid bits, mask
        f += struct.pack("<HHI", 22, bits, 3) + struct.pack("<H", sub) \
            + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    return f


def _capture(monkeypatch):
    """The fleet's tables, per file, as its selection sees them."""
    got = {}
    select = fleet.select_min_peak_angles_batch

    def capture(tables, *a, **kw):
        got.setdefault("tables", []).extend(np.array(t) for t in tables)
        got.setdefault("rot0", []).extend(np.array(r) for r in kw["rot0"])
        return select(tables, *a, **kw)

    monkeypatch.setattr(fleet, "select_min_peak_angles_batch", capture)
    return got


def _reference():
    """``benchmark/reference/offline.py``, imported as a package of its
    own name."""
    name = "bench_reference"
    if name not in sys.modules:
        root = REPO / "benchmark" / "reference"
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py", submodule_search_locations=[str(root)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.offline")


def _catalogue(tmp_path, channels, rate, lengths, seed=24):
    rng = np.random.default_rng(seed)
    paths, ints = [], {}
    for i, n in enumerate(lengths):
        q = _music(rng, channels, n, rate, rng.integers(FULL // 2, FULL))
        p = _write24(tmp_path / f"m{i}.wav", q, rate)
        paths.append(p)
        ints[p] = q
    return paths, ints


# (channels, rate, lengths): two buckets each, at the CLI's blksiz
CASES = {
    "mono_96k": (1, 96000, (40000, 45001, 100000)),    # blksiz 16384
    "stereo_96k": (2, 96000, (40000, 45001, 100000)),
    "stereo_48k": (2, 48000, (20000, 22001, 50000)),   # blksiz 8192
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_tables_equal_the_float_path(tmp_path, monkeypatch, case):
    """The fleet on 24-bit WAVs (batch 2: both buckets, one full batch)
    gives the tables of ``sweep_peaks_aux`` on ``read_audio``'s float32
    samples, which are ``int / 2^23`` exactly, bit for bit, and the
    results of ``find_min_peak_angle``."""
    channels, rate, lengths = CASES[case]
    paths, ints = _catalogue(tmp_path, channels, rate, lengths)
    got = _capture(monkeypatch)
    order = []
    res = fleet.analyze_paths(paths, batch=2, device="cpu",
                              progress=lambda p, r, cached: order.append(p))
    assert fleet._probe(paths[2])[3] == 24
    assert offline_geometry(rate, 0).blksiz == {96000: 16384,
                                                48000: 8192}[rate]
    for p, table, rot0 in zip(order, got["tables"], got["rot0"]):
        audio, r, _ = read_audio(p)
        assert np.array_equal(audio, (ints[p] / FULL).astype(np.float32))
        w_table, w_rot0 = sweep_peaks_aux(audio, offline_geometry(r, 0),
                                          device="cpu")
        assert np.array_equal(table, w_table.numpy()), p
        assert np.array_equal(rot0, w_rot0.numpy()), p
        want = find_min_peak_angle(audio, rate=r, device="cpu")
        assert res[p][0].angles_units == want.angles_units
        assert list(res[p][0].found) == list(want.found)
        np.testing.assert_array_equal(res[p][0].peak_min, want.peak_min)
        np.testing.assert_array_equal(res[p][0].peak_zero, want.peak_zero)
    assert sorted(order) == sorted(paths)


def test_fleet_agrees_with_the_benchmark_reference(tmp_path, monkeypatch):
    """Against ``peak_table`` + ``select_angles`` in float64 on ``int /
    2^23``: every table entry within 1e-4 of the channel's largest, the
    same angles, and the angle-0 entry the exact input peak."""
    offline = _reference()
    paths, ints = _catalogue(tmp_path, 2, 96000, (40000, 100000), seed=7)
    got = _capture(monkeypatch)
    order = []
    res = fleet.analyze_paths(paths, device="cpu",
                              progress=lambda p, r, cached: order.append(p))
    for p, table, rot0 in zip(order, got["tables"], got["rot0"]):
        x = torch.from_numpy(ints[p]).to(torch.float64) / FULL
        w_table, w_rot0 = offline.peak_table(x, 16384)
        scale = w_table.max(axis=1, keepdims=True)
        assert np.abs(table - w_table).max() / scale.min() < 1e-4
        assert np.abs(rot0 - w_rot0).max() / scale.min() < 1e-4
        assert np.array_equal(table[:, 0], w_table[:, 0])
        assert np.array_equal(table[:, 0],
                              np.abs(ints[p]).max(axis=1) / FULL)
        sel = offline.select_angles(w_table[None], w_rot0[None], 24,
                                    False)[0]
        assert res[p][0].angles_units == sel["units"]
        assert list(res[p][0].found) == sel["found"]


def test_a_peak_in_the_low_byte_is_kept(tmp_path, monkeypatch):
    """The loudest sample 8,388,607 (0x7FFFFF) beside a next-loudest of
    8,388,480 (0x7FFF80): the two differ in the low byte alone.  The
    fleet keeps the exact peak; a read rounded to 16 bits does not."""
    rng = np.random.default_rng(11)
    q = _music(rng, 2, 60000, 96000, 8388480)
    q[0, 12345] = 8388607
    p = _write24(tmp_path / "hot.wav", q, 96000)
    got = _capture(monkeypatch)
    res = fleet.analyze_paths([p], device="cpu")
    assert got["tables"][0][0, 0] == np.float32(8388607 / FULL)
    assert res[p][0].peak_zero[0] == np.float32(8388607 / FULL)
    rounded = read_audio_pcm16(p)[0]
    assert float(np.abs(rounded[0]).max()) / 32768 != 8388607 / FULL


def _sixteen(tmp_path, rate, n, count, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        x = _music(rng, 2, n, rate, 30000).astype(np.float32) / 32768
        p = str(tmp_path / f"s{i}.wav")
        write_wav(p, x, rate, bits=16, float_format=False)
        out.append(p)
    return out


def _dispatches(monkeypatch):
    """The fleet's calls of the three sweep entries, with what they got."""
    calls = []
    for mod, name in ((sweep, "sweep_peaks_aux_pcm16"),
                      (sweep, "sweep_peaks_aux_pcm24"),
                      (packed, "sweep_peaks_aux_packed")):
        orig = getattr(mod, name)

        def logged(obj, *a, _orig=orig, _name=name, **k):
            calls.append((_name, obj))
            return _orig(obj, *a, **k)

        monkeypatch.setattr(mod, name, logged)
    return calls


def test_mixed_depths_land_in_separate_buckets(tmp_path, monkeypatch):
    """16-bit and 24-bit WAVs of one rate, channel count and length never
    share a batch; the 16-bit results are bit-identical to a pcm16 run of
    those files alone and equal to the JAX fleet's."""
    rate, n = 96000, 40000
    sixteen = _sixteen(tmp_path, rate, n, 2)
    deep, _ = _catalogue(tmp_path, 2, rate, (n, n))
    calls = _dispatches(monkeypatch)
    paths = [sixteen[0], deep[0], sixteen[1], deep[1]]
    res = fleet.analyze_paths(paths, batch=8, device="cpu")
    # one batch a depth: auto packs the 16-bit pair or ships it as pcm16
    names = sorted(c[0] for c in calls)
    assert len(names) == 2 and names[1] == "sweep_peaks_aux_pcm24"
    assert {fleet._probe(p)[3] for p in sixteen} == {16}
    calls.clear()
    alone = fleet.analyze_paths(sixteen, transport="pcm16", device="cpu")
    assert [c[0] for c in calls] == ["sweep_peaks_aux_pcm16"]
    jax = j_fleet.analyze_paths(sixteen)
    for p in sixteen:
        g, w = res[p][0], alone[p][0]
        assert g.angles_units == w.angles_units == jax[p][0].angles_units
        np.testing.assert_array_equal(g.peak_min, w.peak_min)
        np.testing.assert_array_equal(g.peak_zero, w.peak_zero)
        np.testing.assert_allclose(g.peak_min, jax[p][0].peak_min,
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(g.peak_zero, jax[p][0].peak_zero,
                                   atol=2e-5, rtol=0)


def test_auto_ships_24bit_batches_as_pcm24(tmp_path, monkeypatch):
    """Under ``auto`` every 24-bit batch goes to ``sweep_peaks_aux_pcm24``
    as (files, n_pad, channels, 3) bytes: each file's data chunk as the
    file holds it, then zeros to the bucket's length."""
    paths, ints = _catalogue(tmp_path, 2, 96000, (40000, 45001, 100000))
    calls = _dispatches(monkeypatch)
    fleet.analyze_paths(paths, batch=2, device="cpu")
    assert [c[0] for c in calls] == ["sweep_peaks_aux_pcm24"] * 2
    staged = {}
    for _, buf in calls:
        assert buf.dtype == np.uint8 and buf.ndim == 4
        staged[buf.shape] = buf
    assert set(staged) == {(2, 4 * 16384, 2, 3), (1, 8 * 16384, 2, 3)}
    small = staged[(2, 4 * 16384, 2, 3)].reshape(2, -1)
    rows = {bytes(r[: 40000 * 6]): r for r in small}
    for p in paths[:2]:
        data = _payload(ints[p])
        row = rows[bytes(data[: 40000 * 6])]
        assert np.array_equal(row[: data.size], data)
        assert not row[data.size :].any()


@pytest.mark.parametrize("transport", ["pcm16", "packed"])
def test_16bit_transports_refuse_24bit_files(tmp_path, monkeypatch,
                                             transport):
    """``pcm16`` and ``packed`` would drop a 24-bit file's low byte: the
    fleet raises ``ValueError`` naming the file and its depth while it
    probes, before any file is decoded."""
    sixteen = _sixteen(tmp_path, 96000, 30000, 1)
    deep, _ = _catalogue(tmp_path, 2, 96000, (30000,))

    def no_decode(*a, **k):
        raise AssertionError("a file was decoded")

    import phaserotate_tpu_torch.io as io_pkg
    from phaserotate_tpu_torch.io import pcm24

    monkeypatch.setattr(io_pkg, "read_audio_pcm16", no_decode)
    monkeypatch.setattr(pcm24, "read_pcm24_into", no_decode)
    with pytest.raises(ValueError, match="24-bit") as e:
        fleet.analyze_paths(sixteen + deep, transport=transport,
                            device="cpu")
    assert deep[0] in str(e.value) and transport in str(e.value)


@pytest.mark.parametrize("channels,n", [(1, 5), (2, 7), (2, 8), (3, 4),
                                        (1, 1), (2, 0)])
def test_widen_twin(channels, n):
    """Sign extension at -8,388,608, -1, 0 and 8,388,607, random samples,
    odd lengths, and zero padding widened to +0."""
    rng = np.random.default_rng(channels * 100 + n)
    edges = np.array([-FULL, -1, 0, FULL - 1], np.int32)
    q = rng.integers(-FULL, FULL, (3, channels, n)).astype(np.int32)
    flat = q.reshape(-1)
    flat[: min(flat.size, 4)] = edges[: min(flat.size, 4)]
    flat[-min(flat.size, 4):] = edges[::-1][: min(flat.size, 4)]
    pad = 3
    raw = np.zeros((3, n + pad, channels, 3), np.uint8)
    for r in range(3):
        data = _payload(q[r])
        raw[r].reshape(-1)[: data.size] = data
    got = pcm24_widen(torch.from_numpy(raw))
    assert got.dtype == torch.float32
    assert got.shape == (3, channels, n + pad)
    want = np.zeros((3, channels, n + pad), np.float32)
    want[..., :n] = q / np.float32(FULL)
    assert np.array_equal(got.numpy(), want)
    assert not np.signbit(got.numpy()[..., n:]).any()
    assert torch.equal(got, pcm24_widen_plain(torch.from_numpy(raw)))
    with pytest.raises(ValueError):
        pcm24_widen(torch.from_numpy(raw).reshape(3, -1))
    with pytest.raises(ValueError):
        pcm24_widen(torch.from_numpy(raw).reshape(3, n + pad, -1, 1))
    with pytest.raises(TypeError):
        pcm24_widen(torch.from_numpy(raw).to(torch.int16))


def test_reader_reads_every_24bit_header(tmp_path):
    """Format 1 and WAVE_FORMAT_EXTENSIBLE with the PCM subformat, with a
    LIST chunk of odd size before the data and a chunk after it: the
    same bytes, the frame count of the copied reader's probe, and the
    rest of the buffer untouched."""
    rng = np.random.default_rng(3)
    q = rng.integers(-FULL, FULL, (2, 1001)).astype(np.int32)
    data = _payload(q).tobytes()
    plain = tmp_path / "plain.wav"
    plain.write_bytes(_riff([(b"fmt ", _fmt(1, 2, 96000, 24)),
                             (b"data", data)]))
    ext = tmp_path / "ext.wav"
    ext.write_bytes(_riff([(b"fmt ", _fmt(0xFFFE, 2, 96000, 24, sub=1)),
                           (b"LIST", b"INFOIART\x03\x00\x00\x00ab\x00"),
                           (b"data", data), (b"junk", b"xyz")]))
    for p in (plain, ext):
        h = read_header(str(p))
        assert is_pcm24(h) and (h.rate, h.channels, h.frames) == (
            96000, 2, 1001)
        assert probe_audio(str(p)) == (96000, 2, 1001)
        buf = np.full(1001 * 6 + 10, 7, np.uint8)
        assert read_pcm24_into(str(p), buf) == 1001
        assert buf[: 1001 * 6].tobytes() == data
        assert (buf[1001 * 6 :] == 7).all()
        assert np.array_equal(read_audio(str(p))[0],
                              (q / FULL).astype(np.float32))
    with pytest.raises(ValueError, match="fit"):
        read_pcm24_into(str(plain), np.zeros(1001 * 6 - 1, np.uint8))


def _bad_files():
    data = bytes(range(256)) * 6
    fmt24 = (b"fmt ", _fmt(1, 2, 96000, 24))
    whole = _riff([fmt24, (b"data", data)])
    return {
        "truncated data": whole[:-100],
        "truncated header": whole[:30],
        "not riff": b"RIFX" + whole[4:],
        "not wave": whole[:8] + b"AVI " + whole[12:],
        "no data chunk": _riff([fmt24]),
        "no fmt chunk": _riff([(b"data", data)]),
        "short fmt": _riff([(b"fmt ", b"\x01\x00\x02\x00"),
                            (b"data", data)]),
        "no channels": _riff([(b"fmt ", _fmt(1, 0, 96000, 24)),
                              (b"data", data)]),
        "pcm16": _riff([(b"fmt ", _fmt(1, 2, 96000, 16)), (b"data", data)]),
        "pcm32": _riff([(b"fmt ", _fmt(1, 2, 96000, 32)), (b"data", data)]),
        "pcm8": _riff([(b"fmt ", _fmt(1, 2, 96000, 8)), (b"data", data)]),
        "float32": _riff([(b"fmt ", _fmt(3, 2, 96000, 32)),
                          (b"data", data)]),
        "extensible float": _riff([(b"fmt ", _fmt(0xFFFE, 2, 96000, 24,
                                                  sub=3)),
                                   (b"data", data)]),
    }


@pytest.mark.parametrize("case", sorted(_bad_files()))
def test_reader_refuses_what_is_not_24bit_pcm(tmp_path, case):
    p = tmp_path / "bad.wav"
    p.write_bytes(_bad_files()[case])
    with pytest.raises(WavFormatError):
        read_pcm24_into(str(p), np.zeros(1 << 16, np.uint8))


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "float32", "flac"])
def test_probe_keeps_the_copied_probe(tmp_path, kind):
    """The fleet's probe reads the same rate, channels and frames as
    ``probe_audio`` (a RIFF file's from its chunk headers alone), so a
    16-bit fleet buckets as before; only 24-bit PCM WAV reads at 24."""
    x = (0.3 * np.random.default_rng(2).standard_normal((2, 12345))
         ).astype(np.float32)
    p = str(tmp_path / ("a.flac" if kind == "flac" else "a.wav"))
    if kind == "flac":
        write_flac(p, x, 44100, bits=16)
    elif kind == "float32":
        write_wav(p, x, 44100)
    else:
        write_wav(p, x, 44100, bits=int(kind[3:]), float_format=False)
    assert fleet._probe(p) == (*probe_audio(p),
                               24 if kind == "pcm24" else 16)


def _readers(monkeypatch):
    """The benchmark's readers of the program's 24-bit records, loaded as
    the harness loads them."""
    monkeypatch.syspath_prepend(str(REPO / "benchmark"))
    from harness.spec import metric_reader

    return {name: metric_reader(name) for name in (
        "decode_ms_per_file.pcm24", "widen_ms_per_batch",
        "widen_roofline.analyze")}


def test_benchmark_readers_read_the_24bit_records(monkeypatch):
    """The three readers of the 24-bit catalogue cell on hand-made
    records: the mean ``fleet.decode`` ms, the mean device ms of
    ``pcm24.widen``, and 7 bytes a widened sample at 3.35 TB/s over the
    ``pcm24_widen`` kernels' device time, or the spans' where the trace
    holds none; records outside the window are dropped."""
    readers = _readers(monkeypatch)
    from harness import program
    from harness.trace import Trace

    ms = 1_000_000
    w0 = 10_000 * ms
    samples = 8 * 2 * (1 << 26)
    recs = [("fleet.decode", "fleet-stage_0", w0 + 10 * ms, w0 + 40 * ms,
             {}),
            ("fleet.decode", "fleet-stage_0", w0 + 50 * ms, w0 + 60 * ms,
             {}),
            ("fleet.decode", "fleet-stage_0", w0 - 5 * ms, w0 + 1 * ms, {}),
            ("pcm24.widen", "MainThread", w0 + 100 * ms, w0 + 101 * ms,
             dict(samples=samples, batch=8, device_ms=4.0)),
            ("pcm24.widen", "MainThread", w0 + 200 * ms, w0 + 201 * ms,
             dict(samples=samples, batch=8, device_ms=6.0))]
    monkeypatch.setattr(program, "_drain", lambda: list(recs))
    bound = 1e3 * 7 * samples / 3.35e12
    kernels = [("void pcm24_widen_groups<2>(...)", w0 + 100 * ms,
                w0 + 104 * ms),
               ("void pcm24_widen_groups<2>(...)", w0 + 200 * ms,
                w0 + 206 * ms),
               ("void sweep_kernel<9>(...)", w0 + 300 * ms, w0 + 350 * ms)]
    traced = Trace(device=kernels, window=(w0, w0 + 1000 * ms))
    assert readers["decode_ms_per_file.pcm24"](traced) == pytest.approx(20.0)
    assert readers["widen_ms_per_batch"](traced) == pytest.approx(5.0)
    assert readers["widen_roofline.analyze"](traced) == pytest.approx(
        100 * 2 * bound / 10.0)
    events_only = Trace(window=(w0, w0 + 1000 * ms))
    assert readers["widen_roofline.analyze"](events_only) == pytest.approx(
        100 * 2 * bound / 10.0)
    monkeypatch.setattr(program, "_drain", lambda: [])
    for read in readers.values():
        assert read(Trace(window=(w0, w0 + 1000 * ms))) is None


def _ring_catalogue(tmp_path):
    """Stereo 96 kHz 24-bit files of one bucket (4 blocks of 16384): four
    loud ones that nearly fill it and two quiet ones of about half its
    length, whose pads a stale slot would fill with loud samples."""
    rng = np.random.default_rng(20)
    paths = []
    for i, (n, peak) in enumerate(((65536, FULL - 1), (64000, FULL // 2),
                                   (63001, FULL - 9), (65000, FULL // 3),
                                   (40000, FULL // 64), (41001, 3000))):
        paths.append(_write24(tmp_path / f"r{i}.wav",
                              _music(rng, 2, n, 96000, peak), 96000))
    return paths


def _fresh_tables(paths):
    """{path: (table, rot0)} of ``sweep_peaks_aux`` on a fresh float32
    array of each file's samples."""
    out = {}
    for p in paths:
        audio, rate, _ = read_audio(p)
        table, rot0 = sweep_peaks_aux(audio, offline_geometry(rate, 0),
                                      device="cpu")
        out[p] = (table.numpy(), rot0.numpy())
    return out


def _run_tables(monkeypatch, paths, **kw):
    got = _capture(monkeypatch)
    order = []
    fleet.analyze_paths(paths, device="cpu",
                        progress=lambda p, r, cached: order.append(p), **kw)
    monkeypatch.undo()
    return {p: (t, r) for p, t, r in zip(order, got["tables"], got["rot0"])}


def test_ring_leaves_no_stale_samples_in_a_24bit_pad(tmp_path, monkeypatch):
    """24-bit batches through the reused slots of the staging ring: the
    quiet short pair lands where loud pairs were, later in one call and in
    the next one; every table equals ``sweep_peaks_aux`` on a fresh array
    of the file's samples, bit for bit."""
    paths = _ring_catalogue(tmp_path)
    short = paths[4:]
    want = _fresh_tables(paths)
    runs = [(paths, 2), (short, 2), (paths[:2] + short, 1)]
    for run, batch in runs:
        got = _run_tables(monkeypatch, run, batch=batch)
        assert sorted(got) == sorted(run)
        for p in run:
            assert np.array_equal(got[p][0], want[p][0]), p
            assert np.array_equal(got[p][1], want[p][1]), p


def test_24bit_batch_over_the_ring_share_is_split(tmp_path, monkeypatch):
    """With the ring's cap lowered so that a slot holds one 24-bit file
    of the bucket and not two, the two-file batch is split into one-file
    batches: every file takes a slot of the process's ring, the files
    come back in their input order, and the tables equal the fresh
    per-file sweeps bit for bit."""
    paths = _ring_catalogue(tmp_path)
    run = paths[:2] + paths[4:5]
    key = fleet._bucket_key(96000, 2, 65536, 24, 16384)
    one = fleet._pow2(fleet._slot_bytes(key, 1, "auto"))
    assert fleet._pow2(fleet._slot_bytes(key, 2, "auto")) > one
    want = _fresh_tables(run)
    taken = []
    take = fleet._StagingRing.take
    monkeypatch.setattr(fleet, "_ring_cap_bytes", lambda: 2 * one)
    monkeypatch.setattr(fleet._StagingRing, "take",
                        lambda ring: taken.append(ring) or take(ring))
    got = _capture(monkeypatch)
    order = []
    fleet.analyze_paths(run, batch=2, device="cpu",
                        progress=lambda p, r, cached: order.append(p))
    assert order == run and taken == [fleet._RING] * len(run)
    for p, table, rot0 in zip(order, got["tables"], got["rot0"]):
        assert np.array_equal(table, want[p][0]), p
        assert np.array_equal(rot0, want[p][1]), p

"""The port's fleet front end (fleet.py) against the JAX package's: the
same results, checkpoint files and printed lines on the same files.

The port runs on ``device="cpu"`` here.  Angles must be equal; peaks agree
within 2e-5 (two FFT libraries, float32 roundoff of the convolution); the
three transports are exactly equal among themselves (the unpack is
bit-exact); applied files agree within one 16-bit step where a rounding
boundary is crossed.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from phaserotate_tpu import fleet as j_fleet
from phaserotate_tpu_torch import fleet as p_fleet
from phaserotate_tpu_torch.core.sizes import offline_geometry
from phaserotate_tpu_torch.io import (read_audio, read_audio_pcm16,
                                      write_flac, write_ogg, write_wav)
from phaserotate_tpu_torch.search import find_min_peak_angle, sweep_peaks_aux
from phaserotate_tpu_torch.search.sweep import apply_angles

torch.set_num_threads(1)

RATE = 48000


def analyze_paths(paths, **kw):
    return p_fleet.analyze_paths(paths, device="cpu", **kw)


def _mk(tmp_path, n_files=5, n=20000, seed=41):
    rng = np.random.default_rng(seed)
    paths = []
    t = np.arange(n) / RATE
    for i in range(n_files):
        x = (0.4 * np.sin(2 * np.pi * (100 + 37 * i) * t)
             + 0.2 * np.sin(2 * np.pi * (210 + 11 * i) * t + 0.4)
             + 0.01 * rng.standard_normal(n)).astype(np.float32)
        p = str(tmp_path / f"f{i}.wav")
        write_wav(p, x, RATE, bits=16, float_format=False)
        paths.append(p)
    return paths


def _mk_stereo(tmp_path, n_files=3, n=30000, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    paths = []
    for i in range(n_files):
        x = np.stack([
            0.5 * np.sin(2 * np.pi * (120 + 31 * i) * t)
            + 0.01 * rng.standard_normal(n),
            0.4 * np.sin(2 * np.pi * (260 + 17 * i) * t + 0.7)
            + 0.01 * rng.standard_normal(n),
        ]).astype(np.float32)
        p = str(tmp_path / f"s{i}.wav")
        write_wav(p, x, RATE, bits=16, float_format=False)
        paths.append(p)
    return paths


def _assert_same_results(got, want, paths, exact):
    for p in paths:
        (g, g_rate), (w, w_rate) = got[p], want[p]
        assert g_rate == w_rate
        assert g.angles_units == w.angles_units, p
        assert list(g.found) == list(w.found), p
        if exact:
            np.testing.assert_array_equal(g.peak_min, w.peak_min)
            np.testing.assert_array_equal(g.peak_zero, w.peak_zero)
        else:
            np.testing.assert_allclose(g.peak_min, w.peak_min, atol=2e-5,
                                       rtol=0)
            np.testing.assert_allclose(g.peak_zero, w.peak_zero, atol=2e-5,
                                       rtol=0)


def test_fleet_matches_single_file_search_and_jax(tmp_path):
    """Batched results == per-file find_min_peak_angle, the zero padding
    to the bucket length included, and == the JAX fleet's."""
    paths = _mk(tmp_path)
    res = analyze_paths(paths, batch=3)  # 2 device batches
    for p in paths:
        audio, rate, _ = read_audio(p)
        want = find_min_peak_angle(audio, rate=rate, device="cpu")
        got, g_rate = res[p]
        assert g_rate == rate
        assert got.angles_units == want.angles_units, p
        np.testing.assert_array_equal(got.peak_min, want.peak_min)
    _assert_same_results(res, j_fleet.analyze_paths(paths, batch=3), paths,
                         exact=False)


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("transport", ["packed", "auto"])
def test_fleet_transport_parity(tmp_path, transport, stereo):
    """pcm16 / packed / auto give identical selections and peaks: the
    device sees the same floats either way.  Stereo batches stage as
    (files, 2, n): the packed stream axis covers files x channels."""
    paths = _mk_stereo(tmp_path) if stereo else _mk(tmp_path, n_files=4)
    base = analyze_paths(paths, transport="pcm16")
    _assert_same_results(analyze_paths(paths, transport=transport), base,
                         paths, exact=True)


def test_fleet_auto_ships_noise_as_pcm16(tmp_path, monkeypatch):
    """auto packs what compresses and ships the rest as int16; both kinds
    of batch in one fleet, the results equal to pcm16's."""
    from phaserotate_tpu_torch.io import native
    from phaserotate_tpu_torch.search import packed, sweep

    if not native.available():
        pytest.skip("native host library unavailable: auto never packs")
    rng = np.random.default_rng(3)
    tone = _mk(tmp_path, n_files=2, n=20000)           # bucket of 16 blocks
    noisy = []
    for i in range(2):                   # bucket of 32 blocks, nearly full
        p = str(tmp_path / f"noise{i}.wav")
        write_wav(p, rng.uniform(-0.9, 0.9, 65000).astype(np.float32), RATE,
                  bits=16, float_format=False)
        noisy.append(p)
    calls = []
    for mod, name in ((packed, "sweep_peaks_aux_packed"),
                      (sweep, "sweep_peaks_aux_pcm16")):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _o=orig, _n=name, **k: (
                calls.append(_n), _o(*a, **k))[1])
    res = analyze_paths(tone + noisy, transport="auto", blksiz=2048)
    assert sorted(calls) == ["sweep_peaks_aux_packed",
                             "sweep_peaks_aux_pcm16"]
    _assert_same_results(res, analyze_paths(tone + noisy, blksiz=2048,
                                            transport="pcm16"),
                         tone + noisy, exact=True)


def test_fleet_mixed_lengths_and_formats(tmp_path):
    """Different lengths land in different buckets; FLAC rides the same
    int16 ingest; results match the per-file search and the JAX fleet."""
    t1 = np.arange(15000) / RATE
    t2 = np.arange(50000) / RATE
    a = (0.5 * np.sin(2 * np.pi * 150 * t1)).astype(np.float32)
    b = (0.4 * np.sin(2 * np.pi * 440 * t2)
         + 0.2 * np.sin(2 * np.pi * 97 * t2)).astype(np.float32)
    pa = str(tmp_path / "a.wav")
    pb = str(tmp_path / "b.flac")
    write_wav(pa, a, RATE, bits=16, float_format=False)
    write_flac(pb, b, RATE, bits=16)
    res = analyze_paths([pa, pb])
    for p in (pa, pb):
        audio, r, _ = read_audio(p)
        want = find_min_peak_angle(audio, rate=r, device="cpu")
        assert res[p][0].angles_units == want.angles_units, p
    _assert_same_results(res, j_fleet.analyze_paths([pa, pb]), [pa, pb],
                         exact=False)


@pytest.mark.parametrize("batch", [1, 2])
def test_fleet_batched_apply_matches_per_file(tmp_path, batch):
    """apply_paths (one device pass per batch, files zero-padded to the
    bucket length) writes the audio a per-file run produces: mixed
    lengths and channel counts in one fleet, so the run-ahead loop
    crosses a bucket's edge, with one file a batch and with two."""
    paths = _mk(tmp_path, n_files=3)
    paths += _mk_stereo(tmp_path, n_files=1, n=33333)
    results = analyze_paths(paths)
    written = p_fleet.apply_paths(paths, results, str(tmp_path / "out"),
                                  batch=batch, device="cpu")
    assert set(written) == set(paths)
    single_dir = str(tmp_path / "single")
    os.makedirs(single_dir)
    for p in paths:
        audio, rate, _ = read_audio(p)
        want = apply_angles(
            np.atleast_2d(audio), np.asarray(results[p][0].angles_units),
            offline_geometry(rate, 0), device="cpu").numpy()
        got, g_rate, _ = read_audio(written[p])
        assert g_rate == rate
        np.testing.assert_allclose(got, want, atol=1e-6)
        # _apply_one, the per-file writer, gives the same file
        one = p_fleet._apply_one(p, single_dir, results[p][0], 0,
                                 device="cpu")
        np.testing.assert_allclose(read_audio(one)[0], got, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_checkpoint_resume_across_packages(tmp_path, writer):
    """A checkpoint written by either fleet serves every file of the
    other's rerun from the stored sweeps."""
    paths = _mk(tmp_path, n_files=4)
    ck = str(tmp_path / "sweeps.npz")
    if writer == "jax":
        first = j_fleet.analyze_paths(paths, checkpoint=ck)
        rerun = analyze_paths
    else:
        first = analyze_paths(paths, checkpoint=ck)
        rerun = j_fleet.analyze_paths
    seen = []
    second = rerun(paths, checkpoint=ck,
                   progress=lambda p, res, cached: seen.append(cached))
    assert len(seen) == 4 and all(seen)
    _assert_same_results(second, first, paths, exact=True)
    # and the port's own rerun, with another selection, touches no device
    seen.clear()
    third = analyze_paths(paths, checkpoint=ck, stride=12,
                          progress=lambda p, res, cached: seen.append(cached))
    assert all(seen) and set(third) == set(paths)


def test_fleet_checkpoint_files_hold_the_same_tables(tmp_path):
    paths = _mk(tmp_path, n_files=3)
    ck_p, ck_j = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    analyze_paths(paths, checkpoint=ck_p)
    j_fleet.analyze_paths(paths, checkpoint=ck_j)
    with np.load(ck_p) as zp, np.load(ck_j) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].shape == zj[k].shape and zp[k].dtype == zj[k].dtype
            np.testing.assert_allclose(zp[k], zj[k], atol=2e-5, rtol=0)


@pytest.mark.parametrize("extra", [[], ["-l", "-s", "12"],
                                   ["--transport", "packed", "--batch", "2"]])
def test_fleet_cli_prints_the_jax_clis_lines(tmp_path, capsys, extra):
    paths = _mk(tmp_path, n_files=3) + _mk_stereo(tmp_path, n_files=1)
    assert p_fleet.main(paths + extra, device="cpu") == 0
    got = capsys.readouterr()
    assert j_fleet.main(paths + extra) == 0
    want = capsys.readouterr()
    assert got.out == want.out and got.out.count("ch 1:") == 4
    assert got.out.count("ch 2:") == 1 and got.err == want.err == ""


def test_fleet_cli_checkpoint_and_apply(tmp_path, capsys):
    paths = _mk(tmp_path, n_files=3)
    ck = str(tmp_path / "ck.npz")
    outdir, j_outdir = str(tmp_path / "out"), str(tmp_path / "j_out")
    assert p_fleet.main(paths + ["--checkpoint", ck], device="cpu") == 0
    first = capsys.readouterr().out
    assert "(cached sweep)" not in first
    argv = paths + ["--checkpoint", ck, "--apply", "--outdir"]
    assert p_fleet.main(argv + [outdir], device="cpu") == 0
    second = capsys.readouterr()
    assert second.out.count("(cached sweep)") == 3
    assert second.out.replace("  (cached sweep)", "") == first
    assert j_fleet.main(argv + [j_outdir]) == 0
    want = capsys.readouterr()
    assert second.out == want.out
    assert second.err == want.err.replace(j_outdir, outdir)
    assert second.err.count("wrote ") == 3
    for p in paths:
        name = os.path.basename(p)
        y, rate, _ = read_audio(os.path.join(outdir, name))
        src, _, _ = read_audio(p)
        assert y.shape == src.shape and rate == RATE
        jy, _, _ = read_audio(os.path.join(j_outdir, name))
        np.testing.assert_allclose(y, jy, atol=1.0 / 32768 + 1e-7)
    with pytest.raises(SystemExit):
        p_fleet.main(paths + ["--apply"], device="cpu")
    capsys.readouterr()


def test_fleet_lossy_input(tmp_path):
    """A lossy source (Vorbis) rides the quantizing ingest fallback."""
    t = np.arange(24000) / RATE
    x = (0.5 * np.sin(2 * np.pi * 150 * t)
         + 0.2 * np.sin(2 * np.pi * 340 * t)).astype(np.float32)
    p = str(tmp_path / "l.ogg")
    write_ogg(p, x[None], RATE, quality=0.5)
    res = analyze_paths([p])
    r, g_rate = res[p]
    assert g_rate == RATE and len(r.angles_deg) == 1
    audio, _, _ = read_audio(p)
    q = np.clip(np.rint(audio * 32768.0), -32768, 32767) / 32768.0
    want = find_min_peak_angle(q.astype(np.float32), rate=RATE,
                               device="cpu")
    assert r.angles_units == want.angles_units
    _assert_same_results(res, j_fleet.analyze_paths([p]), [p], exact=False)


def test_fleet_rejects_an_unknown_transport(tmp_path):
    with pytest.raises(ValueError, match="transport"):
        analyze_paths(_mk(tmp_path, n_files=1), transport="zip")


def test_fleet_needs_a_device(tmp_path, capsys):
    """Nothing runs on the CPU unasked: the functions raise, the CLI
    prints one error line and exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    paths = _mk(tmp_path, n_files=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        p_fleet.analyze_paths(paths)
    with pytest.raises(RuntimeError, match="CUDA"):
        p_fleet.apply_paths(paths, {}, str(tmp_path / "out"))
    assert not os.path.exists(str(tmp_path / "out"))
    capsys.readouterr()
    assert p_fleet.main(paths) == 1
    out = capsys.readouterr()
    assert out.out == "" and len(out.err.strip().splitlines()) == 1
    assert out.err.startswith("Error: ")


def _mk_ring(tmp_path, seed=19):
    """Stereo files of one bucket at blksiz 2048 (16 blocks of 2048): four
    loud ones that nearly fill it and two quiet ones of about half its
    length, whose pads a stale slot would fill with loud samples."""
    rng = np.random.default_rng(seed)
    paths = []
    specs = [(32768, 0.7), (32000, 0.6), (31000, 0.8), (32500, 0.5),
             (17000, 0.05), (18001, 0.04)]
    for i, (n, amp) in enumerate(specs):
        t = np.arange(n) / RATE
        x = np.stack([amp * np.sin(2 * np.pi * (130 + 41 * i) * t + ph)
                      + 0.01 * amp * rng.standard_normal(n)
                      for ph in (0.0, 0.9)]).astype(np.float32)
        p = str(tmp_path / f"r{i}.wav")
        write_wav(p, x, RATE, bits=16, float_format=False)
        paths.append(p)
    return paths


def _fresh_tables(paths, blksiz):
    """{path: (table, rot0)} of ``sweep_peaks_aux`` on a fresh float32
    array of each file's own int16 samples."""
    geom = offline_geometry(RATE, blksiz)
    out = {}
    for p in paths:
        x = read_audio_pcm16(p)[0].astype(np.float32) / 32768
        table, rot0 = sweep_peaks_aux(x, geom, device="cpu")
        out[p] = (table.numpy(), rot0.numpy())
    return out


def _run_tables(monkeypatch, paths, **kw):
    """analyze_paths on the CPU -> (results, {path: (table, rot0)} as the
    selection saw them)."""
    got, order = [], []
    select = p_fleet.select_min_peak_angles_batch

    def capture(tables, *a, **k):
        got.extend(zip(np.array(tables), np.array(k["rot0"])))
        return select(tables, *a, **k)

    monkeypatch.setattr(p_fleet, "select_min_peak_angles_batch", capture)
    res = analyze_paths(paths, progress=lambda p, r, cached: order.append(p),
                        **kw)
    monkeypatch.setattr(p_fleet, "select_min_peak_angles_batch", select)
    return res, dict(zip(order, got))


def _assert_fresh(res, got, want, paths):
    for p in paths:
        assert np.array_equal(got[p][0], want[p][0]), p
        assert np.array_equal(got[p][1], want[p][1]), p
        assert np.array_equal(res[p][0].peak_zero, want[p][0][:, 0]), p


@pytest.mark.parametrize("transport", ["pcm16", "packed", "auto"])
def test_fleet_ring_leaves_no_stale_samples_in_a_pad(tmp_path, monkeypatch,
                                                     transport):
    """The staging ring reuses its two slots.  Batches of two (loud,
    loud, quiet short pair) put the short files in the rows that the
    first loud pair filled; a second call puts them where the second
    loud pair was.  Every table equals ``sweep_peaks_aux`` on a fresh
    array of the file's samples, bit for bit, and the first call's
    results still do after the second call reused the slots."""
    paths = _mk_ring(tmp_path)
    short = paths[4:]
    want = _fresh_tables(paths, 2048)
    first, got = _run_tables(monkeypatch, paths, batch=2, blksiz=2048,
                             transport=transport)
    second, got2 = _run_tables(monkeypatch, short, batch=2, blksiz=2048,
                               transport=transport)
    _assert_fresh(first, got, want, paths)
    _assert_fresh(second, got2, want, short)
    # one file a batch: the short ones land in row 0 of either slot
    third, got3 = _run_tables(monkeypatch, paths[:2] + short, batch=1,
                              blksiz=2048, transport=transport)
    _assert_fresh(third, got3, want, paths[:2] + short)


@pytest.mark.parametrize("transport", ["pcm16", "packed", "auto"])
def test_fleet_batch_over_the_ring_share_is_split(tmp_path, monkeypatch,
                                                  transport):
    """With the ring's cap lowered so that a slot holds one file of the
    bucket and not two, the two-file batch is split into one-file
    batches: every file takes a slot of the process's ring, the files
    come back in their input order, and the tables equal the fresh
    per-file sweeps bit for bit."""
    paths = _mk_ring(tmp_path)
    key = p_fleet._bucket_key(RATE, 2, 32768, 16, 2048)
    one, two = (p_fleet._pow2(p_fleet._slot_bytes(key, k, transport))
                for k in (1, 2))
    assert two > one
    monkeypatch.setattr(p_fleet, "_ring_cap_bytes", lambda: 2 * one)
    taken = []
    take = p_fleet._StagingRing.take
    monkeypatch.setattr(p_fleet._StagingRing, "take",
                        lambda ring: taken.append(ring) or take(ring))
    run = paths[:2] + paths[4:5]
    res, got = _run_tables(monkeypatch, run, batch=2, blksiz=2048,
                           transport=transport)
    assert list(got) == run
    assert taken == [p_fleet._RING] * len(run)
    _assert_fresh(res, got, _fresh_tables(paths, 2048), run)


# (key, files, transport, slot bytes, bytes reserved a slot) for every
# batch shape of the two catalogue cells (32-path slices, batches of 8;
# pcm16 warms up the 16-bit buckets past the first) and two packed ones.
# The sizes are fixed: a change to the slot's layout must not change what
# the ring pins.
RING_BYTES = {
    "cli_48k": [
        ((48000, 2, 8388608, 16), 6, "auto", 386072832, 536870912),
        ((48000, 2, 8388608, 16), 6, "pcm16", 386072832, 536870912),
        ((48000, 2, 16777216, 16), 2, "auto", 255983872, 268435456),
        ((48000, 2, 16777216, 16), 8, "auto", 1023934720, 1073741824),
        ((48000, 2, 16777216, 16), 2, "pcm16", 255983872, 268435456),
        ((48000, 2, 16777216, 16), 8, "pcm16", 1023934720, 1073741824),
        ((48000, 2, 33554432, 16), 8, "auto", 2047869184, 2147483648),
        ((48000, 2, 33554432, 16), 8, "pcm16", 2047869184, 2147483648),
        ((48000, 2, 8388608, 16), 8, "packed", 553910528, 1073741824),
        ((48000, 2, 33554432, 16), 6, "packed", 1644953856, 2147483648),
    ],
    "cli_96k24": [
        ((96000, 2, 16777216, 24), 6, "auto", 603979776, 1073741824),
        ((96000, 2, 33554432, 24), 2, "auto", 402653184, 536870912),
        ((96000, 2, 33554432, 24), 8, "auto", 1610612736, 2147483648),
        ((96000, 2, 67108864, 24), 8, "auto", 3221225472, 4294967296),
    ],
}


@pytest.mark.parametrize("config", sorted(RING_BYTES))
def test_fleet_ring_reserves_todays_bytes(monkeypatch, config):
    """Each catalogue batch's slot is the size it was, and on a host of
    96 GiB (the card's) no catalogue batch is split."""
    monkeypatch.setattr(p_fleet, "_ring_cap_bytes", lambda: (96 << 30) // 4)
    share = p_fleet._ring_cap_bytes() // len(p_fleet._RING.slots)
    for key, files, transport, nbytes, reserved in RING_BYTES[config]:
        got = p_fleet._slot_bytes(key, files, transport)
        assert (got, p_fleet._pow2(got)) == (nbytes, reserved), (
            key, files, transport)
        assert reserved <= share


def test_fleet_calls_in_threads_stage_through_their_own_rings(tmp_path,
                                                              monkeypatch):
    """Four ``analyze_paths`` calls at once, in threads, with a short
    switch interval: the call that holds the process's ring stages its
    first batch only once the three others have each staged one through
    a ring of their own.  Every table equals the fresh per-file sweep,
    bit for bit, and the ring's lock is released."""
    paths = _mk_ring(tmp_path)
    want = _fresh_tables(paths, 2048)
    select = p_fleet.select_min_peak_angles_batch
    got, errors = {}, []
    local = threading.local()
    taken = []
    others = threading.Event()
    take = p_fleet._StagingRing.take

    def take_after_others(ring):
        taken.append(ring)
        if ring is p_fleet._RING:
            others.wait(timeout=120)
        elif len({id(r) for r in taken if r is not p_fleet._RING}) == 3:
            others.set()
        return take(ring)

    def capture(tables, *a, **k):
        local.rows.extend(zip(np.array(tables), np.array(k["rot0"])))
        return select(tables, *a, **k)

    def call(i):
        local.rows, order = [], []
        try:
            res = analyze_paths(
                paths[i % 2 :], batch=1 + i % 2, blksiz=2048,
                transport=("pcm16", "auto")[i % 2],
                progress=lambda p, r, cached: order.append(p))
            got[i] = (res, dict(zip(order, local.rows)))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    monkeypatch.setattr(p_fleet, "select_min_peak_angles_batch", capture)
    monkeypatch.setattr(p_fleet._StagingRing, "take", take_after_others)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert others.is_set()
    rings = {id(r): r for r in taken}
    assert len(rings) == 4 and id(p_fleet._RING) in rings
    assert not any(r.pinned for r in rings.values())
    assert sorted(got) == [0, 1, 2, 3]
    for i, (res, tables) in got.items():
        _assert_fresh(res, tables, want, paths[i % 2 :])
    assert not p_fleet._RING.lock.locked()


@pytest.mark.parametrize("cpus", [1, 2, 8, 64])
def test_fleet_decode_workers_follow_the_host(monkeypatch, cpus):
    """A batch decodes on as many threads as it has files, but never on
    more than the CPUs the process may run on less one (the dispatch
    thread's), and on one for a file alone or a host of one CPU."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)))
    for files in (1, 2, 7, 8, 100):
        got = p_fleet._decode_workers(files)
        assert got == max(1, min(files, cpus - 1)), (files, got)
        assert 1 <= got <= files
    assert p_fleet._decode_workers(1) == 1


def _mk_deep_ring(tmp_path, seed=23):
    """The files of ``_mk_ring`` as 24-bit WAVs, every sample given a
    random low byte: one bucket of loud long files and quiet short
    ones."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, p in enumerate(_mk_ring(tmp_path, seed)):
        x = read_audio(p)[0].astype(np.float64) * (1 << 23)
        q = np.clip(np.rint(x) + rng.integers(-128, 128, x.shape),
                    -(1 << 23), (1 << 23) - 1)
        deep = str(tmp_path / f"d{i}.wav")
        write_wav(deep, (q / (1 << 23)).astype(np.float32), RATE, bits=24,
                  float_format=False)
        paths.append(deep)
    return paths


def _decode_case(tmp_path, transport):
    """(paths, transport for analyze_paths, fresh tables) of a catalogue
    in one bucket of files of mixed lengths: 16-bit WAVs for the 16-bit
    transports, 24-bit ones for ``pcm24`` (which ``auto`` ships)."""
    if transport == "pcm24":
        paths = _mk_deep_ring(tmp_path)
        geom = offline_geometry(RATE, 2048)
        want = {}
        for p in paths:
            table, rot0 = sweep_peaks_aux(read_audio(p)[0], geom,
                                          device="cpu")
            want[p] = (table.numpy(), rot0.numpy())
        return paths, "auto", want
    paths = _mk_ring(tmp_path)
    return paths, transport, _fresh_tables(paths, 2048)


def _force_workers(monkeypatch, workers):
    """Make every batch decode on ``workers`` threads (``"more"``: five
    more than its files)."""
    monkeypatch.setattr(p_fleet, "_decode_workers", lambda files: (
        files + 5 if workers == "more" else workers))


@pytest.mark.parametrize("workers", [2, 3, "more"])
@pytest.mark.parametrize("transport", ["auto", "packed", "pcm16", "pcm24"])
def test_fleet_decode_threads_give_one_threads_results(tmp_path, monkeypatch,
                                                       transport, workers):
    """A batch's files decoded on several threads at once give the tables,
    ``rot0`` and selections of one thread, bit for bit, each equal to the
    sweep of a fresh array of the file's own samples: batches of four
    files of mixed lengths in one bucket, then two (and 24-bit files,
    which ride the pcm24 wire)."""
    paths, transport, want = _decode_case(tmp_path, transport)
    runs = {}
    for w in (1, workers):
        _force_workers(monkeypatch, w)
        runs[w] = _run_tables(monkeypatch, paths, batch=4, blksiz=2048,
                              transport=transport)
    (one, one_tables), (many, many_tables) = runs[1], runs[workers]
    assert list(many_tables) == list(one_tables) == paths
    _assert_fresh(one, one_tables, want, paths)
    _assert_fresh(many, many_tables, want, paths)
    _assert_same_results(many, one, paths, exact=True)


@pytest.mark.parametrize("transport", ["auto", "packed", "pcm16", "pcm24"])
def test_fleet_decode_threads_leave_no_stale_samples_in_a_pad(
        tmp_path, monkeypatch, transport):
    """Batches of two on the decode threads (loud, loud, then the quiet
    short pair in the slot the first loud pair filled), and batches of
    three files a batch's threads more than its files: every table
    equals the fresh per-file sweep, so each thread zeroed its own row's
    pad."""
    paths, transport, want = _decode_case(tmp_path, transport)
    for workers, batch in ((2, 2), ("more", 2), (3, 3)):
        _force_workers(monkeypatch, workers)
        res, got = _run_tables(monkeypatch, paths, batch=batch, blksiz=2048,
                               transport=transport)
        _assert_fresh(res, got, want, paths)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("bits", [16, 24])
def test_fleet_decode_threads_raise_the_first_failed_file(
        tmp_path, monkeypatch, bits, workers):
    """Files 2 and 4 of a batch of six fail to decode, file 4 at once
    and file 2 only after a while: the call raises file 2's error, as
    one thread reading them in order does, whatever the threads; the
    ring's lock is released, and the next call of the process, on the
    good files, succeeds with the fresh per-file tables."""
    from phaserotate_tpu_torch import io as p_io
    from phaserotate_tpu_torch.io import WavFormatError, pcm16, pcm24

    paths, transport, want = _decode_case(
        tmp_path, "pcm24" if bits == 24 else "pcm16")
    # at 16 bits a file the WAV reader refuses goes to the copied reader,
    # which then fails too, as both do on a corrupt file
    readers = ([(pcm24, "read_pcm24_into")] if bits == 24
               else [(pcm16, "read_pcm16_into"), (p_io, "read_audio_pcm16")])
    bad = {paths[2]: 0.3, paths[4]: 0.0}
    for module, name in readers:
        def failing(p, *a, _read=getattr(module, name)):
            if p in bad:
                time.sleep(bad[p])
                raise WavFormatError(f"{p}: corrupt")
            return _read(p, *a)

        monkeypatch.setattr(module, name, failing)
    _force_workers(monkeypatch, workers)
    with pytest.raises(WavFormatError, match="corrupt") as err:
        analyze_paths(paths, batch=6, blksiz=2048, transport=transport)
    assert str(err.value) == f"{paths[2]}: corrupt"
    assert not p_fleet._RING.lock.locked()
    good = [p for p in paths if p not in bad]
    res, got = _run_tables(monkeypatch, good, batch=6, blksiz=2048,
                           transport=transport)
    _assert_fresh(res, got, want, good)


def _copied_reader_only(monkeypatch):
    """Make the fleet read every 16-bit file as it did before
    ``io/pcm16.py``: the WAV reader refuses them all, so each takes
    ``read_audio_pcm16``."""
    from phaserotate_tpu_torch.io import WavFormatError, pcm16

    def refuse(p, rows):
        raise WavFormatError(f"{p}: read with the copied reader")

    monkeypatch.setattr(pcm16, "read_pcm16_into", refuse)


@pytest.mark.parametrize("workers", [1, 3, 7])
@pytest.mark.parametrize("transport", ["auto", "packed", "pcm16"])
def test_fleet_wav_reader_equals_the_copied_reader(tmp_path, monkeypatch,
                                                   transport, workers):
    """16-bit WAVs read straight into the slot give the tables, ``rot0``
    and selections of the copied reader, bit for bit, on every transport
    and decode thread count; ``fleet.decode_copied`` counts no file, and
    every file under the copied reader.  Batches of two put the quiet
    short pair in rows the loud pair filled, so the tables also show that
    no stale sample is left in a pad."""
    from phaserotate_tpu_torch.utils.profiling import (CountRecord, drain,
                                                       recording)

    paths = _mk_ring(tmp_path) + _mk_stereo(tmp_path)
    want = _fresh_tables(paths, 2048)
    _force_workers(monkeypatch, workers)
    runs = {}
    for reader in ("wav", "copied"):
        if reader == "copied":
            _copied_reader_only(monkeypatch)
        drain()
        with recording():
            runs[reader] = _run_tables(monkeypatch, paths, batch=2,
                                       blksiz=2048, transport=transport)
        copied = [r.n for r in drain() if isinstance(r, CountRecord)
                  and r.name == "fleet.decode_copied"]
        assert sum(copied) == (0 if reader == "wav" else len(paths))
    (res, got), (c_res, c_got) = runs["wav"], runs["copied"]
    assert list(got) == list(c_got)
    _assert_fresh(res, got, want, paths)
    _assert_fresh(c_res, c_got, want, paths)
    _assert_same_results(res, c_res, paths, exact=True)

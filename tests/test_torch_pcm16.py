"""The fleet's 16-bit WAV reader (``io/pcm16.py``) against the copied one.

``read_pcm16_into`` walks the chunk headers, reads the ``data`` chunk a
piece at a time into a buffer its thread keeps and de-interleaves each
piece into the caller's rows.  It gives ``read_wav_pcm16``'s samples on
mono, stereo and 6-channel files, odd frame counts, ``LIST`` chunks on
either side of ``data``, odd-sized chunks with their pad byte and
``WAVE_FORMAT_EXTENSIBLE``; raises ``WavFormatError`` where the copied
reader does; refuses other depths and formats, which the fleet then reads
with ``read_audio_pcm16`` and counts in ``fleet.decode_copied``; and
allocates nothing the size of the file.
"""

import struct
import threading
import tracemalloc

import numpy as np
import pytest

from phaserotate_tpu_torch import fleet
from phaserotate_tpu_torch.io import (WavFormatError, read_audio_pcm16,
                                      write_flac, write_wav)
from phaserotate_tpu_torch.io import pcm16
from phaserotate_tpu_torch.io.pcm16 import read_pcm16_into
from phaserotate_tpu_torch.io.wav import read_wav_pcm16
from phaserotate_tpu_torch.utils.profiling import CountRecord, drain, recording
from test_torch_pcm24 import _riff
from test_torch_pcm24 import _fmt as _fmt_at

RATE = 48000


def _fmt(tag, channels, bits, sub=None):
    return _fmt_at(tag, channels, RATE, bits, sub)


def _samples(channels, frames, seed):
    return np.random.default_rng(seed).integers(
        -32768, 32768, (channels, frames), dtype=np.int16)


def _list_chunk(text):
    body = b"INFO" + b"INAM" + struct.pack("<I", len(text)) + text
    return b"LIST", body + b"\x00" * (len(text) & 1)


def _write(path, chunks):
    path.write_bytes(_riff(chunks))
    return str(path)


def _data(x):
    return b"data", x.T.astype("<i2").tobytes()


# name -> (channels, frames, chunks around the data chunk)
LAYOUTS = {
    "mono": (1, 1001, [], []),
    "stereo_odd": (2, 12345, [], []),
    "six_channels": (6, 9999, [], []),
    "list_before": (2, 3001, [_list_chunk(b"title")], []),
    "list_after": (2, 3001, [], [_list_chunk(b"after")]),
    "odd_chunks": (2, 777, [(b"junk", b"abc"), _list_chunk(b"odd")],
                   [(b"zzzz", b"q")]),
    "extensible": (2, 4097, [], []),
    "longer_than_a_piece": (6, 100_003, [], []),
}


def _layout_file(tmp_path, name, seed=5):
    channels, frames, before, after = LAYOUTS[name]
    x = _samples(channels, frames, seed)
    fmt = (_fmt(0xFFFE, channels, 16, sub=1) if name == "extensible"
           else _fmt(1, channels, 16))
    return _write(tmp_path / f"{name}.wav",
                  [(b"fmt ", fmt), *before, _data(x), *after]), x


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_reads_what_the_copied_reader_reads(tmp_path, name):
    """Into rows with room to spare (the rest left as it was) and into
    rows shorter than the file (as many frames as fit)."""
    path, x = _layout_file(tmp_path, name)
    want = read_wav_pcm16(path)[0]
    np.testing.assert_array_equal(want, x)
    channels, frames = x.shape
    rows = np.full((channels, frames + 50), 7, np.int16)
    assert read_pcm16_into(path, rows) == frames
    np.testing.assert_array_equal(rows[:, :frames], want)
    assert (rows[:, frames:] == 7).all()
    short = np.zeros((channels, frames // 2), np.int16)
    assert read_pcm16_into(path, short) == frames // 2
    np.testing.assert_array_equal(short, want[:, : frames // 2])


def test_reads_the_rows_of_a_wider_buffer(tmp_path):
    """The fleet's slot: rows of a (files, channels, n_pad) buffer, and a
    partial frame at the data chunk's end is not read."""
    x = _samples(2, 5000, 9)
    data = x.T.astype("<i2").tobytes() + b"\x01\x02"
    path = _write(tmp_path / "partial.wav",
                  [(b"fmt ", _fmt(1, 2, 16)), (b"data", data)])
    np.testing.assert_array_equal(read_wav_pcm16(path)[0], x)
    buf = np.zeros((3, 2, 6000), np.int16)
    assert read_pcm16_into(path, buf[1]) == 5000
    np.testing.assert_array_equal(buf[1, :, :5000], x)
    assert not buf[[0, 2]].any() and not buf[1, :, 5000:].any()


@pytest.mark.parametrize("fault", ["truncated_data", "missing_fmt",
                                   "missing_data", "not_riff"])
def test_raises_where_the_copied_reader_raises(tmp_path, fault):
    x = _samples(2, 1000, 3)
    chunks = [(b"fmt ", _fmt(1, 2, 16)), _data(x)]
    if fault == "missing_fmt":
        chunks = chunks[1:]
    if fault == "missing_data":
        chunks = chunks[:1]
    blob = _riff(chunks)
    if fault == "truncated_data":
        blob = blob[:-100]
    if fault == "not_riff":
        blob = b"RIFX" + blob[4:]
    path = tmp_path / f"{fault}.wav"
    path.write_bytes(blob)
    with pytest.raises(WavFormatError):
        read_wav_pcm16(str(path))
    with pytest.raises(WavFormatError):
        read_pcm16_into(str(path), np.zeros((2, 2000), np.int16))


def _other_files(tmp_path):
    """Files the reader refuses: 8-bit and 24-bit PCM, float, FLAC."""
    x = _samples(2, 3000, 4)
    u8 = ((x.astype(np.int32) >> 8) + 128).astype(np.uint8)
    paths = [_write(tmp_path / "u8.wav", [(b"fmt ", _fmt(1, 2, 8)),
                                          (b"data", u8.T.tobytes())])]
    f = (x / 32768.0).astype(np.float32)
    for name, kw in (("f32.wav", dict(bits=32, float_format=True)),
                     ("i24.wav", dict(bits=24, float_format=False))):
        write_wav(str(tmp_path / name), f, RATE, **kw)
        paths.append(str(tmp_path / name))
    write_flac(str(tmp_path / "c.flac"), f, RATE, bits=16)
    paths.append(str(tmp_path / "c.flac"))
    return paths


def test_refuses_other_formats(tmp_path):
    for p in _other_files(tmp_path):
        with pytest.raises(WavFormatError):
            read_pcm16_into(p, np.zeros((2, 4000), np.int16))
    path, _ = _layout_file(tmp_path, "stereo_odd")
    with pytest.raises(ValueError):
        read_pcm16_into(path, np.zeros((3, 20000), np.int16))
    with pytest.raises(ValueError):
        read_pcm16_into(path, np.zeros((2, 20000), np.int32))


def test_fleet_reads_other_files_with_the_copied_reader(tmp_path,
                                                        monkeypatch):
    """8-bit, float and FLAC files take ``read_audio_pcm16`` (24-bit WAVs
    under ``pcm16`` are refused before any decode, so they are left out),
    and ``fleet.decode_copied`` counts them; 16-bit WAVs beside them do
    not."""
    others = [p for p in _other_files(tmp_path) if "i24" not in p]
    path, _ = _layout_file(tmp_path, "stereo_odd")
    paths = others + [path]
    copied = []
    orig = read_audio_pcm16

    def logged(p):
        copied.append(p)
        return orig(p)

    from phaserotate_tpu_torch import io as p_io

    monkeypatch.setattr(p_io, "read_audio_pcm16", logged)
    drain()
    with recording():
        res = fleet.analyze_paths(paths, batch=8, blksiz=2048,
                                  transport="pcm16", device="cpu")
    counts = [r.n for r in drain() if isinstance(r, CountRecord)
              and r.name == "fleet.decode_copied"]
    assert sorted(copied) == sorted(others)
    # two buckets: the 3000-frame files and the 12345-frame one
    assert sorted(counts) == [0, len(others)]
    assert set(res) == set(paths)


def test_allocates_nothing_the_size_of_the_file(tmp_path):
    """An 8 MB file read after a first read on the same thread: less than
    a tenth of the file is allocated at any moment."""
    x = _samples(2, 2_000_000, 6)
    path = _write(tmp_path / "big.wav", [(b"fmt ", _fmt(1, 2, 16)), _data(x)])
    rows = np.zeros((2, 2_000_000), np.int16)
    read_pcm16_into(path, rows)
    tracemalloc.start()
    try:
        read_pcm16_into(path, rows)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(rows, x)
    assert peak < x.nbytes // 10, peak


def test_threads_keep_buffers_of_their_own(tmp_path):
    """Seven threads reading at once, each file several times: every read
    is the file's own samples, and each thread made one piece buffer."""
    files = []
    for s in range(7):
        (tmp_path / str(s)).mkdir()
        files.append(_layout_file(tmp_path / str(s), "longer_than_a_piece",
                                  seed=s))
    bufs, errors = {}, []

    def work(i):
        try:
            path, x = files[i]
            for _ in range(3):
                rows = np.zeros(x.shape, np.int16)
                read_pcm16_into(path, rows)
                np.testing.assert_array_equal(rows, x)
                bufs.setdefault(i, set()).add(id(pcm16._local.buf))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    assert all(len(ids) == 1 for ids in bufs.values()) and len(bufs) == 7

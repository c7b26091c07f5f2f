"""The inputs are made from the seed: the same seed gives the same
catalogue, songs and sessions; another seed other music over the same
set of lengths."""

import numpy as np
import torch

import bench_tiny  # noqa: F401
from harness.signals import (music_device, music_host, song_seconds,
                             write_wav16)


PEAK = (-1.0, -0.1)


def test_catalogue_is_deterministic_per_seed():
    cpu = torch.device("cpu")
    a = music_device(2 ** 31 + 5, 3, 2, 9000, 48000, PEAK, cpu)[1]
    b = music_device(2 ** 31 + 5, 3, 2, 9000, 48000, PEAK, cpu)[1]
    c = music_device(2 ** 31 + 6, 3, 2, 9000, 48000, PEAK, cpu)[1]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_masters_peak_at_full_scale_and_pack():
    """Every master peaks inside the configuration's range and packs to
    62-72 % of pcm16 under the program's packer, so the auto transport
    packs it (its threshold is 90 %)."""
    from phaserotate_tpu_torch.search.packed import (
        pack_residual, packed_bits_per_sample)

    for i in range(4):
        x16 = music_device(2 ** 31 + 9, i, 2, 48000 * 4, 48000, PEAK,
                           torch.device("cpu"))[1].numpy()
        peak_db = 20 * np.log10(np.abs(x16).max() / 32768.0)
        assert PEAK[0] - 0.01 <= peak_db <= PEAK[1] + 0.01
        bits = packed_bits_per_sample(pack_residual(x16))
        assert 0.6 * 16 <= bits <= 0.75 * 16, bits


def test_sessions_are_deterministic_per_seed():
    a = music_host(7, 1, 2, 5000, 48000)
    assert np.array_equal(a, music_host(7, 1, 2, 5000, 48000))
    assert not np.array_equal(a, music_host(8, 1, 2, 5000, 48000))
    assert not np.array_equal(a, music_host(7, 2, 2, 5000, 48000))


def test_song_lengths_are_one_set():
    s = song_seconds(16, 278.0, 0.4)
    assert s == sorted(s) and abs(np.mean(s) - 278.0) < 5.0
    bucket = 1024 * 8192 / 48000  # fleet's 1,024-block bucket

    def buckets(lengths):  # songs in the 1,024-, 2,048- and 4,096-block ones
        return [sum(bucket * k / 2 < x <= bucket * k for x in lengths)
                for k in (1, 2, 4)]

    assert buckets(s) == [3, 9, 4] and s[0] > bucket / 2
    r = song_seconds(64, 278.0, 0.4)
    assert buckets(r) == [11, 39, 14] and r[0] > bucket / 2


def test_wav_writer_reads_back(tmp_path):
    from phaserotate_tpu_torch.io import read_audio_pcm16

    pcm = np.arange(-3000, 3000, dtype=np.int16).reshape(2, -1)
    write_wav16(str(tmp_path / "a.wav"), pcm, 44100)
    got, rate, _ = read_audio_pcm16(str(tmp_path / "a.wav"))
    assert rate == 44100 and np.array_equal(got, pcm)

"""The inputs are made from the seed: the same seed gives the same
catalogue, songs and sessions; another seed other music over the same
set of lengths.  Masters are made and written at the depth their
configuration states, and 16-bit ones are the bytes they always were."""

import hashlib

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401
from harness.signals import (music_device, music_host, song_seconds,
                             write_wav)


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
    write_wav(str(tmp_path / "a.wav"), pcm, 44100)
    got, rate, _ = read_audio_pcm16(str(tmp_path / "a.wav"))
    assert rate == 44100 and np.array_equal(got, pcm)


def test_24_bit_master_reads_back_exactly(tmp_path):
    """A 24-bit master from the writer is a canonical PCM WAV that the
    port's reader gives back as ``int / 2^23``, every sample exact."""
    from phaserotate_tpu_torch.io import read_audio

    x, q = music_device(2 ** 31 + 21, 1, 2, 9001, 96000, PEAK,
                        torch.device("cpu"), bits=24)
    q = q.numpy()
    assert q.dtype == np.int32 and q.min() < -(1 << 22) < (1 << 22) < q.max()
    assert q.min() >= -(1 << 23) and q.max() < (1 << 23)
    assert np.array_equal(x.numpy(), q / np.float32(1 << 23))
    edge = np.array([[-(1 << 23), (1 << 23) - 1, -1, 0, 1, 0x123456],
                     [5, -5, 0x7FFF00, -0x7FFF00, 255, -256]], np.int32)
    for i, pcm in enumerate((q, edge)):
        path = str(tmp_path / f"a{i}.wav")
        write_wav(path, pcm, 96000, bits=24)
        raw = open(path, "rb").read()
        ch, n = pcm.shape
        assert len(raw) == 44 + 3 * ch * n
        assert raw[20:24] == bytes([1, 0, ch, 0])  # PCM, channels
        assert int.from_bytes(raw[32:34], "little") == 3 * ch  # block align
        assert int.from_bytes(raw[34:36], "little") == 24
        got, rate, _ = read_audio(path)
        assert rate == 96000 and got.dtype == np.float32
        assert np.array_equal(got, pcm / np.float32(1 << 23))


# sha256 of (WAV file, int16 samples, float32 samples) from the writer and
# ``music_device`` as they were before 24-bit masters: seed
# 2^31 + 12345, cli_48k's 48 kHz, stereo, peaks in -1 to -0.1 dBFS, songs
# 0 and 5 of 144,007 samples
PARENT_16 = {
    0: ("f118b69c0f6be13dc22cc356917ba28acee5f50ac6a7b1c373716bafc5f3c13f",
        "a982e4d7ed41d77a8a5d64aba7dcff8d1ba2596db32e0061b9d06a0eb8085c46",
        "a1fc3012c638ad8a4c5052425faaf31c6ef56270b245a5cbafc27d7a599b78ee"),
    5: ("f34b028afd5bea43664919a966091494945febc757ccdcf346d15e787b396eb0",
        "8ec1a84914db6729c1016551de853c79f0787db704a8cfa4c67693c55009712f",
        "cb19155813cf8f86f845562391ee9b3410c260d7ff43c4c4d6e995440a11fc2e"),
}


@pytest.mark.parametrize("index", sorted(PARENT_16))
def test_16_bit_masters_are_unchanged(index, tmp_path):
    """cli_48k's catalogue makes the same samples and WAV bytes as before
    the writer took other depths."""
    x, q = music_device(bench_tiny.SEED, index, 2, 48000 * 3 + 7, 48000,
                        PEAK, torch.device("cpu"))
    assert q.dtype == torch.int16 and x.dtype == torch.float32
    path = tmp_path / "a.wav"
    write_wav(str(path), q.numpy(), 48000)
    got = tuple(hashlib.sha256(b).hexdigest() for b in (
        path.read_bytes(), q.numpy().tobytes(), x.numpy().tobytes()))
    assert got == PARENT_16[index]

"""Audio file I/O: WAV, AIFF, FLAC, W64, RF64, CAF, AU, Ogg Vorbis,
Ogg Opus, MP3 read/write with metadata passthrough.

Host code on numpy and ctypes, copied from ``phaserotate_tpu/io/`` (each
module says so): readers return numpy ``(channels, n)`` float32, and the
tensor is made at the entry point that computes.
"""

from .aiff import read_aiff, write_aiff
from .au import read_au, write_au
from .containers import (
    read_caf,
    read_rf64,
    read_w64,
    write_caf,
    write_rf64,
    write_w64,
)
from .audio import read_audio, read_audio_pcm16, write_audio
from .flac import FlacFormatError, read_flac, write_flac
from .mp3 import Mp3FormatError, read_mp3, write_mp3
from .opus import read_opus, write_opus
from .vorbis import OggFormatError, read_ogg
from .vorbisenc import write_ogg
from .wav import WavFormatError, WavMetadata, read_wav, write_wav

__all__ = [
    "FlacFormatError",
    "Mp3FormatError",
    "OggFormatError",
    "WavFormatError",
    "WavMetadata",
    "read_aiff",
    "read_au",
    "read_audio",
    "read_audio_pcm16",
    "read_caf",
    "read_flac",
    "read_mp3",
    "read_ogg",
    "read_opus",
    "read_rf64",
    "read_w64",
    "read_wav",
    "write_aiff",
    "write_au",
    "write_audio",
    "write_caf",
    "write_flac",
    "write_mp3",
    "write_ogg",
    "write_opus",
    "write_rf64",
    "write_w64",
    "write_wav",
]

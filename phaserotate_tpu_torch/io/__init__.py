"""Audio file I/O of the port: WAV only (other formats are not ported)."""

from .wav import WavFormatError, WavMetadata, read_wav, write_wav

__all__ = ["WavFormatError", "WavMetadata", "read_wav", "write_wav"]

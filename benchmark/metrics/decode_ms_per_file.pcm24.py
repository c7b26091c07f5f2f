"""Wall ms of a 24-bit WAV's exact read per file, on the fleet's staging
thread: the program's span ``fleet.decode`` around
``io.pcm24.read_pcm24_into`` (layer io).  The harness's wrapper of
``io.read_audio_pcm16``, which ``decode_ms_per_file`` reads, sees no
24-bit file."""

from harness.program import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "fleet.decode")

"""Wall ms of ``io.read_audio_pcm16`` per file, on the fleet's staging
thread (layer io)."""

from harness.readers import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "decode")

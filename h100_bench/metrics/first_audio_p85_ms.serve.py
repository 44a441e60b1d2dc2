"""The same times as `first_audio_p50_ms.serve`, 85th percentile by
nearest rank: the highest percentile with ten or more of the window's
requests beyond it at `tts-serve`'s 76 arrivals."""

from h100_bench.metrics._shared import first_audio_ms, nearest_rank


def read(run):
    return nearest_rank(first_audio_ms(run), 85)

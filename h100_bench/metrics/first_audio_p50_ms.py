"""Median over the window's requests of the time from when a request was
due (open loop) or sent (closed loop) to its first audio chunk on the
host, ms; a failed request counts as never served."""

from h100_bench.metrics._shared import first_audio_ms, nearest_rank


def read(run):
    return nearest_rank(first_audio_ms(run), 50)

"""Audio seconds delivered to clients inside the window over the window's
wall seconds (host clock): the card's speech output, 1 / RTF for one
stream, aggregate real time for many."""

from h100_bench.metrics._shared import tts_cfg


def read(run):
    samples = sum(n for r in run.requests for t, n in r.chunks if run.start <= t <= run.end)
    return samples / tts_cfg(run)["code2wav"]["sample_rate"] / (run.end - run.start)

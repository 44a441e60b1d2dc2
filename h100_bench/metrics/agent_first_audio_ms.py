"""The voice agent's pause before it speaks: the time from handing the
user's turn to the agent to the first audio chunk of the reply, ms (host
clock), as the mean over the reply lengths of each length's median turn;
a turn that failed or spoke nothing counts as never served."""

import math

from h100_bench.metrics._shared import turns_by_length


def _first_audio_ms(t):
    first = t["requests"][0].first if t["requests"] else None
    return (first - t["start"]) * 1e3 if t["error"] is None and first is not None else math.inf


def read(run):
    return turns_by_length(run, _first_audio_ms)

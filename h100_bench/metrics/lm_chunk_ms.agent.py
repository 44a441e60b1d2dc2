"""The text LM's chunk as the card serves it beside the TTS, ms: the median
length of the traced slice's `lm.chunk` spans of the mix's chunk length
(`lm_chunk` ids: one chunk graph's launch, the wait for its ids, the ids to
the host; a reply's shorter last chunk left out). Program spans."""

from h100_bench.metrics._shared import nearest_rank
from h100_bench.spans import of_run


def read(run):
    spans = of_run(run)
    if spans is None:
        return None
    n = str(run.mix["lm_chunk"])
    return nearest_rank([(b - a) / 1e3 for name, _i, d, _t, a, b in spans
                         if name == "lm.chunk" and d == n], 50)

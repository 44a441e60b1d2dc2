"""The host's share of a request's first audio, ms: from the start of its
`tts.setup` span (tokenizer, bucket, graphs of a new shape) to the end of
its first `tts.launch` (the first chunk's graph enqueued), the median over
the traced slice's requests that have both. Program spans."""

from h100_bench.metrics._shared import nearest_rank
from h100_bench.spans import of_run


def read(run):
    spans = of_run(run)
    if spans is None:
        return None
    setup = {i: a for n, i, _d, _t, a, _b in spans if n == "tts.setup"}
    first: dict = {}
    for n, i, _d, _t, a, b in sorted(spans, key=lambda s: s[4]):
        if n == "tts.launch" and i in setup and a >= setup[i]:
            first.setdefault(i, b)
    return nearest_rank([(first[i] - setup[i]) / 1e3 for i in first], 50)

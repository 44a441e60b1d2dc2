"""`Turn.first_sentence_s` (user turn to the LM's first finished sentence,
the program's own clock), ms: the mean over the reply lengths of each
length's median turn."""

from h100_bench.metrics._shared import turns_by_length


def read(run):
    return turns_by_length(run, lambda t: t["first_sentence_s"] * 1e3
                           if t["error"] is None and t.get("first_sentence_s") is not None
                           else None)

"""`Turn.first_audio_s - Turn.first_sentence_s`: the first audio chunk's
wait behind the LM's first sentence (the program's own clock), ms: the
mean over the reply lengths of each length's median turn."""

from h100_bench.metrics._shared import turns_by_length


def read(run):
    return turns_by_length(run, lambda t: (t["first_audio_s"] - t["first_sentence_s"]) * 1e3
                           if t["error"] is None and t.get("first_audio_s") is not None
                           and t.get("first_sentence_s") is not None else None)

"""Talker steps computed past a request's EOS or cap, % of all talker
steps in the window: (talker_steps - sum over requests of (frames kept +
1 for the codec_bos step)) / talker_steps, from `TTSEngine.get_metrics()`
at the window's two ends."""


def read(run):
    steps = run.counters1["talker_steps"] - run.counters0["talker_steps"]
    kept = sum(len(r.codes) + 1 for r in run.requests if r.ok)
    if steps <= 0:
        return None
    return 100.0 * (steps - kept) / steps

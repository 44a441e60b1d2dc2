"""Mean of `ContinuousBatcher.pending` (requests queued behind the slots),
sampled by the harness every `sample_ms` from the window's start to the
traced slice's end: stopping the profiler stalls the host for seconds
(collecting the slice's events), and the arrivals due meanwhile would
queue behind a stall that untraced runs do not have."""


def read(run):
    stop = run.summary.t1 if run.summary is not None else run.end
    xs = [p for t, p, _a in run.samples if run.start <= t <= min(stop, run.end)]
    return sum(xs) / len(xs) if xs else None

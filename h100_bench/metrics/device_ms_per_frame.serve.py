"""Device busy ms in the traced slice over the frames whose audio reached
a client in it (all slots together)."""

from h100_bench.metrics._shared import frames_between


def read(run):
    s = run.summary
    if s is None:
        return None
    frames, _pos = frames_between(run, s.t0, s.t1)
    return s.busy_s * 1e3 / frames if frames else None

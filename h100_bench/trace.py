"""The traced slice: `torch.profiler` over a few steady seconds in the
middle of the window, reduced to device intervals, kernel times by name,
idle gaps labelled by the host op that was running, and the program's
counters read at the slice's two ends.

The counters are device reads that wait for the work in flight, so every
launch they count between the two reads ran inside the profiled interval.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

NAME_CHARS = 120


@dataclass
class Summary:
    window_s: float                          # the traced interval
    busy_s: float                            # union of device intervals
    kernels: dict = field(default_factory=dict)   # name -> (seconds, count)
    gaps: list = field(default_factory=list)       # (host op, seconds), longest first
    c0: dict = field(default_factory=dict)         # counters at the slice's start
    c1: dict = field(default_factory=dict)         # and end
    t0: float = 0.0                          # host clock at the slice's ends
    t1: float = 0.0

    def kernel_s(self, part: str) -> tuple[float, int]:
        """Seconds and count of the kernels whose name contains `part`."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if part in name:
                s, n = s + sec, n + cnt
        return s, n

    def delta(self, key: str):
        return self.c1[key] - self.c0[key]


class Slice:
    """Starts the profiler once `tick()` runs past `start`, stops it once
    past `start + seconds`; `counters()` is read right after the start and
    right before the stop."""

    def __init__(self, start: float, seconds: float, counters):
        self.start, self.stop, self.counters = start, start + seconds, counters
        self.prof = None
        self.summary: Summary | None = None
        self._c0 = self._t0 = None
        self._c1 = self._t1 = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self.prof is None and self._t1 is None and now >= self.start:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._c0, self._t0 = self.counters(), time.perf_counter()
        elif self.prof is not None and self._t1 is None and now >= self.stop:
            self._c1, self._t1 = self.counters(), time.perf_counter()
            self.prof.__exit__(None, None, None)

    def reduce(self) -> Summary | None:
        """The slice's summary (after the window; None if it never ran)."""
        if self.prof is None:
            return None
        if self._t1 is None:           # the window ended first: close it here
            self._c1, self._t1 = self.counters(), time.perf_counter()
            self.prof.__exit__(None, None, None)
        self.summary = summarize(self.prof.events())
        self.summary.c0, self.summary.c1 = self._c0, self._c1
        self.summary.t0, self.summary.t1 = self._t0, self._t1
        self.prof = None
        return self.summary


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CUDA"


def summarize(events) -> Summary:
    """Device busy time, kernel sums and idle gaps of profiler events."""
    dev, host, kernels = [], [], {}
    for e in events:
        tr = e.time_range
        if _is_device(e):
            dev.append((tr.start, tr.end))
            name = e.name[:NAME_CHARS]
            s, n = kernels.get(name, (0.0, 0))
            kernels[name] = (s + (tr.end - tr.start) * 1e-6, n + 1)
        else:
            host.append((tr.start, tr.end, e.name[:NAME_CHARS]))
    if not dev:
        return Summary(window_s=0.0, busy_s=0.0)
    dev.sort()
    lo = min([d[0] for d in dev] + [h[0] for h in host])
    hi = max([d[1] for d in dev] + [h[1] for h in host])
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps += [(lo, merged[0][0]), (merged[-1][1], hi)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    host.sort()
    labelled = [(_host_at(host, (a + b) / 2), (b - a) * 1e-6) for a, b in gaps]
    return Summary(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, kernels=kernels,
                   gaps=labelled)


def _host_at(host: list, t: float) -> str:
    """The innermost host op running at `t` (the latest-starting one that
    covers it), or "idle host"."""
    best = None
    for a, b, name in host:
        if a > t:
            break
        if b >= t and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else "idle host"


def breakdown(s: Summary) -> dict:
    """The result line's `breakdown`: the ten device ops that took the most
    time in the slice, and the ten longest idle gaps by host op."""
    ops = sorted(((n, v[0]) for n, v in s.kernels.items()), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in s.gaps]}

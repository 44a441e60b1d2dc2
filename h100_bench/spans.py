"""The program's spans on the device trace's clock: the traced slice's idle
time split by what the host was doing, and its longest idle gaps named by
the program's phase.

The port records spans (`qwen_tts_tpu_torch/utils/timing.py::span`) on
`time.perf_counter_ns` while a profiler records, and `take_spans()` hands
them over. `anchor()` ties that clock to the profiler's: it opens
`record_function("qtts.clock")` on the calling thread and reads
`perf_counter_ns` inside it, so the event's start on the profiler's
timeline gives the offset, with no assumption about the profiler's clock
(the narrowest such event's, where there are several).
`SpanSlice` is `trace.Slice` with one anchor right after the profiler
starts and one right before it stops, and the program's spans taken when
it stops. Its summary is `trace.summarize`'s (the same busy time, kernels
and gap durations) with the spans on the profiler's timeline (`spans`),
the split of the idle time (`split`) and each of the ten longest gaps
labelled `<innermost open program span> > <host op>` where a span was open.

Each idle instant of the slice (no device interval covers it) goes to
"launch" if any thread is inside a `*.launch` span (a chunk graph's
enqueue), else to "program" if any thread is inside another program span,
else to "outside" (the caller's code, asyncio, the harness). The three
parts add up to the slice's idle time.

    python -m h100_bench.spans --workload <cell> --seed <n> --seconds <s> --trace 1

runs a cell as `h100_bench.run` does, on this slice: the result line's
`breakdown.idle_gaps` name the program's phase, and standard error gets one
line `spans: {...}` with the split (% of the slice), the anchors' skew and
each span name's count, total and median (ms). `trace.py` and the readers
take these in by a `benchmark` change; until then this command is how a
cell's idle time is split.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

from . import trace

CLOCK = "qtts.clock"
LAUNCH = ".launch"


def anchor() -> int:
    """`perf_counter_ns` read inside a `qtts.clock` range of the profiler."""
    from torch.profiler import record_function

    with record_function(CLOCK):
        return time.perf_counter_ns()


def on_trace(events, records: list, reads: list) -> tuple[list, dict]:
    """Span records (name, ident, detail, thread, start ns, end ns) on the
    profiler's timeline (us, as `time_range`), by the narrowest anchor (the
    one that bounds its clock read most tightly: a process's first range
    can be wide while the profiler warms up); and the anchors' fit:
    `skew_us`, the last anchor's offset less the first's (the clocks' drift
    over the slice), `width_us`, the widest anchor event (the bound on
    where inside it the clock was read)."""
    clocks = [e.time_range for e in events if e.name == CLOCK and not trace._is_device(e)]
    pairs = list(zip(clocks, reads))
    if not pairs:
        return [], {}
    offsets = [tr.start - r / 1e3 for tr, r in pairs]
    off = min(zip(pairs, offsets), key=lambda p: p[0][0].end - p[0][0].start)[1]
    spans = [(n, i, d, t, a / 1e3 + off, b / 1e3 + off) for n, i, d, t, a, b in records]
    fit = {"skew_us": offsets[-1] - offsets[0] if len(offsets) > 1 else None,
           "width_us": max(tr.end - tr.start for tr, _ in pairs)}
    return spans, fit


def merged(intervals) -> list[list[float]]:
    """The union of intervals, as sorted disjoint [start, end] pairs."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(a: list, b: list) -> float:
    """Total length of the intersection of two unions from `merged`."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_of(dev: list, lo: float, hi: float) -> list[list[float]]:
    """The idle intervals of [lo, hi]: where no device interval runs."""
    busy = merged(dev)
    edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
    return [[a, b] for a, b in zip(edges[::2], edges[1::2]) if b > a]


def split_idle(idle: list, spans: list) -> dict:
    """The idle intervals' time (us) by the priority rule: launch, program,
    outside."""
    launch = merged((s[4], s[5]) for s in spans if s[0].endswith(LAUNCH))
    anyone = merged((s[4], s[5]) for s in spans)
    total = sum(b - a for a, b in idle)
    in_launch, in_any = overlap(idle, launch), overlap(idle, anyone)
    return {"launch": in_launch, "program": in_any - in_launch, "outside": total - in_any}


def span_at(spans: list, t: float) -> str | None:
    """The innermost program span open at `t` (the latest-starting one that
    covers it, on any thread), or None."""
    best = None
    for name, _i, _d, _t, a, b in spans:
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else None


def summarize(events, spans: list) -> trace.Summary:
    """`trace.summarize(events)` with the program's spans (on the profiler's
    timeline): `spans`, `split` (us), `idle_in` (the idle us inside each span
    name's spans) and the gaps labelled."""
    s = trace.summarize(events)
    s.spans, s.split, s.idle_in = spans, {"launch": 0.0, "program": 0.0, "outside": 0.0}, {}
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if trace._is_device(e):
            dev.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name[:trace.NAME_CHARS]))
    if not dev:
        return s
    lo = min([d[0] for d in dev] + [h[0] for h in host])
    hi = max([d[1] for d in dev] + [h[1] for h in host])
    idle = idle_of(dev, lo, hi)
    s.split = split_idle(idle, spans)
    s.idle_in = {name: overlap(idle, merged((r[4], r[5]) for r in spans if r[0] == name))
                 for name in {r[0] for r in spans}}
    host.sort()
    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:10]
    s.gaps = []
    for a, b in gaps:
        label, inner = trace._host_at(host, (a + b) / 2), span_at(spans, (a + b) / 2)
        s.gaps.append((f"{inner} > {label}" if inner else label, (b - a) * 1e-6))
    return s


def take_program_spans() -> list:
    """The program's span records, taken; none from a program without spans."""
    try:
        from qwen_tts_tpu_torch.utils.timing import take_spans
    except ImportError:
        return []
    return take_spans()


def of_run(run) -> list | None:
    """The traced slice's program spans, (name, ident, detail, thread, start
    us, end us): the summary's where the slice took them (`SpanSlice`), else
    taken from the program once and kept on the summary. None without a
    slice or where the program has no spans (the readers then report
    nothing)."""
    s = run.summary
    if s is None:
        return None
    if getattr(s, "spans", None) is None:
        s.spans = [(n, i, d, t, a / 1e3, b / 1e3) for n, i, d, t, a, b in take_program_spans()]
    return s.spans or None


class SpanSlice(trace.Slice):
    """`trace.Slice` with the clocks anchored at the profiler's start and
    stop and the program's spans taken at the stop (see the module)."""

    def __init__(self, start: float, seconds: float, counters):
        super().__init__(start, seconds, counters)
        self.reads: list[int] = []
        self.records: list = []
        anchor()      # the range's first use sets it up, outside the profile

    def tick(self) -> None:
        on = self.prof is not None and self._t1 is None
        if on and time.perf_counter() >= self.stop:
            self.reads.append(anchor())
        super().tick()
        if not on and self.prof is not None and self._t1 is None:
            self.reads.append(anchor())
        elif on and self._t1 is not None:
            self.records = take_program_spans()

    def reduce(self) -> trace.Summary | None:
        if self.prof is None:
            return None
        if self._t1 is None:           # the window ended first: close it here
            self.reads.append(anchor())
            self._c1, self._t1 = self.counters(), time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.records = take_program_spans()
        events = self.prof.events()
        spans, fit = on_trace(events, self.records, self.reads)
        self.summary = summarize(events, spans)
        self.summary.c0, self.summary.c1 = self._c0, self._c1
        self.summary.t0, self.summary.t1 = self._t0, self._t1
        self.prof = None
        print("spans: " + json.dumps(report(self.summary, fit)), file=sys.stderr, flush=True)
        return self.summary


def report(s: trace.Summary, fit: dict) -> dict:
    """The split as % of the slice, the anchors' fit, each span name's
    count, total ms and median ms, and the idle time inside each name's
    spans (% of the slice; nested and concurrent spans each count it)."""
    window = s.window_s * 1e6
    by_name: dict = {}
    for name, _i, _d, _t, a, b in s.spans:
        by_name.setdefault(name, []).append((b - a) / 1e3)
    return {"idle_pct": 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 else None,
            "split_pct": {k: 100.0 * v / window if window > 0 else None
                          for k, v in s.split.items()},
            "anchor": fit,
            "idle_in_pct": {k: 100.0 * v / window for k, v in sorted(s.idle_in.items())
                            if window > 0},
            "by_name": {k: [len(v), sum(v), statistics.median(v)]
                        for k, v in sorted(by_name.items())}}


def main(argv=None) -> int:
    from . import run

    trace.Slice = SpanSlice    # `run.main` looks the slice up when it starts one
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())

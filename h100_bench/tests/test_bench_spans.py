"""The program's spans in the harness (`h100_bench/spans.py` and the readers
that read them): the idle split's priority rule and its sum, the summary
left as `trace.summarize` makes it where no program span was open, the gaps
named by the span open in them, the clock anchor placing a span around its
op's profiler event, the readers with and without spans, and a run leaving
no span records behind."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from h100_bench import spans, trace
from h100_bench.metrics._shared import idle_share
from h100_bench.run import Run, _reader
from h100_bench.tests import _tiny
from qwen_tts_tpu_torch.utils import timing


def ev(name, start, end, device=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=SimpleNamespace(name="CUDA" if device else "CPU"))


# device busy [0, 100), [150, 200), [260, 300), [500, 600); host ops around them
EVENTS = [ev("k1", 0, 100, True), ev("k2", 150, 200, True), ev("k1", 260, 300, True),
          ev("k3", 500, 600, True), ev("cudaGraphLaunch", 90, 170),
          ev("cudaLaunchKernel", 300, 420), ev("aten::copy_", 420, 640)]


def rec(name, a, b, ident=1, thread=7):
    return (name, ident, "", thread, a, b)


def test_the_idle_split_follows_its_priority_rule_and_sums_to_the_idle_share():
    # idle: [100, 150), [200, 260), [300, 500), [600, 640)
    on = [rec("tts.enqueue", 80, 180), rec("tts.launch", 95, 140),        # launch 40, program 10
          rec("lm.chunk", 190, 240, thread=8), rec("lm.launch", 230, 250, thread=8),
          rec("tts.tail_audio", 320, 400), rec("tts.read", 350, 380)]     # nested: counted once
    s = spans.summarize(EVENTS, on)
    split = s.split
    assert split["launch"] == pytest.approx(40 + 20)
    assert split["program"] == pytest.approx(10 + 30 + 80)
    assert split["outside"] == pytest.approx(10 + 120 + 40)
    run = SimpleNamespace(summary=s)
    parts = sum(100.0 * v / (s.window_s * 1e6) for v in split.values())
    assert parts == pytest.approx(idle_share(run), abs=1e-9)
    assert spans.summarize(EVENTS, []).split == {"launch": 0.0, "program": 0.0,
                                                 "outside": pytest.approx(350.0)}


def test_without_program_spans_the_summary_is_trace_summarize_s():
    old, new = trace.summarize(EVENTS), spans.summarize(EVENTS, [])
    assert (new.busy_s, new.window_s, new.kernels) == (old.busy_s, old.window_s, old.kernels)
    assert new.gaps == old.gaps
    assert [g[1] for g in spans.summarize(EVENTS, [rec("tts.read", 0, 700)]).gaps] == [
        g[1] for g in old.gaps]
    assert spans.summarize([ev("aten::add", 0, 5)], []).busy_s == 0.0


def test_the_longest_gaps_name_the_program_span_open_in_them():
    on = [rec("tts.tail_audio", 300, 500), rec("tts.read", 380, 460), rec("lm.chunk", 600, 640)]
    gaps = dict((round(d * 1e6), n) for n, d in spans.summarize(EVENTS, on).gaps)
    assert gaps == {200: "tts.read > cudaLaunchKernel", 60: "idle host",
                    50: "cudaGraphLaunch", 40: "lm.chunk > aten::copy_"}


def test_the_anchor_puts_the_records_on_the_profiler_timeline():
    # a wide first anchor (its clock read 300 us after its start) and a narrow one
    events = [ev(spans.CLOCK, 1000.0, 1400.0), ev(spans.CLOCK, 5000.0, 5002.0),
              ev(spans.CLOCK, 0.0, 9.0, device=True)]          # a device range: not an anchor
    reads = [7_000_300, 11_000_000]                             # ns
    on, fit = spans.on_trace(events, [rec("tts.launch", 7_001_000, 7_002_500)], reads)
    assert on[0][4:] == pytest.approx((1001.0, 1002.5))        # by the narrow anchor
    assert fit == {"skew_us": pytest.approx(0.3), "width_us": 400.0}
    assert spans.on_trace([], [rec("x", 1, 2)], [5]) == ([], {})


def _run(summary, mix=None):
    return Run(cfg={}, mix=mix or {"lm_chunk": 16}, summary=summary, start=0.0, end=1.0)


def test_a_span_on_the_profiler_clock_holds_its_op():
    a, b = torch.randn(384, 384), torch.randn(384, 384)

    def work():
        with record_function("warm"):   # a process's first range opens slowly
            pass
        reads = [spans.anchor()]
        with timing.span("op"):
            torch.mm(a, b)
        reads.append(spans.anchor())
        return reads

    timing.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reads = work()
    got, events = timing.take_spans(), prof.events()
    on, fit = spans.on_trace(events, got, reads)
    ((name, _i, _d, _t, s0, s1),) = on
    (mm,) = [e.time_range for e in events if e.name == "aten::mm"]
    assert name == "op" and s0 - 500 <= mm.start and mm.end <= s1 + 500
    assert abs(fit["skew_us"]) < 500


@pytest.mark.parametrize("name", ["first_launch_ms.stream", "lm_chunk_ms.agent"])
def test_the_span_readers_find_nothing_without_spans(name, monkeypatch):
    assert _reader(name)(_run(None)) is None
    monkeypatch.setattr(spans, "take_program_spans", lambda: [])
    assert _reader(name)(_run(trace.Summary(window_s=1.0, busy_s=0.5))) is None


def test_the_span_readers_values():
    ms = 1000.0                                               # us
    on = [rec("tts.setup", 0, 1, 5), rec("tts.launch", 3 * ms, 4 * ms, 5),
          rec("tts.launch", 9 * ms, 10 * ms, 5),             # its second launch: not read
          rec("tts.setup", 20 * ms, 21 * ms, 6), rec("tts.launch", 21 * ms, 22 * ms, 6),
          rec("tts.launch", 30 * ms, 31 * ms, 7),            # set up before the slice
          rec("tts.setup", 40 * ms, 40 * ms, 8), rec("tts.launch", 42 * ms, 46 * ms, 8)]
    s = trace.Summary(window_s=1.0, busy_s=0.5)
    s.spans = on
    assert _reader("first_launch_ms.stream")(_run(s)) == pytest.approx(4.0)   # of 4, 2, 6
    s.spans = [("lm.chunk", 1, d, 7, 0.0, v * ms)
               for d, v in (("16", 20.0), ("16", 22.0), ("3", 4.0), ("16", 21.0))]
    assert _reader("lm_chunk_ms.agent")(_run(s)) == pytest.approx(21.0)


def test_the_readers_take_the_program_spans_once(monkeypatch):
    taken = []
    monkeypatch.setattr(spans, "take_program_spans", lambda: taken.append(1) or [
        ("lm.chunk", 1, "16", 7, 0, 20_000_000)])                          # ns
    run = _run(trace.Summary(window_s=1.0, busy_s=0.5))
    assert _reader("lm_chunk_ms.agent")(run) == pytest.approx(20.0)
    assert _reader("first_launch_ms.stream")(run) is None and taken == [1]


# the agent's entry ticks the slice only as a turn starts: an 8 s window has
# turns starting inside its slice however slowly the CPU serves them
def test_a_run_leaves_no_span_records(capsys):
    from qwen_tts_tpu_torch.utils.timing import take_spans

    take_spans()
    _tiny.run(capsys, "tts-stream", 13, 1.0)
    assert take_spans() == []
    out = _tiny.run(capsys, "agent-turn", 13, 8.0, 1)
    assert out["metrics"]["lm_chunk_ms.agent"]["value"] > 0
    assert take_spans() == []


def test_the_span_slice_runs_a_cell_and_reports_its_split(capsys):
    real = trace.Slice
    try:
        assert spans.main(_tiny.argv("agent-turn", 12, 8.0, 1)) == 0
    finally:
        trace.Slice = real
    captured = capsys.readouterr()
    line = [x for x in captured.err.splitlines() if x.startswith("spans: ")][-1]
    got = json.loads(line[len("spans: "):])
    assert {"lm.prefill", "lm.chunk", "lm.launch", "tts.launch"} <= set(got["by_name"])
    assert got["anchor"]["width_us"] >= 0
    assert json.loads(captured.out.strip().splitlines()[-1])["correct"] is True

"""The port's spans (`qwen_tts_tpu_torch/utils/timing.py::span`).

Without a profiler a span records nothing and reads nothing but the
profiler's flag. Under `torch.profiler` it records from every thread, where
`record_function` records only on the profiler's own thread. Chunk graphs
with an owner record their launches and waits under it; the batcher's,
with none, record nothing. On the CPU a streamed request of the engine
records its set-up, each chunk's enqueue, launch, read and wait, and the
cut last chunk's decode, all under its request number, also when another
stream is interleaved with it; a text-LM stream records its prefill and
one span a chunk."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from qwen_tts_tpu_torch.core.config import CODEC_EOS, DecoderConfig, tiny_test_config
from qwen_tts_tpu_torch.core.weights import init_tts_weights
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.models import text_lm
from qwen_tts_tpu_torch.utils import timing

TEXT = "hello world"     # 2 words: a cap of 25 frames, chunks of 1, 10, 10 and 4 of 10
LONGER = "one two three four five six seven"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.take_spans()
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    """`fn()` under a CPU profiler; (its result, the spans it recorded,
    the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted(timing.take_spans(), key=lambda r: r[4]), prof


class _Flag:
    """The profiler's module as `span` sees it, counting reads of its flag."""

    def __init__(self):
        self.reads = 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return False


def test_a_span_without_a_profiler_records_nothing_and_reads_only_the_flag(monkeypatch):
    flag, clock = _Flag(), []
    monkeypatch.setattr(timing, "_profiler", flag)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: clock.append(1) or 0)
    monkeypatch.setattr(threading, "get_ident", lambda: clock.append(2) or 0)
    for i in range(100):
        with timing.span("tts.launch", i, ("chunk", 10)):
            pass
    assert flag.reads == 100 and clock == []
    assert timing.take_spans() == []


def test_spans_record_from_every_thread_where_record_function_does_not():
    def other():
        with timing.span("lm.chunk", 2, 16), record_function("other_range"):
            torch.ones(8).sum()

    early = timing.span("tts.setup", 9)
    early.__enter__()                      # opened before the profiler: not recorded

    def work():
        early.__exit__(None, None, None)
        with timing.span("tts.enqueue", 1), record_function("main_range"):
            torch.ones(8).sum()
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    _, got, prof = _profiled(work)
    assert [(r[0], r[1], r[2]) for r in got] == [("tts.enqueue", 1, ""), ("lm.chunk", 2, "16")]
    assert got[0][3] == threading.get_ident() != got[1][3]
    assert all(r[4] <= r[5] for r in got)
    names = {e.name for e in prof.events()}
    assert "main_range" in names and "other_range" not in names
    with timing.span("tts.read"):          # the profiler has stopped
        pass
    assert timing.take_spans() == []


def test_the_buffer_keeps_the_newest_records(monkeypatch):
    from collections import deque

    monkeypatch.setattr(timing, "_spans", deque(maxlen=3))
    _, got, _ = _profiled(lambda: [timing.span("x", i).__enter__().__exit__()
                                   for i in range(5)])
    assert [r[1] for r in got] == [2, 3, 4]


# ── the engine and the text LM ───────────────────────────────────────────


@pytest.fixture(scope="module")
def engine():
    """A tiny CPU engine whose talker never picks EOS: every request runs
    to its cap and ends with a cut chunk."""
    cfg = tiny_test_config(max_seq_len=256)
    w = init_tts_weights(0, cfg, "cpu")
    w.talker.lm_head[:, CODEC_EOS] = 0
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=10, seed=3),
                    model_config=cfg)
    eng.initialize(weights=w)
    return eng


def test_a_streamed_request_records_its_phases(engine):
    def work():
        return list(engine._generate_chunks(TEXT, 10, with_audio=True))

    chunks, got, _ = _profiled(work)
    assert [len(fr) for _a, fr in chunks] == [1, 10, 10, 4]
    names = [r[0] for r in got]
    assert {r[1] for r in got} == {engine._requests}
    assert names[0] == "tts.setup" and names[-1] == "tts.tail_audio"
    assert names.count("tts.tail_audio") == 1
    n = len(chunks)
    assert [names.count(k) for k in ("tts.enqueue", "tts.launch", "tts.read", "tts.wait")] == [
        n, n, n, n + 1]        # and the first chunk's wait for its slot's last reader
    enqueues = [r for r in got if r[0] == "tts.enqueue"]
    for launch in (r for r in got if r[0] == "tts.launch"):
        assert any(e[4] <= launch[4] and launch[5] <= e[5] for e in enqueues)


def test_interleaved_streams_record_under_their_own_request_numbers(engine):
    def work():
        streams = [iter(engine._generate_chunks(t, 10, with_audio=True)) for t in (TEXT, LONGER)]
        live, counts = list(streams), [0, 0]
        while live:
            for k, s in enumerate(streams):
                if s in live:
                    if next(s, None) is None:
                        live.remove(s)
                    else:
                        counts[k] += 1
        return counts

    r0 = engine._requests
    counts, got, _ = _profiled(work)
    assert {r[1] for r in got} == {r0 + 1, r0 + 2}
    for k, ident in enumerate((r0 + 1, r0 + 2)):
        names = [r[0] for r in got if r[1] == ident]
        assert names[0] == "tts.setup" and names.count("tts.tail_audio") == 1
        assert names.count("tts.launch") == names.count("tts.read") == counts[k]


@pytest.mark.parametrize("owner", ["lm", None])
def test_chunk_graphs_record_under_their_owner_or_not_at_all(owner):
    from qwen_tts_tpu_torch.runtime.chunk_graphs import ChunkGraphs

    g = ChunkGraphs(torch.device("cpu"), owner)
    ran = []

    def work():
        g.replay(("chunk", 4), lambda: ran.append(1), 5)
        g.record(0)
        g.wait(0, 5)

    _, got, _ = _profiled(work)
    assert ran == [1] and g.replays == 1
    expect = [] if owner is None else [("lm.launch", 5, "('chunk', 4)"), ("lm.wait", 5, "0")]
    assert [(r[0], r[1], r[2]) for r in got] == expect


@pytest.mark.parametrize("n_new,chunk", [(17, 4), (17, 16), (1, 8)])
def test_a_text_lm_stream_records_its_prefill_and_each_chunk(n_new, chunk):
    cfg = DecoderConfig(num_layers=2, hidden_size=256, intermediate_size=512, num_q_heads=4,
                        num_kv_heads=2, head_dim=128, vocab_size=1024, max_seq_len=128,
                        rope_theta=10000.0)
    lm = text_lm.TextLM(text_lm.init_text_lm_weights(0, cfg, "cpu"), cfg, device="cpu")
    lm.generate([1, 2, 3], 2)                  # stream 1
    out, got, _ = _profiled(lambda: list(lm.generate_stream([1, 2, 3, 4], n_new, chunk)))
    lengths = [len(ids) for ids in out[1:]]
    assert [r[0] for r in got if r[0] in ("lm.prefill", "lm.chunk")] == (
        ["lm.prefill"] + ["lm.chunk"] * len(lengths))
    assert [r[2] for r in got if r[0] == "lm.chunk"] == [str(n) for n in lengths]
    assert {r[1] for r in got} == {2}
    assert [r[0] for r in got].count("lm.launch") == 1 + len(lengths)

"""End-to-end metrics are taken over every request of the window."""

import math

import numpy as np
import pytest

from h100_bench.entries.common import Request
from h100_bench.run import Run, _reader

CFG = {"code2wav": {"sample_rate": 24000, "upsample_rates": [8, 5, 4, 3],
                    "upsampling_ratios": [2, 2]}}


def request(due, first_ms, chunks, end=None, error=None):
    r = Request(text="a b c.", due=due, cap=25, start=due)
    t = due + first_ms / 1e3
    for n in chunks:
        r.chunks.append((t, n))
        r.audio.append(np.zeros(n, np.float32))
        t += 0.1
    r.first = due + first_ms / 1e3 if chunks else None
    r.end = end if end is not None else t
    r.error = error
    return r


def run_of(requests, start=100.0, seconds=10.0):
    return Run(cfg=CFG, requests=requests, start=start, end=start + seconds)


def test_audio_rt_x_counts_audio_received_inside_the_window():
    reqs = [request(100.0 + i, 20.0, [24000] * 3) for i in range(10)]   # 3 s audio each
    reqs.append(request(109.95, 20.0, [24000] * 3))   # two of its chunks land after the close
    r = run_of(reqs)
    assert _reader("audio_rt_x")(r) == pytest.approx((30 + 1) * 24000 / 24000 / 10.0)


def test_percentiles_are_over_all_requests_and_failures_count_as_unserved():
    firsts = [float(i) for i in range(1, 201)]               # 1..200 ms
    reqs = [request(100.0 + i * 0.04, f, [1920]) for i, f in enumerate(firsts)]
    r = run_of(reqs)
    assert _reader("first_audio_p50_ms")(r) == pytest.approx(100.0)
    assert _reader("first_audio_p85_ms.serve")(r) == pytest.approx(170.0)
    reqs[0] = request(100.0, 1.0, [], error="boom")          # the fastest one fails
    r = run_of(reqs)
    assert _reader("first_audio_p50_ms")(r) == pytest.approx(101.0)
    outside = reqs + [request(99.0, 5000.0, [1920])]        # due before the window: not its
    assert _reader("first_audio_p85_ms.serve")(run_of(outside)) == pytest.approx(171.0)


def test_agent_first_audio_weighs_each_reply_length_alike():
    turns = []
    for i, (k, ms) in enumerate([(1, 40.0), (1, 44.0), (1, 41.0), (2, 50.0), (2, 52.0),
                                 (4, 70.0)]):
        req = request(100.0 + i + ms / 1e3, 0.0, [1920])
        turns.append({"start": 100.0 + i, "error": None, "sentences": k, "requests": [req],
                      "first_sentence_s": 0.03, "first_audio_s": ms / 1e3, "replies": []})
    r = Run(cfg=CFG, requests=[], turns=turns, start=100.0, end=110.0)
    # medians by length 41, 50 (nearest rank of 50, 52), 70
    assert _reader("agent_first_audio_ms")(r) == pytest.approx((41.0 + 50.0 + 70.0) / 3)
    assert _reader("lm_first_sentence_ms.agent")(r) == pytest.approx(30.0)
    assert _reader("audio_after_sentence_ms.agent")(r) == pytest.approx(
        (11.0 + 20.0 + 40.0) / 3)
    turns.append({"start": 106.0, "error": "lm failed", "sentences": 3, "requests": [],
                  "replies": []})
    assert math.isinf(_reader("agent_first_audio_ms")(r))     # a failed turn: never served
    turns.append({"start": 111.0, "error": None, "sentences": 5, "requests": [],
                  "first_sentence_s": 9.0, "first_audio_s": 9.0, "replies": []})
    assert _reader("lm_first_sentence_ms.agent")(r) == pytest.approx(30.0)   # after the close


def test_queue_depth_is_the_mean_over_the_window():
    r = Run(cfg=CFG, samples=[(99.0, 50, 0), (100.0, 1, 4), (105.0, 3, 4), (111.0, 9, 4)],
            start=100.0, end=110.0)
    assert _reader("queue_depth.serve")(r) == pytest.approx(2.0)


def test_overrun_share_from_the_engine_counters():
    reqs = [request(100.0, 20.0, [1920])]
    reqs[0].codes = [np.zeros(16)] * 99
    r = Run(cfg=CFG, requests=reqs, start=100.0, end=110.0,
            counters0={"talker_steps": 10}, counters1={"talker_steps": 111})
    assert _reader("overrun_frame_share.stream")(r) == pytest.approx(100.0 / 101)


def test_readers_find_nothing_without_a_trace():
    r = run_of([request(100.0, 20.0, [1920])])
    for name in ("device_idle_share", "device_idle_share.serve", "model_mfu",
                 "model_mfu.serve", "decode_step_roofline",
                 "decode_attention_roofline.serve", "device_ms_per_frame.serve"):
        assert _reader(name)(r) is None


def test_a_split_name_without_its_own_file_is_read_by_the_base_reader():
    from types import SimpleNamespace

    r = run_of([request(100.0, 20.0, [1920])])
    r.summary = SimpleNamespace(busy_s=3.0, window_s=4.0)
    assert _reader("device_idle_share.serve")(r) == _reader("device_idle_share")(r) == 25.0
    with pytest.raises(FileNotFoundError):
        _reader("no_such_metric.serve")

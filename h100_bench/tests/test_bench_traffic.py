"""The traffic generator reproduces from the seed, and every seed asks for
the same work in another order."""

from collections import Counter

from h100_bench import traffic

MIX = {"words": {"median": 10, "sigma": 0.5, "min": 3, "max": 30, "count": 64},
       "vocabulary": ["time", "flow", "light", "sound"], "arrivals": {"rate_per_s": 4.0}}


def test_same_seed_same_traffic():
    big = 2 ** 31 + 12345
    assert traffic.texts(MIX, big, 50) == traffic.texts(MIX, big, 50)
    assert traffic.arrivals(MIX, 51, big) == traffic.arrivals(MIX, 51, big)
    assert traffic.texts(MIX, big, 50) != traffic.texts(MIX, big + 1, 50)


def test_seeds_share_one_multiset_of_lengths_and_gaps():
    a = [len(t.split()) for t in traffic.texts(MIX, 1, 64)]
    b = [len(t.split()) for t in traffic.texts(MIX, 2, 64)]
    assert Counter(a) == Counter(b) and a != b
    assert min(a) >= 3 and max(a) <= 30 and sorted(a)[32] == 10

    def gaps(seed):
        t = traffic.arrivals(MIX, 51, seed)
        return sorted(round(y - x, 9) for x, y in zip([0.0] + t, t))
    assert gaps(1) == gaps(2)


def test_arrivals_fill_the_window_at_the_rate():
    t = traffic.arrivals(MIX, 51, 7)
    assert len(t) == 204 and t == sorted(t)
    assert 0 < t[0] and t[-1] < 51 and t[-1] > 50


def test_choices_take_each_item_equally_often():
    picks = traffic.choices(["a", "b", "c"], 5, 30)
    assert Counter(picks) == {"a": 10, "b": 10, "c": 10}


def test_bursty_arrivals_keep_the_rate_and_share_their_gaps():
    mix = dict(MIX, arrivals={"rate_per_s": 1.5, "kind": "gamma", "cv": 3.0})
    a, b = traffic.arrivals(mix, 51, 1), traffic.arrivals(mix, 51, 2)
    assert len(a) == 76 and a[-1] < 51 and a != b
    ga = sorted(round(y - x, 9) for x, y in zip([0.0] + a, a))
    gb = sorted(round(y - x, 9) for x, y in zip([0.0] + b, b))
    assert ga == gb
    import statistics
    assert statistics.pstdev(ga) / statistics.mean(ga) > 2.0


def test_every_request_runs_to_its_cap_whatever_the_seed():
    import json

    import torch

    from h100_bench import weights
    from h100_bench.reference import qwen3, tts
    from h100_bench.tests._tiny import HERE

    cfg = json.loads((HERE / "tiny-tts.json").read_text())
    for seed in (1, 2):
        w = weights.make_tts(cfg, seed, torch.device("cpu"))
        assert not w["talker.lm_head"][:, tts.CODEC_EOS].any()
        x = tts.talker_inputs(w, "time flow light.", torch.zeros(0, 16, dtype=torch.long))
        logits = qwen3.forward(w, "talker", cfg["talker"], x[None])[0] @ w["talker.lm_head"].float()
        assert (logits.max(-1).values > logits[:, tts.CODEC_EOS]).all()

"""Whole runs of the harness on the CPU at tiny sizes: the result line's
keys, the reference agreeing with the port's plain path, and each fault a
cell can have, planted under the timed path, turning `correct` false."""

import json

import pytest
import torch

from h100_bench.tests import _tiny

ROOT = _tiny.ROOT
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_last_line_has_the_contract_keys(capsys):
    out = _tiny.run(capsys, "tts-stream")
    assert list(out) == CONTRACT + ["checks"]
    e2e = [m["name"] for m in bench()["end_to_end"]
           if "tts-stream" in m.get("workloads", ["tts-stream"])]
    assert sorted(out["metrics"]) == sorted(e2e)
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_a_traced_run_adds_the_trace_keys(capsys):
    out = _tiny.run(capsys, "tts-stream", 12, 2.0, 1)
    assert list(out) == CONTRACT + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["tts-stream", "agent-turn", "tts-serve"])
def test_the_reference_agrees_with_the_port_plain_path(capsys, cell):
    out = _tiny.run(capsys, cell, 21, 1.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def _token_plus_one(monkeypatch):
    from qwen_tts_tpu_torch.runtime import frame_loop

    real = frame_loop.decode_step_with_embed

    def altered(*a, **k):
        state, tok, normed = real(*a, **k)
        return state, (tok + 1) % 2048, normed
    monkeypatch.setattr(frame_loop, "decode_step_with_embed", altered)


def _state_unchanged(monkeypatch):
    from qwen_tts_tpu_torch.models import decoder

    monkeypatch.setattr(decoder, "_write_columns", lambda *a, **k: None)


def _cp_token_altered(monkeypatch):
    from qwen_tts_tpu_torch.models import code_predictor

    real = code_predictor.sample_logits
    monkeypatch.setattr(code_predictor, "sample_logits",
                        lambda *a, **k: (real(*a, **k) + 1) % 2048)


def _audio_altered(monkeypatch):
    from qwen_tts_tpu_torch.engine import tts_engine

    real = tts_engine.code2wav_apply_packed
    monkeypatch.setattr(tts_engine, "code2wav_apply_packed",
                        lambda *a, **k: real(*a, **k) * 0.98)


def _lm_token_altered(monkeypatch):
    from qwen_tts_tpu_torch.models import text_lm

    real = text_lm.generate_tokens

    def altered(*a, **k):
        state, tokens = real(*a, **k)
        return state, (tokens + 1) % 512
    monkeypatch.setattr(text_lm, "generate_tokens", altered)


def _half_the_batch(monkeypatch):
    from qwen_tts_tpu_torch.runtime import continuous

    real = continuous.batched_frames

    def half(*a, **k):
        state, codes, valid, tok, hid = real(*a, **k)
        b = codes.shape[0] // 2
        codes[b:] = codes[:codes.shape[0] - b].clone()
        return state, codes, valid, tok, hid
    monkeypatch.setattr(continuous, "batched_frames", half)


FAULTS = {
    "tts-stream": [_token_plus_one, _state_unchanged, _cp_token_altered, _audio_altered],
    "agent-turn": [_lm_token_altered, _token_plus_one],
    "tts-serve": [_half_the_batch, _token_plus_one],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_planted_fault_makes_the_run_incorrect(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _tiny.run(capsys, cell, 31, 1.0)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell,temperature", [("tts-stream", 2.0), ("tts-stream", 0.3),
                                               ("agent-turn", 0.3)])
def test_sampling_at_another_temperature_makes_the_run_incorrect(capsys, tmp_path, cell,
                                                                 temperature):
    """The program's code predictor samples at another temperature than the
    configuration's (the reference's): every code stays inside the top k,
    so only the sampled codes' distribution, `cp_sample_z`, can tell. The
    window is long enough for several requests to finish on a slow CPU: z
    grows with the square root of the codes sampled."""
    mix = json.loads((_tiny.HERE / f"tiny-{cell}.json").read_text())
    mix["engine"] = {**mix.get("engine", {}), "subtalker_temperature": temperature}
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    out = _tiny.run(capsys, cell, 33, 8.0, 0, "--traffic-file", str(path))
    assert out["checks"]["cp_gap"]["value"] <= out["checks"]["cp_gap"]["limit"]
    assert out["checks"]["cp_sample_z"]["value"] > out["checks"]["cp_sample_z"]["limit"]
    assert out["correct"] is False


def test_no_jax_in_the_process_after_a_run(capsys):
    import sys

    from h100_bench.run import FORBIDDEN, loaded_forbidden

    _tiny.run(capsys, "tts-stream", 41, 1.0)
    found = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
    assert loaded_forbidden() == [] and found == []
    assert torch.get_num_threads() >= 1

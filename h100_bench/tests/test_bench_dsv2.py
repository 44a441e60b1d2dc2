"""The `deepseek_v2` family (`agent-turn-dsv2-lite`) on the CPU at a tiny
size (`tiny-dsv2-agent.json`: one dense and two MoE layers, 8 experts at
top-2 and a shared expert, latent 32, rope 8 with YaRN): the cell runs
through the agent entry and its readers; a planted LM fault turns
`correct` false; the two kernel rooflines read None when the kernel's own
count or the trace disagrees with the host's steps."""

import json
from types import SimpleNamespace

import pytest

from h100_bench.tests import _tiny

HERE = _tiny.HERE
CELL = "agent-turn-dsv2-lite"
LOGIT_CHECK = "lm_logit_median"     # the program's teacher-forced logits against the reference's


def run_cell(capsys, seed: int, trace: int) -> dict:
    from h100_bench import run as bench

    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "1.5", "--trace", str(trace),
            "--device", "cpu", "--config-file", str(HERE / "tiny-dsv2-agent.json"),
            "--traffic-file", str(HERE / "tiny-agent-turn.json")]
    assert bench.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_family_runs_the_agent_cell_and_its_readers(capsys):
    out = run_cell(capsys, 7, 1)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"talker_gap", "cp_gap", "audio_err", "lm_gap", "failed",
                                  "cp_sample_z", LOGIT_CHECK}
    # no device trace on the CPU: the device readers report nothing, the LM's spans do
    assert "moe_experts_roofline" not in out["metrics"]
    assert "lm_first_sentence_ms.agent" in out["metrics"]


def _shared_expert_dropped(monkeypatch):
    import torch
    from qwen_tts_tpu_torch.ops import moe

    for name in ("moe_experts_decode", "moe_experts_prefill"):
        form = getattr(moe, name)
        monkeypatch.setattr(moe, name, lambda x, h, ids, w, gu, down, sgu, sdown, count, f=form:
                            f(x, h, ids, w, gu, down, torch.zeros_like(sgu), sdown, count))


def _rope_not_interleaved(monkeypatch):
    import torch
    from qwen_tts_tpu_torch.models import deepseek_v2 as ds

    def half_split(x, cos, sin):
        d = x.shape[-1]
        return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1) * sin
    monkeypatch.setattr(ds, "rotate", half_split)


def _top_k_minus_one(monkeypatch):
    import torch
    from qwen_tts_tpu_torch.models import deepseek_v2 as ds

    route = ds.route

    def fewer(cfg, h, router):      # the last of the k chosen experts weighs nothing
        ids, w = route(cfg, h, router)
        return ids, torch.cat([w[:, :-1], torch.zeros_like(w[:, -1:])], dim=-1)
    monkeypatch.setattr(ds, "route", fewer)


# Each fault turns `correct` false through the LM number named beside it:
# dropping one of the tiny model's two routed experts moves the served ids
# little (`lm_gap` 0.0-0.27 over seeds 7-10 on 3-6 checked ids) but every
# row's logits (`lm_logit_median` 0.085-0.17 against 0.007-0.010 sound).
@pytest.mark.parametrize("fault,number", [(_shared_expert_dropped, "lm_gap"),
                                          (_rope_not_interleaved, "lm_gap"),
                                          (_top_k_minus_one, LOGIT_CHECK)],
                         ids=["shared_expert_dropped", "rope_not_interleaved", "top_k_minus_one"])
def test_a_planted_lm_fault_turns_correct_false(capsys, monkeypatch, fault, number):
    fault(monkeypatch)
    out = run_cell(capsys, 7, 0)
    check = out["checks"][number]
    assert out["correct"] is False and check["value"] > check["limit"], out["checks"]


def fake_run(trace_events: int, kernel_launches: int, form: str):
    """A traced slice of 10 LM steps of the full configuration (30 steps over
    the run, 4 of them warm-up), its trace and the kernel reading the given
    counts of `form`'s launches."""
    from h100_bench import families
    from h100_bench.run import Run

    cfg = json.loads((HERE.parent / "configs" / "deepseek-v2-lite-voice-agent.json").read_text())
    family = families.load(cfg)
    summary = SimpleNamespace(c0={"lm_steps": 0}, delta={"lm_steps": 10}.__getitem__,
                              kernel_s=lambda part: (0.05, trace_events) if part == form
                              else (0.0, 0))
    lm = SimpleNamespace(steps=26, warm_steps=4,
                         kernel_launches=lambda: {form: kernel_launches})
    replies = [{"prompt": [1] * 64, "reply": [2] * 20, "times": []}]
    return Run(cfg=cfg, summary=summary, turns=[{"replies": replies}], lm_family=family,
               lm_cfg=family.lm_config(cfg), state={"lm": lm})


@pytest.mark.parametrize("metric,form,layers", [
    ("moe_experts_roofline", "moe_experts_decode", 26),
    ("mla_attention_roofline", "mla_decode_attn", 27)])
def test_the_kernel_rooflines_read_none_when_the_counts_disagree(metric, form, layers):
    from h100_bench.run import _reader

    read = _reader(metric)
    sound = read(fake_run(10 * layers, 30 * layers, form))
    assert sound is not None and 0 < sound < 100
    assert read(fake_run(10 * layers - 1, 30 * layers, form)) is None      # a layer unseen
    assert read(fake_run(10 * layers, 30 * layers - 1, form)) is None      # a launch skipped

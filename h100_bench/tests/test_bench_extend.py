"""A later change adds a configuration, a traffic mix, a per-layer metric,
a text-LM family and a cell as new files and new entries in
`BENCHMARK.json` alone: here they are added to a copy of the benchmark,
whose harness files are left as they are, and the new cell runs and
reports the new metric."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from h100_bench.tests import _tiny

ROOT = _tiny.ROOT

READER = '''"""Requests sent in the window a second (a new reader, a new file)."""


def read(run):
    return len(run.requests) / (run.end - run.start)
'''


def test_a_new_cell_needs_only_new_files(tmp_path):
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "h100_bench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    hb = tmp_path / "h100_bench"
    (hb / "configs" / "tiny-tts.json").write_text((hb / "tests" / "tiny-tts.json").read_text())
    mix = json.loads((hb / "tests" / "tiny-tts-stream.json").read_text())
    mix["words"] = {"median": 2, "sigma": 0.1, "min": 2, "max": 3, "count": 4}
    (hb / "traffic" / "short-words.json").write_text(json.dumps(mix))
    (hb / "limits" / "tiny.short").with_suffix(".short.json").write_text(
        (hb / "limits" / "tts-stream.json").read_text())
    (hb / "metrics" / "requests_per_s.py").write_text(READER)
    bench["configs"].append({"name": "tiny-tts", "source": "https://example.org/tiny",
                             "file": "h100_bench/configs/tiny-tts.json", "reduced": [],
                             "why": "a tiny stand-in"})
    bench["workloads"].append({"name": "tiny.short", "config": "tiny-tts",
                               "traffic": "short-words", "chips": 1, "why": "short sentences"})
    bench["per_layer"].append({"name": "requests_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "audio_rt_x",
                               "workloads": ["tiny.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "tiny.short",
                          "--seed", "5", "--seconds", "1", "--trace", "1", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["metrics"]["requests_per_s"]["value"] > 0
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == []


def test_a_checkout_of_only_the_benchmark_refuses_to_run(tmp_path):
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "tts-stream",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


FAMILY = '''"""A text-LM family added as a new file: the port's `TextLM` over the
sizes under the configuration's `lm` key, held to the plain reference;
its steps counted outside B1."""

from h100_bench import check, weights
from h100_bench.reference import lm

GAP = {gap!r}          # added to every gap the reference reads


def lm_config(cfg):
    return dict(cfg["lm"])


def make_weights(cfg, seed, device):
    return weights.make_lm(cfg, seed, device)


def build(run, w):
    from qwen_tts_tpu_torch.core.config import DecoderConfig
    from qwen_tts_tpu_torch.models.text_lm import TextLM

    dc = DecoderConfig(**run.lm_cfg)
    return TextLM(weights.program_lm(w, dc, run.device), dc, device=run.device)


def check_numbers(w, cfg, replies, plan, seed):
    return check.lm_numbers(replies, plan, seed,
                            lambda p, r, s: lm.reply_gaps(w, cfg, p, r, s) + GAP)


def token_flops(cfg, pos):
    return {token_flops!r}


def prefill_flops(cfg, P):
    return 0.0


def b1_step_cost(cfg, pos):
    return None
'''
LM_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "hidden_size",
           "intermediate_size": "intermediate_size", "num_attention_heads": "num_q_heads",
           "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
           "vocab_size": "vocab_size", "rope_theta": "rope_theta",
           "rms_norm_eps": "rms_eps", "max_position_embeddings": "max_seq_len"}


def tiny_lm_agent(hb) -> dict:
    """The tiny agent configuration with its LM's sizes under `lm` and the
    family `tinylm`: no Qwen3 key left at the top level."""
    cfg = json.loads((hb / "tests" / "tiny-agent.json").read_text())
    cfg["lm"] = {new: cfg.pop(old) for old, new in LM_KEYS.items()}
    cfg["lm_family"] = "tinylm"
    return cfg


def roofline_of(family, cfg, lm_steps):
    """`decode_step_roofline` over a traced slice of 10 talker and 10
    code-predictor steps and `lm_steps` text-LM steps, at a fixed device time
    and with every launch seen."""
    from h100_bench.run import Run, _reader

    steps = {"talker_steps": 10, "cp_steps": 10, "lm_steps": lm_steps,
             "decode_launches": 20 + lm_steps}
    summary = SimpleNamespace(t0=0.0, t1=1.0, c0={k: 0 for k in steps},
                              delta=steps.__getitem__,
                              kernel_s=lambda part: (0.01, 20 + lm_steps))
    replies = [{"prompt": [1] * 64, "reply": [2] * 8, "times": []}]
    run = Run(cfg=cfg, summary=summary, turns=[{"replies": replies}], lm_family=family,
              lm_cfg=family.lm_config(cfg))
    return _reader("decode_step_roofline")(run)


@pytest.mark.parametrize("gap", [0.0, 1.0], ids=["sound", "gap_above_its_limit"])
def test_a_new_lm_family_needs_only_new_files(tmp_path, gap):
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    hb = tmp_path / "h100_bench"
    before = {p: p.read_bytes() for p in hb.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (hb / "families" / "tinylm.py").write_text(FAMILY.format(gap=gap, token_flops=1e18))
    (hb / "configs" / "tiny-lm-agent.json").write_text(json.dumps(tiny_lm_agent(hb)))
    (hb / "traffic" / "tiny-agent.json").write_text(
        (hb / "tests" / "tiny-agent-turn.json").read_text())
    (hb / "limits" / "tiny.agent.json").write_text(
        (hb / "limits" / "agent-turn.json").read_text())
    bench["configs"].append({"name": "tiny-lm-agent", "source": "https://example.org/tiny",
                             "file": "h100_bench/configs/tiny-lm-agent.json", "reduced": [],
                             "why": "a tiny stand-in"})
    bench["workloads"].append({"name": "tiny.agent", "config": "tiny-lm-agent",
                               "traffic": "tiny-agent", "chips": 1, "why": "a tiny agent"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "agent-turn" in m.get("workloads", []):
            m["workloads"].append("tiny.agent")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "tiny.agent",
                          "--seed", "6", "--seconds", "1", "--trace", "1", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    checks = result["checks"]
    assert checks["lm_gap"]["value"] >= gap and result["correct"] is (gap == 0.0), checks
    assert all(c["value"] <= c["limit"] for k, c in checks.items() if k != "lm_gap")
    # 1e18 FLOPs a reply id: only the family's count reads this high
    assert result["metrics"]["model_mfu"]["value"] > 1e3
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == []

    spec = importlib.util.spec_from_file_location("tinylm", hb / "families" / "tinylm.py")
    tinylm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tinylm)
    from h100_bench.families import qwen3

    cfg = tiny_lm_agent(hb)
    assert roofline_of(tinylm, cfg, 50) == roofline_of(tinylm, cfg, 0)
    qcfg = json.loads((hb / "tests" / "tiny-agent.json").read_text())
    assert roofline_of(qwen3, qcfg, 50) > roofline_of(qwen3, qcfg, 0)

"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files and new entries in `BENCHMARK.json` alone: here
they are added to a copy of the benchmark, whose harness files are left
as they are, and the new cell runs and reports the new metric."""

import json
import os
import shutil
import subprocess
import sys

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

"""Run the harness in this process on the CPU at tiny sizes beside this
file, and read its result line.

A cell that `BENCHMARK.json` does not list yet but that this folder keeps
as `<cell>-cell.json` (its entries, as a later change would add them) runs
from a root whose `BENCHMARK.json` adds them."""

from __future__ import annotations

import json
import tempfile
from functools import lru_cache
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
CONFIGS = {"tts-stream": "tiny-tts", "tts-serve": "tiny-tts", "agent-turn": "tiny-agent"}


@lru_cache(maxsize=None)
def root_of(cell: str) -> Path:
    later = HERE / f"{cell}-cell.json"
    if not later.exists():
        return ROOT
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in json.loads(later.read_text()).items():
        bench[key] += entries
    root = Path(tempfile.mkdtemp(prefix="h100_bench_root_"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def argv(cell: str, seed: int = 11, seconds: float = 2.0, trace: int = 0, *extra) -> list:
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), "--device", "cpu", "--root", str(root_of(cell)),
            "--config-file", str(HERE / f"{CONFIGS[cell]}.json"),
            "--traffic-file", str(HERE / f"tiny-{cell}.json"), *extra]


def run(capsys, cell: str, *args) -> dict:
    from h100_bench import run as bench

    assert bench.main(argv(cell, *args)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

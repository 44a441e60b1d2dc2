"""On the card, at each cell's own size, on three seeds: the control comes
out as not correct (the configuration's lower-precision path served in the
program's place: int8 weights and int8 KV in the talker, the code
predictor and the text LM; Code2Wav's decode in TF32, the reference in
the program's place), and so does the code predictor sampling at
temperature 1.0 where the configuration says 0.9 (the mix's engine
settings reach the program alone; the check reads the configuration's).
The benchmark's own runs never run either.

    python -m pytest h100_bench/tests/test_bench_control_card.py -q -s

(from the checkout's root, on a machine with the card; skipped without one)
"""

import json
import subprocess
import sys

import pytest

from h100_bench.tests import _tiny

SEEDS = (4100000001, 4100000002, 4100000003)
CELLS = ["tts-stream", "agent-turn"]


def checks(cell, seed, *extra):
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", cell,
                          "--seed", str(seed), "--seconds", "30", "--trace", "0", *extra],
                         cwd=_tiny.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    print(cell, seed, extra[:1], {k: c["value"] for k, c in result["checks"].items()})
    return result


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    for seed in SEEDS:
        assert checks(cell, seed, "--control")["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_sampling_at_temperature_one_is_not_correct(card, tmp_path, cell):
    bench = json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())
    traffic = next(w["traffic"] for w in bench["workloads"] if w["name"] == cell)
    mix = json.loads((_tiny.ROOT / "h100_bench" / "traffic" / f"{traffic}.json").read_text())
    mix["engine"] = {**mix.get("engine", {}), "subtalker_temperature": 1.0}
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    for seed in SEEDS:
        result = checks(cell, seed, "--traffic-file", str(path))
        assert result["checks"]["cp_sample_z"]["value"] > result["checks"]["cp_sample_z"]["limit"]
        assert result["correct"] is False

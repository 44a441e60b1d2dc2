"""One run of one benchmark cell.

    python -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root. The cell, its configuration and its traffic
mix are looked up by name in `BENCHMARK.json`: the configuration's sizes
in `configs/<config>.json`, the mix in `traffic/<mix>.json` (whose
`entry` names the module under `entries/` that drives it), the limits of
the correctness check in `limits/<cell>.json`, each metric's reader in
`metrics/<metric>.py`, an agent configuration's text LM in
`families/<lm_family>.py`. Set-up makes the weights on the card from the
seed, builds the program and warms the shapes the mix uses; the window then
runs for `--seconds`; with `--trace 1` a slice in its middle is profiled
and the per-layer metrics are read, otherwise the end-to-end ones. After
the window the program is freed and a sample of the served outputs is
held to the plain float32 reference (`check.py`). The last line of
standard output is the result's JSON object; the numbers compared and
their limits are the last lines of standard error.

`--control` serves the configuration's lower-precision path instead (the
control that the check has to fail); `--device cpu` runs everything on
the CPU without looking for a card (for the harness's own tests).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen_tts_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def loaded_forbidden() -> list[str]:
    """Top-level modules of JAX or of the JAX package that are loaded
    (names compared whole: `qwen_tts_tpu_torch` is not `qwen_tts_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(v):
    """A number for the JSON line: a non-finite reading as 1e30."""
    return v if math.isfinite(v) else 1e30


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Run:
    """Everything one run carries between the entry module, the readers and the check."""

    def __init__(self, **kw):
        self.state: dict = {}
        self.requests: list = []
        self.turns: list = []
        self.samples: list = []
        self.lateness: list = []
        self.slice = None
        self.summary = None
        self.counters0 = self.counters1 = None
        self.lm_family = self.lm_cfg = None      # an agent's text-LM family and its sizes
        self.__dict__.update(kw)

    def tick(self) -> None:
        if self.slice is not None:
            self.slice.tick()


def _reader(name: str):
    """`metrics/<name>.py`'s `read`; where there is no such file, that of the
    name without its last `.suffix` (`device_idle_share.serve` is read by
    `device_idle_share.py`: one reader for a quantity split by cells)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones, or with
    the trace the per-layer ones, of every entry that names the cell or
    names no cells."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def build_library() -> str:
    """Load the program's CUDA library, timing nvcc when it has to build it."""
    from qwen_tts_tpu_torch.ops import cuda_lib

    before = set(cuda_lib.BUILD_DIR.glob("*.so")) if cuda_lib.BUILD_DIR.exists() else set()
    t = time.perf_counter()
    cuda_lib.load_library()
    s = time.perf_counter() - t
    built = set(cuda_lib.BUILD_DIR.glob("*.so")) - before
    return (f"build: nvcc built {', '.join(p.name for p in built)} in {s:.1f} s" if built
            else f"build: library already built, loaded in {s:.2f} s")


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="serve the configuration's lower-precision path (the check's control)")
    ap.add_argument("--device", default="cuda", help="cpu: the harness's own tests")
    ap.add_argument("--config-file", help="a configuration file in place of the cell's")
    ap.add_argument("--traffic-file", help="a traffic file in place of the cell's")
    ap.add_argument("--root", default=".", help="the checkout's root")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = Path(args.root).resolve()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        say(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads(Path(args.config_file or root / conf["file"]).read_text())
    mix = json.loads(Path(args.traffic_file or HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())

    # caches of anything that compiles, inside the checkout at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(root / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            say(f"this cell needs {cell['chips']} CUDA device(s); "
                f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        say("card:", nvidia_smi())
        say(build_library())
        torch.cuda.reset_peak_memory_stats()
    device = torch.device(args.device)

    from . import check, families, weights

    family = lm_cfg = None
    if "tts" in cfg:                   # an agent configuration: its text LM's family
        try:
            family = families.load(cfg)
        except LookupError as e:
            say(e)
            return 2
        lm_cfg = family.lm_config(cfg)
    tts_cfg = cfg.get("tts", cfg)
    w = weights.make_tts(tts_cfg, args.seed, device)
    w.update(weights.make_code2wav(tts_cfg["code2wav"], args.seed + 1, device))
    if family is not None:
        w.update(family.make_weights(lm_cfg, args.seed + 2, device))
    entry = importlib.import_module(f"h100_bench.entries.{mix['entry']}")
    run = Run(cfg=cfg, mix=mix, seed=args.seed, seconds=args.seconds, device=device,
              control=args.control, weights=w, lm_family=family, lm_cfg=lm_cfg)
    entry.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize()
    run.counters0 = entry.counters(run)
    run.setup_s = process_age()
    run.start = time.perf_counter()
    run.end = run.start + args.seconds
    if args.trace:
        from .trace import Slice

        slice_s = min(mix["trace_slice_s"], args.seconds)
        run.slice = Slice(run.start + (args.seconds - slice_s) / 2, slice_s,
                          lambda: entry.counters(run))
    entry.window(run)
    run.counters1 = entry.counters(run)
    if run.slice is not None:
        run.summary = run.slice.reduce()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        v = _reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": _finite(v), "unit": m["unit"]}
    if run.lateness:
        lat = sorted(run.lateness)
        say(f"generator lateness: median {lat[len(lat) // 2] * 1e3:.3f} ms, "
            f"max {lat[-1] * 1e3:.3f} ms over {len(lat)} arrivals")
    failed = sum(not r.ok for r in run.requests) + sum(t.get("error") is not None
                                                       for t in run.turns)
    attempted = len(run.requests)
    replies = [rp for t in run.turns if t.get("error") is None for rp in t["replies"]]
    entry.release(run)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = check.tts_numbers(w, tts_cfg, run.requests, mix["check"], args.seed, device,
                                control=args.control)
    if family is not None:
        numbers.update(family.check_numbers(w, lm_cfg, replies, mix["check"], args.seed))
    numbers["failed"] = failed
    say(f"check: {numbers.get('frames_checked', 0)} frames, "
        f"{numbers.get('codes_sampled', 0)} sampled codes, "
        f"{numbers.get('tokens_checked', 0)} reply ids against the reference in "
        f"{time.perf_counter() - t:.1f} s")
    checks = {k: {"value": _finite(numbers[k]), "limit": v} for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = loaded_forbidden()
    if bad:
        say(f"refusing to report: {', '.join(bad)} loaded in this process")
        return 4
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace and run.summary is not None:
        from .trace import breakdown

        dev["busy_s"], dev["window_s"] = run.summary.busy_s, run.summary.window_s
        result["breakdown"] = breakdown(run.summary)
    result["checks"] = checks
    for k, c in checks.items():
        say(f"check {k}: {c['value']!r} limit {c['limit']!r}"
            + ("" if c["value"] <= c["limit"] else "  FAILS"))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

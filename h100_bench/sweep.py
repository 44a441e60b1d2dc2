"""Find the knee of an open-loop cell once: the highest arrival rate at
which the batcher's pending queue does not grow over the window.

    python -m h100_bench.sweep --config qwen3-tts-12hz-0.6b --traffic tts-serve \
        --seed <n> --seconds 30 --rates 2,3,4

One process builds the program of a configuration in `BENCHMARK.json` once
and runs one window per rate (the open-loop mix's arrivals at that rate),
printing per rate the pending queue's mean over each third of the window,
the drain after it, the first-audio median and 85th percentile and the
audio delivered. A cell's traffic file then takes about four fifths of
the knee as a fixed number.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

from . import traffic
from .run import HERE, Run, _reader


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--config", required=True, help="a configuration's name in BENCHMARK.json")
    ap.add_argument("--traffic", required=True, help="an open-loop mix under traffic/")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True, help="comma-separated arrivals per second")
    args = ap.parse_args(argv)
    bench = json.loads(Path("BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == args.config)
    cfg = json.loads(Path(conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{args.traffic}.json").read_text())
    import torch

    from . import weights

    dev = torch.device("cuda")
    w = weights.make_tts(cfg, args.seed, dev)
    w.update(weights.make_code2wav(cfg["code2wav"], args.seed + 1, dev))
    entry = importlib.import_module(f"h100_bench.entries.{mix['entry']}")
    run = Run(cfg=cfg, mix=mix, seed=args.seed, seconds=args.seconds, device=dev,
              control=False, weights=w)
    entry.setup(run)
    read = {n: _reader(n) for n in ("audio_rt_x", "first_audio_p50_ms.serve",
                                    "first_audio_p85_ms.serve")}
    for rate in (float(r) for r in args.rates.split(",")):
        mix["arrivals"] = {"rate_per_s": rate}
        run.requests, run.samples, run.lateness = [], [], []
        run.due = traffic.arrivals(mix, args.seconds, args.seed)
        run.texts = traffic.texts(mix, args.seed, len(run.due))
        torch.cuda.synchronize()
        run.start = time.perf_counter()
        run.end = run.start + args.seconds
        entry.window(run)
        drain = time.perf_counter() - run.end
        thirds = [[p for t, p, _a in run.samples
                   if run.start + k * args.seconds / 3 <= t < run.start + (k + 1) * args.seconds / 3]
                  for k in range(3)]
        means = [sum(x) / max(len(x), 1) for x in thirds]
        failed = sum(not r.ok for r in run.requests)
        frames = sum(len(r.codes) for r in run.requests)
        print(json.dumps({"rate_per_s": rate, "requests": len(run.requests), "failed": failed,
                          "frames_per_request": frames / max(len(run.requests), 1),
                          "pending_by_third": means, "drain_s": drain,
                          "max_lateness_ms": max(run.lateness) * 1e3,
                          **{n: f(run) for n, f in read.items()}}), flush=True)
    entry.release(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())

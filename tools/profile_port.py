#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one NVIDIA GPU.

    python3 tools/profile_port.py [profile] [phases] [positions]

With no argument all three run, at full width (Qwen3-TTS-12Hz-0.6B, random
weights from seed 0, the default `TTSConfig()`, which runs on the card):

  profile    one warm 14-word streaming request under `torch.profiler`:
             wall time with and without the profiler, device busy time,
             kernel launches and host time in `cudaLaunchKernel`,
             device-to-host copies (each one waits on the device), device
             time by kernel; then one talker step at position 100: device
             time and launches by kernel, and the host time to enqueue it.
  phases     the phases of three 14-word streaming requests, each timed
             with `torch.cuda.synchronize()` around it: text projection,
             talker prefill (dense T=8 + the first kernel step), one
             `cp_predict`, one talker step, one vocoder chunk, and TTFC.
  positions  the talker step, kernel against plain version, over a random
             cache at positions 1000, 4095 and 8191 (CUDA events).

Every line carries the card's name and power limit. The full profiler
tables go to `chiprun_out/profile_port.txt`.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TEXT = "The quick brown fox jumps over the lazy dog while the band plays on."
OUT = os.path.join(ROOT, "chiprun_out", "profile_port.txt")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _stream(eng, text):
    """Run one streaming request; returns (ttfc s, wall s, audio s)."""
    async def run():
        t0 = time.perf_counter()
        ttfc, n = None, 0
        async for audio, sr in eng.synthesize_streaming(text):
            ttfc = ttfc or time.perf_counter() - t0
            n += len(audio)
        return ttfc, time.perf_counter() - t0, n / eng.sample_rate
    return asyncio.run(run())


def _device_us(evt) -> float:
    return evt.self_device_time_total


def profile(eng, card, out):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from qwen_tts_tpu_torch.models.decoder import init_state
    from qwen_tts_tpu_torch.ops.decode_step import megakernel_forward

    _stream(eng, TEXT)
    _ttfc, plain_wall, audio_s = _stream(eng, TEXT)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        _ttfc, wall, _ = _stream(eng, TEXT)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    busy_ms = sum(_device_us(e) for e in dev) / 1e3
    launch = [e for e in events if e.key.startswith("cudaLaunchKernel")]
    n_launch = sum(e.count for e in launch)
    launch_ms = sum(e.cpu_time_total for e in launch) / 1e3
    dtoh = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    print(f"profile: 14-word request, {audio_s:.2f} s audio: wall {wall:.3f} s profiled, "
          f"{plain_wall:.3f} s not (RTF {plain_wall / audio_s:.4f}); device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / 1e3 / wall:.1f}% of the profiled wall); "
          f"{n_launch} kernel launches, {launch_ms:.1f} ms host in cudaLaunchKernel, "
          f"{dtoh} device-to-host copies [{card}]")
    by_kernel = sorted(dev, key=_device_us, reverse=True)[:12]
    for e in by_kernel:
        print(f"  device {_device_us(e) / 1e3:9.3f} ms  {e.count:7d} calls  {e.key[:90]}")
    out.write("== 14-word request ==\n" + events.table(
        sort_by="self_device_time_total", row_limit=60) + "\n")

    cfg, w = eng.model_config.talker, eng.weights.talker
    state = init_state(cfg, "cuda")._replace(position=100)
    embed = torch.randn(cfg.hidden_size, device="cuda")
    mp = [100] * len(cfg.mrope_section)
    step = lambda: megakernel_forward(cfg, w, state, embed, mrope_pos=mp)  # noqa: E731
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    parts = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type.name == "CUDA" and _device_us(e) > 0:
            name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            parts[name][0] += _device_us(e) / n
            parts[name][1] += e.count / n
    total = sum(p[0] for p in parts.values())
    print(f"talker step at position 100: device {total:.1f} us, "
          f"{sum(p[1] for p in parts.values()):.1f} launches; host enqueue "
          f"{enqueue_ms:.3f} ms [{card}]")
    for name, (us, cnt) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name[:40]:40s} {us:8.1f} us  {cnt:6.1f} launches/step")
    out.write("== talker step, position 100 ==\n" + events.table(
        sort_by="self_device_time_total", row_limit=30) + "\n")


def phases(eng, card):
    """Time each phase of a streaming request with device syncs around it."""
    import torch

    from qwen_tts_tpu_torch.engine import tts_engine
    from qwen_tts_tpu_torch.runtime import frame_loop

    times = defaultdict(list)

    def timed(mod, name, label):
        real = getattr(mod, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = real(*a, **k)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
            return r
        setattr(mod, name, wrapper)
        return lambda: setattr(mod, name, real)

    undo = [timed(tts_engine, "embed_text_ids", "text projection"),
            timed(tts_engine, "talker_prefill", "talker prefill (dense T=8 + first step)"),
            timed(frame_loop, "cp_predict", "cp_predict, one frame"),
            timed(frame_loop, "decode_step_with_embed", "talker step"),
            timed(tts_engine, "vocoder_decode", "vocoder, one chunk")]
    try:
        _stream(eng, TEXT)                        # warm, with the wrappers on
        times.clear()
        ttfc = [_stream(eng, TEXT)[0] * 1e3 for _ in range(3)]
    finally:
        for u in undo:
            u()
    print(f"phases of three 14-word requests, synced [{card}]:")
    for label, ts in times.items():
        ts = sorted(ts)
        print(f"  {label:42s} n={len(ts):4d}  min {ts[0]:8.3f}  median "
              f"{ts[len(ts) // 2]:8.3f}  max {ts[-1]:8.3f} ms")
    print(f"  {'synced TTFC':42s} n={len(ttfc):4d}  "
          + "  ".join(f"{t:.3f}" for t in ttfc) + " ms")


def positions(eng, card):
    import torch

    import chip_smoke

    cfg, w = eng.model_config.talker, eng.weights.talker
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for pos in (1000, 4095, 8191):
        res, ctx = chip_smoke.compare_kernel(cfg, w, pos, True, gen, mrope=True)
        k_ms, p_ms = chip_smoke.time_steps(cfg, w, ctx, True, 30)
        print(f"talker step at position {pos}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
              f"normed cos {res['normed_cos']:.6f}, argmax equal {res['argmax_equal']}, "
              f"K/V rel L2 {max(res['k_col_max_rel_l2'], res['v_col_max_rel_l2']):.4f} [{card}]")


def main() -> int:
    import torch

    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    which = sys.argv[1:] or ["profile", "phases", "positions"]
    card = _card()
    eng = TTSEngine(TTSConfig())
    eng.initialize()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as out:
        for name in which:
            if name == "profile":
                profile(eng, card, out)
            elif name == "phases":
                phases(eng, card)
            elif name == "positions":
                positions(eng, card)
            else:
                raise SystemExit(f"unknown part {name!r}")
    print(json.dumps({"ok": True, "parts": which}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one NVIDIA GPU.

    python3 tools/profile_port.py [--root DIR] [--positions P,...] [profile] [phases]
                                  [positions] [forms] [steps] [vocoder] [requests]
                                  [field=value ...]

With no part named, the first three run, at full width (Qwen3-TTS-12Hz-0.6B,
random weights from seed 0, `TTSConfig()` on the card, with any
`field=value` arguments set on it, e.g. `quantize=int8 kv_cache=int8`).
`--root DIR` imports the port from the tree at DIR instead of this checkout
(the timing helpers stay this checkout's `chip_smoke.py`), so that one call
to the card can time two trees in turn: unpack the other tree with `git
archive` into a git-ignored directory and run parent, change, change,
parent.

  profile    one warm 14-word streaming request under `torch.profiler`:
             wall time with and without the profiler, device busy time,
             kernel launches and host time in `cudaLaunchKernel`,
             device-to-host copies (each one waits on the device), device
             time by kernel; then one talker step at position 100: device
             time and launches by kernel, and the host time to enqueue it.
  phases     the phases of three 14-word streaming requests on the eager
             loop (`fused_chunks=False`, on the engine's weights), each timed
             with `torch.cuda.synchronize()` around it: text projection,
             talker prefill (dense T=8 + the first kernel step), one
             `cp_predict`, one talker step, one vocoder chunk, and TTFC.
  positions  the talker step, kernel against plain version, over a random
             cache at positions 1000, 4095 and 8191 (CUDA events).
  forms      one talker step for each weight form (bf16, int8, int8 with
             128-row groups, int4-g128, mixed), over a bf16 and an int8
             cache, at position 300 (or each of `--positions`): device time
             and launches by kernel (profiler), time by stage from the
             stage timers (`stage_times`: this script builds
             `csrc/decode_step.cu` and `generate.cu` with
             -DQTTS_STAGE_TIMERS into the git-ignored
             `qwen_tts_tpu_torch/_build/variants/`, as
             `tools/attention_variants.py` builds its variants, and runs
             the steps through that library), and the GEMV stages' achieved
             bandwidth (the form's matrix bytes over their time).
  steps      over a random cache: the talker step at positions 30, 300,
             4095 and 8191 (or `--positions`) and the code-predictor step at
             14 (device ms and kernels a step from the profiler, the step
             kernel's among them, host enqueue ms, back-to-back call ms
             from CUDA events, best of three runs, and the device's span
             with the host ahead, `chip_smoke._span_ms`: kernels plus the
             gaps between them, best of three); the standalone decode
             attention on one layer of [28, 8, 8192, 128] bf16 caches at
             300, 4095 and 8191 (device us per call); generation, 256
             greedy steps from position 0 (ms a step, best of two, and the
             device's span of its one launch with the host ahead).
  vocoder    the engine's vocoder alone (`vocoder_backend=code2wav` and
             `vocoder_dtype=...` pick Code2Wav's form): a chunk of
             `chunk_frames` frames (after as many frames of context, for
             Code2Wav) and the first chunk of one frame, each captured as a
             CUDA graph and replayed between CUDA events, with cuDNN's
             heuristic algorithms and with `cudnn.benchmark`'s timed ones;
             then one chunk's device time by kernel (profiler, eager).
  requests   five warm 14-word streaming requests: TTFC median and the
             streaming RTF (all wall over all audio), then one more under
             `torch.profiler`: the device's busy share of its wall (kernel
             time over wall) and its `cudaGraphLaunch` calls; for each value
             of `fused_chunks` the tree's `TTSConfig` has (both, on one set
             of weights: the CUDA-graph path and the eager loop; a tree
             without the field runs its only path).

Every line carries the card's name and power limit. The full profiler
tables go to `chiprun_out/profile_port.txt`.
"""

from __future__ import annotations

import asyncio
import ctypes
import importlib.util
import inspect
import itertools
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSITIONS = (30, 300, 4095, 8191)

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
    state = init_state(cfg, "cuda", eng._kv_dtype)._replace(position=100)
    parts, enqueue_ms, table = _step_parts(cfg, w, state, 50)
    print(f"talker step at position 100: device {sum(p[0] for p in parts.values()):.1f} "
          f"us, {sum(p[1] for p in parts.values()):.1f} launches; host enqueue "
          f"{enqueue_ms:.3f} ms [{card}]")
    for name, (us, cnt) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name[:40]:40s} {us:8.1f} us  {cnt:6.1f} launches/step")
    out.write("== talker step, position 100 ==\n" + table + "\n")


def _parts(fn, n: int):
    """`n` calls of `fn` under the profiler: ({kernel name: [device us per
    call, launches per call]}, the profiler's table)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    parts = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type.name == "CUDA" and _device_us(e) > 0:
            name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            parts[name][0] += _device_us(e) / n
            parts[name][1] += e.count / n
    return parts, events.table(sort_by="self_device_time_total", row_limit=30)


def _smoke():
    """This checkout's `chip_smoke.py` (its timing helpers and random
    caches), whichever tree the port comes from."""
    mod = sys.modules.get("chip_smoke")
    if mod is None:
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      os.path.join(ROOT, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return mod


def _call_ms(fn, n: int, runs: int = 3) -> float:
    """Back-to-back call time of `fn` (CUDA events), the best of `runs` runs."""
    return min(_smoke()._time_ms(fn, n) for _ in range(runs))


def _span_ms(fn, n: int, runs: int = 3) -> float:
    """The device's span per call with the host ahead, the best of `runs`."""
    return min(_smoke()._span_ms(fn, n) for _ in range(runs))


def _step_parts(cfg, w, state, n: int, talker: bool = True):
    """One decode step at the state's position, `n` times (the talker with
    M-RoPE and its head, or the code predictor without): ({kernel name:
    [device us per step, launches per step]}, host enqueue ms per step,
    the profiler's table)."""
    import torch

    step = _stepper(cfg, w, state, talker)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    parts, table = _parts(step, n)
    return parts, enqueue_ms, table


def _stepper(cfg, w, state, talker: bool):
    """A decode step at the state's position, as a function of nothing."""
    import torch

    from qwen_tts_tpu_torch.ops.decode_step import megakernel_forward

    pos = state.position
    embed = torch.randn(cfg.hidden_size, device="cuda")
    mp = [pos] * len(cfg.mrope_section) if talker else None
    return lambda: megakernel_forward(cfg, w, state, embed, mrope_pos=mp,  # noqa: E731
                                      with_head=talker)


STAGES = ("norm+QKV", "attention+O-proj", "norm+gate|up", "SwiGLU+down", "norm+head",
          "logits", "argmax")


_TIMER_LIB = []


def timer_library():
    """The decode kernels built with -DQTTS_STAGE_TIMERS (one nvcc, into
    `_build/variants/`, named by the hash of the sources: built once),
    loaded with ctypes."""
    if not _TIMER_LIB:
        from qwen_tts_tpu_torch.ops import cuda_lib

        out = cuda_lib.BUILD_DIR / "variants"
        out.mkdir(parents=True, exist_ok=True)
        so = out / f"stage_timers_{cuda_lib._digest()}.so"
        if not so.exists():
            tmp = out / f"{so.name}.{os.getpid()}.tmp"
            r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.COMPILE_FLAGS, "-shared",
                                "-DQTTS_STAGE_TIMERS", "-o", str(tmp),
                                str(cuda_lib.CSRC / "decode_step.cu"),
                                str(cuda_lib.CSRC / "generate.cu")],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise SystemExit(f"nvcc failed for the stage-timer build:\n{r.stdout}{r.stderr}")
            os.replace(tmp, so)
        _TIMER_LIB.append(cuda_lib.bind(ctypes.CDLL(str(so))))
    return _TIMER_LIB[0]


def stage_times(cfg, w, state, n: int, talker: bool = True):
    """`n` decode steps at the state's position through `timer_library()`
    (each block reads `globaltimer` as it arrives at a grid barrier, block
    0 also as it leaves one). Returns ({stage: us per step from block 0
    leaving the previous barrier to leaving this stage's}, us per step in
    all, {stage: [block 0's norm (its end; 0 for a stage without one),
    block 0's own work, the slowest block's work]} in us per step)."""
    import torch

    from qwen_tts_tpu_torch.ops import decode_step

    k = len(STAGES)
    lib = timer_library()
    with mock.patch.object(decode_step, "load_library", lambda: lib):
        step = _stepper(cfg, w, state, talker)
        step()
        torch.cuda.synchronize()
        ws = decode_step.workspace(cfg, w.embed.device)
        off = lib.qtts_stage_timers_offset()
        assert off >= 0, "the timer build has no stage timers"
        words = ws[off:off + 8 * (2 + 5 * k)].view(torch.int64)
        words.zero_()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        vals = words.cpu().tolist()
    steps = vals[k + 1]
    assert steps == n, vals
    us = {name: vals[i] / steps / 1e3 for i, name in enumerate(STAGES)}
    work = {name: [vals[4 * k + 2 + i] / steps / 1e3, vals[k + 2 + i] / steps / 1e3,
                   vals[2 * k + 2 + i] / steps / 1e3]
            for i, name in enumerate(STAGES)}
    return us, sum(us.values()), work


def forms(eng, card, out, positions=(300,)):
    """The talker step at each position in each weight form and cache:
    device time and launches from the profiler, time by stage from the
    stage timers, and the GEMV stages' achieved bandwidth."""
    import torch

    chip_smoke = _smoke()
    from qwen_tts_tpu_torch.core.weights import QUANTIZERS

    cfg, w = eng.model_config.talker, eng.weights.talker
    if hasattr(w.layers, "wqkv_q"):
        raise SystemExit("forms: run it on the bf16 engine (no quantize=...)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    variants = {"bf16": w, "int8": QUANTIZERS["int8"](w),
                "int8g128": QUANTIZERS["int8"](w, group_size=128),
                "int4": QUANTIZERS["int4"](w), "mixed": QUANTIZERS["mixed"](w)}
    gemv = ("norm+QKV", "norm+gate|up", "SwiGLU+down", "norm+head")
    for label, qw in variants.items():
        mats = [t for t in qw.layers if t.dim() == 3] + [
            t for t in (qw.lm_head, getattr(qw, "lm_head_s", None)) if t is not None]
        gemv_bytes = sum(t.numel() * t.element_size() for t in mats)
        for kv8, pos in itertools.product((False, True), positions):
            state = chip_smoke.random_state(cfg, pos, gen, kv8)
            parts, enqueue_ms, table = _step_parts(cfg, qw, state, 30)
            total = sum(p[0] for p in parts.values())
            stages, timed, work = stage_times(cfg, qw, state, 30)
            gemv_us = sum(stages[k] for k in gemv)
            bound_ms, _ = chip_smoke._bound_ms(*chip_smoke.step_cost(cfg, qw, pos, True, kv8))
            print(f"talker step [{label}, {'int8' if kv8 else 'bf16'} cache] at position {pos}: "
                  f"device {total:.1f} us (bound {bound_ms * 1e3:.1f} us), "
                  f"{sum(p[1] for p in parts.values()):.1f} launches, host enqueue "
                  f"{enqueue_ms:.3f} ms; stage timers {timed:.1f} us: attention (to its end) "
                  f"{work['attention+O-proj'][0]:.1f} us "
                  f"({work['attention+O-proj'][0] / cfg.num_layers:.2f} a layer), attention + "
                  f"O-proj {stages['attention+O-proj']:.1f} us, the other GEMV stages "
                  f"{gemv_us:.1f} us for {gemv_bytes / 1e9:.4f} GB = "
                  f"{gemv_bytes / gemv_us / 1e6:.3f} TB/s [{card}]")
            print("  stages (us a step): " + json.dumps({k: round(v, 2) for k, v in stages.items()}))
            print("  norm, work to the barrier (block 0, slowest block; us a step): "
                  + json.dumps({k: [round(x, 2) for x in v] for k, v in work.items()}))
            for name, (us, cnt) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
                print(f"  {name[:48]:48s} {us:8.1f} us  {cnt:6.1f} launches/step")
            out.write(f"== talker step {label}, kv8={kv8}, position {pos} ==\n{table}\n")


def phases(eng, card):
    """Time each phase of a streaming request with device syncs around it."""
    import torch

    from qwen_tts_tpu_torch.engine import tts_engine
    from qwen_tts_tpu_torch.runtime import frame_loop

    if getattr(eng.config, "fused_chunks", False):   # a replayed graph has no phases to time
        import dataclasses

        eager = type(eng)(dataclasses.replace(eng.config, quantize=False, fused_chunks=False))
        eager.initialize(weights=eng.weights, vocoder_weights=eng.vocoder_weights)
        eng = eager
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

    chip_smoke = _smoke()

    cfg, w = eng.model_config.talker, eng.weights.talker
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for pos in (1000, 4095, 8191):
        res, ctx = chip_smoke.compare_kernel(cfg, w, pos, True, gen, mrope=True)
        k_ms, p_ms = chip_smoke.time_steps(cfg, w, ctx, True, 30)
        print(f"talker step at position {pos}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
              f"normed cos {res['normed_cos']:.6f}, argmax equal {res['argmax_equal']}, "
              f"K/V rel L2 {max(res['k_col_max_rel_l2'], res['v_col_max_rel_l2']):.4f} [{card}]")


def steps(eng, card, positions=POSITIONS):
    """Step, attention and generation times of the tree the port came from."""
    import torch

    from qwen_tts_tpu_torch.core.config import CODEC_BOS
    from qwen_tts_tpu_torch.models.decoder import init_state
    from qwen_tts_tpu_torch.ops.attention import decode_attention
    from qwen_tts_tpu_torch.ops.generate_kernel import generate_megakernel

    mc, gen = eng.model_config, torch.Generator(device="cuda")
    gen.manual_seed(5)
    kv8 = eng._kv_dtype == torch.int8
    cases = [("talker", mc.talker, eng.weights.talker, p, kv8) for p in positions]
    cases.append(("code predictor", mc.code_predictor, eng.weights.code_predictor.decoder, 14,
                  False))
    for label, cfg, w, pos, kv8 in cases:
        state = _smoke().random_state(cfg, pos, gen, kv8)
        parts, enqueue_ms, _ = _step_parts(cfg, w, state, 10, talker=label == "talker")
        step = _stepper(cfg, w, state, label == "talker")
        res = {"device_ms": sum(p[0] for p in parts.values()) / 1e3,
               "step_kernel_ms": parts.get("decode_persistent", (0.0, 0))[0] / 1e3,
               "device_span_ms": _span_ms(step, 10),
               "kernels_per_step": sum(p[1] for p in parts.values()),
               "step_kernels_per_step": parts.get("decode_persistent", (0.0, 0))[1],
               "enqueue_ms": enqueue_ms, "call_ms": _call_ms(step, 50)}
        print(f"steps: {label} step at position {pos}: {json.dumps(res)} [{card}]")
        del state

    cfg = mc.talker
    L, KVH, S, D, HQ = (cfg.num_layers, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim,
                        cfg.num_q_heads)
    q, k_new, v_new = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((HQ, D), (KVH, D), (KVH, D)))
    kc = torch.randn(L, KVH, S, D, generator=gen, device="cuda").bfloat16()
    vc = torch.randn(L, KVH, S, D, generator=gen, device="cuda").bfloat16()
    for pos in (300, 4095, 8191):
        # the position as this tree's wrapper takes it: a device int32 tensor
        # (a host int in trees before device positions)
        at = (torch.full((), pos, dtype=torch.int32, device="cuda")
              if "positions" in inspect.signature(decode_attention).parameters else pos)
        call = lambda: decode_attention(q, k_new, v_new, kc, vc, L - 1, at)  # noqa: E731
        call()
        parts, _ = _parts(call, 100)
        print(f"steps: decode attention at position {pos}: device "
              f"{sum(p[0] for p in parts.values()):.3f} us a call [{card}]")
    del kc, vc

    state = init_state(cfg, "cuda", eng._kv_dtype)
    first = torch.full((1,), CODEC_BOS, dtype=torch.int32, device="cuda")
    starts = [0] * len(cfg.mrope_section)
    call = lambda: generate_megakernel(cfg, eng.weights.talker, state, first, 256,  # noqa: E731
                                       starts)
    ms = _call_ms(call, 1, runs=2) / 256
    span = _span_ms(call, 1, runs=2) / 256
    print(f"steps: generation, 256 steps from position 0: {ms:.4f} ms a step = "
          f"{1e3 / ms:.1f} tok/s, device span {span:.4f} ms a step (one launch; idle share "
          f"{1 - span / ms:.3f}) [{card}]")


def vocoder(eng, card, out):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    chip_smoke = _smoke()
    n, groups = eng.config.chunk_frames, eng.model_config.num_code_groups
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    codes = torch.randint(0, 2048, (2 * n, groups), generator=gen, device="cuda")
    ctx = codes[n:] if eng.config.vocoder_backend == "code2wav" else None
    chunk = lambda: eng._frames_decode(codes[:n], ctx)  # noqa: E731
    first = lambda: eng._frames_decode(codes[:1])  # noqa: E731
    form = f"{eng.config.vocoder_backend} {eng.config.vocoder_dtype}"
    for bench in (False, True, False):
        torch.backends.cudnn.benchmark = bench
        try:
            ms, ms1 = chip_smoke._graph_ms(chunk, 20), chip_smoke._graph_ms(first, 20)
        finally:
            torch.backends.cudnn.benchmark = False
        print(f"vocoder [{form}], cudnn.benchmark={bench}: a {n}-frame chunk {ms:.4f} ms, "
              f"the first chunk (1 frame) {ms1:.4f} ms (CUDA-graph replays) [{card}]")
    chunk()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            chunk()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    print(f"vocoder [{form}]: one chunk's device time by kernel (5 chunks profiled, eager, "
          f"cudnn.benchmark=False), {sum(_device_us(e) for e in dev) / 5e3:.3f} ms in all:")
    for e in sorted(dev, key=_device_us, reverse=True)[:12]:
        print(f"  device {_device_us(e) / 5e3:8.3f} ms  {e.count / 5:6.1f} calls  {e.key[:90]}")
    out.write(f"== vocoder {form}, 5 chunks ==\n" + prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40) + "\n")


def requests(eng, card, n: int = 5):
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    engines = [eng]
    if hasattr(eng.config, "fused_chunks"):       # the other path, on the same weights
        other = type(eng)(dataclasses.replace(eng.config, quantize=False,
                                              fused_chunks=not eng.config.fused_chunks))
        other.initialize(weights=eng.weights, vocoder_weights=eng.vocoder_weights)
        engines.append(other)
    for e in engines:
        path = {True: "graph", False: "eager"}.get(getattr(e.config, "fused_chunks", None),
                                                   "eager (no fused_chunks)")
        _stream(e, TEXT)                          # warm
        runs = [_stream(e, TEXT) for _ in range(n)]
        ttfc = sorted(r[0] * 1e3 for r in runs)
        rtf = sum(r[1] for r in runs) / sum(r[2] for r in runs)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _ttfc, wall, _ = _stream(e, TEXT)
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy_s = sum(_device_us(x) for x in events
                     if x.device_type.name == "CUDA" and _device_us(x) > 0) / 1e6
        graphs = sum(x.count for x in events if x.key == "cudaGraphLaunch")
        print(f"requests [{path}]: {n} warm 14-word streaming requests: TTFC median "
              f"{ttfc[n // 2]:.2f} ms (min {ttfc[0]:.2f}, max {ttfc[-1]:.2f}), streaming RTF "
              f"{rtf:.4f}; one more profiled: device busy {busy_s / wall:.4f} of its "
              f"{wall:.3f} s wall, {graphs} cudaGraphLaunch [{card}]")


def main() -> int:
    args = sys.argv[1:]
    root, positions = ROOT, None
    if "--root" in args:
        i = args.index("--root")
        root = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    if "--positions" in args:
        i = args.index("--positions")
        positions = tuple(int(p) for p in args[i + 1].split(","))
        del args[i:i + 2]
    sys.path.insert(0, root)
    import torch

    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    which = [a for a in args if "=" not in a] or ["profile", "phases", "positions"]
    options = {k: {"True": True, "False": False}.get(v, v)
               for k, v in (a.split("=", 1) for a in args if "=" in a)}
    card = _card()
    eng = TTSEngine(TTSConfig(**options))
    eng.initialize()
    print(f"tree {root}, engine options {options or 'default'} [{card}]")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as out:
        for name in which:
            if name == "profile":
                profile(eng, card, out)
            elif name == "phases":
                phases(eng, card)
            elif name == "positions":
                positions(eng, card)
            elif name == "forms":
                forms(eng, card, out, positions or (300,))
            elif name == "steps":
                steps(eng, card, positions or POSITIONS)
            elif name == "vocoder":
                vocoder(eng, card, out)
            elif name == "requests":
                requests(eng, card)
            else:
                raise SystemExit(f"unknown part {name!r}")
    print(json.dumps({"ok": True, "parts": which}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

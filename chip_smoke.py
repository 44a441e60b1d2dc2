#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`qwen_tts_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and no result line
is printed):
  1. card name and power limit, torch and CUDA versions; builds the
     kernels of `qwen_tts_tpu_torch/csrc/` (one nvcc per source, started
     together, linked into one library) and prints ptxas' register,
     shared-memory and spill lines for each entry;
  2. the persistent decode-step kernel's grid (blocks, blocks a kv head,
     blocks an SM, SMs, shared memory, registers, and how many clusters of
     8 and of 16 of its blocks the card holds at once,
     cudaOccupancyMaxActiveClusters) for the talker on a bf16
     and an int8 cache and for the code predictor; then the decode-step
     kernel against its plain PyTorch version at full width
     (Qwen3-TTS-12Hz-0.6B, random weights from a seed): the 28-layer talker
     at positions 0, 1, 300, 4095 and 8191 over a randomly filled cache
     (across the attention core's tile and block boundaries and at long
     prefixes), the 5-layer code predictor at positions 2 and 14; then one
     step at 4095 run twice on the same inputs, the same bits;
  3. the engine's main path, `TTSEngine(TTSConfig())` (on the card by
     default; each chunk one replay of a CUDA graph captured in
     `initialize()`): three streaming requests of different lengths and one
     `synthesize`; checks chunk lengths, finite audio, and that the
     decode-step kernel's own launch count (`TTSEngine.decode_launches`:
     the kernel counts in its workspace, so graph replays are counted)
     equals the talker plus code-predictor decode steps run, frames
     computed past EOS or the cap included; then a reduced model on the GPU
     (kernels) against the same model on the CPU (plain path), greedy: the
     first frame's codes equal and its audio within 1e-3, and over 8 frames
     either >= 95% of the codes equal or the first differing code a near
     tie (top-2 gap < 2e-2) of the CPU logits that chose it, the GPU taking
     the CPU's runner-up;
  4. step times of the decode-step kernel and its plain version (CUDA
     events), the device's span of a talker and a code-predictor step with
     the host ahead (the decode kernel's time: `torch.profiler` loses up
     to all of its events), the kernels the profiler sees over 20
     consecutive decode steps (talker on a bf16 and an int8 cache, code
     predictor: the step kernel, at most once a step, and nothing else,
     from a run in which the profiler saw a kernel),
     and the talker step at positions 30, 300, 4095 and 8191: the device's
     span, kernels a call, call ms; TTFC and RTF of the main path;
  5. the decode-attention kernel against its plain version at full talker
     shape (layer 27 of [28, 8, 8192, 128] caches) at positions 0, 1, 63,
     64, 65, 255, 256, 257, 300, 1023, 1024, 1025, 4095 and 8191, the rows
     past the position and the other layers poisoned: max |diff| <= 2e-3 *
     max(1, max |ref|), and each run twice with the same bits; then with 1
     and 8 q heads per kv head at 0, 65 and 1025;
  6. N-step generation, `generate_megakernel`, 64 greedy steps from
     CODEC_BOS at position 0 (the path's run: one C call, no host sync
     between steps, checked under `torch.cuda.set_sync_debug_mode("error")`),
     and 64 steps from a random position-300 cache with M-RoPE deltas
     (0, 5, 9); both held bit for bit (tokens and cache columns) to a loop
     of decode-step launches + `torch.argmax` + `embed[token]`;
  7. the "pallas" path's eager loop, `TTSEngine(TTSConfig(backend="pallas",
     fused_chunks=False))` (phase 15 runs its graphs): one
     streaming request with the chunk checks of phase 3 and
     decode-attention launches == 28 x talker steps + 5 x code-predictor
     steps; then the reduced-model GPU-versus-CPU parity of phase 3 on
     that backend;
  8. times (CUDA events, interleaved plain-kernel-kernel-plain): decode
     attention at positions 300, 4095 and 8191 beside its plain version and
     `scaled_dot_product_attention` on bf16 tensors of the same prefix
     (the port never calls it); generation of 64 steps (best of two)
     beside one run of its plain version, the kernels the profiler sees an
     8-step call launch (at most one), and 256 steps from position 0 as
     tokens/s beside the
     decode-step host loop's and the weight-bandwidth bound, with the
     device's span and idle share;
  9. the quantized forms of the decode-step kernel against its plain
     version at full width: int8 per channel, int8 with 128-row groups,
     int4-g128 and mixed, each with a bf16 and an int8 cache, the talker at
     positions 0, 1 and 300 over a random cache (and 4095 over the int8
     cache) and the code predictor (bf16 cache, bf16 heads) at 2 and 14,
     then an int8+kv8 step at 4095 run twice, the same bits: normed cosine >= 0.999, logits
     within 2e-2 * max(1, max |ref|), cache columns (int8 ones dequantized)
     at phase 2's bar, and layer 0's int8 rows within 1 LSB with their
     scales within rtol 5e-3 (deeper int8 rows carry phase 2's bf16 drift
     into their rounding: their LSB differences are counted and printed);
 10. the quantized main path, `TTSConfig(quantize="int8",
     kv_cache="int8")`: three streaming requests and one `synthesize` with
     phase 3's checks and the kernel's own count of decode-step launches ==
     decode steps, then the
     reduced model's GPU-versus-CPU parity on that configuration (backend
     "mega" on both: the kernel and its plain version); then one streaming
     request each with quantize "int4" and "mixed", kv_cache "int8";
 11. generation on int8+kv8, int4+kv8 and mixed+kv8 held to the
     decode-step loop bit for bit (tokens, cache rows and scales) as in
     phase 6;
 12. times of each form: talker step at position 300 over an int8 cache
     (kernel call, device span, plain, the form's bound) and
     code-predictor step (call and device span), kernels per decode step
     as in phase 4 (talker
     on both caches, code predictor), the int8 form's talker step at 30,
     300, 4095 and 8191 as in phase 4, generation of 64 and 256 steps for
     each form of phase 11, and the int8+kv8 engine's TTFC and streaming
     RTF;
 13. the graph path against the eager loop: for bf16 (phase 3's engine) and
     int8+kv8 (phase 10's), an engine with `fused_chunks=False` on the same
     weights serves phase 3's first two streaming requests and its
     `synthesize` with the same request numbers: codes equal bit for bit, chunk
     lengths equal, audio within 1e-4 * max(1, max |eager|); one warm
     request under `torch.profiler`: one `cudaGraphLaunch` a chunk plus one
     for the first chunk, the host's other CUDA calls a chunk, and the
     device's busy share of the wall; TTFC and RTF medians of both paths on
     one line;
 14. a local checkpoint and the Code2Wav vocoder at full width (the talker
     at 28 layers, `Code2WavConfig()`): phase 3's bf16 weights written by
     the port's safetensors writer under the reference key names, beside a
     `code2wav.safetensors` made from a seed under the torch module's key
     names (norm scales 1 + N(0, 0.02), the rest N(0, 0.02)); an engine
     built from `model_path` and `vocoder_path` (`vocoder_backend=
     "code2wav"`, the load timed) streams the codes and audio of one handed
     the same weights, bit for bit; for `vocoder_dtype` float32 and
     bfloat16, the graph path against the eager loop on phase 13's requests
     (codes bit for bit, audio within 1e-4), the decode kernel's own launch
     count on the graph path equal to its decode steps, `synthesize` equal
     to the streamed chunks joined; Code2Wav on the card against the CPU on
     the same 35 frames (relative L2 <= 1e-3 in f32, cosine >= 0.995 in
     bf16); two bf16 requests interleaved chunk by chunk on one engine give
     what each gives alone, bit for bit, with the host's time of a park
     (waiting for the holder's in-flight chunks included) and a restore;
     TTFC (median of five warm requests) and streaming RTF of both dtypes
     and of the default path, and Code2Wav's device ms a chunk
     (one CUDA graph of the decode, replayed between CUDA events) with
     cuDNN's heuristic algorithms and with `cudnn.benchmark`'s timed ones;
 15. the decode-attention kernel on device positions (one int32 a slot, read
     by the kernel, its grid fixed by the cache's length) against its plain
     version at full talker shape, one slot at 0, 1, 63, 64, 300, 4095, 8191
     and 8192 (a full cache) and four slots at four positions each (0/1/63/
     64, 300/4095/8191/8192, 8192/65/1025/0) over caches [4, 28, 8, 8192,
     128], rows past each slot's position poisoned, phase 5's bar, each run
     twice with the same bits; its device and call time for one and four
     slots at 300, 4095 and 8191 beside `scaled_dot_product_attention`;
     then engines with `backend="pallas"` and `"dense"` and
     `fused_chunks=True` (graphs captured in `initialize()`) against their
     eager loops on phase 3's weights: phase 13's first request streamed and
     `synthesize`d, codes equal bit for bit, audio within 1e-4, the
     decode-attention kernel's own launch count on the graph path equal to
     the layers times the steps run ("pallas"; none on "dense"), no
     decode-step kernel, TTFC and RTF medians of both paths; and a talker
     step of two slots on device positions, one at its cache's end: its
     column lands in its own last rows only, the other slot as it is beside
     a neighbour at 3;
 16. continuous batching at full width and depth, `TTSConfig(max_seq_len=
     1024)` on phase 3's weights as `benchmarks/bench_continuous.py` serves
     it, `ContinuousBatcher(slots=4, chunk_frames=10, admit_chunk_frames=2)`
     (every graph captured in `warm()`): 8 requests of the smoke's texts
     150 ms apart, bf16 and then int8 + kv8: each request's audio non-empty,
     finite and whole hops, no graph captured during traffic, the
     decode-attention kernel's own launch count equal to its layers times
     the frames dispatched plus the admissions' first steps; aggregate
     real-time factor (audio seconds over wall seconds), first audio p50 and
     p95, the device's busy share (the graphs' time between CUDA events
     around each replay, over the wall until the device is done); one short request under the
     profiler (one `cudaGraphLaunch` a chunk or admission); one request of the crowd served
     alone with its request number gives the same codes; bf16 only:
     `synthesize_batch` of four short texts against each text alone with
     its request number, padded to four slots by copies of it (codes equal
     or first parting at a near tie: two logits or two noisy sampler scores
     within 2e-2) and on one slot fed the batch's codes (the talker's hidden
     state at every step within cosine 0.999 of the batch's; at the first
     choice the slot would have made otherwise, a greedy code 0 within
     2e-2, or two adjacent top-k logits within 2e-2: a rank swap that
     reorders the sampler's noise).
The next-to-last line is a JSON object describing the kernels, one entry
per quantized form as well; the last line is {"ok": true, "device":
{...}}. JAX and the JAX package are blocked for the whole run: the port
must not need them.
"""

from __future__ import annotations

import asyncio
import importlib.abc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TEXTS = (
    "Hello from the GPU.",
    "The quick brown fox jumps over the lazy dog while the band plays on.",
    "Streaming speech synthesis sends the first audio chunk after one frame, "
    "then keeps the listener fed with longer chunks until the sentence ends.",
)
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense
# bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores
# Both sides of the attention core's boundaries: one block a kv head up to
# 64 rows (a tile), one tile a block up to 1,024 rows, then ranges of tiles.
ATTN_POSITIONS = (0, 1, 63, 64, 65, 255, 256, 257, 300, 1023, 1024, 1025, 4095, 8191)
ATTN_TIMED = (300, 4095, 8191)
STEP_TIMED = (30, 300, 4095, 8191)          # talker step times
STEP_POSITIONS = (0, 1, 300, 4095, 8191)    # talker, decode step vs plain
ATTN_LAYER = 27
# Phase 15: B3 on device positions, one slot; a cache of 8192 rows is full at 8192
ATTN_SLOT_POSITIONS = (0, 1, 63, 64, 300, 4095, 8191, 8192)
RING_GRAPHS = 3      # chunk graphs of the engine's ring (engine/chunk_graphs.py RING)
# Phase 16: continuous batching as benchmarks/bench_continuous.py serves it
SERVE_SEQ, SERVE_SLOTS, SERVE_REQUESTS, SERVE_GAP_S = 1024, 4, 8, 0.15
GEN_STEPS = 64
GEN_TIMED_STEPS = 256
GEN_FORMS = ("int8", "int4", "mixed")   # weight forms of the kv8 generation phases


def _quant_forms():
    """label -> (quantizer, keyword arguments) of the weight forms."""
    from qwen_tts_tpu_torch.core.weights import QUANTIZERS

    return {"int8": (QUANTIZERS["int8"], {}),
            "int8g128": (QUANTIZERS["int8"], {"group_size": 128}),
            "int4": (QUANTIZERS["int4"], {}), "mixed": (QUANTIZERS["mixed"], {})}


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "qwen_tts_tpu"):
            raise ImportError(f"chip_smoke: the port must not import {name}")
        return None


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_counts(fn, iters: int) -> dict:
    """{kernel name: [device ms per call, launches per call]} over `iters`
    calls of `fn`, from `torch.profiler` (names without namespaces and
    arguments); empty if the profiler saw nothing. The profiler loses
    events under load, never adds one: up to ~30% of the persistent decode
    kernel's launches in a run, and at times all of them, so its launch
    counts are ceilings and its times are taken per launch seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            ms, n = parts.get(name, (0.0, 0.0))
            parts[name] = [ms + e.self_device_time_total / iters / 1e3, n + e.count / iters]
    return parts


def _kernels_seen(fn, iters: int, tries: int = 5) -> dict:
    """{kernel name: launches per call} from `_kernel_counts`, run again
    (up to `tries` times) until the profiler saw at least one kernel, so
    that a check that it saw nothing else cannot pass on an empty set."""
    for _ in range(tries):
        counts = {k: v[1] for k, v in _kernel_counts(fn, iters).items()}
        if counts:
            return counts
    raise AssertionError(f"the profiler saw no kernel in {tries} runs of {iters} calls")


def _device_by_kernel(fn, iters: int, tries: int = 5) -> dict:
    """`_kernel_counts`, run again (up to `tries` times) until the profiler
    saw a kernel: at times it loses every event of a run."""
    for _ in range(tries):
        parts = _kernel_counts(fn, iters)
        if parts:
            return parts
    raise AssertionError(f"the profiler saw no device time in {tries} runs")


def _device_ms(fn, iters: int) -> float:
    """Device time per call: the summed durations of the CUDA kernels that
    `iters` calls ran, from `torch.profiler`. Unlike CUDA events around
    back-to-back calls, this leaves out the host's time to enqueue them.
    The profiler can lose a few events under load (never add one), so each
    kernel counts as its mean duration times its launches per call rounded
    to a whole number."""
    return sum(ms / n * max(1, round(n)) for ms, n in _device_by_kernel(fn, iters).values())


def _span_ms(fn, iters: int) -> float:
    """The device's span per call with the host ahead: `iters` calls queued
    behind a ~50 ms device sleep, timed with CUDA events (kernels and the
    gaps between them, none of the host's enqueue)."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int) -> float:
    """The device's time per call of `fn` captured as one CUDA graph (after
    two eager runs on the capture's stream, which set up its libraries) and
    replayed `iters` times between CUDA events: no host enqueue in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _time_ms(graph.replay, iters, warmup=2)


def _interleaved(kernel, plain, iters: int, plain_iters: int, warmup: int = 3,
                 plain_warmup: int | None = None):
    """(kernel ms, plain ms): the best of two runs each, in the order
    plain, kernel, kernel, plain."""
    pw = warmup if plain_warmup is None else plain_warmup
    p1, k1, k2, p2 = (_time_ms(plain, plain_iters, pw), _time_ms(kernel, iters, warmup),
                      _time_ms(kernel, iters, warmup), _time_ms(plain, plain_iters, pw))
    return min(k1, k2), min(p1, p2)


def _bound_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def step_cost(cfg, w, pos: int, with_head: bool, kv8: bool = False):
    """(bytes, FLOPs) one decode step at cache row `pos` must move and do:
    every layer weight read once (in its form: bf16, int8 or packed int4,
    with its f32 scales), the cache prefix read once (int8 rows with their
    f32 scales for an int8 cache), the new K/V column written, the input
    row read and the outputs written. FLOPs count 2 per weight whatever its
    storage; they are held to the bf16 tensor-core rate, the fastest type
    the products could run in (every form is bytes-bound by far)."""
    lw = w.layers
    L, H, I, V = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    KVH, D, HQ, Q, KV = cfg.num_kv_heads, cfg.head_dim, cfg.num_q_heads, cfg.q_size, cfg.kv_size
    wbytes = sum(t.numel() * t.element_size() for t in lw) + w.final_norm.numel() * 2
    wflops = 2 * L * (H * (Q + 2 * KV) + Q * H + H * 2 * I + I * H)
    if with_head:
        head_s = getattr(w, "lm_head_s", None)
        wbytes += w.lm_head.numel() * w.lm_head.element_size() + (
            0 if head_s is None else head_s.numel() * 4)
        wflops += 2 * H * V
    row = D + 4 if kv8 else D * 2                  # bytes of one cached head row
    cache = 2 * L * KVH * pos * row
    io = 2 * L * KVH * row + H * 4 * 2 + (V * 4 if with_head else 0)
    attn_flops = 4 * L * HQ * (pos + 1) * D
    return wbytes + cache + io, wflops + attn_flops


def _clone(state):
    """A copy of a decode state's cache tensors (and scales)."""
    return state._replace(**{f: t.clone() for f, t in state._asdict().items()
                             if hasattr(t, "clone")})


def random_state(cfg, pos: int, gen, kv8: bool = False):
    """A cache with rows [0, pos) random (quantized per row for int8)."""
    import torch
    from qwen_tts_tpu_torch.models.decoder import init_state, quantize_rows

    state = init_state(cfg, "cuda", torch.int8 if kv8 else torch.bfloat16)
    for cache, scales in ((state.k_cache, state.k_scale), (state.v_cache, state.v_scale)):
        if pos:
            rows = torch.randn(cache[:, :, :pos].shape, generator=gen, device="cuda")
            if kv8:
                cache[:, :, :pos], scales[:, :, :pos] = quantize_rows(rows)
            else:
                cache[:, :, :pos] = rows.to(torch.bfloat16)
    return state._replace(position=pos)


def compare_kernel(cfg, w, pos: int, with_head: bool, gen, mrope: bool, kv8: bool = False,
                   quant_bar: bool = False):
    """Kernel vs plain version at one position over a random cache.
    `quant_bar` adds the logits bar of the quantized forms: within
    2e-2 * max(1, max |ref|)."""
    import torch
    from qwen_tts_tpu_torch.models.decoder import rope_rows
    from qwen_tts_tpu_torch.ops.decode_step import (
        megakernel_forward,
        megakernel_forward_reference,
    )

    dev = w.embed.device
    state = random_state(cfg, pos, gen, kv8)
    embed = torch.randn(cfg.hidden_size, generator=gen, device=dev)
    mp = [pos] * len(cfg.mrope_section) if mrope else None
    sk = _clone(state)
    _, logits_k, normed_k = megakernel_forward(cfg, w, sk, embed, mrope_pos=mp, with_head=with_head)
    cos, sin = rope_rows(cfg, w.rope, pos, 1, mp)
    _, logits_r, normed_r = megakernel_forward_reference(cfg, w, state, embed, cos, sin, with_head)
    torch.cuda.synchronize()
    res = {"pos": pos, "kv": "int8" if kv8 else "bf16", "normed_cos": _cos(normed_k, normed_r),
           "normed_max_abs": float((normed_k - normed_r).abs().max())}
    # K/V columns, layer by layer: max |diff| <= 2e-2 * max(1, max |ref|)
    # and relative L2 error < 2e-2. Scaled, not a flat atol: after ~10
    # layers the two versions' different f32 summation orders have flipped
    # enough bf16 roundings that 28-layer columns of magnitude ~4 differ by
    # 1-2 bf16 ulps (0.016-0.031) while their relative error stays below 1%.
    # An int8 column is compared dequantized (rows times scales) at that
    # bar; its layer-0 rows, computed from the same inputs up to summation
    # order, must also be within 1 LSB with scales within rtol 5e-3. Deeper
    # rows quantize f32 values that carry the drift above, so they may
    # differ by more LSBs (counted, not bounded).
    for name, a, b, sa, sb in (("k", sk.k_cache, state.k_cache, sk.k_scale, state.k_scale),
                               ("v", sk.v_cache, state.v_cache, sk.v_scale, state.v_scale)):
        ca, cb = a[:, :, pos].float(), b[:, :, pos].float()
        ok0 = True
        if kv8:
            lsb = (ca - cb).abs()                                  # [L, KVH, D]
            srel = (sa[:, :, pos] - sb[:, :, pos]).abs() / sb[:, :, pos]
            over = (lsb > 1).flatten(1).any(dim=1).nonzero()
            res[f"{name}_row_max_lsb"] = int(lsb.max())
            res[f"{name}_row_max_lsb_layer0"] = int(lsb[0].max())
            res[f"{name}_rows_over_1lsb_frac"] = float((lsb > 1).float().mean())
            res[f"{name}_first_layer_over_1lsb"] = int(over[0]) if len(over) else None
            res[f"{name}_scale_max_rel"] = float(srel.max())
            res[f"{name}_scale_max_rel_layer0"] = float(srel[0].max())
            ok0 = res[f"{name}_row_max_lsb_layer0"] <= 1 and \
                res[f"{name}_scale_max_rel_layer0"] <= 5e-3
            ca, cb = ca * sa[:, :, pos, None], cb * sb[:, :, pos, None]
        ca, cb = ca.flatten(1), cb.flatten(1)
        d = (ca - cb).abs()
        bound = 2e-2 * cb.abs().max(dim=1).values.clamp_min(1.0)
        rel = d.norm(dim=1) / cb.norm(dim=1)
        res[f"{name}_col_max_abs"] = float(d.max())
        res[f"{name}_col_max_rel_l2"] = float(rel.max())
        res[f"{name}_col_ok"] = bool(ok0 and (d.max(dim=1).values <= bound).all()
                                     and (rel < 2e-2).all())
    assert res["normed_cos"] > 0.999, res
    assert res["k_col_ok"] and res["v_col_ok"], res
    if with_head:
        top2 = torch.topk(logits_r, 2).values
        tie = float(top2[0] - top2[1]) < 1e-3 * float(logits_r.abs().max())
        res["argmax_equal"] = int(logits_k.argmax()) == int(logits_r.argmax())
        res["logits_max_abs"] = float((logits_k - logits_r).abs().max())
        assert res["argmax_equal"] or tie, res
        if quant_bar:
            assert res["logits_max_abs"] <= 2e-2 * max(1.0, float(logits_r.abs().max())), res
    return res, (sk, state, embed, cos, sin, mp)


def check_deterministic(cfg, w, pos: int, gen, kv8: bool, label: str):
    """Two kernel steps from copies of one random cache: normed, logits and
    every cache tensor equal bit for bit."""
    import torch
    from qwen_tts_tpu_torch.ops.decode_step import megakernel_forward

    state = random_state(cfg, pos, gen, kv8)
    embed = torch.randn(cfg.hidden_size, generator=gen, device="cuda")
    mp = [pos] * len(cfg.mrope_section)
    a, b = _clone(state), state
    _, la, na = megakernel_forward(cfg, w, a, embed, mrope_pos=mp)
    _, lb, nb = megakernel_forward(cfg, w, b, embed, mrope_pos=mp)
    torch.cuda.synchronize()
    same = (torch.equal(la, lb) and torch.equal(na, nb)
            and all(torch.equal(x, y) for x, y in zip(a[:2] + a[3:], b[:2] + b[3:])
                    if x is not None))
    print("decode step run twice", json.dumps({"case": label, "pos": pos,
                                                "kv": "int8" if kv8 else "bf16",
                                                "bit_identical": same}))
    assert same, label
    return same


def time_step_positions(cfg, w, gen, card, kv8: bool = False):
    """Talker step at STEP_TIMED positions over a random cache, the same
    row each call (so each call also fills the positions array): the
    device's span with the host ahead (CUDA events; the step kernel and
    the small fill kernel), the kernels the profiler saw a call,
    back-to-back call ms, and the bound."""
    import torch
    from qwen_tts_tpu_torch.ops.decode_step import megakernel_forward

    out = {}
    for pos in STEP_TIMED:
        state = random_state(cfg, pos, gen, kv8)
        embed = torch.randn(cfg.hidden_size, generator=gen, device="cuda")
        mp = [pos] * len(cfg.mrope_section)
        step = lambda: megakernel_forward(cfg, w, state, embed, mrope_pos=mp)  # noqa: E731
        counts = _kernels_seen(step, 10)
        # one step kernel a call (and the positions fill): never more
        assert set(counts) <= {"decode_persistent", "set_ints"} and all(
            n <= 1 for n in counts.values()), counts
        res = {"device_span_ms": _span_ms(step, 10), "kernels_per_call_seen": counts,
               "call_ms": _time_ms(step, 20)}
        res["bound_ms"], res["bound_by"] = _bound_ms(*step_cost(cfg, w, pos, True, kv8))
        out[pos] = res
        print(f"talker step [{'int8' if kv8 else 'bf16'} cache] at position {pos}: "
              f"{json.dumps(res)} {card}")
        del state
    return out


def kernels_per_step(cfg, w, state, talker: bool, label: str):
    """20 consecutive decode steps from the state's position under the
    profiler: the step kernel's launches a step as it counts them itself
    in its workspace (exactly 1), and the kernels the profiler saw, by
    name (the step kernel and nothing else: the position array advances
    inside the kernel), from a run in which it saw at least one. The
    profiler's own count is a ceiling: it loses events under load."""
    import torch
    from qwen_tts_tpu_torch.ops import decode_step
    from qwen_tts_tpu_torch.ops.decode_step import megakernel_forward

    embed = torch.randn(cfg.hidden_size, device="cuda")
    box = [state]

    def step():
        pos = box[0].position
        mp = [pos] * len(cfg.mrope_section) if talker else None
        box[0], _, _ = megakernel_forward(cfg, w, box[0], embed, mrope_pos=mp, with_head=talker)

    step()  # the positions array now holds the next step's positions
    n0 = decode_step.device_launches(cfg, embed.device)
    counts = {}
    for tries in range(1, 6):  # each try: 21 steps
        counts = {k: v[1] for k, v in _kernel_counts(step, 20).items()}
        if counts:
            break
    per_step = (decode_step.device_launches(cfg, embed.device) - n0) / (21 * tries)
    print(f"kernels per decode step [{label}]: the step kernel's own count {per_step}; the "
          f"profiler saw {json.dumps(counts)}")
    assert per_step == 1 and counts and set(counts) <= {"decode_persistent"}, (per_step, counts)
    return per_step


def time_steps(cfg, w, ctx, with_head: bool, iters: int):
    """(kernel ms, plain ms) of one step at the context's position."""
    from qwen_tts_tpu_torch.ops.decode_step import (
        megakernel_forward,
        megakernel_forward_reference,
    )

    sk, sr, embed, cos, sin, mp = ctx
    kernel = lambda: megakernel_forward(cfg, w, sk, embed, mrope_pos=mp, with_head=with_head)  # noqa: E731
    plain = lambda: megakernel_forward_reference(cfg, w, sr, embed, cos, sin, with_head)  # noqa: E731
    return _interleaved(kernel, plain, iters, max(iters // 5, 3))


def check_stream(eng, chunks):
    """The chunk lengths of a streaming request and finite, nonzero audio."""
    import numpy as np

    hop = eng.vocoder_config.hop_length
    chunk = eng.config.chunk_frames * hop
    lens = [len(c) for c in chunks]
    assert lens[0] == hop, lens
    assert all(n == chunk for n in lens[1:-1]), lens
    assert len(lens) == 1 or (0 < lens[-1] <= chunk and lens[-1] % hop == 0), lens
    audio = np.concatenate(chunks)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    return audio


def stream(eng, text):
    """One streaming request: (TTFC s, wall s, chunks)."""
    async def run():
        t0 = time.perf_counter()
        ttfc, chunks = None, []
        async for audio, sr in eng.synthesize_streaming(text):
            if ttfc is None:
                ttfc = time.perf_counter() - t0
            chunks.append(audio)
        return ttfc, time.perf_counter() - t0, chunks
    return asyncio.run(run())


def run_requests(eng):
    """Three streaming requests and one synthesize; returns per-request stats."""
    import numpy as np
    import torch

    hop = eng.vocoder_config.hop_length
    stats = []
    for text in TEXTS:
        ttfc, wall, chunks = stream(eng, text)
        audio = check_stream(eng, chunks)
        stats.append({"text_words": len(text.split()), "chunks": len(chunks),
                      "audio_s": len(audio) / eng.sample_rate, "ttfc_ms": ttfc * 1e3,
                      "wall_s": wall, "rtf": wall / (len(audio) / eng.sample_rate)})
    t0 = time.perf_counter()
    wav, sr = eng.synthesize(TEXTS[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert len(wav) > 0 and len(wav) % hop == 0 and np.isfinite(wav).all()
    stats.append({"synthesize": True, "audio_s": len(wav) / sr, "wall_s": wall,
                  "rtf": wall / (len(wav) / sr)})
    return stats


def serve(eng, texts=TEXTS, synthesize: bool = True, request0: int = 200,
          synthesize_text: str = TEXTS[1]):
    """The streaming requests of `texts`, numbered from `request0`, through
    the engine's chunk generator, then one `synthesize` of `synthesize_text`:
    ([(TTFC ms, wall s, audio s, [(audio, frames)...]) per request],
    (waveform, the frames it decoded) or None)."""
    out = []
    for r, text in enumerate(texts):
        eng._requests = request0 + r - 1
        t0 = time.perf_counter()
        ttfc, chunks = None, []
        for audio, frames in eng._generate_chunks(text, eng.config.chunk_frames, True):
            ttfc = ttfc or time.perf_counter() - t0
            chunks.append((audio, frames))
        wall = time.perf_counter() - t0
        out.append((ttfc * 1e3, wall, sum(len(a) for a, _ in chunks) / eng.sample_rate, chunks))
    if not synthesize:
        return out, None
    eng._requests = request0 + len(texts) - 1
    seen, real = [], eng._decode_to_audio
    eng._decode_to_audio = lambda frames: (seen.append(list(frames)), real(frames))[1]
    try:
        wav, _sr = eng.synthesize(synthesize_text)
    finally:
        del eng._decode_to_audio
    return out, (wav, seen[-1])


def graph_against_eager(geng, label: str, card: str) -> dict:
    """Phase 13: the graph engine `geng` against an eager engine on its
    weights (`fused_chunks=False`), the same requests and request numbers:
    codes equal bit for bit, audio within 1e-4 * max(1, max |eager|); then
    one warm request of the graph engine under the profiler; TTFC and RTF
    medians of both."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine

    eeng = TTSEngine(TTSConfig(fused_chunks=False, kv_cache=geng.config.kv_cache))
    eeng.initialize(weights=geng.weights, vocoder_weights=geng.vocoder_weights)
    serve(eeng, TEXTS[:1], synthesize=False, request0=190)     # warm
    g_out, g_syn = serve(geng, TEXTS[:2])
    e_out, e_syn = serve(eeng, TEXTS[:2])
    stack = lambda chunks: np.stack([f for _a, fr in chunks for f in fr])  # noqa: E731
    res = {"form": label, "requests": [], "synthesize": {}}
    for (_t, _w, _s, gc), (_t2, _w2, _s2, ec) in zip(g_out, e_out):
        lens = ([len(fr) for _a, fr in gc], [len(fr) for _a, fr in ec])
        diff = max(float(np.abs(a - b).max()) for (a, _), (b, _) in zip(gc, ec))
        scale = max(1.0, max(float(np.abs(b).max()) for b, _ in ec))
        res["requests"].append({"chunks": len(gc), "frames": int(sum(lens[0])),
                                "codes_equal": lens[0] == lens[1]
                                and bool(np.array_equal(stack(gc), stack(ec))),
                                "audio_max_abs_diff": diff, "bar": 1e-4 * scale})
    (gw, gf), (ew, ef) = g_syn, e_syn
    res["synthesize"] = {"frames": len(gf), "codes_equal": len(gf) == len(ef) and bool(
        np.array_equal(np.stack(gf), np.stack(ef))), "audio_max_abs_diff": float(
        np.abs(gw - ew).max()), "bar": 1e-4 * max(1.0, float(np.abs(ew).max()))}
    print(f"graph against eager [{label}]: {json.dumps(res)}")
    for r in res["requests"] + [res["synthesize"]]:
        assert r["codes_equal"] and r["audio_max_abs_diff"] <= r["bar"], res

    geng._requests = 230
    r0 = geng._graphs.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunks = list(geng._generate_chunks(TEXTS[2], geng.config.chunk_frames, True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    replays = geng._graphs.replays - r0
    calls, busy_us = {}, 0.0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            busy_us += e.self_device_time_total
        elif e.key.startswith("cuda") and e.count:
            calls[e.key] = e.count
    graph_launches = calls.pop("cudaGraphLaunch", 0)
    prof_res = {"chunks_yielded": len(chunks), "replays": replays,
                "cudaGraphLaunch": graph_launches,
                "other_cuda_calls_per_chunk": {k: v / replays for k, v in sorted(calls.items())},
                "device_busy_share": busy_us / 1e6 / wall, "profiled_wall_s": wall}
    print(f"graph path [{label}], one warm {len(TEXTS[2].split())}-word request profiled: "
          f"{json.dumps(prof_res)} {card}")
    assert graph_launches == replays >= len(chunks), prof_res

    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    times = {f"{name}_{k}": med([f(r) for r in out]) for name, out in (("graph", g_out),
                                                                        ("eager", e_out))
             for k, f in (("ttfc_ms", lambda r: r[0]), ("rtf", lambda r: r[1] / r[2]))}
    print(f"graph against eager [{label}], medians of the two streaming requests: TTFC "
          f"graph {times['graph_ttfc_ms']:.2f} ms, eager {times['eager_ttfc_ms']:.2f} ms; "
          f"RTF graph {times['graph_rtf']:.4f}, eager {times['eager_rtf']:.4f} {card}")
    del eeng
    return {**times, "device_busy_share": prof_res["device_busy_share"],
            "cuda_graph_launches": graph_launches, "replays": replays}


def record_logits(frame_loop):
    """Patch the frame loop to keep, per frame, the talker logits that chose
    code 0 and the code-predictor logits `[15, V]` that chose codes 1..15.
    Returns (talker, cp, undo)."""
    from qwen_tts_tpu_torch.models.decoder import lm_head_logits

    real_cp, real_step = frame_loop.cp_predict, frame_loop.decode_step_with_embed
    talker, cp = [], []

    def cp_predict(*a, **k):
        codes, logits = real_cp(*a, **{**k, "return_logits": True})
        cp.append(logits)
        return codes

    def decode_step_with_embed(cfg, w, *a, **k):
        state, token, normed = real_step(cfg, w, *a, **k)
        talker.append(lm_head_logits(w, normed[None])[0])
        return state, token, normed

    def undo():
        frame_loop.cp_predict, frame_loop.decode_step_with_embed = real_cp, real_step

    frame_loop.cp_predict, frame_loop.decode_step_with_embed = cp_predict, decode_step_with_embed
    return talker, cp, undo


def reduced_engine_parity(backend: str = "auto", **quant):
    """A reduced model, greedy, on the GPU (kernels) and on the CPU (plain
    path), both on `backend`, with the engine options `quant`. The first
    frame's 16 codes must be equal and its audio close (atol 1e-3). Over the first 8 frames, >= 95% of the
    codes must be equal, or else the first code that differs must be a near
    tie: the CPU logits that chose it have a top-2 gap < 2e-2 and the GPU
    chose the runner-up. (The two devices sum in different orders; one
    near-tie flip changes every frame after it.)"""
    import numpy as np
    import torch
    from qwen_tts_tpu_torch.core.config import tiny_test_config
    from qwen_tts_tpu_torch.core.weights import init_tts_weights
    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
    from qwen_tts_tpu_torch.runtime import frame_loop
    from qwen_tts_tpu_torch.vocoder.model import VocoderConfig, init_vocoder_weights

    mc = tiny_test_config(max_seq_len=256)
    w_cpu = init_tts_weights(SEED, mc, "cpu")
    v_cpu = init_vocoder_weights(SEED + 1, VocoderConfig(), "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        eng = TTSEngine(TTSConfig(device=dev, backend=backend, max_seq_len=256,
                                  chunk_frames=4, subtalker_do_sample=False,
                                  fused_chunks=backend != "pallas", **quant),
                        model_config=mc)
        to_dev = lambda t: t.to(dev)  # noqa: E731
        eng.initialize(weights=_map(to_dev, w_cpu), vocoder_weights=_map(to_dev, v_cpu))
        if dev == "cpu":
            talker_logits, cp_logits, undo = record_logits(frame_loop)
        try:
            chunks = list(eng._generate_chunks(TEXTS[0], 4, with_audio=True))
        finally:
            if dev == "cpu":
                undo()
        out[dev] = (chunks[0][0], np.stack([f for _a, fr in chunks for f in fr][:8]))
    (audio_g, a), (audio_c, b) = out["cuda"], out["cpu"]
    n = min(len(a), len(b))
    res = {"backend": backend, **quant, "first_frame_equal": bool((a[0] == b[0]).all()),
           "first_chunk_audio_max_abs": float(np.abs(audio_g - audio_c).max()),
           "frames": n, "codes_equal_frac_8_frames": float((a[:n] == b[:n]).mean())}
    assert res["first_frame_equal"] and res["first_chunk_audio_max_abs"] < 1e-3, (res, a, b)
    diff = np.argwhere(a[:n] != b[:n])
    if len(diff):
        f, g = (int(x) for x in diff[0])
        logits = talker_logits[f] if g == 0 else cp_logits[f][g - 1]
        top2 = torch.topk(logits, 2)
        res.update(first_diff_frame_group=[f, g],
                   first_diff_top2_gap=float(top2.values[0] - top2.values[1]),
                   first_diff_gpu_took_runner_up=int(a[f, g]) == int(top2.indices[1]))
        near_tie = res["first_diff_top2_gap"] < 2e-2 and res["first_diff_gpu_took_runner_up"]
        assert res["codes_equal_frac_8_frames"] >= 0.95 or near_tie, (res, a, b)
    return res


def _map(fn, tree):
    if isinstance(tree, tuple):
        return type(tree)(*[_map(fn, x) for x in tree]) if hasattr(tree, "_fields") \
            else tuple(_map(fn, x) for x in tree)
    return fn(tree)


def _reset_launches():
    import torch

    from qwen_tts_tpu_torch.ops import attention, decode_step, generate_kernel

    for fn in (decode_step.megakernel_forward, generate_kernel.generate_megakernel):
        fn.launches = 0
    attention.reset_device_launches(torch.device("cuda"))


def attention_inputs(cfg, gen):
    """Full-shape decode-attention inputs: q, k_new, v_new f32, caches
    [L, KVH, S, D] bf16 poisoned everywhere (77 / -77), and random rows for
    layer ATTN_LAYER to copy in below each position."""
    import torch

    L, KVH, S, D, HQ = (cfg.num_layers, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim,
                        cfg.num_q_heads)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    q, k_new, v_new = rnd(HQ, D), rnd(KVH, D), rnd(KVH, D)
    kc = torch.full((L, KVH, S, D), -77.0, dtype=torch.bfloat16, device="cuda")
    vc = torch.full((L, KVH, S, D), 77.0, dtype=torch.bfloat16, device="cuda")
    rows = (rnd(KVH, S, D).bfloat16(), rnd(KVH, S, D).bfloat16())
    return q, k_new, v_new, kc, vc, rows


def set_prefix(kc, vc, rows, pos: int):
    """Layer ATTN_LAYER: random rows below `pos`, 99 from `pos` on."""
    for cache, r in ((kc, rows[0]), (vc, rows[1])):
        cache[ATTN_LAYER, :, :pos] = r[:, :pos]
        cache[ATTN_LAYER, :, pos:] = 99.0


def _dev_pos(*positions):
    """Positions as the decode-attention kernel reads them: a device int32
    tensor, `[]` for one position, `[B]` for B."""
    import torch

    t = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return t[0] if len(positions) == 1 else t


def compare_attention(cfg, gen):
    """Phase 5: the decode-attention kernel against its plain version."""
    import torch
    from qwen_tts_tpu_torch.ops.attention import decode_attention, decode_attention_reference

    q, k_new, v_new, kc, vc, rows = attention_inputs(cfg, gen)
    errs = []
    for pos in ATTN_POSITIONS:
        set_prefix(kc, vc, rows, pos)
        p = _dev_pos(pos)
        got = decode_attention(q, k_new, v_new, kc, vc, ATTN_LAYER, p)
        again = decode_attention(q, k_new, v_new, kc, vc, ATTN_LAYER, p)
        want = decode_attention_reference(q, k_new, v_new, kc, vc, ATTN_LAYER, p)
        torch.cuda.synchronize()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        same = torch.equal(got, again)
        ok = err <= 2e-3 * max(1.0, scale) and bool(torch.isfinite(got).all()) and same
        print("decode attention vs plain", json.dumps(
            {"pos": pos, "max_abs": err, "ref_max_abs": scale, "run_twice_bit_identical": same,
             "ok": ok}))
        assert ok, (pos, err, scale)
        errs.append(err)
    # the kernel's other instantiations: G = 1 and G = 8 q heads per kv head
    for HQ, KVH in ((8, 8), (16, 2)):
        q2, kn2, vn2 = (torch.randn(shape, generator=gen, device="cuda")
                        for shape in ((HQ, 128), (KVH, 128), (KVH, 128)))
        kc2, vc2 = (torch.randn(2, KVH, 1088, 128, generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
        for pos in (0, 65, 1025):
            got = decode_attention(q2, kn2, vn2, kc2, vc2, 1, _dev_pos(pos))
            want = decode_attention_reference(q2, kn2, vn2, kc2, vc2, 1, _dev_pos(pos))
            torch.cuda.synchronize()
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            print("decode attention vs plain", json.dumps(
                {"G": HQ // KVH, "pos": pos, "max_abs": err, "ref_max_abs": scale}))
            assert err <= 2e-3 * max(1.0, scale), (HQ, KVH, pos, err)
            errs.append(err)
    return max(errs), (q, k_new, v_new, kc, vc, rows)


def generate_loop(cfg, w, state, first: int, steps: int, starts):
    """N decode-step launches + torch.argmax + embed[token]: what the
    N-step kernel must equal bit for bit. Returns (state, tokens [N])."""
    import torch
    from qwen_tts_tpu_torch.ops.decode_step import megakernel_forward

    tok, toks = torch.full((1,), first, dtype=torch.long, device="cuda"), []
    for n in range(steps):
        mp = [s + n for s in starts]
        state, logits, _ = megakernel_forward(cfg, w, state, w.embed[tok][0].float(),
                                              mrope_pos=mp)
        tok = torch.argmax(logits).reshape(1)
        toks.append(tok)
    return state, torch.cat(toks)


def compare_generate(cfg, w, state, first: int, starts, label: str):
    """One N-step call under sync-debug "error" (no step may sync the host),
    then the step loop from a copy of the same state: tokens and the
    written cache columns must be equal bit for bit."""
    import torch
    from qwen_tts_tpu_torch.ops.generate_kernel import generate_megakernel

    pos0 = state.position
    loop_state = _clone(state)
    before = generate_megakernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, toks = generate_megakernel(cfg, w, state, first, GEN_STEPS, mrope_pos0=starts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    calls = generate_megakernel.launches - before
    loop_state, loop_toks = generate_loop(cfg, w, loop_state, first, GEN_STEPS, starts)
    torch.cuda.synchronize()
    cols = slice(pos0, pos0 + GEN_STEPS)
    diff = max(float((state.k_cache[:, :, cols].float() - loop_state.k_cache[:, :, cols].float())
                     .abs().max()),
               float((state.v_cache[:, :, cols].float() - loop_state.v_cache[:, :, cols].float())
                     .abs().max()))
    caches = [(a, b) for a, b in zip(state[:2] + state[3:], loop_state[:2] + loop_state[3:])
              if a is not None]
    res = {"case": label, "pos0": pos0, "steps": GEN_STEPS, "c_calls": calls,
           "tokens_equal": bool(torch.equal(toks.long(), loop_toks)),
           "cache_equal": all(torch.equal(a, b) for a, b in caches),
           "cache_cols_max_abs": diff, "position": state.position,
           "first_tokens": toks[:8].tolist()}
    print("generate vs decode-step loop", json.dumps(res))
    assert calls == 1 and state.position == pos0 + GEN_STEPS, res
    assert res["tokens_equal"] and res["cache_equal"], res
    return res


def time_attention(cfg, ctx, card):
    """Phase 8: kernel, plain and scaled_dot_product_attention per position:
    device time per call (profiler) and back-to-back call time (CUDA
    events, which the host's enqueue bounds when it is the slower)."""
    import torch
    import torch.nn.functional as F
    from qwen_tts_tpu_torch.ops.attention import decode_attention, decode_attention_reference

    q, k_new, v_new, kc, vc, rows = ctx
    out = {}
    for pos in ATTN_TIMED:
        set_prefix(kc, vc, rows, pos)
        p = _dev_pos(pos)
        kernel = lambda: decode_attention(q, k_new, v_new, kc, vc, ATTN_LAYER, p)  # noqa: E731
        plain = lambda: decode_attention_reference(  # noqa: E731
            q, k_new, v_new, kc, vc, ATTN_LAYER, p)
        qb = q.bfloat16()[None, :, None, :]
        kb = torch.cat([kc[ATTN_LAYER, :, :pos], k_new.bfloat16()[:, None]], dim=1)[None]
        vb = torch.cat([vc[ATTN_LAYER, :, :pos], v_new.bfloat16()[:, None]], dim=1)[None]
        lib = lambda: F.scaled_dot_product_attention(qb, kb, vb, enable_gqa=True)  # noqa: E731
        k_call, p_call = _interleaved(kernel, plain, 200, 50)
        l_call = min(_time_ms(lib, 200), _time_ms(lib, 200))
        k_ms, p_ms = _device_ms(kernel, 100), _device_ms(plain, 20)
        l_ms = _device_ms(lib, 100)
        nbytes = 2 * cfg.num_kv_heads * pos * cfg.head_dim * 2 + (
            2 * q.numel() + 2 * k_new.numel()) * 4
        flops = 4 * cfg.num_q_heads * (pos + 1) * cfg.head_dim
        b_ms, b_by = _bound_ms(nbytes, flops)
        out[pos] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "call_ms": k_call, "plain_call_ms": p_call,
                    "library_call_ms": l_call}
        print(f"decode attention (pos {pos}, layer of [28,8,8192,128]), device ms per call: "
              f"kernel {k_ms:.5f}, plain {p_ms:.5f}, scaled_dot_product_attention "
              f"{l_ms:.5f}, bound {b_ms:.5f} ({b_by}); back-to-back call ms: kernel "
              f"{k_call:.5f}, plain {p_call:.5f}, sdpa {l_call:.5f} {card}")
    return out


def time_generate(cfg, w, card, kv8: bool = False, label: str = "bf16"):
    """Phases 8 and 12: one N-step call (N = 64) beside its plain version,
    the kernels an 8-step call launches, and N = 256 from position 0 as
    tokens/s beside the decode-step host loop, with the device's span per
    step (the call with the host ahead) and its idle share while the call
    runs."""
    import torch
    from qwen_tts_tpu_torch.core.config import CODEC_BOS
    from qwen_tts_tpu_torch.models.decoder import init_state
    from qwen_tts_tpu_torch.ops.decode_step import device_launches
    from qwen_tts_tpu_torch.ops.generate_kernel import (
        generate_megakernel,
        generate_megakernel_reference,
    )

    state = init_state(cfg, "cuda", torch.int8 if kv8 else torch.bfloat16)
    starts = [0] * len(cfg.mrope_section)
    first = torch.full((1,), CODEC_BOS, dtype=torch.int32, device="cuda")
    kernel = lambda: generate_megakernel(cfg, w, state, first, GEN_STEPS, starts)  # noqa: E731
    plain = lambda: generate_megakernel_reference(  # noqa: E731
        cfg, w, state, first, GEN_STEPS, starts)
    # the plain loop (5-10 s) compiles nothing and the earlier phases ran its
    # ops: one run of it, then the kernel's best of two
    p_ms = _time_ms(plain, 1, warmup=0)
    k_ms = min(_time_ms(kernel, 3, warmup=1), _time_ms(kernel, 3, warmup=1))
    nbytes = flops = 0
    for n in range(GEN_STEPS):
        b, f = step_cost(cfg, w, n, True, kv8)
        nbytes, flops = nbytes + b, flops + f
    b_ms, b_by = _bound_ms(nbytes, flops)
    print(f"generate [{label}], {GEN_STEPS} steps from position 0: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) {card}")

    n0 = device_launches(cfg, w.embed.device)
    counts, calls = {}, 0
    for _ in range(5):  # each try: 6 calls, until the profiler saw a kernel
        counts = {k: v[1] for k, v in _kernel_counts(
            lambda: generate_megakernel(cfg, w, state, first, 8, starts), 5).items()}
        calls += 6
        if counts:
            break
    per_call = (device_launches(cfg, w.embed.device) - n0) / calls
    print(f"generate [{label}], kernels an 8-step call launches: the kernel's own count "
          f"{per_call}; the profiler saw {json.dumps(counts)}")
    # the step kernel, at most once a call, and the fill of the positions
    # array (each call starts from the same position): nothing else
    assert per_call == 1 and counts and set(counts) <= {"decode_persistent", "set_ints"} and \
        counts.get("decode_persistent", 0) <= 1, (per_call, counts)

    n = GEN_TIMED_STEPS
    call = lambda: generate_megakernel(cfg, w, state, first, n, starts)  # noqa: E731
    loop = lambda: generate_loop(cfg, w, state, CODEC_BOS, n, starts)  # noqa: E731
    g_ms, l_ms = _interleaved(call, loop, 2, 2, warmup=1)
    span_ms = _span_ms(call, 1)
    nbytes = sum(step_cost(cfg, w, i, True, kv8)[0] for i in range(n))
    b_ms256 = nbytes / HBM_BYTES_PER_S * 1e3
    tok_s = {"generate_tok_s": n / g_ms * 1e3, "decode_step_loop_tok_s": n / l_ms * 1e3,
             "bound_tok_s": n / b_ms256 * 1e3, "device_span_ms_per_step": span_ms / n,
             "device_idle_share": max(0.0, 1 - span_ms / g_ms), "bound_ms_per_step": b_ms256 / n,
             "kernels_per_call": per_call}
    print(f"generate [{label}], {n} steps from position 0: {g_ms / n:.4f} ms/step = "
          f"{tok_s['generate_tok_s']:.1f} tok/s (device span {span_ms / n:.4f} ms/step, idle "
          f"share {tok_s['device_idle_share']:.4f}); "
          f"decode-step host loop {l_ms / n:.4f} ms/step = "
          f"{tok_s['decode_step_loop_tok_s']:.1f} tok/s; weight-bandwidth bound "
          f"{b_ms256 / n:.4f} ms/step = {tok_s['bound_tok_s']:.1f} tok/s {card}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, **tok_s}


_T0 = time.perf_counter()


def synthetic_code2wav_state(cfg, seed: int, device) -> dict:
    """A Code2Wav state dict under the torch module's key names, f32 on
    `device`, from a seed: norm scales 1 + N(0, 0.02), everything else
    N(0, 0.02) (the scale of the module's own initializer)."""
    import torch
    from qwen_tts_tpu_torch.vocoder.code2wav import code2wav_state, init_code2wav_weights

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = {k: v.shape for k, v in code2wav_state(
        init_code2wav_weights(0, cfg, "meta"), cfg).items()}
    return {k: float(k.endswith("norm.weight")) + 0.02 * torch.randn(
        s, generator=gen, device=device) for k, s in shapes.items()}


def code2wav_flops(cfg, frames: int) -> float:
    """Multiply-adds x 2 of one Code2Wav decode of `frames` frames (the
    transformer's products and every conv), from the shapes."""
    h, t = cfg.hidden_size, frames
    qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim
    per_layer = t * h * (qkv + cfg.num_attention_heads * cfg.head_dim + 3 * cfg.intermediate_size)
    per_layer += 2 * t * min(t, cfg.sliding_window) * cfg.num_attention_heads * cfg.head_dim
    macs = cfg.num_hidden_layers * per_layer
    for r in cfg.upsampling_ratios:
        macs += h * h * r * t                                   # k = r transposed conv
        t *= r
        macs += h * 7 * t + 8 * h * h * t                       # ConvNeXt
    c = cfg.decoder_dim
    macs += h * c * 7 * t
    for r in cfg.upsample_rates:
        macs += c * (c // 2) * 2 * r * t                        # k = 2r transposed conv
        t, c = t * r - r, c // 2
        macs += 3 * (c * c * 7 + c * c) * t                     # residual units
    return 2.0 * (macs + c * 7 * t)


def _timed(fn, sync_first: bool = True):
    """fn() with the card synchronised after it, and before it unless
    `sync_first` is False (then the time includes waiting for work already
    queued): (result, seconds)."""
    import torch

    if sync_first:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _warm_ttfc_rtf(eng, n: int = 5) -> dict:
    """TTFC median of `n` warm streaming requests of TEXTS[1], and their
    streaming RTF (all wall over all audio)."""
    stream(eng, TEXTS[1])
    runs = [stream(eng, TEXTS[1]) for _ in range(n)]
    ttfc = sorted(r[0] * 1e3 for r in runs)
    audio_s = sum(sum(len(c) for c in r[2]) for r in runs) / eng.sample_rate
    return {"ttfc_ms_median": ttfc[n // 2], "ttfc_ms_min": ttfc[0], "ttfc_ms_max": ttfc[-1],
            "rtf": sum(r[1] for r in runs) / audio_s}


def code2wav_phase(eng, card: str, c2c=None) -> dict:
    """Phase 14: a checkpoint round trip and the Code2Wav vocoder (at
    `c2c`, the public `Code2WavConfig()` unless given; see the module
    docstring). `eng` is phase 3's bf16 engine: every engine here takes its
    configuration, model and device, with the vocoder options changed."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from qwen_tts_tpu_torch.core.safetensors import save_file
    from qwen_tts_tpu_torch.core.weights import load_tts_weights, tts_state_dict
    from qwen_tts_tpu_torch.engine.tts_engine import TTSEngine
    from qwen_tts_tpu_torch.vocoder.code2wav import (
        Code2WavConfig,
        convert_code2wav_state,
        named_leaves,
    )
    from qwen_tts_tpu_torch.vocoder.code2wav_fast import (
        code2wav_apply_packed,
        pack_code2wav_weights,
    )
    from qwen_tts_tpu_torch.vocoder.loader import load_code2wav

    mc, dev, c2c = eng.model_config, eng.device, c2c or Code2WavConfig()
    state = synthetic_code2wav_state(c2c, SEED + 21, dev)
    c2w = convert_code2wav_state(state, c2c, dev)
    stack = lambda chunks: np.stack([f for _a, fr in chunks for f in fr])  # noqa: E731
    res = {"card": card}

    def config(**kw):
        return dataclasses.replace(eng.config, vocoder_backend="code2wav", code2wav_config=c2c,
                                   **kw)

    def engine(**kw):
        e = TTSEngine(config(**kw), model_config=mc)
        e.initialize(weights=eng.weights, vocoder_weights=c2w)
        return e

    # 1. the checkpoint round trip
    with tempfile.TemporaryDirectory() as d:
        _, write_s = _timed(lambda: (save_file(tts_state_dict(eng.weights, mc),
                                               f"{d}/model.safetensors"),
                                     save_file(state, f"{d}/code2wav.safetensors")))
        _, load_w_s = _timed(lambda: load_tts_weights(d, mc, dev, verbose=False))
        _, load_v_s = _timed(lambda: load_code2wav(d, c2c, dev))
        peng = TTSEngine(config(model_path=d, vocoder_path=d), model_config=mc)
        _, init_s = _timed(peng.initialize)
    del state
    meng = engine()
    assert not peng._vocoder_is_random
    p_out, _ = serve(peng, TEXTS[:2], synthesize=False, request0=300)
    m_out, _ = serve(meng, TEXTS[:2], synthesize=False, request0=300)
    same = all(np.array_equal(stack(a[3]), stack(b[3])) and all(
        np.array_equal(x, y) for (x, _), (y, _) in zip(a[3], b[3])) for a, b in zip(p_out, m_out))
    res["checkpoint"] = {
        "tokenizer": type(peng.tokenizer).__name__, "write_s": write_s,
        "load_tts_weights_s": load_w_s, "load_code2wav_s": load_v_s,
        "engine_init_from_path_s": init_s, "codes_and_audio_equal_in_memory_engine": same,
        "tts_values": sum(v.numel() for v in tts_state_dict(eng.weights, mc).values()),
        "c2w_values": sum(t.numel() for _p, t in named_leaves(c2w))}
    print(f"checkpoint round trip (model.safetensors {res['checkpoint'].pop('tts_values')}"
          f" bf16 values, code2wav.safetensors {res['checkpoint'].pop('c2w_values')} f32): "
          f"{json.dumps(res['checkpoint'])} {card}")
    assert same and res["checkpoint"]["tokenizer"] == "FallbackTokenizer", res
    del meng

    # 2. graph against eager, both dtypes; launches; synthesize; GPU against CPU
    res["dtypes"] = {}
    graphs = {"float32": peng, "bfloat16": engine(vocoder_dtype="bfloat16")}
    for dt, g in graphs.items():
        e = engine(vocoder_dtype=dt, fused_chunks=False)
        serve(e, TEXTS[:1], synthesize=False, request0=190)         # warm
        m0, d0 = g.get_metrics(), g.decode_launches()
        g_out, _ = serve(g, TEXTS[:2], synthesize=False, request0=310)
        launches = g.decode_launches() - d0
        m1 = g.get_metrics()
        steps = (m1["talker_steps"] - m0["talker_steps"]) + (m1["cp_steps"] - m0["cp_steps"])
        e_out, _ = serve(e, TEXTS[:2], synthesize=False, request0=310)
        r = {"requests": [], "decode_step_launches": launches, "decode_steps": steps}
        for a, b in zip(g_out, e_out):
            ga, ea = a[3], b[3]
            r["requests"].append({
                "chunks": len(ga), "frames": int(sum(len(f) for _x, f in ga)),
                "codes_equal": [len(f) for _x, f in ga] == [len(f) for _x, f in ea]
                and bool(np.array_equal(stack(ga), stack(ea))),
                "audio_max_abs_diff": max(float(np.abs(x - y).max())
                                          for (x, _), (y, _) in zip(ga, ea)),
                "audio_max_abs": max(float(np.abs(x).max()) for x, _ in ga)})
        g._requests = 319
        wav, _sr = g.synthesize(TEXTS[1])
        g._requests = 319
        joined = np.concatenate([a for a, _f in g._generate_chunks(TEXTS[1], 10, True)])
        r["synthesize_equals_stream"] = bool(np.array_equal(wav, joined))
        print(f"code2wav [{dt}], graph against eager: {json.dumps(r)} {card}")
        assert launches == steps > 0, r
        assert r["synthesize_equals_stream"], r
        for q in r["requests"]:
            assert q["codes_equal"] and q["audio_max_abs_diff"] <= 1e-4, r
        res["dtypes"][dt] = r
        del e

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    codes = torch.randint(0, 3072, (35, mc.num_code_groups), generator=gen, device=dev)
    w_cpu = pack_code2wav_weights(_map(lambda t: t.cpu(), c2w), torch.float32)
    (ref,), cpu_s = _timed(lambda: code2wav_apply_packed(
        c2c, w_cpu, codes.clamp(0, c2c.codebook_size - 1).t()[None].cpu()))
    ref = ref.double()
    cmp = {"frames": 35, "cpu_s": cpu_s, "cpu_max_abs": float(ref.abs().max()),
           "cpu_clipped_share": float((ref.abs() >= 1).double().mean())}
    for dt, g in graphs.items():
        out = g._raw_decode(codes).double().cpu()
        cmp[dt] = {"rel_l2": float((out - ref).norm() / ref.norm()), "cosine": _cos(out, ref),
                   "max_abs_diff": float((out - ref).abs().max())}
    print(f"code2wav on the card against the CPU (f32 packed), same 35 frames: "
          f"{json.dumps(cmp)} {card}")
    assert cmp["float32"]["rel_l2"] <= 1e-3 and cmp["bfloat16"]["cosine"] >= 0.995, cmp
    res["gpu_vs_cpu"] = cmp

    # 3. two bf16 requests interleaved chunk by chunk on one engine
    g = graphs["bfloat16"]
    alone = [serve(g, (t,), synthesize=False, request0=330 + i)[0][0][3]
             for i, t in enumerate(TEXTS[1:])]
    times = {"park": [], "restore": []}
    for name in times:
        real = getattr(g, f"_{name}")

        def timed(s, _real=real, _name=name):
            times[_name].append(_timed(lambda: _real(s), sync_first=False)[1] * 1e3)
        setattr(g, f"_{name}", timed)
    try:
        g._requests = 329
        its = [iter(g._generate_chunks(t, 10, True)) for t in TEXTS[1:]]
        got, live = [[], []], [0, 1]
        while live:
            for i in list(live):
                c = next(its[i], None)
                if c is None:
                    live.remove(i)
                else:
                    got[i].append(c)
    finally:
        del g._park, g._restore
    inter = {"chunks": [len(c) for c in got], "parks": len(times["park"]),
             "park_ms": times["park"], "restore_ms": times["restore"],
             "equal_alone": all(
                 [len(f) for _x, f in a] == [len(f) for _x, f in b]
                 and np.array_equal(stack(a), stack(b))
                 and all(np.array_equal(x, y) for (x, _), (y, _) in zip(a, b))
                 for a, b in zip(alone, got))}
    print(f"code2wav [bfloat16], two requests interleaved chunk by chunk: {json.dumps(inter)} "
          f"{card}")
    assert inter["equal_alone"] and inter["parks"] >= 2, inter
    res["interleaved"] = inter

    # 4. timings
    res["timings"] = {"default (fast vocoder)": _warm_ttfc_rtf(eng)}
    for dt, g in graphs.items():
        res["timings"][f"code2wav {dt}"] = _warm_ttfc_rtf(g)
    res["timings"]["default (fast vocoder), again"] = _warm_ttfc_rtf(eng)
    for k, v in res["timings"].items():
        print(f"main path [{k}]: TTFC median {v['ttfc_ms_median']:.2f} ms (min "
              f"{v['ttfc_ms_min']:.2f}, max {v['ttfc_ms_max']:.2f}), streaming RTF "
              f"{v['rtf']:.4f} (five warm 14-word requests) {card}")
    n, hop = 10, c2c.hop_length
    chunk, ctx = codes[:n].clone(), codes[n:2 * n].clone()
    flops = code2wav_flops(c2c, 2 * n)
    res["chunk_ms"] = {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        try:
            for dt, g in graphs.items():
                ms = _graph_ms(lambda: g._frames_decode(chunk, ctx), 20)
                first = _graph_ms(lambda: g._frames_decode(chunk[:1]), 20)
                key = f"{dt}, cudnn.benchmark={bench}"
                res["chunk_ms"][key] = {"chunk_ms": ms, "first_chunk_ms": first,
                                        "chunk_tflop_s": flops / ms / 1e9}
        finally:
            torch.backends.cudnn.benchmark = False
    print(f"code2wav device ms a chunk ({n} frames after {n} of context: {flops / 1e9:.1f} "
          f"GFLOP; the first chunk: 1 frame), CUDA-graph replays: "
          f"{json.dumps(res['chunk_ms'])} {card}")
    assert all(len(a) == n * hop for a in [g._frames_decode(chunk, ctx) for g in graphs.values()])
    del graphs, peng, g
    return res


def _attention_bound(cfg, B: int, pos: int):
    """B3's least time for B slots at position `pos`: each slot's prefix K
    and V rows (bf16) and its q, k_new, v_new and out (f32) moved once, the
    f32 products on the CUDA cores (its operations' type) at 67 TFLOP/s."""
    nbytes = B * (2 * cfg.num_kv_heads * pos * cfg.head_dim * 2
                  + (2 * cfg.num_q_heads + 2 * cfg.num_kv_heads) * cfg.head_dim * 4)
    flops = B * 4 * cfg.num_q_heads * (pos + 1) * cfg.head_dim
    return _bound_ms(nbytes, flops, F32_FLOP_PER_S)


def device_position_attention(cfg, gen, card) -> dict:
    """Phase 15's kernel half: B3 on device positions against its plain
    version, one slot at ATTN_SLOT_POSITIONS and four slots at four
    positions each, over full-shape caches [4, 28, 8, 8192, 128] whose rows
    past each slot's position and whose other layers hold poison; then the
    device and call time of one slot and of four at 300 / 4095 / 8191 beside
    `scaled_dot_product_attention` on the same prefixes (bf16, its
    `enable_gqa`), which the port never calls."""
    import torch
    import torch.nn.functional as F
    from qwen_tts_tpu_torch.ops.attention import decode_attention, decode_attention_reference

    L, KVH, S, D, HQ = (cfg.num_layers, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim,
                        cfg.num_q_heads)
    B = 4
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    q, kn, vn = rnd(B, HQ, D), rnd(B, KVH, D), rnd(B, KVH, D)
    kc = torch.full((B, L, KVH, S, D), -77.0, dtype=torch.bfloat16, device="cuda")
    vc = torch.full((B, L, KVH, S, D), 77.0, dtype=torch.bfloat16, device="cuda")
    for c in (kc, vc):
        c[:, ATTN_LAYER] = rnd(B, KVH, S, D).bfloat16()

    def prefix(positions):
        for b, p in enumerate(positions):
            for c in (kc, vc):
                c[b, ATTN_LAYER, :, p:] = 99.0

    def refill():
        for c in (kc, vc):
            c[:, ATTN_LAYER] = rnd(B, KVH, S, D).bfloat16()

    def check(label, got, again, want):
        torch.cuda.synchronize()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        same = torch.equal(got, again)
        ok = err <= 2e-3 * max(1.0, scale) and bool(torch.isfinite(got).all()) and same
        print("decode attention on device positions vs plain", json.dumps(
            {**label, "max_abs": err, "ref_max_abs": scale, "run_twice_bit_identical": same,
             "ok": ok}))
        assert ok, (label, err, scale)
        return err

    errs = {1: [], B: []}
    for pos in ATTN_SLOT_POSITIONS:
        refill()
        prefix([pos] * B)
        p = _dev_pos(pos)
        args = (q[0], kn[0], vn[0], kc[0], vc[0], ATTN_LAYER, p)
        errs[1].append(check({"slots": 1, "pos": pos}, decode_attention(*args),
                             decode_attention(*args), decode_attention_reference(*args)))
    for group in ((0, 1, 63, 64), (300, 4095, 8191, S), (S, 65, 1025, 0)):
        refill()
        prefix(group)
        args = (q, kn, vn, kc, vc, ATTN_LAYER, _dev_pos(*group))
        errs[B].append(check({"slots": B, "pos": list(group)}, decode_attention(*args),
                             decode_attention(*args), decode_attention_reference(*args)))

    timed = {}
    for pos in ATTN_TIMED:
        refill()
        prefix([pos] * B)
        for n in (1, B):
            args = ((q[0], kn[0], vn[0], kc[0], vc[0], ATTN_LAYER, _dev_pos(pos)) if n == 1
                    else (q, kn, vn, kc, vc, ATTN_LAYER, _dev_pos(*[pos] * B)))
            kernel = lambda a=args: decode_attention(*a)  # noqa: E731
            plain = lambda a=args: decode_attention_reference(*a)  # noqa: E731
            qb = q[:n].bfloat16()[:, :, None, :]
            kb = torch.cat([kc[:n, ATTN_LAYER, :, :pos], kn[:n].bfloat16()[:, :, None]], dim=2)
            vb = torch.cat([vc[:n, ATTN_LAYER, :, :pos], vn[:n].bfloat16()[:, :, None]], dim=2)
            lib = lambda: F.scaled_dot_product_attention(qb, kb, vb, enable_gqa=True)  # noqa: E731
            k_call, p_call = _interleaved(kernel, plain, 200, 20)
            l_call = min(_time_ms(lib, 200), _time_ms(lib, 200))
            k_ms, p_ms, l_ms = _device_ms(kernel, 100), _device_ms(plain, 10), _device_ms(lib, 100)
            b_ms, b_by = _attention_bound(cfg, n, pos)
            timed[(n, pos)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                               "bound_ms": b_ms, "bound_by": b_by, "call_ms": k_call,
                               "plain_call_ms": p_call, "library_call_ms": l_call}
            print(f"decode attention on device positions, {n} slot(s) at {pos} (layer of "
                  f"[28,8,8192,128] each), device ms per call: kernel {k_ms:.5f}, plain "
                  f"{p_ms:.5f}, scaled_dot_product_attention {l_ms:.5f}, bound {b_ms:.5f} "
                  f"({b_by}); back-to-back call ms: kernel {k_call:.5f}, plain {p_call:.5f}, "
                  f"sdpa {l_call:.5f} {card}")
    del kc, vc
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs[1]), "max_abs_err_slots": max(errs[B]), "times": timed}


def cache_end_step(eng, card) -> dict:
    """A talker step (phase 3's weights, full width and depth, caches cut to
    64 rows) of two slots on device positions, one at 64 (its cache full)
    and one at 3, on "pallas" and "dense": finite; the full slot writes its
    column in its own last rows only (the write clamps its position, as the
    kernel does); the other slot's output and rows are those it has beside
    a neighbour at 3."""
    import dataclasses

    import torch

    from qwen_tts_tpu_torch.models import decoder as td

    cfg = dataclasses.replace(eng.model_config.talker, max_seq_len=64)
    S, w = cfg.max_seq_len, eng.weights.talker
    gen = torch.Generator(device="cuda").manual_seed(64)
    x = torch.randn((2, 1, cfg.hidden_size), generator=gen, device="cuda")
    fill = torch.randn(td.init_state(cfg, "cuda", slots=2).k_cache.shape, generator=gen,
                       device="cuda").mul_(0.1).bfloat16()
    out = {}
    for impl in ("pallas", "dense"):
        runs = []
        for first in (S, 3):
            st = td.init_state(cfg, "cuda", slots=2)
            st.k_cache.copy_(fill)
            st.v_cache.copy_(fill)
            st.pos.copy_(torch.tensor([first, 3], dtype=torch.int32, device="cuda"))
            st, normed = td.forward_chunk(cfg, w, st, x, attn_impl=impl)
            runs.append((st, normed))
        torch.cuda.synchronize()
        (st, normed), (st3, normed3) = runs
        changed = (st.k_cache[0] != fill[0]).any(-1)
        res = {"finite": bool(torch.isfinite(normed).all()),
               "neighbour_same": bool(torch.equal(normed[1], normed3[1])
                                      and torch.equal(st.k_cache[1], st3.k_cache[1])),
               "own_last_rows_only": bool(not changed[:, :, :S - 1].any()
                                          and changed[:, :, S - 1].all()),
               "positions": st.pos.tolist()}
        print(f"[{impl}] a talker step of a slot at its cache's end ({S} rows) beside one at "
              f"3: {json.dumps(res)} {card}")
        assert res["finite"] and res["neighbour_same"] and res["own_last_rows_only"] \
            and res["positions"] == [S + 1, 4], res
        out[impl] = res
    return out


def backend_graphs_phase(eng, card) -> dict:
    """Phase 15's engine half: backends "pallas" and "dense" with
    `fused_chunks=True` (graphs captured in `initialize()`) against their
    eager loops on phase 3's weights, phase 13's first request streamed and
    synthesized: codes equal bit for bit, audio within 1e-4 * max(1, max
    |eager|); the decode-attention kernel's own launch count on the graph
    path equal to talker layers x talker steps + code-predictor layers x
    code-predictor steps ("pallas"; 0 on "dense"), and no decode-step
    kernel; TTFC and RTF medians of both paths."""
    import numpy as np
    import torch
    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
    from qwen_tts_tpu_torch.ops import attention, decode_step

    mc, out = eng.model_config, {}
    texts = TEXTS[:1]      # the eager loops run at RTF ~2: the shortest request
    for backend in ("pallas", "dense"):
        g, e = (TTSEngine(TTSConfig(backend=backend, fused_chunks=f)) for f in (True, False))
        for x in (g, e):
            x.initialize(weights=eng.weights, vocoder_weights=eng.vocoder_weights)
        serve(g, ("Hi.",), synthesize=False, request0=190)              # warm
        assert len(g._graphs.graphs) >= 1 + RING_GRAPHS and g._talker.pos is not None
        torch.cuda.synchronize()
        _reset_launches()
        m0 = g.get_metrics()
        g_out, g_syn = serve(g, texts, synthesize_text=texts[0])
        torch.cuda.synchronize()
        launches = attention.device_launches(g.device)
        m1 = g.get_metrics()
        t_steps, c_steps = (m1["talker_steps"] - m0["talker_steps"],
                            m1["cp_steps"] - m0["cp_steps"])
        want = (mc.talker.num_layers * t_steps + mc.code_predictor.num_layers * c_steps
                if backend == "pallas" else 0)
        e_out, e_syn = serve(e, texts, synthesize_text=texts[0])
        stack = lambda chunks: np.stack([f for _a, fr in chunks for f in fr])  # noqa: E731
        reqs = [{"codes_equal": [len(fr) for _a, fr in gc] == [len(fr) for _a, fr in ec]
                 and bool(np.array_equal(stack(gc), stack(ec))),
                 "audio_max_abs_diff": max(float(np.abs(a - b).max())
                                           for (a, _), (b, _) in zip(gc, ec)),
                 "bar": 1e-4 * max(1.0, max(float(np.abs(b).max()) for b, _ in ec))}
                for (_t, _w, _s, gc), (_t2, _w2, _s2, ec) in zip(g_out, e_out)]
        (gw, gf), (ew, ef) = g_syn, e_syn
        reqs.append({"codes_equal": len(gf) == len(ef) and bool(
            np.array_equal(np.stack(gf), np.stack(ef))),
            "audio_max_abs_diff": float(np.abs(gw - ew).max()),
            "bar": 1e-4 * max(1.0, float(np.abs(ew).max()))})
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        res = {"requests": reqs, "decode_attention_launches": launches,
               "want_launches": want, "talker_steps": t_steps, "cp_steps": c_steps,
               "decode_step_wrapper_launches": decode_step.megakernel_forward.launches,
               "graph_ttfc_ms": med([r[0] for r in g_out]),
               "eager_ttfc_ms": med([r[0] for r in e_out]),
               "graph_rtf": sum(r[1] for r in g_out) / sum(r[2] for r in g_out),
               "eager_rtf": sum(r[1] for r in e_out) / sum(r[2] for r in e_out)}
        print(f"backend {backend} [CUDA graphs against the eager loop]: {json.dumps(res)} "
              f"{card}")
        assert all(r["codes_equal"] and r["audio_max_abs_diff"] <= r["bar"] for r in reqs), res
        assert launches == want and (want > 0) == (backend == "pallas"), res
        assert decode_step.megakernel_forward.launches == 0, res
        out[backend] = res
        del g, e
        torch.cuda.empty_cache()
    return out


def _staggered(batcher, texts, gap_s: float):
    """Submit `texts` to the batcher `gap_s` apart; per request (submit
    time, first audio time, end time, audio), all on the host clock, and
    the wall from the first submit to the last end."""
    import numpy as np

    async def one(i, text, t0):
        await asyncio.sleep(i * gap_s)
        sub, first, parts = time.perf_counter(), None, []
        async for audio, _sr in batcher.submit(text):
            first = first or time.perf_counter()
            parts.append(audio)
        return sub - t0, first - t0, time.perf_counter() - t0, np.concatenate(parts)

    async def run():
        t0 = time.perf_counter()
        res = await asyncio.gather(*[one(i, t, t0) for i, t in enumerate(texts)])
        return res, time.perf_counter() - t0

    return asyncio.run(run())


def _tie_gaps(a: int, b: int, logits, noise=None, temperature: float = 0.9) -> dict:
    """How near a tie two codes a and b of one choice were. "logit": |logit[a]
    - logit[b]| (greedy: which wins; sampled: two codes this close swap
    top-k ranks, and so the noise each meets). Sampled (`noise`, the
    choice's Gumbel draws over the top-k ranks): "score", the gap between
    the two codes' noisy scores, logit / temperature + the noise at its
    rank, which the sampler's argmax compares (inf if either is not in the
    top k)."""
    import torch

    gaps = {"logit": abs(float(logits[a] - logits[b]))}
    if noise is not None:
        vals, idxs = torch.topk(logits / temperature, noise.shape[-1])
        score = {int(i): float(v + n) for i, v, n in zip(idxs, vals, noise)}
        gaps["score"] = abs(score[a] - score[b]) if a in score and b in score else math.inf
    return gaps


def _rank_swap_gap(a: int, b: int, batch_logits, other_logits, k: int) -> dict:
    """Sampled choices of codes a (another run) and b (the batch) from two
    runs' logits: the sampler adds the noise of each top-k rank to the code
    at that rank, so rounding parts the runs when it swaps two codes'
    ranks. "min_adjacent": the smallest gap between adjacent top-k logits
    of the batch; "rank_swap": for a or b at a rank that holds another code
    in the other run, the smallest gap in the batch's logits between it and
    that code (inf if neither code's rank moved)."""
    import torch

    ob = torch.topk(batch_logits, k).indices.tolist()
    oo = torch.topk(other_logits, k).indices.tolist()
    vals = torch.topk(batch_logits, k).values
    gaps = {"min_adjacent": float((vals[:-1] - vals[1:]).min()), "rank_swap": math.inf}
    for c in (a, b):
        for mine, theirs in ((ob, oo), (oo, ob)):
            if c in mine and theirs[mine.index(c)] != c:
                other = theirs[mine.index(c)]
                gap = abs(float(batch_logits[c] - batch_logits[other]))
                gaps["rank_swap"] = min(gaps["rank_swap"], gap)
    return gaps


def _profiled(fn):
    """(device busy µs, cudaGraphLaunch calls, wall s) of `fn()` under
    `torch.profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, graph_launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            busy_us += e.self_device_time_total
        elif e.key == "cudaGraphLaunch":
            graph_launches += e.count
    return busy_us, graph_launches, wall


def serving_phase(eng3, card) -> dict:
    """Phase 16 (see the module docstring)."""
    import numpy as np
    import torch

    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
    from qwen_tts_tpu_torch.ops import attention
    from qwen_tts_tpu_torch.runtime import frame_loop
    from qwen_tts_tpu_torch.runtime.continuous import ContinuousBatcher

    texts = [TEXTS[i % len(TEXTS)] for i in range(SERVE_REQUESTS)]
    out = {}
    for label, kw in (("bf16", {}), ("int8+kv8", {"quantize": "int8", "kv_cache": "int8"})):
        # the batcher captures its own graphs: none of the engine's
        eng = TTSEngine(TTSConfig(max_seq_len=SERVE_SEQ, warmup=False, **kw))
        eng.initialize(weights=eng3.weights, vocoder_weights=eng3.vocoder_weights)
        b = ContinuousBatcher(eng, slots=SERVE_SLOTS, chunk_frames=10, admit_chunk_frames=2)
        t0 = time.perf_counter()
        b.warm()
        warm_s = time.perf_counter() - t0
        graphs, captures = set(b._g.graphs), b.captures
        b.serve([TEXTS[0]])                               # warm: the host-side set-up
        reqs, frames = [], [0]
        real_admit, real_dispatch = b._admit, b._dispatch
        b._admit = lambda r, s: (reqs.append(r), real_admit(r, s))[1]
        b._dispatch = lambda n: (frames.__setitem__(0, frames[0] + n), real_dispatch(n))[1]
        torch.cuda.synchronize()
        attention.reset_device_launches(eng.device)
        spans, real_replay = [], b._g.replay

        def timed_replay(key, body):      # events around each replay, on its stream
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(b._g.stream)
            real_replay(key, body)
            ev[1].record(b._g.stream)
            spans.append(ev)

        b._g.replay = timed_replay
        t0 = time.perf_counter()
        results, wall = _staggered(b, texts, SERVE_GAP_S)
        torch.cuda.synchronize()       # the chunk dispatched past the last end, too
        busy_wall = time.perf_counter() - t0
        del b._g.replay
        launches = attention.device_launches(eng.device)
        graph_ms = sum(s0.elapsed_time(s1) for s0, s1 in spans)
        hop = eng.vocoder_config.hop_length
        for _s, _f, _e, audio in results:
            assert len(audio) > 0 and len(audio) % hop == 0 and np.isfinite(audio).all()
        kv8 = eng._kv_dtype == torch.int8
        lt, lc = eng.model_config.talker.num_layers, eng.model_config.code_predictor.num_layers
        want = frames[0] * ((0 if kv8 else lt) + 14 * lc) + (0 if kv8 else lt) * len(reqs)
        first_ms = sorted((f - s) * 1e3 for s, f, _e, _a in results)
        audio_s = sum(len(a) for *_x, a in results) / eng.sample_rate
        pct = lambda xs, q: xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]  # noqa: E731
        res = {"requests": len(results), "slots": SERVE_SLOTS, "max_seq_len": SERVE_SEQ,
               "warm_s": warm_s, "graphs": len(graphs), "audio_s": audio_s, "wall_s": wall,
               "aggregate_rt_x": audio_s / wall, "first_audio_p50_ms": pct(first_ms, 0.5),
               "first_audio_p95_ms": pct(first_ms, 0.95), "frames_dispatched": frames[0],
               "admissions": len(reqs), "decode_attention_launches": launches,
               "device_busy_share": graph_ms / 1e3 / busy_wall,
               "want_launches": want,
               "closed_graph_set": set(b._g.graphs) == graphs and b.captures == captures}
        assert res["closed_graph_set"] and launches == want, res
        # one request alone under the profiler: the CUDA calls of a chunk and
        # an admission (a whole staggered run is millions of kernel events)
        r0, q0, a0 = b._g.replays, b._seq, len(reqs)
        busy_us, graph_launches, pwall = _profiled(lambda: b.serve([TEXTS[0]]))
        chunks, admissions = b._seq - q0, len(reqs) - a0
        res.update(profiled_busy_share=busy_us / 1e6 / pwall, profiled_wall_s=pwall,
                   chunks=chunks, profiled_admissions=admissions,
                   graph_launches=graph_launches,
                   graph_launches_per_chunk=(graph_launches - admissions) / chunks,
                   replays=b._g.replays - r0)
        assert graph_launches == chunks + admissions == res["replays"], res
        # a request alone through the batcher: the codes it had in the crowd
        r = reqs[2]
        eng._requests = r.number - 1
        b.serve([r.text])
        alone = reqs[-1]
        a_codes, s_codes = np.concatenate(alone.codes), np.concatenate(r.codes)
        res["alone_codes_equal"] = bool(np.array_equal(a_codes, s_codes))
        assert res["alone_codes_equal"], (a_codes.shape, s_codes.shape)
        b._admit, b._dispatch = real_admit, real_dispatch
        print(f"serving [{label}] {SERVE_REQUESTS} requests {SERVE_GAP_S * 1e3:.0f} ms apart on "
              f"{SERVE_SLOTS} slots: {json.dumps(res)} {card}")
        print(f"serving [{label}]: aggregate real-time x {res['aggregate_rt_x']:.3f} {card}")
        print(f"serving [{label}]: first audio p50 {res['first_audio_p50_ms']:.2f} ms, p95 "
              f"{res['first_audio_p95_ms']:.2f} ms {card}")
        print(f"serving [{label}]: device busy share {res['device_busy_share']:.4f} {card}")
        print(f"serving [{label}]: graph launches per chunk "
              f"{res['graph_launches_per_chunk']:.3f} ({graph_launches} for {chunks} chunks "
              f"and {admissions} admissions, one graph each) {card}")
        if not kw:
            res["synthesize_batch"] = batch_against_singles(eng, frame_loop, card)
        out[label] = res
        del b, eng
        torch.cuda.empty_cache()
    return out


BATCH_TEXTS = ("Hello from the GPU.", "One more short line.", "Batched speech.",
               "Four texts at once here.")


def batch_against_singles(eng, frame_loop, card) -> dict:
    """`synthesize_batch` of four short texts against each text run alone
    with its request number, twice. Padded to the same four slots (three
    copies of it beside it), where a request's codes depend on its number,
    not on its slot or its neighbours: codes equal, or else first parting
    at a near tie of the batch's logits (`_tie_gaps` < 2e-2). On one slot,
    where the products round otherwise, fed the batch's codes (each frame's
    code predictor and each talker step return the batch's choices), so
    the two runs see the same inputs all the way: the talker's hidden state
    at every step within cosine 0.999 of the batch's (the bar at which
    `tests/test_batch.py` holds JAX's batch to its sequential path), and at
    the first choice the slot would have made otherwise, a near tie where
    rounding can reorder: a greedy code 0 within 2e-2, or a sampled code
    whose top-k logits hold two adjacent ones within 2e-2 (their ranks, and
    so the noise each meets, swap; `_rank_swap_gap`)."""
    import numpy as np
    import torch
    from qwen_tts_tpu_torch.models.decoder import lm_head_logits
    from qwen_tts_tpu_torch.ops.sampling import gumbel_from_uniform

    def cosine(a, b) -> float:
        a, b = a.double().flatten(), b.double().flatten()
        return float((a @ b) / (a.norm() * b.norm()))

    texts = list(BATCH_TEXTS)
    n0 = eng._requests
    real_cp, real_step = frame_loop.cp_predict, frame_loop.decode_step_with_embed
    cp, talker, force = [], [], {}     # per call: (codes, logits); (token, logits, normed)

    def cp_predict(*a, **k):
        codes, logits = real_cp(*a, **{**k, "return_logits": True})
        cp.append((codes, logits))
        forced = force.get("cp", [])
        return forced[len(cp) - 1] if len(cp) <= len(forced) else codes

    def decode_step_with_embed(cfg, w, *a, **k):
        state, token, normed = real_step(cfg, w, *a, **k)
        talker.append((token, lm_head_logits(w, normed[None])[0], normed))
        forced = force.get("tok", [])
        return state, (forced[len(talker) - 1] if len(talker) <= len(forced) else token), normed

    seen, real = [], eng._decode_to_audio
    eng._decode_to_audio = lambda frames: (seen.append(np.stack(frames)), real(frames))[1]
    frame_loop.cp_predict, frame_loop.decode_step_with_embed = cp_predict, decode_step_with_embed
    try:
        t0 = time.perf_counter()
        results = eng.synthesize_batch(texts)
        batch_s = time.perf_counter() - t0
        batch_seen, seen[:] = list(seen), []
        b_cp, b_talker = list(cp), list(talker)
        padded, one_slot = [], []
        for i, text in enumerate(texts):
            eng._requests = n0 + i
            eng.synthesize_batch([text] * len(texts))
            padded.append(seen[0])
            force.update(cp=[c[i:i + 1] for c, _l in b_cp], tok=[t[i:i + 1] for t, *_x in b_talker])
            cp.clear()
            talker.clear()
            eng._requests = n0 + i
            eng.synthesize_batch([text])
            one_slot.append((list(cp), list(talker)))
            force.clear()
            cp.clear()
            talker.clear()
            seen.clear()
    finally:
        frame_loop.cp_predict, frame_loop.decode_step_with_embed = real_cp, real_step
        del eng._decode_to_audio
    res = {"texts": len(texts), "batch_s": batch_s, "padded": [], "one_slot": []}
    for i in range(len(texts)):
        wav, _sr = results[i]
        assert len(wav) > 0 and np.isfinite(wav).all()
        got = batch_seen[i]
        one = padded[i]
        n = min(len(one), len(got))
        diff = np.argwhere(one[:n] != got[:n])
        entry = {"frames_batch": len(got), "frames_alone": len(one),
                 "codes_equal": not len(diff) and len(one) == len(got)}
        if len(diff):
            f, g = (int(x) for x in diff[0])
            logits = b_talker[f][1][i] if g == 0 else b_cp[f][1][i, g - 1]
            noise = None
            if g > 0:     # the draws of text i's request number, frame f, group g
                noise = gumbel_from_uniform(eng._draw(n0 + i + 1, f, 1)[0, g - 1]).cpu()
            gaps = _tie_gaps(int(one[f, g]), int(got[f, g]), logits.cpu(), noise)
            entry.update(first_diff_frame_group=[f, g], tie_gaps=gaps)
            entry["near_tie"] = min(gaps.values()) < 2e-2
        res["padded"].append(entry)
        assert entry["codes_equal"] or entry["near_tie"], ("padded", entry, res)

        # one slot, fed the batch's codes: its own choices and hidden states
        o_cp, o_talker = one_slot[i]
        steps = min(len(o_talker), len(b_talker))
        cos = [cosine(o_talker[s][2][0], b_talker[s][2][i]) for s in range(steps)]
        entry = {"frames_batch": len(got), "steps_compared": steps,
                 "hidden_cos_min": min(cos), "own_choices_equal": True}
        part = None
        for f in range(min(len(got), len(o_cp))):
            if int(o_talker[f][0][0]) != int(b_talker[f][0][i]):
                part = (f, 0)
                break
            own, want = o_cp[f][0][0].tolist(), b_cp[f][0][i].tolist()
            if own != want:
                part = (f, next(g for g in range(1, 16) if own[g] != want[g]))
                break
        if part is not None:
            f, g = part
            entry["own_choices_equal"] = False
            if g == 0:
                a, b = int(o_talker[f][0][0]), int(b_talker[f][0][i])
                lb, lo = b_talker[f][1][i].cpu(), o_talker[f][1][0].cpu()
                gaps = _tie_gaps(a, b, lb)
                rule = gaps["logit"]
            else:
                a, b = int(o_cp[f][0][0, g]), int(b_cp[f][0][i, g])
                lb, lo = b_cp[f][1][i, g - 1].cpu(), o_cp[f][1][0, g - 1].cpu()
                noise = gumbel_from_uniform(eng._draw(n0 + i + 1, f, 1)[0, g - 1]).cpu()
                gaps = {**_tie_gaps(a, b, lb, noise), **_rank_swap_gap(a, b, lb, lo,
                                                                       noise.shape[-1])}
                rule = gaps["min_adjacent"]
            top = torch.topk(lb, eng._top_k).indices
            entry.update(first_parting_frame_group=[f, g], tie_gaps=gaps,
                         logit_drift_topk=float((lb[top] - lo[top]).abs().max()))
            entry["near_tie"] = rule < 2e-2
        res["one_slot"].append(entry)
        assert entry["hidden_cos_min"] > 0.999 and (part is None or entry["near_tie"]), \
            ("one slot", entry, res)
    print(f"synthesize_batch of {len(texts)} texts against each alone, padded to four slots "
          f"by copies of it and on one slot fed the batch's codes: {json.dumps(res)} {card}")
    return res


def _phase_done(n: int) -> None:
    print(f"phase {n} done at {time.perf_counter() - _T0:.1f} s")


def main() -> int:
    sys.meta_path.insert(0, _NoJax())
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from qwen_tts_tpu_torch.core.config import CODEC_BOS
    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
    from qwen_tts_tpu_torch.models.decoder import init_state
    from qwen_tts_tpu_torch.ops import attention, cuda_lib, decode_step, generate_kernel

    # ── phase 1: card, versions, build ──
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    cuda_lib.load_library()
    print(f"{', '.join(p.name for p in cuda_lib.sources())} built+loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, log in sorted(cuda_lib.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas {src}:", line.strip())

    _phase_done(1)

    # ── phase 2: decode-step kernel vs plain at full width ──
    eng = TTSEngine(TTSConfig())
    assert eng.device.type == "cuda"
    t0 = time.perf_counter()
    eng.initialize()
    torch.cuda.synchronize()
    print(f"engine init (full-width random weights on the card) "
          f"{time.perf_counter() - t0:.1f} s")
    mc = eng.model_config
    tw, cw = eng.weights.talker, eng.weights.code_predictor.decoder
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    grid = {"talker": decode_step.launch_info(mc.talker, tw, init_state(mc.talker, "cuda")),
            "talker_kv8": decode_step.launch_info(
                mc.talker, tw, init_state(mc.talker, "cuda", torch.int8)),
            "code_predictor": decode_step.launch_info(
                mc.code_predictor, cw, init_state(mc.code_predictor, "cuda"), with_head=False)}
    print(f"decode-step kernel, persistent grid (one launch a step): {json.dumps(grid)} {card}")
    errs, ctx = [], {}
    for pos in STEP_POSITIONS:
        res, c = compare_kernel(mc.talker, tw, pos, True, gen, mrope=True)
        print("talker kernel vs plain", json.dumps(res))
        errs.append(max(res["normed_max_abs"], res["logits_max_abs"]))
        if pos == 300:
            ctx["talker"] = c
        del c
    for pos in (2, 14):
        res, c = compare_kernel(mc.code_predictor, cw, pos, False, gen, mrope=False)
        print("code-predictor kernel vs plain", json.dumps(res))
        errs.append(res["normed_max_abs"])
        ctx["cp"] = c
    check_deterministic(mc.talker, tw, 4095, gen, False, "bf16")

    _phase_done(2)

    # ── phase 3: the main path through the engine ──
    stream(eng, TEXTS[0])                          # warm: the host-side set-up
    _reset_launches()
    m0, d0 = eng.get_metrics(), eng.decode_launches()
    stats = run_requests(eng)
    launches = {"decode_step": eng.decode_launches() - d0}
    m1 = eng.get_metrics()
    steps = (m1["talker_steps"] - m0["talker_steps"]) + (m1["cp_steps"] - m0["cp_steps"])
    print(f"main path (CUDA graphs): {launches['decode_step']} decode-step launches (the "
          f"kernel's own count; the wrapper's {decode_step.megakernel_forward.launches}), "
          f"{steps} decode steps "
          f"(talker {m1['talker_steps'] - m0['talker_steps']}, "
          f"code predictor {m1['cp_steps'] - m0['cp_steps']})")
    assert launches["decode_step"] == steps > 0, (launches, steps)
    parity = reduced_engine_parity()
    print("reduced model, GPU kernel vs CPU plain engine:", json.dumps(parity))

    _phase_done(3)

    # ── phase 4: decode-step timings ──
    t_k, t_p = time_steps(mc.talker, tw, ctx["talker"], True, 50)
    sk, _, embed, _, _, mp = ctx["talker"]
    t_dev = _span_ms(lambda: decode_step.megakernel_forward(mc.talker, tw, sk, embed,
                                                             mrope_pos=mp), 20)
    c_k, c_p = time_steps(mc.code_predictor, cw, ctx["cp"], False, 100)
    csk, _, cembed, _, _, _ = ctx["cp"]
    c_step = lambda: decode_step.megakernel_forward(  # noqa: E731
        mc.code_predictor, cw, csk, cembed, with_head=False)
    c_dev = _span_ms(c_step, 50)
    per_step = {"talker": kernels_per_step(mc.talker, tw, random_state(mc.talker, 300, gen),
                                           True, "talker bf16, bf16 cache"),
                "talker_kv8": kernels_per_step(mc.talker, tw,
                                               random_state(mc.talker, 300, gen, kv8=True),
                                               True, "talker bf16, int8 cache"),
                "cp": kernels_per_step(mc.code_predictor, cw,
                                       random_state(mc.code_predictor, 2, gen), False,
                                       "code predictor bf16")}
    t_b, t_by = _bound_ms(*step_cost(mc.talker, tw, 300, True))
    c_b, _ = _bound_ms(*step_cost(mc.code_predictor, cw, 14, False))
    print(f"talker step (pos 300): kernel {t_k:.4f} ms (device span {t_dev:.4f} ms), plain "
          f"{t_p:.4f} ms, bound {t_b:.4f} ms ({t_by}) {card}")
    print(f"code-predictor step (pos 14): kernel {c_k:.4f} ms (device span with the host "
          f"ahead {c_dev:.4f} ms), plain {c_p:.4f} ms, bound {c_b:.4f} ms {card}")
    step_pos = time_step_positions(mc.talker, tw, gen, card)
    for s in stats:
        print("request", json.dumps(s), card)
    streams = [s for s in stats if "ttfc_ms" in s]
    ttfc = sorted(s["ttfc_ms"] for s in streams)
    rtf = sum(s["wall_s"] for s in streams) / sum(s["audio_s"] for s in streams)
    print(f"main path (CUDA graphs): TTFC median {ttfc[len(ttfc) // 2]:.2f} ms "
          f"(max {ttfc[-1]:.2f}), streaming RTF {rtf:.4f} {card}")

    _phase_done(4)

    # ── phase 5: decode-attention kernel vs plain at full talker shape ──
    attn_err, attn_ctx = compare_attention(mc.talker, gen)

    _phase_done(5)

    # ── phase 6: N-step generation, the path's run, then vs the step loop ──
    _reset_launches()
    state0 = init_state(mc.talker, "cuda")
    starts0 = [0] * len(mc.talker.mrope_section)
    g0 = compare_generate(mc.talker, tw, state0, CODEC_BOS, starts0, "from CODEC_BOS at 0")
    launches["generate"] = g0["c_calls"]
    warm = init_state(mc.talker, "cuda")._replace(position=300)
    shape = warm.k_cache[:, :, :300].shape
    warm.k_cache[:, :, :300] = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    warm.v_cache[:, :, :300] = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    g1 = compare_generate(mc.talker, tw, warm, int(g0["first_tokens"][-1]),
                          [300 + d for d in (0, 5, 9)],
                          "from a random cache at 300, deltas (0,5,9)")
    gen_err = max(g0["cache_cols_max_abs"], g1["cache_cols_max_abs"])
    del warm, state0

    _phase_done(6)

    # ── phase 7: the "pallas" path through the engine ──
    peng = TTSEngine(TTSConfig(backend="pallas", fused_chunks=False))
    peng.initialize(weights=eng.weights, vocoder_weights=eng.vocoder_weights)
    _reset_launches()
    m0 = peng.get_metrics()
    ttfc, wall, chunks = stream(peng, TEXTS[0])
    launches["decode_attention"] = attention.device_launches(peng.device)
    m1 = peng.get_metrics()
    audio = check_stream(peng, chunks)
    t_steps, c_steps = (m1["talker_steps"] - m0["talker_steps"],
                        m1["cp_steps"] - m0["cp_steps"])
    want = mc.talker.num_layers * t_steps + mc.code_predictor.num_layers * c_steps
    print(f"pallas path: {launches['decode_attention']} decode-attention launches = "
          f"{mc.talker.num_layers} x {t_steps} talker steps + {mc.code_predictor.num_layers} "
          f"x {c_steps} code-predictor steps ({want}); {len(chunks)} chunks, "
          f"{len(audio) / peng.sample_rate:.2f} s audio, TTFC {ttfc * 1e3:.2f} ms, "
          f"RTF {wall / (len(audio) / peng.sample_rate):.4f} {card}")
    assert launches["decode_attention"] == want > 0, (launches, want)
    assert decode_step.megakernel_forward.launches == 0
    parity_p = reduced_engine_parity("pallas")
    print("reduced model, GPU kernels vs CPU plain engine:", json.dumps(parity_p))
    del peng

    _phase_done(7)

    # ── phase 8: timings of the new kernels ──
    attn_t = time_attention(mc.talker, attn_ctx, card)
    del attn_ctx
    gen_t = time_generate(mc.talker, tw, card)

    _phase_done(8)

    # ── phase 9: the quantized forms of the decode step vs plain at full width ──
    qweights, qerr, qctx = {}, {}, {}
    for label, (fn, kw) in _quant_forms().items():
        qt, qc = fn(tw, **kw), fn(cw, quant_head=False, **kw)
        qweights[label], e = (qt, qc), []
        for kv8 in (False, True):
            for pos in (0, 1, 4095, 300) if kv8 else (0, 1, 300):
                res, c = compare_kernel(mc.talker, qt, pos, True, gen, mrope=True, kv8=kv8,
                                        quant_bar=True)
                print(f"talker [{label}] kernel vs plain", json.dumps(res))
                e.append(max(res["normed_max_abs"], res["logits_max_abs"]))
                if kv8 and pos == 300:
                    qctx[(label, "talker")] = c
                del c
        for pos in (2, 14):
            res, c = compare_kernel(mc.code_predictor, qc, pos, False, gen, mrope=False,
                                    quant_bar=True)
            print(f"code-predictor [{label}] kernel vs plain", json.dumps(res))
            e.append(res["normed_max_abs"])
            qctx[(label, "cp")] = c
        qerr[label] = max(e)
    check_deterministic(mc.talker, qweights["int8"][0], 4095, gen, True, "int8+kv8")

    _phase_done(9)

    # ── phase 10: the quantized main path, TTSConfig(quantize=..., kv_cache="int8") ──
    qeng = TTSEngine(TTSConfig(quantize="int8", kv_cache="int8"))
    qeng.initialize()
    stream(qeng, TEXTS[0])                         # warm
    m0, d0 = qeng.get_metrics(), qeng.decode_launches()
    qstats = run_requests(qeng)
    qlaunch = {"int8": qeng.decode_launches() - d0}
    m1 = qeng.get_metrics()
    steps = (m1["talker_steps"] - m0["talker_steps"]) + (m1["cp_steps"] - m0["cp_steps"])
    print(f"int8+kv8 path: {qlaunch['int8']} decode-step launches, {steps} decode steps")
    assert qlaunch["int8"] == steps > 0, (qlaunch, steps)
    assert qeng._talker_state.k_cache.dtype == torch.int8
    parity_q = reduced_engine_parity("mega", quantize="int8", kv_cache="int8")
    print("reduced model int8+kv8, GPU kernel vs CPU plain engine:", json.dumps(parity_q))
    for q in ("int4", "mixed"):
        e = TTSEngine(TTSConfig(quantize=q, kv_cache="int8"))
        e.initialize()
        m0, d0 = e.get_metrics(), e.decode_launches()
        ttfc, wall, chunks = stream(e, TEXTS[0])
        qlaunch[q] = e.decode_launches() - d0
        m1 = e.get_metrics()
        audio = check_stream(e, chunks)
        steps = (m1["talker_steps"] - m0["talker_steps"]) + (m1["cp_steps"] - m0["cp_steps"])
        print(f"{q}+kv8 path: {qlaunch[q]} decode-step launches, {steps} decode steps; "
              f"{len(chunks)} chunks, {len(audio) / e.sample_rate:.2f} s audio, TTFC "
              f"{ttfc * 1e3:.2f} ms, RTF {wall / (len(audio) / e.sample_rate):.4f} {card}")
        assert qlaunch[q] == steps > 0, (q, qlaunch, steps)
        del e

    _phase_done(10)

    # ── phase 11: N-step generation on the quantized forms + kv8 vs the step loop ──
    glaunch, gerr = {}, {}
    for label in GEN_FORMS:
        qt = qweights[label][0]
        _reset_launches()
        g0 = compare_generate(mc.talker, qt, init_state(mc.talker, "cuda", torch.int8),
                              CODEC_BOS, starts0, f"[{label}+kv8] from CODEC_BOS at 0")
        glaunch[label] = generate_kernel.generate_megakernel.launches
        g1 = compare_generate(mc.talker, qt, random_state(mc.talker, 300, gen, kv8=True),
                              int(g0["first_tokens"][-1]), [300 + d for d in (0, 5, 9)],
                              f"[{label}+kv8] from a random int8 cache at 300, deltas (0,5,9)")
        gerr[label] = max(g0["cache_cols_max_abs"], g1["cache_cols_max_abs"])

    _phase_done(11)

    # ── phase 12: timings of the quantized forms ──
    qt_t = {}
    for label in _quant_forms():
        qt, qc = qweights[label]
        tctx, cctx = qctx[(label, "talker")], qctx[(label, "cp")]
        k_ms, p_ms = time_steps(mc.talker, qt, tctx, True, 50)
        sk, _, embed, _, _, mp = tctx
        d_ms = _span_ms(lambda: decode_step.megakernel_forward(
            mc.talker, qt, sk, embed, mrope_pos=mp), 20)
        ck_ms, cp_ms = time_steps(mc.code_predictor, qc, cctx, False, 100)
        csk, _, cembed, _, _, _ = cctx
        cd_ms = _span_ms(lambda: decode_step.megakernel_forward(
            mc.code_predictor, qc, csk, cembed, with_head=False), 50)
        per_step[label] = kernels_per_step(mc.talker, qt, random_state(mc.talker, 300, gen, True),
                                           True, f"talker {label}, int8 cache")
        per_step[f"{label}_bf16_cache"] = kernels_per_step(
            mc.talker, qt, random_state(mc.talker, 300, gen), True, f"talker {label}, bf16 cache")
        per_step[f"{label}_cp"] = kernels_per_step(
            mc.code_predictor, qc, random_state(mc.code_predictor, 2, gen), False,
            f"code predictor {label}")
        b_ms, b_by = _bound_ms(*step_cost(mc.talker, qt, 300, True, kv8=True))
        cb_ms, _ = _bound_ms(*step_cost(mc.code_predictor, qc, 14, False))
        qt_t[label] = {"ms": k_ms, "device_span_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "cp_ms": ck_ms, "cp_device_span_ms": cd_ms,
                       "cp_plain_ms": cp_ms, "cp_bound_ms": cb_ms}
        print(f"talker step [{label}+kv8] (pos 300): kernel {k_ms:.4f} ms (device {d_ms:.4f} "
              f"ms), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); code-predictor step "
              f"[{label}] (pos 14): kernel {ck_ms:.4f} ms (device {cd_ms:.4f} ms), plain "
              f"{cp_ms:.4f} ms, bound "
              f"{cb_ms:.4f} ms {card}")
    qt_t["int8"]["by_position"] = {str(p): v for p, v in time_step_positions(
        mc.talker, qweights["int8"][0], gen, card, kv8=True).items()}
    qgen_t = {label: time_generate(mc.talker, qweights[label][0], card, kv8=True,
                                   label=f"{label}+kv8") for label in GEN_FORMS}
    for s_ in qstats:
        print("request [int8+kv8]", json.dumps(s_), card)
    streams = [s_ for s_ in qstats if "ttfc_ms" in s_]
    qttfc = sorted(s_["ttfc_ms"] for s_ in streams)
    qrtf = sum(s_["wall_s"] for s_ in streams) / sum(s_["audio_s"] for s_ in streams)
    print(f"int8+kv8 slice: TTFC median {qttfc[len(qttfc) // 2]:.2f} ms (max "
          f"{qttfc[-1]:.2f}), streaming RTF {qrtf:.4f} {card}")

    _phase_done(12)

    # ── phase 13: the graph path against the eager loop, bf16 and int8+kv8 ──
    engine_t = {"bf16": graph_against_eager(eng, "bf16", card),
                "int8+kv8": graph_against_eager(qeng, "int8+kv8", card)}
    del qeng

    _phase_done(13)

    # ── phase 14: a local checkpoint and the Code2Wav vocoder at full width ──
    c2w_res = code2wav_phase(eng, card)

    _phase_done(14)

    # ── phase 15: "pallas" and "dense" in CUDA graphs; B3 on device positions ──
    slot_attn = device_position_attention(mc.talker, gen, card)
    cache_end_step(eng, card)
    backends = backend_graphs_phase(eng, card)
    launches["decode_attention_graphs"] = backends["pallas"]["decode_attention_launches"]

    _phase_done(15)

    # ── phase 16: continuous batching and synthesize_batch at full width ──
    serving = serving_phase(eng, card)
    launches["decode_attention_slots"] = serving["bf16"]["decode_attention_launches"]

    _phase_done(16)
    assert all(math.isfinite(e) for e in errs + [attn_err, gen_err, *qerr.values(),
                                                 *gerr.values(), slot_attn["max_abs_err"],
                                                 slot_attn["max_abs_err_slots"]])
    a300 = attn_t[300]
    print(json.dumps({"kernels": [
        {"name": "decode_step", "route": "cuda",
         "source": "qwen_tts_tpu_torch/csrc/decode_step.cu",
         "replaces": "qwen_tts_tpu/ops/decode_step.py:98",
         "launches": launches["decode_step"], "max_abs_err": max(errs),
         "ms": t_k, "plain_ms": t_p, "bound_ms": t_b, "bound_by": t_by, "library_ms": None,
         "device_span_ms": t_dev, "cp_ms": c_k, "cp_device_span_ms": c_dev, "cp_plain_ms": c_p,
         "cp_bound_ms": c_b,
         "by_position": {str(p): v for p, v in step_pos.items()},
         "kernels_per_step": per_step, "grid": grid, "engine": engine_t,
         "code2wav_graph_launches": {dt: r["decode_step_launches"]
                                     for dt, r in c2w_res["dtypes"].items()}},
        {"name": "decode_attention", "route": "cuda",
         "source": "qwen_tts_tpu_torch/csrc/attention.cu",
         "replaces": "qwen_tts_tpu/ops/attention.py:29",
         "launches": launches["decode_attention"], "max_abs_err": attn_err,
         "ms": a300["ms"], "plain_ms": a300["plain_ms"], "bound_ms": a300["bound_ms"],
         "bound_by": a300["bound_by"], "library_ms": a300["library_ms"],
         "call_ms": a300["call_ms"],
         "by_position": {str(p): v for p, v in attn_t.items()},
         "graph_path_launches": {b: r["decode_attention_launches"]
                                 for b, r in backends.items()}},
        {"name": "decode_attention[device positions, 4 slots]", "route": "cuda",
         "source": "qwen_tts_tpu_torch/csrc/attention.cu",
         "replaces": "qwen_tts_tpu/ops/attention.py:29",
         "launches": launches["decode_attention_slots"],
         "max_abs_err": max(slot_attn["max_abs_err"], slot_attn["max_abs_err_slots"]),
         **slot_attn["times"][(4, 300)],
         "by_slots_and_position": {f"{n}x{p}": v for (n, p), v in slot_attn["times"].items()},
         "serving": serving},
        {"name": "generate", "route": "cuda",
         "source": "qwen_tts_tpu_torch/csrc/generate.cu",
         "replaces": "qwen_tts_tpu/ops/generate_kernel.py:52",
         "launches": launches["generate"], "max_abs_err": gen_err,
         "ms": gen_t["ms"], "plain_ms": gen_t["plain_ms"], "bound_ms": gen_t["bound_ms"],
         "bound_by": gen_t["bound_by"], "library_ms": None, "steps": GEN_STEPS,
         "tok_s_256": gen_t["generate_tok_s"],
         "decode_step_loop_tok_s_256": gen_t["decode_step_loop_tok_s"],
         "bound_tok_s_256": gen_t["bound_tok_s"],
         "device_span_ms_per_step_256": gen_t["device_span_ms_per_step"],
         "device_idle_share_256": gen_t["device_idle_share"],
         "kernels_per_call": gen_t["kernels_per_call"]},
        *[{"name": f"decode_step[{q}+kv8]", "route": "cuda",
           "source": "qwen_tts_tpu_torch/csrc/decode_layer.cuh",
           "replaces": "qwen_tts_tpu/ops/decode_step.py:98",
           "launches": qlaunch[q], "max_abs_err": qerr[q], "library_ms": None,
           **qt_t[q], **({"g128_max_abs_err": qerr["int8g128"],
                          **{f"g128_{k}": v for k, v in qt_t["int8g128"].items()}}
                         if q == "int8" else {})}
          for q in ("int8", "int4", "mixed")],
        *[{"name": f"generate[{q}+kv8]", "route": "cuda",
           "source": "qwen_tts_tpu_torch/csrc/generate.cu",
           "replaces": "qwen_tts_tpu/ops/generate_kernel.py:52",
           "launches": glaunch[q], "max_abs_err": gerr[q], "ms": qgen_t[q]["ms"],
           "plain_ms": qgen_t[q]["plain_ms"], "bound_ms": qgen_t[q]["bound_ms"],
           "bound_by": qgen_t[q]["bound_by"], "library_ms": None, "steps": GEN_STEPS,
           "device_span_ms_256": qgen_t[q]["device_span_ms_per_step"] * GEN_TIMED_STEPS,
           "tok_s_256": qgen_t[q]["generate_tok_s"],
           "bound_tok_s_256": qgen_t[q]["bound_tok_s"],
           "device_span_ms_per_step_256": qgen_t[q]["device_span_ms_per_step"],
           "device_idle_share_256": qgen_t[q]["device_idle_share"],
           "kernels_per_call": qgen_t[q]["kernels_per_call"],
           "bound_ms_per_step_256": qgen_t[q]["bound_ms_per_step"]}
          for q in GEN_FORMS],
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

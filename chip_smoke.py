#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`qwen_tts_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and no result line
is printed):
  1. card name and power limit, torch and CUDA versions; builds the three
     kernels of `qwen_tts_tpu_torch/csrc/` (one nvcc per source, started
     together, linked into one library) and prints ptxas' register,
     shared-memory and spill lines for each entry;
  2. the decode-step kernel against its plain PyTorch version at full width
     (Qwen3-TTS-12Hz-0.6B, random weights from a seed): the 28-layer talker
     at positions 0, 1 and 300 over a randomly filled cache, the 5-layer
     code predictor at positions 2 and 14;
  3. the engine's main path, `TTSEngine(TTSConfig())` (on the card by
     default): three streaming requests of different lengths and one
     `synthesize`; checks chunk lengths, finite audio, and that the
     decode-step kernel's launch count equals the talker plus
     code-predictor decode steps run; then a reduced model on the GPU
     (kernels) against the same model on the CPU (plain path), greedy: the
     first frame's codes equal and its audio within 1e-3, and over 8 frames
     either >= 95% of the codes equal or the first differing code a near
     tie (top-2 gap < 2e-2) of the CPU logits that chose it, the GPU taking
     the CPU's runner-up;
  4. step times of the decode-step kernel and its plain version (CUDA
     events), TTFC and RTF of the eager engine;
  5. the decode-attention kernel against its plain version at full talker
     shape (layer 27 of [28, 8, 8192, 128] caches) at positions 0, 1, 255,
     256, 257, 300, 4095 and 8191, the rows past the position and the other
     layers poisoned: max |diff| <= 2e-3 * max(1, max |ref|);
  6. N-step generation, `generate_megakernel`, 64 greedy steps from
     CODEC_BOS at position 0 (the path's run: one C call, no host sync
     between steps, checked under `torch.cuda.set_sync_debug_mode("error")`),
     and 64 steps from a random position-300 cache with M-RoPE deltas
     (0, 5, 9); both held bit for bit (tokens and cache columns) to a loop
     of decode-step launches + `torch.argmax` + `embed[token]`;
  7. the "pallas" path, `TTSEngine(TTSConfig(backend="pallas"))`: one
     streaming request with the chunk checks of phase 3 and
     decode-attention launches == 28 x talker steps + 5 x code-predictor
     steps; then the reduced-model GPU-versus-CPU parity of phase 3 on
     that backend;
  8. times (CUDA events, interleaved plain-kernel-kernel-plain): decode
     attention at positions 300, 4095 and 8191 beside its plain version and
     `scaled_dot_product_attention` on bf16 tensors of the same prefix
     (the port never calls it); generation of 64 steps beside its plain
     version, and of 256 steps from position 0 as tokens/s beside the
     decode-step host loop's and the weight-bandwidth bound.
The next-to-last line is a JSON object describing the three kernels; the
last line is {"ok": true, "device": {...}}. JAX and the JAX package are
blocked for the whole run: the port must not need them.
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
ATTN_POSITIONS = (0, 1, 255, 256, 257, 300, 4095, 8191)
ATTN_TIMED = (300, 4095, 8191)
ATTN_LAYER = 27
GEN_STEPS = 64
GEN_TIMED_STEPS = 256


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


def _device_ms(fn, iters: int) -> float:
    """Device time per call: the summed durations of the CUDA kernels that
    `iters` calls ran, from `torch.profiler`, over `iters`. Unlike CUDA
    events around back-to-back calls, this leaves out the host's time to
    enqueue them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA")
    assert us > 0, "the profiler saw no device time"
    return us / iters / 1e3


def _interleaved(kernel, plain, iters: int, plain_iters: int, warmup: int = 3,
                 plain_warmup: int | None = None):
    """(kernel ms, plain ms): the best of two runs each, in the order
    plain, kernel, kernel, plain."""
    pw = warmup if plain_warmup is None else plain_warmup
    p1, k1, k2, p2 = (_time_ms(plain, plain_iters, pw), _time_ms(kernel, iters, warmup),
                      _time_ms(kernel, iters, warmup), _time_ms(plain, plain_iters, pw))
    return min(k1, k2), min(p1, p2)


def _bound_ms(nbytes: float, flops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def step_cost(cfg, w, pos: int, with_head: bool):
    """(bytes, FLOPs) one decode step at cache row `pos` must move and do:
    every layer weight read once, the cache prefix read once, the new K/V
    column written, the input row read and the outputs written."""
    lw = w.layers
    wbytes = sum(t.numel() * t.element_size() for t in lw) + w.final_norm.numel() * 2
    wflops = 2 * sum(t.numel() for t in (lw.wqkv, lw.wo, lw.w_gate_up, lw.w_down))
    if with_head:
        wbytes += w.lm_head.numel() * 2
        wflops += 2 * w.lm_head.numel()
    L, KVH, D, HQ = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.num_q_heads
    cache = 2 * L * KVH * pos * D * 2
    io = 2 * L * KVH * D * 2 + cfg.hidden_size * 4 * 2 + (cfg.vocab_size * 4 if with_head else 0)
    attn_flops = 4 * L * HQ * (pos + 1) * D
    return wbytes + cache + io, wflops + attn_flops


def compare_kernel(cfg, w, pos: int, with_head: bool, gen, mrope: bool):
    """Kernel vs plain version at one position over a random cache."""
    import torch
    from qwen_tts_tpu_torch.models.decoder import init_state, rope_rows
    from qwen_tts_tpu_torch.ops.decode_step import (
        megakernel_forward,
        megakernel_forward_reference,
    )

    dev = w.embed.device
    state = init_state(cfg, dev)
    if pos:
        shape = state.k_cache[:, :, :pos].shape
        state.k_cache[:, :, :pos] = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        state.v_cache[:, :, :pos] = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    state = state._replace(position=pos)
    embed = torch.randn(cfg.hidden_size, generator=gen, device=dev)
    mp = [pos] * len(cfg.mrope_section) if mrope else None
    sk = state._replace(k_cache=state.k_cache.clone(), v_cache=state.v_cache.clone())
    _, logits_k, normed_k = megakernel_forward(cfg, w, sk, embed, mrope_pos=mp, with_head=with_head)
    cos, sin = rope_rows(cfg, w.rope, pos, 1, mp)
    _, logits_r, normed_r = megakernel_forward_reference(cfg, w, state, embed, cos, sin, with_head)
    torch.cuda.synchronize()
    res = {"pos": pos, "normed_cos": _cos(normed_k, normed_r),
           "normed_max_abs": float((normed_k - normed_r).abs().max())}
    # K/V columns, layer by layer: max |diff| <= 2e-2 * max(1, max |ref|) and
    # relative L2 error < 2e-2. Scaled, not a flat atol: after ~10 layers the
    # two versions' different f32 summation orders have flipped enough bf16
    # roundings that 28-layer columns of magnitude ~4 differ by 1-2 bf16 ulps
    # (0.016-0.031) while their relative error stays below 1%.
    for name, a, b in (("k", sk.k_cache, state.k_cache), ("v", sk.v_cache, state.v_cache)):
        ca, cb = a[:, :, pos].float().flatten(1), b[:, :, pos].float().flatten(1)
        d = (ca - cb).abs()
        bound = 2e-2 * cb.abs().max(dim=1).values.clamp_min(1.0)
        rel = d.norm(dim=1) / cb.norm(dim=1)
        res[f"{name}_col_max_abs"] = float(d.max())
        res[f"{name}_col_max_rel_l2"] = float(rel.max())
        res[f"{name}_col_ok"] = bool((d.max(dim=1).values <= bound).all() and (rel < 2e-2).all())
    assert res["normed_cos"] > 0.999, res
    assert res["k_col_ok"] and res["v_col_ok"], res
    if with_head:
        top2 = torch.topk(logits_r, 2).values
        tie = float(top2[0] - top2[1]) < 1e-3 * float(logits_r.abs().max())
        res["argmax_equal"] = int(logits_k.argmax()) == int(logits_r.argmax())
        res["logits_max_abs"] = float((logits_k - logits_r).abs().max())
        assert res["argmax_equal"] or tie, res
    return res, (sk, state, embed, cos, sin, mp)


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


def reduced_engine_parity(backend: str = "auto"):
    """A reduced model, greedy, on the GPU (kernels) and on the CPU (plain
    path), both on `backend`. The first frame's 16 codes must be equal and
    its audio close (atol 1e-3). Over the first 8 frames, >= 95% of the
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
                                  chunk_frames=4, subtalker_do_sample=False), model_config=mc)
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
    res = {"backend": backend, "first_frame_equal": bool((a[0] == b[0]).all()),
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
    from qwen_tts_tpu_torch.ops import attention, decode_step, generate_kernel

    for fn in (decode_step.megakernel_forward, attention.decode_attention,
               generate_kernel.generate_megakernel):
        fn.launches = 0


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


def compare_attention(cfg, gen):
    """Phase 5: the decode-attention kernel against its plain version."""
    import torch
    from qwen_tts_tpu_torch.ops.attention import decode_attention, decode_attention_reference

    q, k_new, v_new, kc, vc, rows = attention_inputs(cfg, gen)
    errs = []
    for pos in ATTN_POSITIONS:
        set_prefix(kc, vc, rows, pos)
        got = decode_attention(q, k_new, v_new, kc, vc, ATTN_LAYER, pos)
        want = decode_attention_reference(q, k_new, v_new, kc, vc, ATTN_LAYER, pos)
        torch.cuda.synchronize()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        ok = err <= 2e-3 * max(1.0, scale) and bool(torch.isfinite(got).all())
        print("decode attention vs plain", json.dumps(
            {"pos": pos, "max_abs": err, "ref_max_abs": scale, "ok": ok}))
        assert ok, (pos, err, scale)
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
    loop_state = state._replace(k_cache=state.k_cache.clone(), v_cache=state.v_cache.clone())
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
    res = {"case": label, "pos0": pos0, "steps": GEN_STEPS, "c_calls": calls,
           "tokens_equal": bool(torch.equal(toks.long(), loop_toks)),
           "cache_equal": bool(torch.equal(state.k_cache, loop_state.k_cache)
                               and torch.equal(state.v_cache, loop_state.v_cache)),
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
        kernel = lambda: decode_attention(q, k_new, v_new, kc, vc, ATTN_LAYER, pos)  # noqa: E731
        plain = lambda: decode_attention_reference(  # noqa: E731
            q, k_new, v_new, kc, vc, ATTN_LAYER, pos)
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


def time_generate(cfg, w, card):
    """Phase 8: one N-step call (N = 64) beside its plain version, and
    N = 256 from position 0 as tokens/s beside the decode-step host loop."""
    import torch
    from qwen_tts_tpu_torch.core.config import CODEC_BOS
    from qwen_tts_tpu_torch.models.decoder import init_state
    from qwen_tts_tpu_torch.ops.generate_kernel import (
        generate_megakernel,
        generate_megakernel_reference,
    )

    state = init_state(cfg, "cuda")
    starts = [0] * len(cfg.mrope_section)
    first = torch.full((1,), CODEC_BOS, dtype=torch.int32, device="cuda")
    kernel = lambda: generate_megakernel(cfg, w, state, first, GEN_STEPS, starts)  # noqa: E731
    plain = lambda: generate_megakernel_reference(  # noqa: E731
        cfg, w, state, first, GEN_STEPS, starts)
    # the plain loop compiles nothing and the earlier phases ran its ops
    k_ms, p_ms = _interleaved(kernel, plain, 3, 1, warmup=1, plain_warmup=0)
    nbytes = flops = 0
    for n in range(GEN_STEPS):
        b, f = step_cost(cfg, w, n, True)
        nbytes, flops = nbytes + b, flops + f
    b_ms, b_by = _bound_ms(nbytes, flops)
    print(f"generate, {GEN_STEPS} steps from position 0: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) {card}")

    n = GEN_TIMED_STEPS
    call = lambda: generate_megakernel(cfg, w, state, first, n, starts)  # noqa: E731
    loop = lambda: generate_loop(cfg, w, state, CODEC_BOS, n, starts)  # noqa: E731
    g_ms, l_ms = _interleaved(call, loop, 2, 2, warmup=1)
    busy_ms = _device_ms(call, 1)
    nbytes = sum(step_cost(cfg, w, i, True)[0] for i in range(n))
    b_ms256 = nbytes / HBM_BYTES_PER_S * 1e3
    tok_s = {"generate_tok_s": n / g_ms * 1e3, "decode_step_loop_tok_s": n / l_ms * 1e3,
             "bound_tok_s": n / b_ms256 * 1e3, "device_busy_ms_per_step": busy_ms / n}
    print(f"generate, {n} steps from position 0: {g_ms / n:.4f} ms/step = "
          f"{tok_s['generate_tok_s']:.1f} tok/s (device busy {busy_ms / n:.4f} ms/step); "
          f"decode-step host loop {l_ms / n:.4f} ms/step = "
          f"{tok_s['decode_step_loop_tok_s']:.1f} tok/s; weight-bandwidth bound "
          f"{b_ms256 / n:.4f} ms/step = {tok_s['bound_tok_s']:.1f} tok/s {card}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, **tok_s}


_T0 = time.perf_counter()


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
    from qwen_tts_tpu_torch.ops import attention, cuda_lib, decode_step

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
    errs, ctx = [], {}
    for pos in (0, 1, 300):
        res, c = compare_kernel(mc.talker, tw, pos, True, gen, mrope=True)
        print("talker kernel vs plain", json.dumps(res))
        errs.append(max(res["normed_max_abs"], res["logits_max_abs"]))
        ctx["talker"] = c
    for pos in (2, 14):
        res, c = compare_kernel(mc.code_predictor, cw, pos, False, gen, mrope=False)
        print("code-predictor kernel vs plain", json.dumps(res))
        errs.append(res["normed_max_abs"])
        ctx["cp"] = c

    _phase_done(2)

    # ── phase 3: the main path through the engine ──
    run_requests(eng)                              # warm: cuBLAS/cuDNN set-up
    _reset_launches()
    m0 = eng.get_metrics()
    stats = run_requests(eng)
    launches = {"decode_step": decode_step.megakernel_forward.launches}
    m1 = eng.get_metrics()
    steps = (m1["talker_steps"] - m0["talker_steps"]) + (m1["cp_steps"] - m0["cp_steps"])
    print(f"main path: {launches['decode_step']} decode-step launches, {steps} decode steps "
          f"(talker {m1['talker_steps'] - m0['talker_steps']}, "
          f"code predictor {m1['cp_steps'] - m0['cp_steps']})")
    assert launches["decode_step"] == steps > 0, (launches, steps)
    parity = reduced_engine_parity()
    print("reduced model, GPU kernel vs CPU plain engine:", json.dumps(parity))

    _phase_done(3)

    # ── phase 4: decode-step timings ──
    t_k, t_p = time_steps(mc.talker, tw, ctx["talker"], True, 50)
    sk, _, embed, _, _, mp = ctx["talker"]
    t_dev = _device_ms(lambda: decode_step.megakernel_forward(mc.talker, tw, sk, embed,
                                                               mrope_pos=mp), 20)
    c_k, c_p = time_steps(mc.code_predictor, cw, ctx["cp"], False, 100)
    t_b, t_by = _bound_ms(*step_cost(mc.talker, tw, 300, True))
    c_b, _ = _bound_ms(*step_cost(mc.code_predictor, cw, 14, False))
    print(f"talker step (pos 300): kernel {t_k:.4f} ms (device {t_dev:.4f} ms), plain "
          f"{t_p:.4f} ms, bound {t_b:.4f} ms ({t_by}) {card}")
    print(f"code-predictor step (pos 14): kernel {c_k:.4f} ms, plain {c_p:.4f} ms, "
          f"bound {c_b:.4f} ms {card}")
    for s in stats:
        print("request", json.dumps(s), card)
    streams = [s for s in stats if "ttfc_ms" in s]
    ttfc = sorted(s["ttfc_ms"] for s in streams)
    rtf = sum(s["wall_s"] for s in streams) / sum(s["audio_s"] for s in streams)
    print(f"eager slice: TTFC median {ttfc[len(ttfc) // 2]:.2f} ms "
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
    peng = TTSEngine(TTSConfig(backend="pallas"))
    peng.initialize(weights=eng.weights, vocoder_weights=eng.vocoder_weights)
    _reset_launches()
    m0 = peng.get_metrics()
    ttfc, wall, chunks = stream(peng, TEXTS[0])
    launches["decode_attention"] = attention.decode_attention.launches
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
    assert all(math.isfinite(e) for e in errs + [attn_err, gen_err])
    a300 = attn_t[300]
    print(json.dumps({"kernels": [
        {"name": "decode_step", "route": "cuda",
         "source": "qwen_tts_tpu_torch/csrc/decode_step.cu",
         "replaces": "qwen_tts_tpu/ops/decode_step.py:98",
         "launches": launches["decode_step"], "max_abs_err": max(errs),
         "ms": t_k, "plain_ms": t_p, "bound_ms": t_b, "bound_by": t_by, "library_ms": None,
         "device_ms": t_dev, "cp_ms": c_k, "cp_plain_ms": c_p, "cp_bound_ms": c_b},
        {"name": "decode_attention", "route": "cuda",
         "source": "qwen_tts_tpu_torch/csrc/attention.cu",
         "replaces": "qwen_tts_tpu/ops/attention.py:29",
         "launches": launches["decode_attention"], "max_abs_err": attn_err,
         "ms": a300["ms"], "plain_ms": a300["plain_ms"], "bound_ms": a300["bound_ms"],
         "bound_by": a300["bound_by"], "library_ms": a300["library_ms"],
         "call_ms": a300["call_ms"],
         "by_position": {str(p): v for p, v in attn_t.items()}},
        {"name": "generate", "route": "cuda",
         "source": "qwen_tts_tpu_torch/csrc/generate.cu",
         "replaces": "qwen_tts_tpu/ops/generate_kernel.py:52",
         "launches": launches["generate"], "max_abs_err": gen_err,
         "ms": gen_t["ms"], "plain_ms": gen_t["plain_ms"], "bound_ms": gen_t["bound_ms"],
         "bound_by": gen_t["bound_by"], "library_ms": None, "steps": GEN_STEPS,
         "tok_s_256": gen_t["generate_tok_s"],
         "decode_step_loop_tok_s_256": gen_t["decode_step_loop_tok_s"],
         "bound_tok_s_256": gen_t["bound_tok_s"],
         "device_busy_ms_per_step_256": gen_t["device_busy_ms_per_step"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

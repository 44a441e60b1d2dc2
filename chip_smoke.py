#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`qwen_tts_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and no result line
is printed):
  1. card name and power limit, torch and CUDA versions; builds the
     decode-step kernel from `qwen_tts_tpu_torch/csrc/decode_step.cu` with
     nvcc and prints ptxas' register and shared-memory lines;
  2. the kernel against its plain PyTorch version on the card at full width
     (Qwen3-TTS-12Hz-0.6B, random weights from a seed): the 28-layer talker
     at positions 0, 1 and 300 over a randomly filled cache, the 5-layer
     code predictor at positions 2 and 14;
  3. the engine's main path, `TTSEngine(TTSConfig(device="cuda"))` with the
     default config: three streaming requests of different lengths and one
     `synthesize`; checks chunk lengths, finite audio, and that the kernel's
     launch count equals the talker plus code-predictor decode steps run;
     then a reduced model on the GPU (kernel) against the same model on the
     CPU (plain path), greedy: the first frame's codes equal and its audio
     within 1e-3, and over 8 frames either >= 95% of the codes equal or the
     first differing code a near tie (top-2 gap < 2e-2) of the CPU logits
     that chose it, the GPU taking the CPU's runner-up;
  4. step times of the kernel and the plain version (CUDA events), TTFC and
     RTF of the eager engine.
The next-to-last line is a JSON object describing the kernel; the last line
is {"ok": true, "device": {...}}. JAX is blocked for the whole run: the
port must not need it.
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


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
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
    p1, k1, k2, p2 = (_time_ms(plain, max(iters // 5, 3)), _time_ms(kernel, iters),
                      _time_ms(kernel, iters), _time_ms(plain, max(iters // 5, 3)))
    return min(k1, k2), min(p1, p2)


def run_requests(eng):
    """Three streaming requests and one synthesize; returns per-request stats."""
    import numpy as np
    import torch

    hop = eng.vocoder_config.hop_length
    chunk = eng.config.chunk_frames * hop
    stats = []

    async def stream(text):
        t0 = time.perf_counter()
        ttfc, chunks = None, []
        async for audio, sr in eng.synthesize_streaming(text):
            if ttfc is None:
                ttfc = time.perf_counter() - t0
            chunks.append(audio)
        return ttfc, time.perf_counter() - t0, chunks

    for text in TEXTS:
        ttfc, wall, chunks = asyncio.run(stream(text))
        lens = [len(c) for c in chunks]
        assert lens[0] == hop, lens
        assert all(n == chunk for n in lens[1:-1]), lens
        assert len(lens) == 1 or (0 < lens[-1] <= chunk and lens[-1] % hop == 0), lens
        audio = np.concatenate(chunks)
        assert np.isfinite(audio).all() and np.abs(audio).max() > 0
        stats.append({"text_words": len(text.split()), "chunks": len(lens),
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


def reduced_engine_parity():
    """A reduced model, greedy, on the GPU (kernel) and on the CPU (plain
    path). The first frame's 16 codes must be equal and its audio close
    (atol 1e-3). Over the first 8 frames, >= 95% of the codes must be
    equal, or else the first code that differs must be a near tie: the CPU
    logits that chose it have a top-2 gap < 2e-2 and the GPU chose the
    runner-up. (The two devices sum in different orders; one near-tie flip
    changes every frame after it.)"""
    import numpy as np
    import torch
    from qwen_tts_tpu.core.config import tiny_test_config
    from qwen_tts_tpu_torch.core.weights import init_tts_weights
    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
    from qwen_tts_tpu_torch.runtime import frame_loop
    from qwen_tts_tpu_torch.vocoder.model import VocoderConfig, init_vocoder_weights

    mc = tiny_test_config(max_seq_len=256)
    w_cpu = init_tts_weights(SEED, mc, "cpu")
    v_cpu = init_vocoder_weights(SEED + 1, VocoderConfig(), "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        eng = TTSEngine(TTSConfig(device=dev, max_seq_len=256, chunk_frames=4,
                                  subtalker_do_sample=False), model_config=mc)
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
    res = {"first_frame_equal": bool((a[0] == b[0]).all()),
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


def main() -> int:
    sys.meta_path.insert(0, _NoJax())
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
    from qwen_tts_tpu_torch.ops import decode_step

    # ── phase 1: card, versions, build ──
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    decode_step.load_library()
    print(f"decode_step.cu built+loaded in {time.perf_counter() - t0:.1f} s")
    for line in decode_step.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ── phase 2: kernel vs plain at full width ──
    eng = TTSEngine(TTSConfig(device="cuda"))
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

    # ── phase 3: the main path through the engine ──
    run_requests(eng)                              # warm: cuBLAS/cuDNN set-up
    decode_step.megakernel_forward.launches = 0
    m0 = eng.get_metrics()
    stats = run_requests(eng)
    launches = decode_step.megakernel_forward.launches
    m1 = eng.get_metrics()
    steps = (m1["talker_steps"] - m0["talker_steps"]) + (m1["cp_steps"] - m0["cp_steps"])
    print(f"main path: {launches} kernel launches, {steps} decode steps "
          f"(talker {m1['talker_steps'] - m0['talker_steps']}, "
          f"code predictor {m1['cp_steps'] - m0['cp_steps']})")
    assert launches == steps and launches > 0, (launches, steps)
    parity = reduced_engine_parity()
    print("reduced model, GPU kernel vs CPU plain engine:", json.dumps(parity))

    # ── phase 4: timings ──
    t_k, t_p = time_steps(mc.talker, tw, ctx["talker"], True, 50)
    c_k, c_p = time_steps(mc.code_predictor, cw, ctx["cp"], False, 100)
    print(f"talker step (pos 300): kernel {t_k:.4f} ms, plain {t_p:.4f} ms {card}")
    print(f"code-predictor step (pos 14): kernel {c_k:.4f} ms, plain {c_p:.4f} ms {card}")
    for s in stats:
        print("request", json.dumps(s), card)
    streams = [s for s in stats if "ttfc_ms" in s]
    ttfc = sorted(s["ttfc_ms"] for s in streams)
    rtf = sum(s["wall_s"] for s in streams) / sum(s["audio_s"] for s in streams)
    print(f"eager slice: TTFC median {ttfc[len(ttfc) // 2]:.2f} ms "
          f"(max {ttfc[-1]:.2f}), streaming RTF {rtf:.4f} {card}")

    assert all(math.isfinite(e) for e in errs)
    print(json.dumps({"kernels": [{
        "name": "decode_step",
        "route": "cuda",
        "source": "qwen_tts_tpu_torch/csrc/decode_step.cu",
        "replaces": "qwen_tts_tpu/ops/decode_step.py:98",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": t_k,
        "plain_ms": t_p,
        "cp_ms": c_k,
        "cp_plain_ms": c_p,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

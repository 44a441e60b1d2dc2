#!/usr/bin/env python3
"""Block size, ring depth and cluster size of the decode-attention core, on one NVIDIA GPU.

    python3 tools/attention_variants.py [THREADS:STAGES:BLOCKS ...]

Builds `qwen_tts_tpu_torch/csrc/attention.cu` (the standalone decode-attention
kernel on the core of `csrc/attention_core.cuh`) once per variant, with
`-DQTTS_ATTN_THREADS`, `-DQTTS_ATTN_STAGES` and `-DQTTS_ATTN_MAX_BLOCKS`
(threads a block, tiles in the ring, most blocks a kv head; default
256:3:16, 256:3:8, 256:3:1, 256:2:16, 256:4:16, 512:3:16; 64-row tiles;
all nvcc processes started together), into the git-ignored
`qwen_tts_tpu_torch/_build/variants/`. Then, on full talker shapes (q
[16, 128] f32, one layer of [28, 8, 8192, 128] bf16 caches), for each
variant at positions 300, 4095 and 8191: checks the kernel against
`decode_attention_reference` (2e-3 x max(1, max |ref|)) and prints its
device time per call (`torch.profiler`, 100 calls), beside
`scaled_dot_product_attention` on the same prefix. Variants run in the
order given, then again reversed; each line keeps the lower of the two
times. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

POSITIONS = (300, 4095, 8191)
DEFAULT_VARIANTS = ("256:3:16", "256:3:8", "256:3:1", "256:2:16", "256:4:16", "512:3:16")


def build(variants):
    from qwen_tts_tpu_torch.ops import cuda_lib

    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        threads, stages, blocks = v.split(":")
        so = out_dir / f"attn_t{threads}_s{stages}_b{blocks}.so"
        procs[v] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.COMPILE_FLAGS, "-shared",
             f"-DQTTS_ATTN_THREADS={threads}", f"-DQTTS_ATTN_STAGES={stages}",
             f"-DQTTS_ATTN_MAX_BLOCKS={blocks}", "-o", str(so),
             str(cuda_lib.CSRC / "attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {v}:\n{log}")
        for line in log.splitlines():
            if "registers" in line:
                print(f"  ptxas [{v}]: {line.strip()}")
        lib = ctypes.CDLL(str(so), mode=ctypes.RTLD_LOCAL)
        lib.qtts_decode_attention.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                              + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2)
        lib.qtts_decode_attention.restype = ctypes.c_int
        libs[v] = lib
    return libs


def main() -> int:
    import torch

    import chip_smoke
    from qwen_tts_tpu_torch.ops.attention import decode_attention_reference

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    variants = sys.argv[1:] or list(DEFAULT_VARIANTS)
    libs = build(variants)
    L, KVH, S, D, HQ, layer = 28, 8, 8192, 128, 16, 27
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    q = torch.randn(HQ, D, generator=gen, device="cuda")
    k_new = torch.randn(KVH, D, generator=gen, device="cuda")
    v_new = torch.randn(KVH, D, generator=gen, device="cuda")
    kc = torch.randn(L, KVH, S, D, generator=gen, device="cuda").bfloat16()
    vc = torch.randn(L, KVH, S, D, generator=gen, device="cuda").bfloat16()
    out = torch.empty(HQ, D, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    best, failed = {}, False
    for order in (variants, variants[::-1]):
        for v in order:
            lib = libs[v]
            for pos in POSITIONS:
                p = torch.full((), pos, dtype=torch.int32, device="cuda")

                def call():
                    err = lib.qtts_decode_attention(
                        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kc.data_ptr(),
                        vc.data_ptr(), out.data_ptr(), p.data_ptr(), 1, L, HQ, KVH, S, D,
                        layer, HQ * D, KVH * D, L * KVH * S * D, HQ * D, None, stream)
                    assert err == 0, err
                out.fill_(float("nan"))
                call()
                want = decode_attention_reference(q, k_new, v_new, kc, vc, layer, p)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                ok = err <= 2e-3 * max(1.0, float(want.abs().max()))
                try:
                    ms = chip_smoke._device_ms(call, 100) if ok else float("nan")
                except AssertionError as e:  # the kernel did not run
                    ms, ok = float("nan"), False
                    print(f"  {v} pos {pos}: {e}")
                if not ok:
                    print(f"  {v} pos {pos}: max |err| {err} [{card}]")
                best[(v, pos)] = min(ms, best.get((v, pos), ms))
                failed |= not ok
    for pos in POSITIONS:
        qb = q.bfloat16()[None, :, None, :]
        kb = torch.cat([kc[layer, :, :pos], k_new.bfloat16()[:, None]], dim=1)[None]
        vb = torch.cat([vc[layer, :, :pos], v_new.bfloat16()[:, None]], dim=1)[None]
        sdpa = chip_smoke._device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qb, kb, vb, enable_gqa=True), 100)
        print(f"position {pos}: scaled_dot_product_attention {sdpa * 1e3:.3f} us [{card}]")
        for v in variants:
            print(f"position {pos} threads:stages:blocks {v}: device us per call "
                  f"{best[(v, pos)] * 1e3:.3f} [{card}]")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""One fused decode step: the CUDA kernel, its plain version, and the wrapper.

Port of `qwen_tts_tpu/ops/decode_step.py` (`megakernel_forward` :453, Pallas
body `_megakernel` :98) for bf16 weights and a bf16 KV cache. One call runs
one token through all L layers — RMSNorm, fused QKV, QK-RMSNorm, RoPE, the
new K/V column written into the cache at `position`, online-softmax GQA over
the cache prefix plus the in-flight column, O-proj, SwiGLU MLP — then the
final RMSNorm and, optionally, the LM head. The same code serves the
28-layer talker and the 5-layer code predictor.

`megakernel_forward` dispatches on where the tensors are: on the CPU it
runs `megakernel_forward_reference` (plain PyTorch, the same rounding
points); on a CUDA device it launches `csrc/decode_step.cu` through ctypes,
or raises. The kernel is compiled with nvcc for sm_90a into `_build/` at
first use. `megakernel_forward.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

from qwen_tts_tpu.core.config import DecoderConfig

from ..core.weights import DecoderWeights
from ..models.decoder import (
    DecodeState,
    forward_layers,
    lm_head_logits,
    rope_rows,
)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "decode_step.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_log = ""   # nvcc's output (ptxas register/shared-memory lines)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def load_library() -> ctypes.CDLL:
    """Compile `csrc/decode_step.cu` (once per source content) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"decode_step_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qtts_decode_step.argtypes = ([ptr] * 18 + [i32] * 9
                                     + [ctypes.c_float, ptr])
    lib.qtts_decode_step.restype = i32
    lib.qtts_workspace_bytes.argtypes = [i32] * 6
    lib.qtts_workspace_bytes.restype = ctypes.c_longlong
    _lib = lib
    return lib


def megakernel_forward_reference(cfg: DecoderConfig, w: DecoderWeights,
                                 state: DecodeState, embed: torch.Tensor,
                                 cos: torch.Tensor, sin: torch.Tensor,
                                 with_head: bool = True):
    """Plain PyTorch version of the kernel: the dense single-token layer of
    `models/decoder.py` (same bf16 rounding points), cache written in place.
    Returns (state, logits [V] f32 or None, normed [H] f32)."""
    state, normed = forward_layers(cfg, w, state, embed.float()[None, :], cos, sin)
    logits = lm_head_logits(w, normed)[0] if with_head else None
    return state, logits, normed[0]


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"decode_step: {name} is {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}; the kernel takes {tuple(shape)} {dtype} "
                         f"on {device}")
    if not t.is_contiguous():
        raise ValueError(f"decode_step: {name} must be contiguous")


def megakernel_forward(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                       embed: torch.Tensor,
                       mrope_pos: Sequence[int] | None = None,
                       with_head: bool = True):
    """One fused decode step. Returns (state, logits [V] f32 or None when
    `with_head` is False, normed [H] f32). The cache is updated in place."""
    pos = state.position
    if pos >= cfg.max_seq_len:
        raise ValueError(f"decode position {pos} >= max_seq_len {cfg.max_seq_len}")
    cos, sin = rope_rows(cfg, w.rope, pos, 1, mrope_pos)
    dev = embed.device
    if dev.type == "cpu":
        return megakernel_forward_reference(cfg, w, state, embed, cos, sin, with_head)
    if dev.type != "cuda":
        raise ValueError(f"decode_step: no kernel for device {dev}")

    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    HQ, KVH, D, S, V = (cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.max_seq_len, cfg.vocab_size)
    Q, KV = cfg.q_size, cfg.kv_size
    bf, f32 = torch.bfloat16, torch.float32
    lw = w.layers
    embed = embed.to(f32).contiguous()
    cos, sin = cos.reshape(D // 2).contiguous(), sin.reshape(D // 2).contiguous()
    for name, t, shape, dtype in (
            ("embed", embed, (H,), f32),
            ("input_norm", lw.input_norm, (L, H), bf),
            ("wqkv", lw.wqkv, (L, H, Q + 2 * KV), bf),
            ("q_norm", lw.q_norm, (L, D), bf),
            ("k_norm", lw.k_norm, (L, D), bf),
            ("wo", lw.wo, (L, Q, H), bf),
            ("post_norm", lw.post_norm, (L, H), bf),
            ("w_gate_up", lw.w_gate_up, (L, H, 2 * I), bf),
            ("w_down", lw.w_down, (L, I, H), bf),
            ("final_norm", w.final_norm, (H,), bf),
            ("lm_head", w.lm_head, (H, V), bf),
            ("cos", cos, (D // 2,), f32),
            ("sin", sin, (D // 2,), f32),
            ("k_cache", state.k_cache, (L, KVH, S, D), bf),
            ("v_cache", state.v_cache, (L, KVH, S, D), bf)):
        _check(name, t, shape, dtype, dev)
    if D != 128 or HQ % KVH or HQ // KVH > 8 or any(
            n % 64 for n in (H, Q + 2 * KV, 2 * I, V)):
        raise ValueError(f"decode_step kernel does not take this config: {cfg}")

    lib = load_library()
    ws = torch.empty(lib.qtts_workspace_bytes(H, I, HQ, KVH, D, V),
                     dtype=torch.uint8, device=dev)
    normed = torch.empty(H, dtype=f32, device=dev)
    logits = torch.empty(V, dtype=f32, device=dev) if with_head else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.qtts_decode_step(
        embed.data_ptr(), lw.input_norm.data_ptr(), lw.wqkv.data_ptr(),
        lw.q_norm.data_ptr(), lw.k_norm.data_ptr(), lw.wo.data_ptr(),
        lw.post_norm.data_ptr(), lw.w_gate_up.data_ptr(), lw.w_down.data_ptr(),
        w.final_norm.data_ptr(), w.lm_head.data_ptr() if with_head else None,
        cos.data_ptr(), sin.data_ptr(), state.k_cache.data_ptr(),
        state.v_cache.data_ptr(), normed.data_ptr(),
        logits.data_ptr() if with_head else None, ws.data_ptr(),
        L, H, I, HQ, KVH, D, S, V, pos, cfg.rms_eps, stream)
    if err != 0:
        raise RuntimeError(f"decode_step kernel failed with CUDA error {err}")
    megakernel_forward.launches += 1
    return state._replace(position=pos + 1), logits, normed


megakernel_forward.launches = 0

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
or raises. The kernel is built with the port's other kernels by
`ops/cuda_lib.py` at first use. `megakernel_forward.launches` counts
kernel launches.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.config import DecoderConfig
from ..core.weights import DecoderWeights
from ..models.decoder import (
    DecodeState,
    forward_layers,
    lm_head_logits,
    rope_rows,
)
from .cuda_lib import check, check_tensor, load_library, stream_of


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


def check_decoder(kernel: str, cfg: DecoderConfig, w: DecoderWeights,
                  state: DecodeState, dev: torch.device) -> None:
    """Raise unless the weights and caches are what the decode-step code of
    `csrc/decode_layer.cuh` takes: bf16, contiguous, on `dev`, at these
    widths, with D = 128, at most 8 q heads per kv head and every matrix
    width a multiple of 64."""
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    KVH, D, S, V = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len, cfg.vocab_size
    Q, KV, bf, lw = cfg.q_size, cfg.kv_size, torch.bfloat16, w.layers
    for name, t, shape in (
            ("input_norm", lw.input_norm, (L, H)),
            ("wqkv", lw.wqkv, (L, H, Q + 2 * KV)),
            ("q_norm", lw.q_norm, (L, D)),
            ("k_norm", lw.k_norm, (L, D)),
            ("wo", lw.wo, (L, Q, H)),
            ("post_norm", lw.post_norm, (L, H)),
            ("w_gate_up", lw.w_gate_up, (L, H, 2 * I)),
            ("w_down", lw.w_down, (L, I, H)),
            ("final_norm", w.final_norm, (H,)),
            ("lm_head", w.lm_head, (H, V)),
            ("k_cache", state.k_cache, (L, KVH, S, D)),
            ("v_cache", state.v_cache, (L, KVH, S, D))):
        check_tensor(kernel, name, t, shape, bf, dev)
    if D != 128 or cfg.num_q_heads % KVH or cfg.gqa_groups > 8 or any(
            n % 64 for n in (H, Q + 2 * KV, 2 * I, V)):
        raise ValueError(f"{kernel} kernel does not take this config: {cfg}")


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
    f32, lw = torch.float32, w.layers
    embed = embed.to(f32).contiguous()
    cos, sin = cos.reshape(D // 2).contiguous(), sin.reshape(D // 2).contiguous()
    check_decoder("decode_step", cfg, w, state, dev)
    for name, t, n in (("embed", embed, H), ("cos", cos, D // 2), ("sin", sin, D // 2)):
        check_tensor("decode_step", name, t, (n,), f32, dev)

    lib = load_library()
    ws = torch.empty(lib.qtts_workspace_bytes(H, I, HQ, KVH, D, V),
                     dtype=torch.uint8, device=dev)
    normed = torch.empty(H, dtype=f32, device=dev)
    logits = torch.empty(V, dtype=f32, device=dev) if with_head else None
    err = lib.qtts_decode_step(
        embed.data_ptr(), lw.input_norm.data_ptr(), lw.wqkv.data_ptr(),
        lw.q_norm.data_ptr(), lw.k_norm.data_ptr(), lw.wo.data_ptr(),
        lw.post_norm.data_ptr(), lw.w_gate_up.data_ptr(), lw.w_down.data_ptr(),
        w.final_norm.data_ptr(), w.lm_head.data_ptr() if with_head else None,
        cos.data_ptr(), sin.data_ptr(), state.k_cache.data_ptr(),
        state.v_cache.data_ptr(), normed.data_ptr(),
        logits.data_ptr() if with_head else None, ws.data_ptr(),
        L, H, I, HQ, KVH, D, S, V, pos, cfg.rms_eps, stream_of(dev))
    check("decode_step", err)
    megakernel_forward.launches += 1
    return state._replace(position=pos + 1), logits, normed


megakernel_forward.launches = 0

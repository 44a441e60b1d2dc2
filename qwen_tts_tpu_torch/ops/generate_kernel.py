"""N greedy decode steps in one call: the CUDA kernel, its plain version, the wrapper.

Port of `qwen_tts_tpu/ops/generate_kernel.py` (`generate_megakernel` :769,
`_generate_impl` :514, Pallas body `_gen_kernel` :52) for bf16 weights and
a bf16 KV cache. Step n runs the talker's decode step at cache row
`pos0 + n` from the embedding of the previous step's argmax (step 0 from
`embed[first_token]`), writing the K/V column into the cache in place. With
`cfg.mrope_section` set, section s of the rotary frequencies rotates by
`mrope_pos0[s] + n` (by default the cache position: standard RoPE).

`generate_megakernel` dispatches on where the tensors are: on the CPU it
runs `generate_megakernel_reference`; on a CUDA device it makes one C call
to `csrc/generate.cu`, which enqueues all N steps with the token fed back
on the device (no host sync between steps), or raises.
`generate_megakernel.launches` counts those calls.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.config import DecoderConfig
from ..core.weights import DecoderWeights
from ..models.decoder import DecodeState, rope_rows
from .cuda_lib import check, check_tensor, int4, load_library, stream_of
from .decode_step import check_decoder, megakernel_forward_reference


def _mrope_starts(cfg: DecoderConfig, pos0: int,
                  mrope_pos0: Sequence[int] | None) -> list[int] | None:
    """Per-section start positions of step 0 (None: standard RoPE)."""
    if cfg.mrope_section is None:
        return None
    if mrope_pos0 is None:
        return [pos0] * len(cfg.mrope_section)
    starts = [int(p) for p in mrope_pos0]
    if len(starts) != len(cfg.mrope_section):
        raise ValueError(f"mrope_pos0 {starts} needs one position per section "
                         f"{cfg.mrope_section}")
    return starts


def _check_rope_room(w: DecoderWeights, starts: Sequence[int] | None, pos0: int,
                     num_steps: int) -> None:
    """M-RoPE sections index the rope table ahead of the cache position;
    fail instead of reading past the table's rows."""
    firsts = starts if starts is not None else [pos0]
    rows = w.rope.cos.shape[0]
    hi = max(firsts) + num_steps
    if min(firsts) < 0 or hi > rows:
        raise ValueError(
            f"mrope_pos0 max + num_steps ({hi}) exceeds the rope table ({rows} "
            f"rows = max_seq_len + headroom), or a start is negative; shorten "
            f"the run or raise MROPE_HEADROOM (core/weights.py)")


def generate_megakernel_reference(cfg: DecoderConfig, w: DecoderWeights,
                                  state: DecodeState, first_token: torch.Tensor,
                                  num_steps: int,
                                  mrope_pos0: Sequence[int] | None = None):
    """Plain version: a loop of `megakernel_forward_reference`, argmax and
    `embed[token]`, with the same rope rows. Returns (state, tokens [N] int32)."""
    pos0 = state.position
    starts = _mrope_starts(cfg, pos0, mrope_pos0)
    token = first_token.reshape(1)
    tokens = []
    for n in range(num_steps):
        embed = w.embed[token][0].float()
        mp = None if starts is None else [s + n for s in starts]
        cos, sin = rope_rows(cfg, w.rope, pos0 + n, 1, mp)
        state, logits, _ = megakernel_forward_reference(cfg, w, state, embed, cos, sin)
        token = torch.argmax(logits).reshape(1)
        tokens.append(token)
    return state, torch.cat(tokens).to(torch.int32)


def generate_megakernel(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                        first_token, num_steps: int,
                        mrope_pos0: Sequence[int] | None = None):
    """Greedy-decode `num_steps` tokens from `first_token` (an int or a
    one-element tensor on the weights' device). Returns (state at
    `position + num_steps`, tokens [num_steps] int32 on the device); the
    cache is updated in place."""
    pos0 = state.position
    if num_steps <= 0 or pos0 + num_steps > cfg.max_seq_len:
        raise ValueError(f"positions [{pos0}, {pos0 + num_steps}) outside the "
                         f"cache's max_seq_len {cfg.max_seq_len}")
    starts = _mrope_starts(cfg, pos0, mrope_pos0)
    _check_rope_room(w, starts, pos0, num_steps)
    dev = w.embed.device
    if isinstance(first_token, torch.Tensor):
        first = first_token.reshape(1).to(device=dev, dtype=torch.int32)
    else:
        # a fill kernel, not a host-to-device copy: nothing waits
        first = torch.full((1,), int(first_token), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return generate_megakernel_reference(cfg, w, state, first, num_steps, starts)
    if dev.type != "cuda":
        raise ValueError(f"generate: no kernel for device {dev}")

    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    HQ, KVH, D, S, V = (cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.max_seq_len, cfg.vocab_size)
    check_decoder("generate", cfg, w, state, dev)
    if w.embed.shape[0] < V:
        raise ValueError(f"generate: embedding table {tuple(w.embed.shape)} has fewer "
                         f"rows than the vocabulary ({V})")
    check_tensor("generate", "embed", w.embed, (w.embed.shape[0], H), torch.bfloat16, dev)
    rows = w.rope.cos.shape[0]
    for name, t in (("rope.cos", w.rope.cos), ("rope.sin", w.rope.sin)):
        check_tensor("generate", name, t, (rows, D // 2), torch.float32, dev)
    secs = cfg.mrope_section or ()
    if len(secs) > 4 or (secs and not cfg.mrope_interleaved):
        raise ValueError(f"generate kernel takes at most 4 interleaved M-RoPE "
                         f"sections: {secs}, interleaved={cfg.mrope_interleaved}")
    deltas = [s - pos0 for s in starts] if starts is not None else []

    lib = load_library()
    ws = torch.empty(lib.qtts_generate_workspace_bytes(H, I, HQ, KVH, D, V),
                     dtype=torch.uint8, device=dev)
    tokens = torch.empty(num_steps, dtype=torch.int32, device=dev)
    lw = w.layers
    err = lib.qtts_generate(
        first.data_ptr(), w.embed.data_ptr(), lw.input_norm.data_ptr(),
        lw.wqkv.data_ptr(), lw.q_norm.data_ptr(), lw.k_norm.data_ptr(),
        lw.wo.data_ptr(), lw.post_norm.data_ptr(), lw.w_gate_up.data_ptr(),
        lw.w_down.data_ptr(), w.final_norm.data_ptr(), w.lm_head.data_ptr(),
        w.rope.cos.data_ptr(), w.rope.sin.data_ptr(), rows,
        state.k_cache.data_ptr(), state.v_cache.data_ptr(), tokens.data_ptr(),
        ws.data_ptr(), L, H, I, HQ, KVH, D, S, V, pos0, num_steps, cfg.rms_eps,
        len(secs), int4(secs), int4(deltas), stream_of(dev))
    check("generate", err)
    generate_megakernel.launches += 1
    return state._replace(position=pos0 + num_steps), tokens


generate_megakernel.launches = 0

"""N greedy decode steps in one call: the CUDA kernel, its plain version, the wrapper.

Port of `qwen_tts_tpu/ops/generate_kernel.py` (`generate_megakernel` :769,
`_generate_impl` :514, Pallas body `_gen_kernel` :52) for every weight form
of the decode step (bf16, int8, int4-g128, mixed) and a bf16 or int8 KV
cache. Step n runs the talker's decode step at cache row
`pos0 + n` from the embedding of the previous step's argmax (step 0 from
`embed[first_token]`), writing the K/V column into the cache in place. With
`cfg.mrope_section` set, section s of the rotary frequencies rotates by
`mrope_pos0[s] + n` (by default the cache position: standard RoPE).

`generate_megakernel` dispatches on where the tensors are: on the CPU it
runs `generate_megakernel_reference`; on a CUDA device it makes one launch
of `csrc/generate.cu`, the decode step's persistent kernel with the step
loop, the argmax and the embedding of the token fed back inside it (no
host work between steps), or raises. M-RoPE takes the interleaved or the
chunked layout and up to 8 sections. `generate_megakernel.launches`
counts those launches.

Each step is the decode step of `ops/decode_step.py`, so the in-flight
token joins its own attention as an f32 column. The JAX kernel stages it
in its tail ring in the cache's dtype and reads it back
(`generate_kernel.py:278-297, 389-421`); under an int8 cache the two differ
by one int8 rounding of that column, which the JAX package's own kv8
generation tests allow for (`tests/test_generate_kernel.py:246-335`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.config import DecoderConfig
from ..core.weights import DecoderWeights
from ..models.decoder import DecodeState, rope_rows
from .cuda_lib import check, check_tensor, ints, load_library, stream_of
from .decode_step import (
    check_rope,
    decoder_struct,
    megakernel_forward_reference,
    positions,
    rope_spec,
    workspace,
)


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

    H, V = cfg.hidden_size, cfg.vocab_size
    secs, interleaved = rope_spec(cfg, starts)
    dec = decoder_struct("generate", cfg, w, state, dev, with_head=True)
    if w.embed.shape[0] < V:
        raise ValueError(f"generate: embedding table {tuple(w.embed.shape)} has fewer "
                         f"rows than the vocabulary ({V})")
    check_tensor("generate", "embed", w.embed, (w.embed.shape[0], H), torch.bfloat16, dev)
    values = (pos0, *starts) if secs else (pos0,)
    check_rope("generate", cfg, w, values[1:] if secs else values, num_steps, dev)

    lib = load_library()
    ws = workspace(cfg, dev)
    pos_entry = positions(state, values, dev)
    tokens = torch.empty(num_steps, dtype=torch.int32, device=dev)
    err = lib.qtts_generate(
        dec, first.data_ptr(), w.embed.data_ptr(), w.rope.cos.data_ptr(),
        w.rope.sin.data_ptr(), pos_entry[0].data_ptr(), len(secs), interleaved, ints(secs),
        tokens.data_ptr(), ws.data_ptr(), num_steps, stream_of(dev))
    pos_entry[1] = None if err else tuple(v + num_steps for v in values)  # what the launch leaves
    check("generate", err)
    generate_megakernel.launches += 1
    return state._replace(position=pos0 + num_steps), tokens


generate_megakernel.launches = 0

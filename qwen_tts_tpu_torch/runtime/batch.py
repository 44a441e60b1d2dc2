"""Batched (B > 1) generation — the port of `qwen_tts_tpu/runtime/batch.py`.

JAX vmaps the single-utterance frame path over B utterances. Here the same
functions take B slots directly (`models/decoder.py`, `runtime/frame_loop.py`):
every matrix product runs on B rows, one a slot, and reads each weight once
for all slots; the attention is per slot, over its own cache `[B, L, KVH,
S, D]` at its own device position, through the decode-attention kernel
(`attn_impl="pallas"`, bf16 cache, on a GPU) or its plain version. Slots
may sit at different positions (continuous batching admits requests into
them at any time, `runtime/continuous.py`), so a batched step takes no host
position. A slot's results depend on its own inputs only, up to the
rounding of the batched products.

Used by `TTSEngine.synthesize_batch` and `runtime/continuous.py`. Sampling
noise comes in as uniform draws, `[B, n, 15, top_k]`, which the caller
makes per (request, absolute frame) as the engine does; JAX takes a key per
utterance instead (`rng`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.config import DecoderConfig
from ..core.weights import CodePredictorWeights, DecoderWeights
from ..models.decoder import DecodeState, init_state
from .frame_loop import frames_chunk, talker_prefill


def batched_prefill(cfg: DecoderConfig, w: DecoderWeights, prefill_embeds: torch.Tensor,
                    attn_impl: str = "dense", kv_dtype=torch.bfloat16,
                    mrope_deltas: Sequence[int] | None = None):
    """Fresh-state prefill + first CODEC_BOS decode for B utterances,
    `prefill_embeds [B, 8, H]`, on their device. `kv_dtype` torch.int8 gives
    a per-row-scaled int8 KV cache.

    Returns (state of B slots, first_token [B], first_hidden [B, H])."""
    state = init_state(cfg, prefill_embeds.device, kv_dtype, slots=prefill_embeds.shape[0])
    return talker_prefill(cfg, w, state, prefill_embeds, attn_impl=attn_impl,
                          mrope_deltas=mrope_deltas)


def batched_frames(talker_cfg: DecoderConfig, cp_cfg: DecoderConfig,
                   talker_w: DecoderWeights, cp_w: CodePredictorWeights,
                   state: DecodeState, prev_token: torch.Tensor, hidden: torch.Tensor,
                   trailing: torch.Tensor, trailing_len: torch.Tensor,
                   trailing_idx0: torch.Tensor, tts_pad_embed: torch.Tensor,
                   uniform: torch.Tensor | None, num_frames: int = 10,
                   do_sample: bool = True, temperature: float = 0.9, top_k: int = 50,
                   attn_impl: str = "dense", mrope_deltas: Sequence[int] | None = None,
                   cp_state: DecodeState | None = None):
    """`num_frames` frames for B utterances: `state` of B slots (updated in
    place), prev_token [B] int, hidden [B, H] f32, trailing [B, T_pad, H],
    trailing_len and trailing_idx0 [B] int32, uniform [B, n, 15, top_k]
    (None when greedy), `cp_state` a code-predictor state of B slots (None:
    a fresh one each frame).

    Returns (state, codes [B, N, 16], valid [B, N], next_token [B],
    next_hidden [B, H])."""
    return frames_chunk(talker_cfg, cp_cfg, talker_w, cp_w, state, prev_token, hidden,
                        trailing, trailing_len, trailing_idx0, tts_pad_embed, uniform,
                        num_frames=num_frames, do_sample=do_sample,
                        temperature=temperature, top_k=top_k, attn_impl=attn_impl,
                        mrope_deltas=mrope_deltas, cp_state=cp_state)

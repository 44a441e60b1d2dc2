"""Per-frame decode loop — the port of `qwen_tts_tpu/runtime/frame_loop.py`.

A frame is: the code predictor's 16 codes, the sum of their 16 codec
embeddings plus the trailing-text embedding as the next talker input, and
one talker step. JAX scans frames on the device inside one jit; here a
Python loop enqueues them, and the engine captures a whole chunk of them
into one CUDA graph (`engine/tts_engine.py`). So nothing in the loop waits
on the device, and nothing that changes from chunk to chunk is a host
value: the trailing-text index and length are device int32 scalars, the
text row is chosen with `torch.where` (JAX `frame_step` :83-89), the
Gumbel noise is transformed from a buffer of uniforms the caller filled,
the EOS `alive` flag stays on the device, and tables are indexed by a
token as `table[token.reshape(1)][0]`: indexing by a 0-d tensor reads it
back to the host, which waits on the device. Positions are host integers
that the kernels also keep on the device (`ops/decode_step.py`), or a
state's own device positions (`models/decoder.py`), so a replayed chunk
carries on from where the last one left.

Every function takes one stream or B slots (`runtime/batch.py`): hidden
`[B, H]`, tokens, trailing index and length `[B]`, trailing rows
`[B, T, H]`, uniforms `[B, n, 15, top_k]`, a state of B slots; each slot's
results depend on its own inputs only (up to the rounding of the batched
matrix products).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..core.config import CODEC_BOS, CODEC_EOS, DecoderConfig
from ..core.weights import CodePredictorWeights, DecoderWeights
from ..models.code_predictor import cp_predict
from ..models.decoder import DecodeState, decode_step_with_embed, forward_chunk
from ..ops.sampling import gumbel_from_uniform


class FrameResult(NamedTuple):
    state: DecodeState
    codes: torch.Tensor         # [(B,) 16] int64
    next_token: torch.Tensor    # int64, 0-d or [B]
    next_hidden: torch.Tensor   # [(B,) H] f32


def _mrope_pos(state: DecodeState, mrope_deltas: Sequence[int] | None):
    if mrope_deltas is None:
        return None
    return [state.position + d for d in mrope_deltas]


def _sum_code_embeddings(codes: torch.Tensor, talker_embed: torch.Tensor,
                         cp_codec_embeds: torch.Tensor) -> torch.Tensor:
    """Σ of the 16 codec-group embeddings of a frame's codes `[(B,) 16]`,
    f32 `[(B,) H]`."""
    groups = torch.arange(cp_codec_embeds.shape[0], device=codes.device)
    rest = cp_codec_embeds[groups, codes[..., 1:]].float()
    return talker_embed[codes[..., :1]][..., 0, :].float() + rest.sum(dim=-2)


def _text_rows(trailing: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row `idx` (clamped to the last) of `trailing [T, H]`, or of each
    slot's `[B, T, H]` at its `idx [B]`."""
    row = idx.clamp_max(trailing.shape[-2] - 1).long()
    if trailing.dim() == 2:
        return trailing[row.reshape(1)][0]
    return trailing.gather(1, row[:, None, None].expand(-1, 1, trailing.shape[-1]))[:, 0]


def frame_step(talker_cfg: DecoderConfig, cp_cfg: DecoderConfig,
               talker_w: DecoderWeights, cp_w: CodePredictorWeights,
               state: DecodeState, prev_token: torch.Tensor, hidden: torch.Tensor,
               trailing: torch.Tensor, trailing_len: torch.Tensor,
               trailing_idx: torch.Tensor, tts_pad_embed: torch.Tensor,
               noise: torch.Tensor | None, do_sample: bool = True,
               temperature: float = 0.9, top_k: int = 50, attn_impl: str = "dense",
               mrope_deltas: Sequence[int] | None = None,
               cp_state: DecodeState | None = None) -> FrameResult:
    """One full frame. `trailing_len` and `trailing_idx` are int32 tensors
    on the device (0-d, or `[B]`); `cp_state` is the code predictor's state,
    reset in place (None: a fresh one)."""
    codes = cp_predict(cp_cfg, cp_w, hidden, prev_token, talker_w.embed,
                       do_sample=do_sample, temperature=temperature, top_k=top_k,
                       noise=noise, attn_impl=attn_impl, state=cp_state)
    embed_sum = _sum_code_embeddings(codes, talker_w.embed, cp_w.codec_embeds)
    text_embed = torch.where((trailing_idx < trailing_len)[..., None],
                             _text_rows(trailing, trailing_idx).float(),
                             tts_pad_embed.float())
    state, next_token, next_hidden = decode_step_with_embed(
        talker_cfg, talker_w, state, embed_sum + text_embed,
        attn_impl=attn_impl, mrope_pos=_mrope_pos(state, mrope_deltas))
    return FrameResult(state, codes, next_token, next_hidden)


def frames_chunk(talker_cfg: DecoderConfig, cp_cfg: DecoderConfig,
                 talker_w: DecoderWeights, cp_w: CodePredictorWeights,
                 state: DecodeState, prev_token: torch.Tensor,
                 hidden: torch.Tensor, trailing: torch.Tensor, trailing_len: torch.Tensor,
                 trailing_idx0: torch.Tensor, tts_pad_embed: torch.Tensor,
                 uniform: torch.Tensor | None, num_frames: int, do_sample: bool = True,
                 temperature: float = 0.9, top_k: int = 50,
                 attn_impl: str = "dense",
                 mrope_deltas: Sequence[int] | None = None,
                 cp_state: DecodeState | None = None):
    """`num_frames` frames from the trailing-text index `trailing_idx0` (an
    int32 device tensor, as is `trailing_len`: 0-d, or `[B]` for B slots).
    With sampling on, `uniform [(B,) num_frames, 15, top_k]` holds each
    frame's uniform draws (keyed by the absolute frame index, so codes do
    not depend on how frames are chunked), turned into Gumbel noise here.
    Frame i is valid while no token fed so far was CODEC_EOS (the JAX
    `alive` rule); frames after EOS are still computed, as in JAX, and
    flagged.

    Returns (state, codes [(B,) n, 16] int64, valid [(B,) n] bool,
    next_token, next_hidden).
    """
    noise = gumbel_from_uniform(uniform[..., :num_frames, :, :]) if do_sample else None
    alive = torch.ones(hidden.shape[:-1], dtype=torch.bool, device=hidden.device)
    codes, valid = [], []
    tok, hid = prev_token, hidden
    for i in range(num_frames):
        r = frame_step(talker_cfg, cp_cfg, talker_w, cp_w, state, tok, hid,
                       trailing, trailing_len, trailing_idx0 + i, tts_pad_embed,
                       None if noise is None else noise[..., i, :, :],
                       do_sample=do_sample, temperature=temperature, top_k=top_k,
                       attn_impl=attn_impl, mrope_deltas=mrope_deltas, cp_state=cp_state)
        alive = alive & (tok != CODEC_EOS)
        codes.append(r.codes)
        valid.append(alive)
        state, tok, hid = r.state, r.next_token, r.next_hidden
    return state, torch.stack(codes, dim=-2), torch.stack(valid, dim=-1), tok, hid


def talker_prefill(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                   embeds: torch.Tensor, attn_impl: str = "dense",
                   mrope_deltas: Sequence[int] | None = None):
    """Dense prefill of the conditioning rows `[(B,) T, H]`, then the first
    decode step from CODEC_BOS. Returns (state, first_token, first_hidden)."""
    state, _ = forward_chunk(cfg, w, state, embeds,
                             mrope_pos=_mrope_pos(state, mrope_deltas))
    bos = w.embed[CODEC_BOS]
    if embeds.dim() == 3:
        bos = bos.expand(embeds.shape[0], -1)
    return decode_step_with_embed(cfg, w, state, bos, attn_impl=attn_impl,
                                  mrope_pos=_mrope_pos(state, mrope_deltas))

"""Per-frame decode loop — the port of `qwen_tts_tpu/runtime/frame_loop.py`.

A frame is: the code predictor's 16 codes, the sum of their 16 codec
embeddings plus the trailing-text embedding as the next talker input, and
one talker step. JAX scans frames on the device inside one jit; here a
Python loop enqueues them, and nothing in the loop waits on the device:
positions and trailing-text indices are host integers, the EOS `alive`
flag stays a device tensor until the caller reads the chunk, and tables
are indexed by a token as `table[token.reshape(1)][0]`: indexing by a 0-d
tensor reads it back to the host, which waits on the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from qwen_tts_tpu.core.config import CODEC_BOS, CODEC_EOS, DecoderConfig

from ..core.weights import CodePredictorWeights, DecoderWeights
from ..models.code_predictor import cp_predict
from ..models.decoder import DecodeState, decode_step_with_embed, forward_chunk

# (absolute frame index) -> [15, top_k] Gumbel noise for that frame
NoiseFn = Callable[[int], torch.Tensor]


class FrameResult(NamedTuple):
    state: DecodeState
    codes: torch.Tensor         # [16] int64
    next_token: torch.Tensor    # 0-d int64
    next_hidden: torch.Tensor   # [H] f32


def _mrope_pos(state: DecodeState, mrope_deltas: Sequence[int] | None):
    if mrope_deltas is None:
        return None
    return [state.position + d for d in mrope_deltas]


def _sum_code_embeddings(codes: torch.Tensor, talker_embed: torch.Tensor,
                         cp_codec_embeds: torch.Tensor) -> torch.Tensor:
    """Σ of the 16 codec-group embeddings of one frame, f32 [H]."""
    groups = torch.arange(cp_codec_embeds.shape[0], device=codes.device)
    rest = cp_codec_embeds[groups, codes[1:]].float()
    return talker_embed[codes[:1]][0].float() + rest.sum(dim=0)


def frame_step(talker_cfg: DecoderConfig, cp_cfg: DecoderConfig,
               talker_w: DecoderWeights, cp_w: CodePredictorWeights,
               state: DecodeState, prev_token: torch.Tensor, hidden: torch.Tensor,
               trailing: torch.Tensor, trailing_len: int, trailing_idx: int,
               tts_pad_embed: torch.Tensor, noise: torch.Tensor | None,
               do_sample: bool = True, temperature: float = 0.9, top_k: int = 50,
               attn_impl: str = "dense",
               mrope_deltas: Sequence[int] | None = None) -> FrameResult:
    """One full frame."""
    codes = cp_predict(cp_cfg, cp_w, hidden, prev_token, talker_w.embed,
                       do_sample=do_sample, temperature=temperature, top_k=top_k,
                       noise=noise, attn_impl=attn_impl)
    embed_sum = _sum_code_embeddings(codes, talker_w.embed, cp_w.codec_embeds)
    if trailing_idx < trailing_len:
        text_embed = trailing[min(trailing_idx, trailing.shape[0] - 1)]
    else:
        text_embed = tts_pad_embed
    state, next_token, next_hidden = decode_step_with_embed(
        talker_cfg, talker_w, state, embed_sum + text_embed.float(),
        attn_impl=attn_impl, mrope_pos=_mrope_pos(state, mrope_deltas))
    return FrameResult(state, codes, next_token, next_hidden)


def frames_chunk(talker_cfg: DecoderConfig, cp_cfg: DecoderConfig,
                 talker_w: DecoderWeights, cp_w: CodePredictorWeights,
                 state: DecodeState, prev_token: torch.Tensor,
                 hidden: torch.Tensor, trailing: torch.Tensor, trailing_len: int,
                 trailing_idx0: int, tts_pad_embed: torch.Tensor,
                 noise_fn: NoiseFn | None, num_frames: int, do_sample: bool = True,
                 temperature: float = 0.9, top_k: int = 50,
                 attn_impl: str = "dense",
                 mrope_deltas: Sequence[int] | None = None):
    """`num_frames` frames. Frame i is valid while no token fed so far was
    CODEC_EOS (the JAX `alive` rule); frames after EOS are still computed,
    as in JAX, and flagged. Noise is keyed by the absolute frame index, so
    the codes do not depend on how frames are chunked.

    Returns (state, codes [n, 16] int64, valid [n] bool, next_token, next_hidden).
    """
    alive = torch.ones((), dtype=torch.bool, device=hidden.device)
    codes, valid = [], []
    tok, hid = prev_token, hidden
    for i in range(num_frames):
        frame = trailing_idx0 + i
        r = frame_step(talker_cfg, cp_cfg, talker_w, cp_w, state, tok, hid,
                       trailing, trailing_len, frame, tts_pad_embed,
                       noise_fn(frame) if (do_sample and noise_fn) else None,
                       do_sample=do_sample, temperature=temperature, top_k=top_k,
                       attn_impl=attn_impl, mrope_deltas=mrope_deltas)
        alive = alive & (tok != CODEC_EOS)
        codes.append(r.codes)
        valid.append(alive)
        state, tok, hid = r.state, r.next_token, r.next_hidden
    return state, torch.stack(codes), torch.stack(valid), tok, hid


def talker_prefill(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                   embeds: torch.Tensor, attn_impl: str = "dense",
                   mrope_deltas: Sequence[int] | None = None):
    """Dense prefill of the conditioning rows, then the first decode step
    from CODEC_BOS. Returns (state, first_token, first_hidden)."""
    state, _ = forward_chunk(cfg, w, state, embeds,
                             mrope_pos=_mrope_pos(state, mrope_deltas))
    return decode_step_with_embed(cfg, w, state, w.embed[CODEC_BOS],
                                  attn_impl=attn_impl,
                                  mrope_pos=_mrope_pos(state, mrope_deltas))

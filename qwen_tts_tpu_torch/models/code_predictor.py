"""Code predictor — the 5-layer transformer producing codebook groups 1..15.

Port of `qwen_tts_tpu/models/code_predictor.py::cp_predict`: a 2-token dense
prefill `[talker_hidden, embed(first_token)]`, then per group: head →
sample → embed → one single-token step. The JAX scan also runs a step
after the last group whose output nothing reads; the port skips it, so a
frame costs 14 steps, not 15 (tests assert the codes are unchanged). The
caller may pass the decoder's state, which is reset in place (the frame
loop keeps one for all frames, so a captured frame allocates nothing and
its cache keeps its address); without one a fresh state is allocated. The
decoder may be quantized (the engine's `cp_quantize`); its KV cache and its
15 heads stay bf16, as in the JAX package.

On the "mega" backend a one-stream frame on a CUDA device is one launch of
the decode-step kernel (`ops/cp_frame.py`: 16 steps from cache row 0, the
heads and the sampling inside it; `frame_kernel` says when). The plain path
stays for the CPU, for B slots and for tensor-parallel ranks.
"""

from __future__ import annotations

import torch

from ..core.config import DecoderConfig
from ..core.weights import CodePredictorWeights
from ..ops.cp_frame import cp_frame, kernel_takes
from ..ops.sampling import sample_logits
from .decoder import DecodeState, forward_chunk, init_state, matmul, reset_state


def frame_kernel(attn_impl: str, device, cfg: DecoderConfig, do_sample: bool,
                 temperature: float, top_k: int) -> bool:
    """Whether `cp_predict` runs a one-stream frame (no tensor-parallel
    rank, a bf16 cache) as one launch of the decode-step kernel: the "mega"
    backend on a CUDA device, with a config and sampling the kernel takes."""
    return (attn_impl == "mega" and torch.device(device).type == "cuda"
            and kernel_takes(cfg, do_sample, temperature, top_k))


def cp_predict(
    cfg: DecoderConfig,
    w: CodePredictorWeights,
    talker_hidden: torch.Tensor,       # [(B,) H] f32 — talker post-final-norm hidden
    first_token: torch.Tensor,         # int, 0-d or [B] — the talker's codebook-0 token
    talker_embed_table: torch.Tensor,  # [3072, H] bf16
    do_sample: bool = True,
    temperature: float = 0.9,
    top_k: int = 50,
    noise: torch.Tensor | None = None,  # [(B,) num_groups, top_k] Gumbel noise
    num_groups: int = 15,
    attn_impl: str = "dense",
    return_logits: bool = False,
    state: DecodeState | None = None,   # reset in place; None: a fresh one
    tp=None,                            # a tensor-parallel rank's collectives
):
    """Predict all 16 codebook groups of one frame, for one stream
    (`talker_hidden [H]`) or B slots (`[B, H]`, a state of B slots; each
    slot's rows of every product are its own). Returns `[(B,) 16]` int64
    `[first_token, predicted_1..15]` (and the `[(B,) 15, 2048]` f32 logits
    when `return_logits`). On a tensor-parallel rank `cfg`, `w` and the
    state are its shard (`parallel/sharding.py::shard_cp_weights`): each
    head's vocab shards are joined before the sample."""
    one = talker_hidden.dim() == 1
    if one and tp is None and (state is None or state.k_scale is None) and frame_kernel(
            attn_impl, talker_hidden.device, cfg, do_sample, temperature, top_k):
        tokens, logits = cp_frame(
            cfg, w, state if state is not None else init_state(cfg, talker_hidden.device),
            talker_hidden, first_token, talker_embed_table, noise, do_sample, temperature,
            top_k, num_groups, return_logits)
        codes = torch.cat([first_token.reshape(1).to(torch.int64), tokens.to(torch.int64)])
        return (codes, logits) if return_logits else codes
    hidden = talker_hidden[None] if one else talker_hidden
    if state is None:
        state = init_state(cfg, talker_hidden.device, slots=None if one else hidden.shape[0])
    else:
        state = reset_state(state)
    # 1-element index: a 0-d one is read back to the host (a device sync)
    first_embed = talker_embed_table[first_token.reshape(-1)].float()
    prefill = torch.stack([hidden.float(), first_embed], dim=1)
    state, normed = forward_chunk(cfg, w.decoder, state, prefill[0] if one else prefill,
                                  tp=tp)
    hidden = normed[..., -1, :]
    tokens, all_logits = [], []
    for g in range(num_groups):
        logits = matmul(hidden, w.lm_heads[g])
        if tp is not None:
            logits = tp.gather_vocab(logits)
        token = sample_logits(logits, do_sample, temperature, top_k,
                              None if noise is None else noise[..., g, :])
        tokens.append(token)
        all_logits.append(logits)
        if g + 1 < num_groups:
            embed = w.codec_embeds[g][token.reshape(-1)].float()
            state, normed = forward_chunk(cfg, w.decoder, state,
                                          embed if one else embed[:, None],
                                          attn_impl=attn_impl, tp=tp)
            hidden = normed[..., 0, :]
    codes = torch.stack([first_token.reshape(token.shape).to(torch.int64), *tokens], dim=-1)
    if return_logits:
        return codes, torch.stack(all_logits, dim=-2)
    return codes

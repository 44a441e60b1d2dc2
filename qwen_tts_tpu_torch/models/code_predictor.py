"""Code predictor — the 5-layer transformer producing codebook groups 1..15.

Port of `qwen_tts_tpu/models/code_predictor.py::cp_predict`: a 2-token dense
prefill `[talker_hidden, embed(first_token)]`, then per group: head →
sample → embed → one single-token step. The JAX scan also runs a step
after the last group whose output nothing reads; the port skips it, so a
frame costs 14 steps, not 15 (tests assert the codes are unchanged).
"""

from __future__ import annotations

import torch

from ..core.config import DecoderConfig
from ..core.weights import CodePredictorWeights
from ..ops.sampling import sample_logits
from .decoder import forward_chunk, init_state, matmul


def cp_predict(
    cfg: DecoderConfig,
    w: CodePredictorWeights,
    talker_hidden: torch.Tensor,       # [H] f32 — talker post-final-norm hidden
    first_token: torch.Tensor,         # 0-d int — the talker's codebook-0 token
    talker_embed_table: torch.Tensor,  # [3072, H] bf16
    do_sample: bool = True,
    temperature: float = 0.9,
    top_k: int = 50,
    noise: torch.Tensor | None = None,  # [num_groups, top_k] Gumbel noise
    num_groups: int = 15,
    attn_impl: str = "dense",
    return_logits: bool = False,
):
    """Predict all 16 codebook groups of one frame. Returns `[16]` int64
    `[first_token, predicted_1..15]` (and the `[15, 2048]` f32 logits when
    `return_logits`)."""
    state = init_state(cfg, talker_hidden.device)
    # 1-element index: a 0-d one is read back to the host (a device sync)
    first_embed = talker_embed_table[first_token.reshape(1)][0].float()
    prefill = torch.stack([talker_hidden.float(), first_embed])
    state, normed = forward_chunk(cfg, w.decoder, state, prefill)
    hidden = normed[-1]
    tokens, all_logits = [], []
    for g in range(num_groups):
        logits = matmul(hidden, w.lm_heads[g])
        token = sample_logits(logits, do_sample, temperature, top_k,
                              None if noise is None else noise[g])
        tokens.append(token)
        all_logits.append(logits)
        if g + 1 < num_groups:
            embed = w.codec_embeds[g][token.reshape(1)][0].float()
            state, normed = forward_chunk(cfg, w.decoder, state, embed[None],
                                          attn_impl=attn_impl)
            hidden = normed[0]
    codes = torch.stack([first_token.reshape(()).to(torch.int64), *tokens])
    if return_logits:
        return codes, torch.stack(all_logits)
    return codes

"""Greedy multi-step generation as a loop of decode steps.

Port of `qwen_tts_tpu/runtime/generate.py::generate_tokens` (a `lax.scan`
over `decode_step`). Here a Python loop enqueues the steps; the token stays
on the device and indexes the embedding table as a one-element tensor (a
0-d index would be read back to the host), so no step waits on the device.
`ops/generate_kernel.py::generate_megakernel` runs the same steps from one
C call.
"""

from __future__ import annotations

import torch

from ..core.config import DecoderConfig
from ..core.weights import DecoderWeights
from ..models.decoder import DecodeState, decode_step


def generate_tokens(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                    first_token, num_steps: int, attn_impl: str = "dense"):
    """Greedy-decode `num_steps` tokens from `first_token` (an int or a
    one-element tensor). Returns (state, tokens [num_steps] int32)."""
    token = torch.as_tensor(first_token, device=w.embed.device).reshape(1)
    tokens = []
    for _ in range(num_steps):
        state, token, _ = decode_step(cfg, w, state, token, attn_impl=attn_impl)
        tokens.append(token.reshape(1))
    return state, torch.cat(tokens).to(torch.int32)

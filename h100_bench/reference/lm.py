"""Plain float32 Qwen3-0.6B text LM: the served reply's logits, teacher-forced.

One full causal pass over the prompt and the served reply ids; the logits
at the prompt's last row and at each reply row before the last choose the
next id greedily, through the head tied to the embedding.
"""

from __future__ import annotations

import torch

from . import qwen3


def reply_gaps(w: dict, cfg: dict, prompt: list[int], reply: list[int],
               stop: int | None) -> torch.Tensor:
    """`[len(reply) (+1)]` gaps of the served ids (and of `stop`, the id that
    ended the reply early, when given) below the reference's best logit."""
    served = list(reply) + ([stop] if stop is not None else [])
    emb = w["lm.embed"]
    ids = torch.tensor(list(prompt) + list(reply), device=emb.device)[:len(prompt) + len(served) - 1]
    hidden = qwen3.forward(w, "lm", cfg, emb[ids].float()[None])[0]
    logits = hidden[len(prompt) - 1:] @ emb.float().t()
    return qwen3.gap(logits, torch.tensor(served, device=emb.device))

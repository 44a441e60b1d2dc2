"""Token sampling on the device: greedy argmax, or top-k + temperature +
Gumbel-max. Port of `qwen_tts_tpu/ops/sampling.py`.

torch cannot reproduce JAX's threefry bits, so the Gumbel noise is an
argument: callers draw it from an explicit `torch.Generator`
(`gumbel_noise`), and tests inject the exact values JAX drew. The
transform is its own function (`gumbel_from_uniform`): the engine draws a
chunk's uniforms outside its CUDA graph, with a generator seeded per
frame, and the graph transforms them.
"""

from __future__ import annotations

import torch


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel samples -log(-log(u)), u clamped to [tiny, 1)."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel samples, -log(-log(u)) with u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return gumbel_from_uniform(u)


def sample_logits(logits: torch.Tensor, do_sample: bool, temperature: float = 0.9,
                  top_k: int = 50, noise: torch.Tensor | None = None) -> torch.Tensor:
    """Tokens (int64) of logits `[..., V]`: `[]` for one row, `[B]` for B.
    With sampling on, `noise` holds Gumbel noise of shape `[..., top_k]`
    (or `[..., V]` when top-k does not restrict)."""
    if not do_sample or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if noise is None:
        raise ValueError("sampling needs Gumbel noise")
    scaled = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        vals, idxs = torch.topk(scaled, top_k)
        pick = torch.argmax(vals + noise, dim=-1, keepdim=True)
        return idxs.gather(-1, pick)[..., 0]
    return torch.argmax(scaled + noise, dim=-1)

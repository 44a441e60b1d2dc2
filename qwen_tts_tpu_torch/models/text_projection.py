"""Text embedding + projection MLP (151936 → 2048 → SiLU → 1024).

Port of `qwen_tts_tpu/models/text_projection.py`: `embedding(ids) →
SiLU(fc1) → fc2`, bf16 weights with f32 accumulation, bf16 output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.weights import TextProjectionWeights
from .decoder import matmul


def embed_text_ids(w: TextProjectionWeights, token_ids: torch.Tensor) -> torch.Tensor:
    """[T] int → [T, hidden_size] bf16.

    Ids past the table are clamped to its last row, as JAX's gather does
    (only reduced test vocabularies are smaller than the Qwen special ids)."""
    x = w.text_embedding[token_ids.clamp(0, w.text_embedding.shape[0] - 1)]
    x = F.silu(matmul(x, w.fc1_w) + w.fc1_b.float())
    x = matmul(x, w.fc2_w) + w.fc2_b.float()
    return x.to(torch.bfloat16)

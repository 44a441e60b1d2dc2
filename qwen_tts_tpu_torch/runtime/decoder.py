"""Stateful talker decoder — the port of `qwen_tts_tpu/runtime/decoder.py`.

The same surface as the JAX `TTSDecoder`: `step(token_id)`,
`step_with_embed(embed)`, `prefill(embeds)`, `reset()`, `position`,
`embed_weight` and `state`, over the functional decoder of
`models/decoder.py`. The KV cache lives on the weights' device and is
updated in place. The TTS engine's frame loop does not go through this
class; it serves parity checks and callers that drive the talker alone.

Backends: `"dense"` is plain torch (the JAX package calls its plain
backend `"xla"`); `"pallas"` runs the dense layers with the CUDA
decode-attention kernel in each single-token step (`ops/attention.py`);
`"mega"` runs each single-token step as the CUDA decode-step kernel
(`ops/decode_step.py`). Prefill is dense on every backend, as in JAX. On
the CPU the kernels run their plain versions.
"""

from __future__ import annotations

import torch

from ..core.config import TALKER_CONFIG, DecoderConfig
from ..core.weights import DecoderWeights
from ..models import decoder as _decoder
from ..models.decoder import DecodeState, init_state

BACKENDS = ("dense", "pallas", "mega")


class TTSDecoder:
    """Stateful talker decoder."""

    def __init__(self, weights: DecoderWeights, cfg: DecoderConfig = TALKER_CONFIG,
                 backend: str = "mega"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.cfg = cfg
        self.backend = backend
        self._w = weights
        self._state = init_state(cfg, weights.embed.device)

    def step(self, token_id: int) -> tuple[int, torch.Tensor]:
        """One decode step from a token id -> (next token, hidden f32 [H])."""
        token = torch.full((1,), int(token_id), dtype=torch.int64,
                           device=self._w.embed.device)
        self._state, nxt, hidden = _decoder.decode_step(
            self.cfg, self._w, self._state, token, attn_impl=self.backend)
        return int(nxt), hidden

    def step_with_embed(self, embed: torch.Tensor) -> tuple[int, torch.Tensor]:
        """One decode step from a precomputed embedding [H]."""
        self._state, nxt, hidden = _decoder.decode_step_with_embed(
            self.cfg, self._w, self._state, embed, attn_impl=self.backend)
        return int(nxt), hidden

    def prefill(self, embeds: torch.Tensor) -> tuple[int, torch.Tensor]:
        """Dense causal prefill of [T, H] embeddings -> (next token, last hidden)."""
        self._state, nxt, hidden = _decoder.prefill(self.cfg, self._w, self._state, embeds)
        return int(nxt), hidden

    def reset(self):
        """Zero the cache and return to position 0."""
        self._state.k_cache.zero_()
        self._state.v_cache.zero_()
        self._state = self._state._replace(position=0)

    @property
    def position(self) -> int:
        return self._state.position

    @property
    def embed_weight(self) -> torch.Tensor:
        """Codec embedding table [3072, 1024] bf16."""
        return self._w.embed

    @property
    def state(self) -> DecodeState:
        return self._state

    @state.setter
    def state(self, s: DecodeState):
        self._state = s

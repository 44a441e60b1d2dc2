"""Weight containers for the port, in the JAX package's layout.

Counterpart of `qwen_tts_tpu/core/weights.py:29-206`. Per-layer tensors are
stacked on a leading `[L, ...]` axis, projection matrices are stored
`[in_features, out_features]` (the hot path is `x @ W`), and Q|K|V and
gate|up are fused on the output axis. Keeping the layout identical lets
`from_jax` convert the JAX package's parameters leaf by leaf and lets the
CUDA decode-step kernel read the same slabs the Pallas kernel streamed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qwen_tts_tpu.core.config import DecoderConfig, TTSModelConfig

# Extra rope-table rows when M-RoPE is on: section positions may run ahead
# of the cache position (the JAX package's MROPE_HEADROOM).
MROPE_HEADROOM = 1024


class LayerWeights(NamedTuple):
    input_norm: torch.Tensor   # [L, H]
    wqkv: torch.Tensor         # [L, H, Q + 2*KV]  (q | k | v)
    q_norm: torch.Tensor       # [L, D]
    k_norm: torch.Tensor       # [L, D]
    wo: torch.Tensor           # [L, Q, H]
    post_norm: torch.Tensor    # [L, H]
    w_gate_up: torch.Tensor    # [L, H, 2*I]       (gate | up)
    w_down: torch.Tensor       # [L, I, H]


class RopeTable(NamedTuple):
    cos: torch.Tensor          # [rows, D//2] f32
    sin: torch.Tensor


class DecoderWeights(NamedTuple):
    layers: LayerWeights
    final_norm: torch.Tensor   # [H]
    embed: torch.Tensor        # [V, H] codec embedding (zeros for the CP)
    lm_head: torch.Tensor      # [H, V] (zeros for the CP)
    rope: RopeTable


class CodePredictorWeights(NamedTuple):
    decoder: DecoderWeights
    lm_heads: torch.Tensor     # [15, H, 2048]
    codec_embeds: torch.Tensor  # [15, 2048, H]


class TextProjectionWeights(NamedTuple):
    text_embedding: torch.Tensor  # [151936, 2048]
    fc1_w: torch.Tensor           # [2048, 2048] (in, out)
    fc1_b: torch.Tensor           # [2048]
    fc2_w: torch.Tensor           # [2048, 1024]
    fc2_b: torch.Tensor           # [1024]


class TTSWeights(NamedTuple):
    talker: DecoderWeights
    code_predictor: CodePredictorWeights
    text_projection: TextProjectionWeights


def make_rope_table(cfg: DecoderConfig, device="cpu") -> RopeTable:
    """f32 cos/sin `[rows, D//2]`, built exactly as the JAX package builds
    it (numpy f32), with `MROPE_HEADROOM` extra rows under M-RoPE."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    rows = cfg.max_seq_len + (MROPE_HEADROOM if cfg.mrope_section is not None else 0)
    freqs = np.outer(np.arange(rows, dtype=np.float32), inv_freq)
    return RopeTable(
        cos=torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
        sin=torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device),
    )


def _normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * scale


def init_decoder_weights(gen: torch.Generator, cfg: DecoderConfig, device="cpu",
                         with_heads: bool = True) -> DecoderWeights:
    """Random bf16 decoder weights at the JAX package's scales."""
    h, q, kv, i, d = (cfg.hidden_size, cfg.q_size, cfg.kv_size,
                      cfg.intermediate_size, cfg.head_dim)
    L, v = cfg.num_layers, cfg.vocab_size
    bf = torch.bfloat16

    def mat(shape, fan_in):
        return _normal(gen, shape, fan_in ** -0.5, device).to(bf)

    def ones(*shape):
        return torch.ones(shape, dtype=bf, device=device)

    layers = LayerWeights(
        input_norm=ones(L, h),
        wqkv=mat((L, h, q + 2 * kv), h),
        q_norm=ones(L, d),
        k_norm=ones(L, d),
        wo=mat((L, q, h), q),
        post_norm=ones(L, h),
        w_gate_up=mat((L, h, 2 * i), h),
        w_down=mat((L, i, h), i),
    )
    if with_heads:
        embed, lm_head = mat((v, h), h), mat((h, v), h)
    else:
        embed = torch.zeros((v, h), dtype=bf, device=device)
        lm_head = torch.zeros((h, v), dtype=bf, device=device)
    return DecoderWeights(layers=layers, final_norm=ones(h), embed=embed,
                          lm_head=lm_head, rope=make_rope_table(cfg, device))


def init_tts_weights(seed: int, cfg: TTSModelConfig, device="cpu") -> TTSWeights:
    """Seeded random weights for the whole model, made on `device` (so a
    full-width model is drawn on the GPU, not on the host)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bf = torch.bfloat16
    talker = init_decoder_weights(gen, cfg.talker, device)
    cp_dec = init_decoder_weights(gen, cfg.code_predictor, device, with_heads=False)
    h, cpv = cfg.code_predictor.hidden_size, cfg.code_predictor.vocab_size
    ng = cfg.num_code_groups - 1
    cp = CodePredictorWeights(
        decoder=cp_dec,
        lm_heads=_normal(gen, (ng, h, cpv), h ** -0.5, device).to(bf),
        codec_embeds=_normal(gen, (ng, cpv, h), h ** -0.5, device).to(bf),
    )
    tp = cfg.text_projection
    text = TextProjectionWeights(
        text_embedding=_normal(gen, (tp.text_vocab_size, tp.text_hidden_size),
                               0.02, device).to(bf),
        fc1_w=_normal(gen, (tp.text_hidden_size, tp.text_hidden_size),
                      tp.text_hidden_size ** -0.5, device).to(bf),
        fc1_b=torch.zeros((tp.text_hidden_size,), dtype=bf, device=device),
        fc2_w=_normal(gen, (tp.text_hidden_size, tp.hidden_size),
                      tp.text_hidden_size ** -0.5, device).to(bf),
        fc2_b=torch.zeros((tp.hidden_size,), dtype=bf, device=device),
    )
    return TTSWeights(talker=talker, code_predictor=cp, text_projection=text)


# ── conversion from the JAX package ─────────────────────────────────────────


def to_torch(a, device="cpu") -> torch.Tensor:
    """One array (numpy, or anything `np.asarray` accepts) → tensor, bit-exact.

    bf16 arrives as an ml_dtypes array, which `torch.from_numpy` rejects, so
    it crosses as its uint16 bit pattern."""
    a = np.array(a, copy=True, order="C")   # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


_NESTED = {
    "talker": DecoderWeights,
    "decoder": DecoderWeights,
    "code_predictor": CodePredictorWeights,
    "text_projection": TextProjectionWeights,
    "layers": LayerWeights,
    "rope": RopeTable,
}


def convert_tuple(cls, tree, device="cpu"):
    """Build `cls` from an object with the same field names (a JAX
    NamedTuple of arrays), recursing into the nested weight tuples."""
    out = {}
    for name in cls._fields:
        leaf = getattr(tree, name)
        sub = _NESTED.get(name)
        out[name] = (convert_tuple(sub, leaf, device) if sub is not None
                     else to_torch(leaf, device))
    return cls(**out)


def from_jax(tree, device="cpu") -> TTSWeights:
    """The JAX package's `TTSWeights` (bf16/f32 leaves) → the port's."""
    return convert_tuple(TTSWeights, tree, device)

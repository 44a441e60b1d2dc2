"""Plain PyTorch Qwen3 decoder — the port of `qwen_tts_tpu/models/decoder.py`.

Same numerics as the JAX oracle: f32 residual stream, bf16 weights with f32
accumulation (activations are rounded to bf16 where they enter a matrix
product, then both sides are upcast and multiplied in f32, because torch's
bf16 `@` would round its output to bf16), RMSNorm eps 1e-6 in f32, per-head
QK-RMSNorm, half-split RoPE, GQA attention over the old cache plus the
chunk's own (f32) keys and values.

Unlike JAX, the port updates the KV cache in place: `forward_chunk` writes
the chunk's columns into `state.k_cache` / `state.v_cache` and returns a
state that shares those tensors with the position advanced. Positions are
host integers, so no step waits on the device to learn where it is.
A single-token chunk goes to the CUDA decode-step kernel when
`attn_impl == "mega"` (`ops/decode_step.py`), and its attention to the
CUDA decode-attention kernel in every layer when `attn_impl == "pallas"`
(`ops/attention.py`; the name is the JAX package's), as in the JAX
package. Chunks of more than one token (prefill) stay dense.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..core.config import DecoderConfig
from ..core.weights import DecoderWeights, LayerWeights, RopeTable
from ..ops.attention import decode_attention


class DecodeState(NamedTuple):
    """bf16 KV cache `[L, KVH, S, D]` and the number of filled positions."""

    k_cache: torch.Tensor
    v_cache: torch.Tensor
    position: int


def init_state(cfg: DecoderConfig, device="cuda") -> DecodeState:
    shape = (cfg.num_layers, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        v_cache=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        position=0,
    )


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * weight.float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE. x: [..., D]; cos/sin broadcastable to [..., D//2]."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mrope_section_masks(cfg: DecoderConfig, device="cuda") -> list[torch.Tensor]:
    """Boolean `[D//2]` masks assigning each rotary frequency index to an
    M-RoPE section: contiguous runs, or the interleaved Qwen3-Omni layout
    where index j belongs to section s >= 1 iff j % n == s and j < n*sec[s]
    (else to section 0). Built on `device` from an arange, so composing a
    row never copies from the host."""
    d2 = cfg.head_dim // 2
    secs = cfg.mrope_section
    if secs is None or sum(secs) != d2:
        raise ValueError(f"mrope_section {secs} must sum to head_dim//2 ({d2})")
    j = torch.arange(d2, device=device)
    n = len(secs)
    if cfg.mrope_interleaved:
        out = [None] * n
        taken = torch.zeros(d2, dtype=torch.bool, device=device)
        for s in range(n - 1, 0, -1):
            out[s] = (j % n == s) & (j < n * secs[s])
            taken |= out[s]
        out[0] = ~taken
        return out
    out, start = [], 0
    for s in range(n):
        out.append((j >= start) & (j < start + secs[s]))
        start += secs[s]
    return out


def _rope_slice(table: torch.Tensor, start: int, T: int) -> torch.Tensor:
    if not 0 <= start <= table.shape[0] - T:
        raise ValueError(f"rope rows [{start}, {start + T}) outside the "
                         f"table's {table.shape[0]} rows")
    return table[start:start + T]


def mrope_rows(cfg: DecoderConfig, rope: RopeTable, mrope_pos: Sequence[int], T: int):
    """`[T, D//2]` cos/sin rows for M-RoPE: section s rotates by position
    `mrope_pos[s] + t`. With equal components this is the standard row."""
    masks = mrope_section_masks(cfg, rope.cos.device)
    cos = torch.zeros((T, rope.cos.shape[1]), dtype=rope.cos.dtype, device=rope.cos.device)
    sin = torch.zeros_like(cos)
    for s, mask in enumerate(masks):
        cos = torch.where(mask[None, :], _rope_slice(rope.cos, int(mrope_pos[s]), T), cos)
        sin = torch.where(mask[None, :], _rope_slice(rope.sin, int(mrope_pos[s]), T), sin)
    return cos, sin


def rope_rows(cfg: DecoderConfig, rope: RopeTable, pos: int, T: int,
              mrope_pos: Sequence[int] | None = None):
    """The cos/sin rows a T-token chunk at cache position `pos` rotates by."""
    if cfg.mrope_section is not None and mrope_pos is not None:
        return mrope_rows(cfg, rope, mrope_pos, T)
    return _rope_slice(rope.cos, pos, T), _rope_slice(rope.sin, pos, T)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-rounded activations times bf16 weights, accumulated in f32."""
    return x.to(torch.bfloat16).float() @ w.float()


def layer_slice(layers: LayerWeights, li: int) -> LayerWeights:
    """One layer's weights (views without the leading L axis)."""
    return LayerWeights(*(t[li] for t in layers))


def _dense_mixed_attention(
    cfg: DecoderConfig,
    q: torch.Tensor,         # [T, HQ, D] f32
    k_chunk: torch.Tensor,   # [T, KVH, D] f32 — this chunk's keys (post-RoPE)
    v_chunk: torch.Tensor,   # [T, KVH, D] f32
    k_old: torch.Tensor,     # [KVH, S, D] bf16 — entries < start_pos are valid
    v_old: torch.Tensor,
    start_pos: int,
) -> torch.Tensor:
    """Attention over the old cache prefix plus causal attention inside the
    chunk, without reading the chunk back from the cache. Returns
    `[T, HQ*D]` f32. The old prefix is sliced to `start_pos` rows, which is
    what the JAX version's masked, position-bounded loop computes."""
    T = q.shape[0]
    h_q, h_kv, d, g = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim, cfg.gqa_groups
    scale = 1.0 / (d ** 0.5)
    qh = q.permute(1, 0, 2).reshape(h_kv, g, T, d)
    kf = k_old[:, :start_pos].float()
    vf = v_old[:, :start_pos].float()
    kc = k_chunk.permute(1, 0, 2)
    vc = v_chunk.permute(1, 0, 2)
    s_old = torch.einsum("hgtd,hsd->hgts", qh, kf) * scale
    s_new = torch.einsum("hgtd,hud->hgtu", qh, kc) * scale
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s_new = s_new.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    p_old, p_new = probs[..., :start_pos], probs[..., start_pos:]
    attn = (torch.einsum("hgts,hsd->hgtd", p_old, vf)
            + torch.einsum("hgtu,hud->hgtd", p_new, vc))
    return attn.reshape(h_q, T, d).permute(1, 0, 2).reshape(T, h_q * d)


def _layer_forward(cfg: DecoderConfig, lw: LayerWeights, x: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor, li: int,
                   start_pos: int, cos: torch.Tensor, sin: torch.Tensor,
                   attn_impl: str = "dense"):
    """Layer `li` over a T-token chunk; the caches `[L, KVH, S, D]` are only
    read. Returns (x [T,H] f32, k_new, v_new [KVH, T, D] bf16 — the chunk's
    cache columns)."""
    T = x.shape[0]
    h_q, h_kv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    Q, KV = cfg.q_size, cfg.kv_size
    qkv = matmul(rms_norm(x, lw.input_norm, cfg.rms_eps), lw.wqkv)
    q = qkv[:, :Q].reshape(T, h_q, d)
    k = qkv[:, Q:Q + KV].reshape(T, h_kv, d)
    v = qkv[:, Q + KV:].reshape(T, h_kv, d)
    q = apply_rope(rms_norm(q, lw.q_norm, cfg.rms_eps), cos[:, None, :], sin[:, None, :])
    k = apply_rope(rms_norm(k, lw.k_norm, cfg.rms_eps), cos[:, None, :], sin[:, None, :])
    if attn_impl == "pallas" and T == 1:
        attn = decode_attention(q[0].contiguous(), k[0].contiguous(), v[0].contiguous(),
                                k_cache, v_cache, li, start_pos).reshape(1, h_q * d)
    else:
        attn = _dense_mixed_attention(cfg, q, k, v, k_cache[li], v_cache[li], start_pos)
    x = x + matmul(attn, lw.wo)
    gate_up = matmul(rms_norm(x, lw.post_norm, cfg.rms_eps), lw.w_gate_up)
    I = cfg.intermediate_size
    x = x + matmul(F.silu(gate_up[:, :I]) * gate_up[:, I:], lw.w_down)
    k_new = k.to(torch.bfloat16).permute(1, 0, 2)
    v_new = v.to(torch.bfloat16).permute(1, 0, 2)
    return x, k_new, v_new


def _check_room(cfg: DecoderConfig, pos: int, T: int) -> None:
    if pos + T > cfg.max_seq_len:
        raise ValueError(f"positions [{pos}, {pos + T}) exceed max_seq_len "
                         f"{cfg.max_seq_len}")


def forward_layers(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                   x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   attn_impl: str = "dense"):
    """All layers over a chunk `x [T, H]` f32 with the given rope rows;
    writes the chunk's cache columns in place, each after its layer's
    attention. Returns (state, normed)."""
    T, pos = x.shape[0], state.position
    _check_room(cfg, pos, T)
    for li in range(cfg.num_layers):
        x, k_new, v_new = _layer_forward(
            cfg, layer_slice(w.layers, li), x, state.k_cache, state.v_cache, li,
            pos, cos, sin, attn_impl)
        state.k_cache[li, :, pos:pos + T] = k_new
        state.v_cache[li, :, pos:pos + T] = v_new
    normed = rms_norm(x, w.final_norm, cfg.rms_eps)
    return state._replace(position=pos + T), normed


def forward_chunk(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                  embeds: torch.Tensor, attn_impl: str = "dense",
                  mrope_pos: Sequence[int] | None = None):
    """Run a T-token chunk through all layers. Returns (state, normed [T,H] f32),
    `normed` being the post-final-RMSNorm hidden state. `attn_impl` is
    "dense", "pallas" (the attention kernel when T == 1) or "mega" (the
    decode-step kernel when T == 1)."""
    T = embeds.shape[0]
    if attn_impl == "mega" and T == 1:
        from ..ops.decode_step import megakernel_forward

        # forward_chunk returns no logits, so the kernel skips the head
        state, _, normed = megakernel_forward(cfg, w, state, embeds[0],
                                              mrope_pos=mrope_pos, with_head=False)
        return state, normed[None, :]
    _check_room(cfg, state.position, T)
    cos, sin = rope_rows(cfg, w.rope, state.position, T, mrope_pos)
    return forward_layers(cfg, w, state, embeds.float(), cos, sin, attn_impl)


def lm_head_logits(w: DecoderWeights, normed: torch.Tensor) -> torch.Tensor:
    """Codec LM head logits, f32."""
    return matmul(normed, w.lm_head)


def decode_step_with_embed(cfg: DecoderConfig, w: DecoderWeights,
                           state: DecodeState, embed: torch.Tensor,
                           attn_impl: str = "dense",
                           mrope_pos: Sequence[int] | None = None):
    """One decode step from an embedding [H]. Returns (state, greedy token
    (0-d int64 tensor), normed [H] f32)."""
    if attn_impl == "mega":
        from ..ops.decode_step import megakernel_forward

        state, logits, normed = megakernel_forward(cfg, w, state, embed,
                                                   mrope_pos=mrope_pos)
        return state, torch.argmax(logits), normed
    state, normed = forward_chunk(cfg, w, state, embed[None, :],
                                  attn_impl=attn_impl, mrope_pos=mrope_pos)
    return state, torch.argmax(lm_head_logits(w, normed)[0]), normed[0]


def decode_step(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                token_id: torch.Tensor, attn_impl: str = "dense",
                mrope_pos: Sequence[int] | None = None):
    """One decode step from a codec token id (a tensor of one element, on
    the weights' device). Returns (state, greedy token, normed [H] f32)."""
    embed = w.embed[token_id.reshape(1)][0]
    return decode_step_with_embed(cfg, w, state, embed, attn_impl=attn_impl,
                                  mrope_pos=mrope_pos)


def prefill(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
            embeds: torch.Tensor):
    """Dense causal prefill of T embeddings [T, H]. Returns (state,
    last greedy token, last normed [H] f32)."""
    state, normed = forward_chunk(cfg, w, state, embeds)
    return state, torch.argmax(lm_head_logits(w, normed[-1:])[0]), normed[-1]

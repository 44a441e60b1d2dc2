"""Plain PyTorch Qwen3 decoder — the port of `qwen_tts_tpu/models/decoder.py`.

Same numerics as the JAX oracle: f32 residual stream, bf16 weights with f32
accumulation (activations are rounded to bf16 where they enter a matrix
product, then both sides are upcast and multiplied in f32, because torch's
bf16 `@` would round its output to bf16), RMSNorm eps 1e-6 in f32, per-head
QK-RMSNorm, half-split RoPE, GQA attention over the old cache plus the
chunk's own (f32) keys and values.

Unlike JAX, the port updates the KV cache in place: `forward_chunk` writes
the chunk's columns into `state.k_cache` / `state.v_cache` and returns a
state that shares those tensors with the position advanced. An int8 cache
(`init_state(cfg, device, torch.int8)`) stores each new head row as
round(row / scale) with scale = max(absmax, 1e-8) / 127 from the f32 row,
in `k_scale` / `v_scale` `[L, KVH, S]`; attention multiplies the rows it
reads by their scales and takes the chunk's own columns in f32.

Quantized weights (`core/weights.py`: int8, int4-g128, mixed) run the
dense path on one dequantized layer at a time (`dense_mm`, the JAX
package's `dequant_mat_slice` numerics): no bf16 copy of the weights is
kept. The decode-step kernel's plain version passes its own product
(`ops/decode_step.py::mm_scaled`) instead. Positions are
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
from ..core.weights import DecoderWeights, LayerWeights, RopeTable, dequant_mat
from ..ops.attention import decode_attention


class DecodeState(NamedTuple):
    """KV cache `[L, KVH, S, D]` (bf16, or int8 with f32 per-row scales
    `[L, KVH, S]`) and the number of filled positions."""

    k_cache: torch.Tensor
    v_cache: torch.Tensor
    position: int
    k_scale: torch.Tensor | None = None   # int8 cache only
    v_scale: torch.Tensor | None = None


def init_state(cfg: DecoderConfig, device="cuda", dtype=torch.bfloat16) -> DecodeState:
    """A zero cache of `dtype` (torch.bfloat16 or torch.int8) at position 0."""
    if dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"KV cache dtype {dtype} is neither bfloat16 nor int8")
    shape = (cfg.num_layers, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
    scale = (lambda: torch.zeros(shape[:3], dtype=torch.float32, device=device)) \
        if dtype == torch.int8 else (lambda: None)
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        position=0, k_scale=scale(), v_scale=scale(),
    )


def reset_state(state: DecodeState) -> DecodeState:
    """Zero the cache and its scales in place; back to position 0."""
    for t in state[:2] + state[3:]:
        if t is not None:
            t.zero_()
    return state._replace(position=0)


def quantize_rows(cols: torch.Tensor):
    """f32 head rows `[..., D]` → (int8 rows, f32 scales `[...]`), the
    absmax/127 scheme of the JAX package's int8 cache."""
    s = cols.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(cols / s[..., None]), -127, 127).to(torch.int8), s


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


def dense_mm(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None) -> torch.Tensor:
    """`x [T, in] @ W`, W bf16 (`s` None) or one layer's quantized matrix
    with its scales, dequantized to bf16 first (form picked by shape)."""
    return matmul(x, w if s is None else dequant_mat(w, s, x.shape[-1]))


def layer_slice(layers: LayerWeights, li: int) -> LayerWeights:
    """One layer's weights (views without the leading L axis), of any form."""
    return type(layers)(*(t[li] for t in layers))


def layer_mat(lw, name: str):
    """(matrix, scales or None) of one of wqkv, wo, w_gate_up, w_down."""
    if hasattr(lw, "wqkv_q"):
        return getattr(lw, f"{name}_q"), getattr(lw, f"{name}_s")
    return getattr(lw, name), None


def _dense_mixed_attention(
    cfg: DecoderConfig,
    q: torch.Tensor,         # [T, HQ, D] f32
    k_chunk: torch.Tensor,   # [T, KVH, D] f32 — this chunk's keys (post-RoPE)
    v_chunk: torch.Tensor,   # [T, KVH, D] f32
    k_old: torch.Tensor,     # [KVH, S, D] bf16|int8 — entries < start_pos are valid
    v_old: torch.Tensor,
    start_pos: int,
    ks_old: torch.Tensor | None = None,   # [KVH, S] f32 row scales (int8 cache)
    vs_old: torch.Tensor | None = None,
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
    if ks_old is not None:
        kf = kf * ks_old[:, :start_pos, None]
        vf = vf * vs_old[:, :start_pos, None]
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
                   state: DecodeState, li: int, start_pos: int, cos: torch.Tensor,
                   sin: torch.Tensor, attn_impl: str = "dense", mm=dense_mm):
    """Layer `li` over a T-token chunk; the caches are only read. `mm(x, w,
    s)` is the matrix product. Returns (x [T,H] f32, k_new, v_new
    [KVH, T, D] f32 — the chunk's cache columns)."""
    T = x.shape[0]
    h_q, h_kv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    Q, KV = cfg.q_size, cfg.kv_size
    k_cache, v_cache = state.k_cache, state.v_cache
    qkv = mm(rms_norm(x, lw.input_norm, cfg.rms_eps), *layer_mat(lw, "wqkv"))
    q = qkv[:, :Q].reshape(T, h_q, d)
    k = qkv[:, Q:Q + KV].reshape(T, h_kv, d)
    v = qkv[:, Q + KV:].reshape(T, h_kv, d)
    q = apply_rope(rms_norm(q, lw.q_norm, cfg.rms_eps), cos[:, None, :], sin[:, None, :])
    k = apply_rope(rms_norm(k, lw.k_norm, cfg.rms_eps), cos[:, None, :], sin[:, None, :])
    kv8 = state.k_scale is not None
    if attn_impl == "pallas" and T == 1 and not kv8:   # kv8 stays dense, as in JAX
        attn = decode_attention(q[0].contiguous(), k[0].contiguous(), v[0].contiguous(),
                                k_cache, v_cache, li, start_pos).reshape(1, h_q * d)
    else:
        attn = _dense_mixed_attention(
            cfg, q, k, v, k_cache[li], v_cache[li], start_pos,
            state.k_scale[li] if kv8 else None, state.v_scale[li] if kv8 else None)
    x = x + mm(attn, *layer_mat(lw, "wo"))
    gate_up = mm(rms_norm(x, lw.post_norm, cfg.rms_eps), *layer_mat(lw, "w_gate_up"))
    I = cfg.intermediate_size
    x = x + mm(F.silu(gate_up[:, :I]) * gate_up[:, I:], *layer_mat(lw, "w_down"))
    return x, k.permute(1, 0, 2), v.permute(1, 0, 2)


def _check_room(cfg: DecoderConfig, pos: int, T: int) -> None:
    if pos + T > cfg.max_seq_len:
        raise ValueError(f"positions [{pos}, {pos + T}) exceed max_seq_len "
                         f"{cfg.max_seq_len}")


def _write_columns(state: DecodeState, li: int, pos: int, k_new: torch.Tensor,
                   v_new: torch.Tensor) -> None:
    """Store f32 columns [KVH, T, D] at rows pos.. of layer li: bf16-rounded,
    or quantized per head row with their scales for an int8 cache."""
    T = k_new.shape[1]
    for cache, scales, cols in ((state.k_cache, state.k_scale, k_new),
                                (state.v_cache, state.v_scale, v_new)):
        if scales is None:
            cache[li, :, pos:pos + T] = cols.to(cache.dtype)
        else:
            cache[li, :, pos:pos + T], scales[li, :, pos:pos + T] = quantize_rows(cols)


def forward_layers(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                   x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   attn_impl: str = "dense", mm=dense_mm):
    """All layers over a chunk `x [T, H]` f32 with the given rope rows;
    writes the chunk's cache columns in place, each after its layer's
    attention. Returns (state, normed)."""
    T, pos = x.shape[0], state.position
    _check_room(cfg, pos, T)
    for li in range(cfg.num_layers):
        x, k_new, v_new = _layer_forward(cfg, layer_slice(w.layers, li), x, state, li,
                                         pos, cos, sin, attn_impl, mm)
        _write_columns(state, li, pos, k_new, v_new)
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
    """Codec LM head logits, f32; an int8 head (`lm_head_s` set) is upcast
    and its per-channel scale applied to the logits."""
    logits = matmul(normed, w.lm_head)
    s = getattr(w, "lm_head_s", None)
    return logits if s is None else logits * s


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

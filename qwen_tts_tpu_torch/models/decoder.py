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
(`ops/decode_step.py::mm_scaled`) instead.

A state holds one stream (caches `[L, KVH, S, D]`) or B slots (caches
`[B, L, KVH, S, D]`, `init_state(..., slots=B)`), the batched path of
`runtime/batch.py`, whose matrix products take one row a slot and read
each weight once for all slots. Its host `position` is where a chunk of
more than one token starts (every slot at once) and where the host's room
checks look. A state may also carry its position on the device (`pos`, an
int32 tensor `[]` or `[B]`; always for B slots): a single-token step then
takes no host position, so a CUDA graph that captured it replays it where
the tensor says. Its RoPE rows are gathered by that position, its cache
columns written with `index_copy_` at row `pos[b]`, its attention runs
over rows below it, and the step advances the tensor in place. Without
`pos` the positions are host integers, so no step waits on the device to
learn where it is (the code predictor's, whose every frame runs the same
positions, and the decode-step kernel's, which keeps its own).

A single-token chunk goes to the CUDA decode-step kernel when
`attn_impl == "mega"` (`ops/decode_step.py`), and its attention to the
CUDA decode-attention kernel in every layer when `attn_impl == "pallas"`
and the cache is bf16 (`ops/attention.py`; the name is the JAX
package's), as in the JAX package; otherwise it is the kernel's plain
version, masked by the device position, or over the rows below a host
position. Chunks of more than one token (prefill) stay dense.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..core.config import DecoderConfig
from ..core.weights import DecoderWeights, LayerWeights, RopeTable, dequant_mat
from ..ops.attention import decode_attention, decode_attention_reference


class DecodeState(NamedTuple):
    """KV cache `[(B,) L, KVH, S, D]` (bf16, or int8 with f32 per-row scales
    `[(B,) L, KVH, S]`), the number of filled positions on the host, and
    optionally on the device (`pos`, int32 `[]` or `[B]`)."""

    k_cache: torch.Tensor
    v_cache: torch.Tensor
    position: int
    k_scale: torch.Tensor | None = None   # int8 cache only
    v_scale: torch.Tensor | None = None
    pos: torch.Tensor | None = None       # device positions, advanced in place


def init_state(cfg: DecoderConfig, device="cuda", dtype=torch.bfloat16,
               slots: int | None = None, device_pos: bool = False) -> DecodeState:
    """A zero cache of `dtype` (torch.bfloat16 or torch.int8) at position 0:
    one stream, or `slots` slots (which always carry device positions);
    `device_pos` gives one stream its position on the device too."""
    if dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"KV cache dtype {dtype} is neither bfloat16 nor int8")
    lead = () if slots is None else (slots,)
    shape = (*lead, cfg.num_layers, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
    scale = (lambda: torch.zeros(shape[:-1], dtype=torch.float32, device=device)) \
        if dtype == torch.int8 else (lambda: None)
    pos = torch.zeros(lead, dtype=torch.int32, device=device) \
        if slots is not None or device_pos else None
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        position=0, k_scale=scale(), v_scale=scale(), pos=pos,
    )


def reset_state(state: DecodeState) -> DecodeState:
    """Zero the cache, its scales and device positions in place; back to
    position 0."""
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


def device_rope_rows(cfg: DecoderConfig, rope: RopeTable, pos: torch.Tensor,
                     mrope_deltas: Sequence[int] | None = None):
    """`[B, 1, D//2]` cos/sin rows of single-token steps at the device
    positions `pos [B]`, gathered on the device: M-RoPE section s rotates by
    `pos + mrope_deltas[s]`. Rows past the table's end are clamped to its
    last (the host checks room before a step runs)."""
    last = rope.cos.shape[0] - 1
    rows = lambda d: (pos.long() + d).clamp(0, last)  # noqa: E731
    if cfg.mrope_section is None or mrope_deltas is None:
        r = rows(0)
        return rope.cos[r][:, None], rope.sin[r][:, None]
    masks = mrope_section_masks(cfg, rope.cos.device)
    cos = sin = None
    for mask, d in zip(masks, mrope_deltas):
        r = rows(int(d))
        c, s_ = rope.cos[r], rope.sin[r]
        cos = c if cos is None else torch.where(mask[None, :], c, cos)
        sin = s_ if sin is None else torch.where(mask[None, :], s_, sin)
    return cos[:, None], sin[:, None]


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


def _slots(t: torch.Tensor | None, dims: int) -> torch.Tensor | None:
    """A one-stream tensor of `dims` axes as one slot (a view), or the
    batched tensor as it is."""
    return t if t is None or t.dim() > dims else t[None]


def _dense_mixed_attention(
    cfg: DecoderConfig,
    q: torch.Tensor,         # [B, T, HQ, D] f32
    k_chunk: torch.Tensor,   # [B, T, KVH, D] f32 — this chunk's keys (post-RoPE)
    v_chunk: torch.Tensor,   # [B, T, KVH, D] f32
    k_old: torch.Tensor,     # [B, KVH, S, D] bf16|int8 — entries < start_pos are valid
    v_old: torch.Tensor,
    start_pos: int,
    ks_old: torch.Tensor | None = None,   # [B, KVH, S] f32 row scales (int8 cache)
    vs_old: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention over the old cache prefix plus causal attention inside the
    chunk, without reading the chunk back from the cache, every slot at the
    same host position (one stream: each argument without its B axis).
    Returns `[(B,) T, HQ*D]` f32. The old prefix is sliced to `start_pos`
    rows, which is what the JAX version's masked, position-bounded loop
    computes."""
    if q.dim() == 3:
        return _dense_mixed_attention(cfg, *(None if t is None else t[None] for t in (
            q, k_chunk, v_chunk, k_old, v_old)), start_pos,
            *(None if t is None else t[None] for t in (ks_old, vs_old)))[0]
    B, T = q.shape[:2]
    h_q, h_kv, d, g = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim, cfg.gqa_groups
    scale = 1.0 / (d ** 0.5)
    qh = q.permute(0, 2, 1, 3).reshape(B, h_kv, g, T, d)
    kf = k_old[:, :, :start_pos].float()
    vf = v_old[:, :, :start_pos].float()
    if ks_old is not None:
        kf = kf * ks_old[:, :, :start_pos, None]
        vf = vf * vs_old[:, :, :start_pos, None]
    kc = k_chunk.permute(0, 2, 1, 3)
    vc = v_chunk.permute(0, 2, 1, 3)
    s_old = torch.einsum("bhgtd,bhsd->bhgts", qh, kf) * scale
    s_new = torch.einsum("bhgtd,bhud->bhgtu", qh, kc) * scale
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s_new = s_new.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    p_old, p_new = probs[..., :start_pos], probs[..., start_pos:]
    attn = (torch.einsum("bhgts,bhsd->bhgtd", p_old, vf)
            + torch.einsum("bhgtu,bhud->bhgtd", p_new, vc))
    return attn.reshape(B, h_q, T, d).permute(0, 2, 1, 3).reshape(B, T, h_q * d)


def _layer_forward(cfg: DecoderConfig, lw: LayerWeights, x: torch.Tensor,
                   state: DecodeState, li: int, start_pos: int, cos: torch.Tensor,
                   sin: torch.Tensor, attn_impl: str = "dense", mm=dense_mm,
                   positions: torch.Tensor | None = None):
    """Layer `li` over a T-token chunk of each of B slots, `x [B, T, H]`; the
    caches are only read. With device `positions [B]` (T == 1) the
    attention is the decode-attention kernel (`attn_impl` "pallas", bf16
    cache) or its plain version, masked by them; with a host `start_pos` it
    is the kernel at that position ("pallas", T == 1, bf16 cache) or the
    dense attention over the rows below it. `mm(x, w, s)` is the matrix
    product, over the B*T rows. `cos`/`sin` are `[B or 1, T, D//2]`.
    Returns (x [B,T,H] f32, k_new, v_new [B, KVH, T, D] f32 — the chunk's
    cache columns)."""
    B, T, H = x.shape
    h_q, h_kv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    Q, KV = cfg.q_size, cfg.kv_size
    k_cache, v_cache = _slots(state.k_cache, 4), _slots(state.v_cache, 4)
    qkv = mm(rms_norm(x.reshape(B * T, H), lw.input_norm, cfg.rms_eps), *layer_mat(lw, "wqkv"))
    q = qkv[:, :Q].reshape(B, T, h_q, d)
    k = qkv[:, Q:Q + KV].reshape(B, T, h_kv, d)
    v = qkv[:, Q + KV:].reshape(B, T, h_kv, d)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    q = apply_rope(rms_norm(q, lw.q_norm, cfg.rms_eps), c, s)
    k = apply_rope(rms_norm(k, lw.k_norm, cfg.rms_eps), c, s)
    kv8 = state.k_scale is not None
    kernel = attn_impl == "pallas" and not kv8        # kv8 stays dense, as in JAX
    if T == 1 and (positions is not None or kernel):
        if positions is None:
            positions = torch.full((B,), start_pos, dtype=torch.int32, device=x.device)
        cols = (q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous())
        if kernel:
            attn = decode_attention(*cols, k_cache, v_cache, li, positions)
        else:
            attn = decode_attention_reference(*cols, k_cache, v_cache, li, positions,
                                              _slots(state.k_scale, 3),
                                              _slots(state.v_scale, 3))
        attn = attn.reshape(B, 1, h_q * d)
    else:
        ks, vs = _slots(state.k_scale, 3), _slots(state.v_scale, 3)
        attn = _dense_mixed_attention(
            cfg, q, k, v, k_cache[:, li], v_cache[:, li], start_pos,
            ks[:, li] if kv8 else None, vs[:, li] if kv8 else None)
    x = x + mm(attn.reshape(B * T, h_q * d), *layer_mat(lw, "wo")).reshape(B, T, H)
    gate_up = mm(rms_norm(x.reshape(B * T, H), lw.post_norm, cfg.rms_eps),
                 *layer_mat(lw, "w_gate_up"))
    I = cfg.intermediate_size
    x = x + mm(F.silu(gate_up[:, :I]) * gate_up[:, I:], *layer_mat(lw, "w_down")).reshape(B, T, H)
    return x, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def _check_room(cfg: DecoderConfig, pos: int, T: int) -> None:
    if pos + T > cfg.max_seq_len:
        raise ValueError(f"positions [{pos}, {pos + T}) exceed max_seq_len "
                         f"{cfg.max_seq_len}")


def _write_columns(state: DecodeState, li: int, pos: int, k_new: torch.Tensor,
                   v_new: torch.Tensor, rows: torch.Tensor | None = None) -> None:
    """Store f32 columns [B, KVH, T, D] of layer li: at rows pos.. of every
    slot, or (T == 1) at the flat cache rows `rows [B*KVH]` of layer 0 plus
    li's offset (`_flat_rows`); bf16-rounded, or quantized per head row with
    their scales for an int8 cache."""
    T = k_new.shape[2]
    for cache, scales, cols in ((state.k_cache, state.k_scale, k_new),
                                (state.v_cache, state.v_scale, v_new)):
        c5, s4 = _slots(cache, 4), _slots(scales, 3)
        vals, sc = (cols.to(cache.dtype), None) if scales is None else quantize_rows(cols)
        if rows is None:
            c5[:, li, :, pos:pos + T] = vals
            if sc is not None:
                s4[:, li, :, pos:pos + T] = sc
            continue
        L, KVH, S, D = c5.shape[1:]
        r = rows + li * KVH * S
        c5.view(-1, D).index_copy_(0, r, vals.reshape(-1, D))
        if sc is not None:
            s4.view(-1).index_copy_(0, r, sc.reshape(-1))


def _flat_rows(state: DecodeState, positions: torch.Tensor) -> torch.Tensor:
    """`[B*KVH]` int64: the row of (slot b, kv head h, position pos[b]) in
    layer 0 of the caches viewed as rows `[B*L*KVH*S, D]`, the position
    clamped into [0, S) as JAX's `dynamic_update_slice` clamps its start: a
    step of a slot past the cache's end (which the host's room checks keep
    from happening) overwrites that slot's own last row, never a row of
    another kv head, layer or slot."""
    c5 = _slots(state.k_cache, 4)
    B, L, KVH, S = c5.shape[:4]
    dev = positions.device
    base = (torch.arange(B, device=dev)[:, None] * (L * KVH * S)
            + torch.arange(KVH, device=dev)[None, :] * S)
    return (base + positions.long().clamp(0, S - 1).reshape(B, 1)).reshape(-1)


def forward_layers(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                   x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   attn_impl: str = "dense", mm=dense_mm, device_pos: bool = False):
    """All layers over a chunk `x [T, H]` (one stream) or `[B, T, H]` (B
    slots) f32 with the given rope rows; writes the chunk's cache columns
    in place, each after its layer's attention. With `device_pos` (T == 1)
    the step runs at `state.pos` and advances it; otherwise at the host
    position, after which `state.pos`, if any, holds the new one. Returns
    (state, normed) in x's shape."""
    one = x.dim() == 2
    xb = x[None] if one else x
    T, pos = xb.shape[1], state.position
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    positions = rows = None
    if device_pos:
        positions = state.pos.reshape(-1)
        if positions.device.type == "cpu":     # a read that waits for nothing
            bad = (positions < 0) | (positions + T > cfg.max_seq_len)
            if bool(bad.any()):
                raise ValueError(f"positions {positions.tolist()} + {T} outside "
                                 f"max_seq_len {cfg.max_seq_len}")
        rows = _flat_rows(state, positions)
    else:
        _check_room(cfg, pos, T)
    for li in range(cfg.num_layers):
        xb, k_new, v_new = _layer_forward(cfg, layer_slice(w.layers, li), xb, state, li,
                                          pos, cos, sin, attn_impl, mm, positions)
        _write_columns(state, li, pos, k_new, v_new, rows)
    normed = rms_norm(xb, w.final_norm, cfg.rms_eps)
    if device_pos:
        state.pos.add_(T)
    elif state.pos is not None:
        state.pos.fill_(pos + T)
    return state._replace(position=pos + T), normed[0] if one else normed


def forward_chunk(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                  embeds: torch.Tensor, attn_impl: str = "dense",
                  mrope_pos: Sequence[int] | None = None):
    """Run a T-token chunk through all layers: `embeds [T, H]` for one
    stream, `[B, T, H]` for a state of B slots. Returns (state, normed
    [(B,) T, H] f32), `normed` being the post-final-RMSNorm hidden state.
    `attn_impl` is "dense", "pallas" (the attention kernel when T == 1) or
    "mega" (the decode-step kernel when T == 1, one stream). A
    single-token chunk of a state with device positions runs at them
    (`mrope_pos` then gives, less the host position, the sections'
    offsets); any other at the host position."""
    T = embeds.shape[-2]
    if attn_impl == "mega" and T == 1 and embeds.dim() == 2:
        from ..ops.decode_step import megakernel_forward

        # forward_chunk returns no logits, so the kernel skips the head
        state, _, normed = megakernel_forward(cfg, w, state, embeds[0],
                                              mrope_pos=mrope_pos, with_head=False)
        return state, normed[None, :]
    if T == 1 and state.pos is not None:
        deltas = None if mrope_pos is None else [int(m) - state.position for m in mrope_pos]
        cos, sin = device_rope_rows(cfg, w.rope, state.pos.reshape(-1), deltas)
        return forward_layers(cfg, w, state, embeds.float(), cos, sin, attn_impl,
                              device_pos=True)
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
    """One decode step from an embedding [H] (one stream) or [B, H] (B
    slots). Returns (state, greedy token (int64, 0-d or [B]), normed
    [(B,) H] f32)."""
    if attn_impl == "mega" and embed.dim() == 1:
        from ..ops.decode_step import megakernel_forward

        state, logits, normed = megakernel_forward(cfg, w, state, embed,
                                                   mrope_pos=mrope_pos)
        return state, torch.argmax(logits), normed
    state, normed = forward_chunk(cfg, w, state, embed[..., None, :],
                                  attn_impl=attn_impl, mrope_pos=mrope_pos)
    logits = lm_head_logits(w, normed)[..., 0, :]
    return state, torch.argmax(logits, dim=-1), normed[..., 0, :]


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

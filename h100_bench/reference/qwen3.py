"""Plain float32 Qwen3 decoder: a full causal forward pass, no cache.

Written from the published architecture (Qwen3: pre-RMSNorm blocks,
grouped-query attention with per-head RMSNorm on queries and keys,
half-split rotary embedding, SwiGLU MLP, final RMSNorm). The weights are
the benchmark's bf16 tensors, upcast to float32 one layer at a time, in
the layout the benchmark draws them: per-layer tensors stacked `[L, ...]`,
matrices `[in, out]`, q|k|v and gate|up fused on the output axis.

The talker's interleaved M-RoPE rotates every section by the same
position for text-only input, which is the standard rotary embedding, so
one position per row is all this module takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def full_precision() -> None:
    """Matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x `[B, heads, T, D]` rotated by positions 0..T-1 (half-split pairs:
    dims j and j + D/2 share frequency theta ** (-2j / D))."""
    T, D = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(w: dict, prefix: str, c: dict, x: torch.Tensor) -> torch.Tensor:
    """Embeddings `[B, T, H]` → final-normed hidden states `[B, T, H]`, f32."""
    B, T, H = x.shape
    HQ, KVH, D, I = c["num_q_heads"], c["num_kv_heads"], c["head_dim"], c["intermediate_size"]
    eps, theta = c["rms_eps"], c["rope_theta"]
    Q, KV = HQ * D, KVH * D
    x = x.float()
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    for li in range(c["num_layers"]):
        def p(name):
            return w[f"{prefix}.{name}"][li].float()

        h = rms_norm(x, p("input_norm"), eps)
        qkv = h @ p("wqkv")
        q = qkv[..., :Q].reshape(B, T, HQ, D).transpose(1, 2)
        k = qkv[..., Q:Q + KV].reshape(B, T, KVH, D).transpose(1, 2)
        v = qkv[..., Q + KV:].reshape(B, T, KVH, D).transpose(1, 2)
        q = rope(rms_norm(q, p("q_norm"), eps), theta)
        k = rope(rms_norm(k, p("k_norm"), eps), theta)
        k = k.repeat_interleave(HQ // KVH, dim=1)
        v = v.repeat_interleave(HQ // KVH, dim=1)
        s = (q @ k.transpose(-1, -2)) / D ** 0.5
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
        x = x + a.transpose(1, 2).reshape(B, T, Q) @ p("wo")
        h = rms_norm(x, p("post_norm"), eps)
        gu = h @ p("w_gate_up")
        x = x + (F.silu(gu[..., :I]) * gu[..., I:]) @ p("w_down")
    return rms_norm(x, w[f"{prefix}.final_norm"], eps)


def gap(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the best one: `[N, V]`,
    `[N]` → `[N]` (0 where the token is the reference's argmax)."""
    return logits.max(-1).values - logits.gather(-1, tokens.long()[:, None])[:, 0]

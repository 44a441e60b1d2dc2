"""Plain float32 DeepSeek-V2 text LM: the full causal forward pass, no cache.

Written from the published DeepSeek-V2 architecture (`config.json` and
`modeling_deepseek.py` of deepseek-ai/DeepSeek-V2-Lite), in the
non-absorbed form, with no cache, kernels or batching:

- pre-RMSNorm blocks; a final RMSNorm before the untied head;
- multi-head latent attention without a query LoRA: q = W_q h split into
  q_nope and q_pe a head; W_kv_a h split into the latent c_kv (normed by
  `kv_a_layernorm`) and one rope row k_pe shared by every head; W_kv_b
  c_kv gives each head's k_nope and v; score = (q_nope . k_nope + q_pe .
  k_pe) * softmax_scale, softmax_scale = q_head_dim ** -0.5 * mscale ** 2;
- rope on the rope dims only, in DeepSeek's interleaved pairing (the dims
  viewed as (d/2, 2) and transposed before the half-split rotation), with
  YaRN frequencies (a linear ramp between the correction dims blends the
  base frequencies and the base frequencies over the factor) and the cos
  and sin scaled by mscale(factor, mscale) / mscale(factor, mscale_all_dim);
- the first `first_k_dense_replace` layers a dense SwiGLU MLP, the others a
  mixture of experts: the router's softmax over the routed experts in
  float32, a greedy top-k, the weights renormalised only with
  `norm_topk_prob` and else times `routed_scaling_factor`, each chosen
  SwiGLU expert weighted, plus the shared experts (one SwiGLU of
  `n_shared_experts` times the expert width) for every token.

The weights are the caller's tensors (bf16 on the card), upcast to float32
one layer at a time (a routed expert only when a row chose it), so the pass
fits beside them. Layouts: per-layer tensors stacked `[L, ...]` (the dense
MLP over the dense layers, the router and experts over the expert layers);
attention matrices, the router and the head `[in, out]`; the MLPs' (dense,
routed and shared experts) `[out, in]`, gate and up stacked on the output
axis.
"""

from __future__ import annotations

import math

import torch


def full_precision() -> None:
    """Matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, original: int) -> float:
    return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))


def inv_freq(c: dict) -> torch.Tensor:
    """The YaRN inverse frequencies `[dr / 2]` (float32, as published)."""
    dim, base, y = c["qk_rope_head_dim"], c["rope_theta"], c["rope_scaling"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (y["factor"] * base ** exps)
    low = max(math.floor(_correction_dim(y["beta_fast"], dim, base,
                                         y["original_max_position_embeddings"])), 0)
    high = min(math.ceil(_correction_dim(y["beta_slow"], dim, base,
                                         y["original_max_position_embeddings"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def cos_sin(c: dict, T: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin `[T, dr]` of positions 0..T-1, times the YaRN mscale ratio."""
    y = c["rope_scaling"]
    scale = (yarn_mscale(y["factor"], y["mscale"])
             / yarn_mscale(y["factor"], y["mscale_all_dim"]))
    freqs = torch.outer(torch.arange(T, dtype=torch.float32), inv_freq(c))
    emb = torch.cat([freqs, freqs], dim=-1)
    return (emb.cos() * scale).to(device), (emb.sin() * scale).to(device)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x `[..., T, dr]`: interleaved pairs gathered (even dims, then odd),
    then rotated by half-split pairs."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def softmax_scale(c: dict) -> float:
    y = c["rope_scaling"]
    m = yarn_mscale(y["factor"], y["mscale_all_dim"])
    return (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5 * m * m


def swiglu(h: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """h `[T, H]` through gate|up `[2I, H]` and down `[H, I]` ([out, in])."""
    gu = h @ gate_up.float().t()
    I = gu.shape[-1] // 2
    return (torch.nn.functional.silu(gu[:, :I]) * gu[:, I:]) @ down.float().t()


def route(c: dict, h: torch.Tensor, gate: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, ids) `[T, k]` of the routed experts (float32 router)."""
    scores = (h.float() @ gate.float()).softmax(dim=-1)
    w, ids = torch.topk(scores, k=c["num_experts_per_tok"], dim=-1)
    if c["num_experts_per_tok"] > 1 and c["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    else:
        w = w * c["routed_scaling_factor"]
    return w, ids


def moe(c: dict, w: dict, p: str, mi: int, h: torch.Tensor) -> torch.Tensor:
    weights, ids = route(c, h, w[f"{p}.router"][mi])
    out = swiglu(h, w[f"{p}.shared_gate_up"][mi], w[f"{p}.shared_down"][mi])
    for e in ids.unique().tolist():
        rows, slot = (ids == e).nonzero(as_tuple=True)
        y = swiglu(h[rows], w[f"{p}.experts_gate_up"][mi, e], w[f"{p}.experts_down"][mi, e])
        out = out.index_add(0, rows, y * weights[rows, slot, None])
    return out


def attention(c: dict, w: dict, p: str, li: int, h: torch.Tensor, cos, sin) -> torch.Tensor:
    T = h.shape[0]
    NH, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    C = c["kv_lora_rank"]
    q = (h @ w[f"{p}.wq"][li].float()).view(T, NH, dn + dr).transpose(0, 1)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv_a = h @ w[f"{p}.wkv_a"][li].float()
    ckv = rms_norm(kv_a[:, :C], w[f"{p}.kv_norm"][li], c["rms_norm_eps"])
    k_pe = kv_a[:, C:]
    kv = (ckv @ w[f"{p}.wkv_b"][li].float()).view(T, NH, dn + dv).transpose(0, 1)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe, k_pe = rope(q_pe, cos, sin), rope(k_pe, cos, sin)
    s = (q_nope @ k_nope.transpose(-1, -2) + q_pe @ k_pe.t()) * softmax_scale(c)
    causal = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
    return a.transpose(0, 1).reshape(T, NH * dv) @ w[f"{p}.wo"][li].float()


def forward(w: dict, c: dict, x: torch.Tensor, p: str = "lm") -> torch.Tensor:
    """Embeddings `[T, H]` → final-normed hidden states `[T, H]`, float32."""
    eps, dense = c["rms_norm_eps"], c["first_k_dense_replace"]
    x = x.float()
    cos, sin = cos_sin(c, x.shape[0], x.device)
    for li in range(c["num_hidden_layers"]):
        x = x + attention(c, w, p, li, rms_norm(x, w[f"{p}.input_norm"][li], eps), cos, sin)
        h = rms_norm(x, w[f"{p}.post_norm"][li], eps)
        if li < dense:
            x = x + swiglu(h, w[f"{p}.dense_gate_up"][li], w[f"{p}.dense_down"][li])
        else:
            x = x + moe(c, w, p, li - dense, h)
    return rms_norm(x, w[f"{p}.final_norm"], eps)


def logits(w: dict, c: dict, ids: list[int], p: str = "lm") -> torch.Tensor:
    """`[T, V]` float32 logits of every position of `ids`."""
    emb = w[f"{p}.embed"]
    hidden = forward(w, c, emb[torch.tensor(ids, device=emb.device)], p)
    return hidden @ w[f"{p}.lm_head"].float()


def reply_gaps(w: dict, c: dict, prompt: list[int], reply: list[int],
               stop: int | None) -> torch.Tensor:
    """`[len(reply) (+1)]` gaps of the served ids (and of `stop`, the id that
    ended the reply early, when given) below the reference's best logit,
    teacher-forced: the logits at the prompt's last row and at each reply
    row before the last."""
    served = list(reply) + ([stop] if stop is not None else [])
    ids = (list(prompt) + list(reply))[:len(prompt) + len(served) - 1]
    lg = logits(w, c, ids)[len(prompt) - 1:]
    tokens = torch.tensor(served, device=lg.device)
    return lg.max(-1).values - lg.gather(-1, tokens[:, None])[:, 0]

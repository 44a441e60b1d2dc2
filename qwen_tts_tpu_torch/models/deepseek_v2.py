"""DeepSeek-V2 as a text LM of the port: latent attention, routed and shared experts.

The published architecture (deepseek-ai/DeepSeek-V2-Lite, `config.json` and
`modeling_deepseek.py`), held to the plain float32 reference
`tests/_deepseek_v2_reference.py` on the CPU and, in the benchmark, to its
copy `h100_bench/reference/deepseek_v2.py` on the card:

- 27 pre-RMSNorm layers at hidden 2,048; the final RMSNorm before an
  untied head `[2048, 102400]`;
- multi-head latent attention (MLA) with no query LoRA: 16 heads, q =
  W_q h split into q_nope (128) and q_pe (64) a head; W_kv_a h split into
  the latent c_kv (512, normed by `kv_a_layernorm`) and one rope row k_pe
  (64) that every head shares; W_kv_b c_kv gives each head's k_nope (128)
  and v (128); softmax_scale = 192 ** -0.5 * mscale(40, 0.707) ** 2;
- rope on the 64 rope dims only, interleaved pairs gathered before the
  half-split rotation, with YaRN frequencies (factor 40, original context
  4,096, beta_fast 32, beta_slow 1; cos and sin scaled by mscale(40,
  mscale) / mscale(40, mscale_all_dim) = 1 here);
- layer 0 a dense SwiGLU MLP of width 10,944, layers 1-26 a mixture of
  experts: a float32 router's softmax over 64 experts, a greedy top-6, the
  weights neither renormalised nor scaled (`routed_scaling_factor` 1), six
  SwiGLU experts of width 1,408 and the two shared experts as one SwiGLU of
  width 2,816 for every token.

The cache holds only each token's normed latent and roped k_pe, `[L, S,
576]` bf16 (31 KB a token over 27 layers). The prefill runs the published,
non-absorbed MLA over the prompt with causal attention. The decode step
runs the absorbed form, equal in value: q_lat[h] = q_nope[h] W_UK[h] (the
k_nope half of W_kv_b), the latent attention kernel over the cache rows
(`ops/mla_attention.py`), then o[h] = o_lat[h] W_UV[h] (the v half). The
MoE layers go through the expert kernel (`ops/moe.py`): its one-row form in
a decode step, its multi-row form in the prefill. Projections, norms,
rope, the router and the head with its argmax are plain torch operations.

Departures from the published code: bf16 weights, activations and cache
where it computes in the checkpoint's type, with float32 accumulation in
every product and float32 norms, softmaxes, router and residual stream;
the expert kernel sums its experts' shares with float32 atomics, in no
fixed order.

`DeepseekV2LM` drives the model through the port's text-LM driver
(`runtime/lm_driver.py`, the one `models/text_lm.py::TextLM` uses): on a
GPU the prompt's prefill and each chunk of `generate_stream` are one
CUDA-graph replay each, with the spans `lm.prefill`, `lm.chunk`,
`lm.launch` and `lm.wait`; on the CPU the same bodies run eagerly on the
kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import mla_attention, moe
from ..runtime.lm_driver import LMDriver
from .decoder import rms_norm
from .text_lm import _require_device

FORMS = ("mla_decode_attn", "moe_experts_decode", "moe_experts_prefill")


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The published `config.json` keys the model reads (DeepSeek-V2-Lite's
    values), YaRN's `rope_scaling` flattened into `yarn_*`."""

    num_hidden_layers: int = 27
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    vocab_size: int = 102400
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 163840
    yarn_factor: float = 40.0
    yarn_original_max_position_embeddings: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 0.707
    yarn_mscale_all_dim: float = 0.707

    @classmethod
    def from_published(cls, d: dict) -> "DeepseekV2Config":
        """From a `config.json`-shaped dict (`rope_scaling` nested; every
        layer after the dense ones an expert layer, `moe_layer_freq` 1)."""
        if d.get("moe_layer_freq", 1) != 1:
            raise ValueError(f"moe_layer_freq {d['moe_layer_freq']}: only 1 is supported")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw.update({f"yarn_{k}": v for k, v in (d.get("rope_scaling") or {}).items()
                   if f"yarn_{k}" in names})
        return cls(**kw)

    @property
    def max_seq_len(self) -> int:
        return self.max_position_embeddings

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, li: int) -> bool:
        return li >= self.first_k_dense_replace

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """q_head_dim ** -0.5 times mscale(factor, mscale_all_dim) squared."""
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return cfg.q_head_dim ** -0.5 * m * m


def rope_table(cfg: DeepseekV2Config, device) -> tuple[torch.Tensor, torch.Tensor]:
    """YaRN cos and sin `[max_seq_len, dr]` f32 (the published frequencies:
    a linear ramp between the correction dims of beta_fast and beta_slow
    blends the base frequencies, kept where they turn fast, with the base
    frequencies over the factor; times the mscale ratio)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def correction(rotations):
        orig = cfg.yarn_original_max_position_embeddings
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    fast, slow = 1.0 / base ** exps, 1.0 / (cfg.yarn_factor * base ** exps)
    low = max(math.floor(correction(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(correction(cfg.yarn_beta_slow)), dim - 1)
    high = high + 0.001 if low == high else high
    keep = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    inv = slow * (1 - keep) + fast * keep
    scale = (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
             / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    ang = torch.outer(torch.arange(cfg.max_seq_len, dtype=torch.float32), inv)
    ang = torch.cat([ang, ang], dim=-1)
    return (ang.cos() * scale).to(device), (ang.sin() * scale).to(device)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope: the interleaved pairs of x `[..., dr]` gathered (even
    dims, then odd), then the half-split rotation; cos and sin broadcast."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1) * sin


def route(cfg: DeepseekV2Config, h: torch.Tensor, router: torch.Tensor):
    """(ids `[T, k]` int64, weights `[T, k]` f32): the float32 router's
    softmax over the routed experts, a greedy top-k, renormalised only with
    `norm_topk_prob`, else times `routed_scaling_factor`."""
    scores = (h.float() @ router).softmax(dim=-1)
    w, ids = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    if cfg.num_experts_per_tok > 1 and cfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    else:
        w = w * cfg.routed_scaling_factor
    return ids, w


class DeepseekV2Weights(NamedTuple):
    """The program's tensors: per-layer ones stacked `[L, ...]` (the dense
    MLP over the dense layers, router and experts over the expert layers).
    Attention matrices, router and head `[in, out]`; the MLPs' `[out, in]`
    (gate|up stacked on the output axis), the layout the expert kernel
    streams."""

    embed: torch.Tensor            # [V, H]
    input_norm: torch.Tensor       # [L, H]
    w_qkv_a: torch.Tensor          # [L, H, NH*(dn+dr) + C + dr]: W_q | W_kv_a
    kv_norm: torch.Tensor          # [L, C]
    w_uk: torch.Tensor             # [L, NH, dn, C]: the k_nope half of W_kv_b
    w_uv: torch.Tensor             # [L, NH, C, dv]: its v half
    wo: torch.Tensor               # [L, NH*dv, H]
    post_norm: torch.Tensor        # [L, H]
    dense_gate_up: torch.Tensor    # [Ld, 2I, H]
    dense_down: torch.Tensor       # [Ld, H, I]
    router: torch.Tensor           # [Lm, H, E] f32
    experts_gate_up: torch.Tensor  # [Lm, E, 2Ie, H]
    experts_down: torch.Tensor     # [Lm, E, H, Ie]
    shared_gate_up: torch.Tensor   # [Lm, 2Is, H]
    shared_down: torch.Tensor      # [Lm, H, Is]
    final_norm: torch.Tensor       # [H]
    lm_head: torch.Tensor          # [H, V]
    rope_cos: torch.Tensor         # [S, dr] f32
    rope_sin: torch.Tensor         # [S, dr] f32


def tensor_shapes(cfg: DeepseekV2Config) -> dict[str, tuple]:
    """The published model's tensors by name, in the layout `weights_from`
    reads (W_kv_b `[C, NH*(dn+dv)]`, each head's k_nope then v columns)."""
    L, H, V, C = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size, cfg.kv_lora_rank
    NH, dr, dn, dv = (cfg.num_attention_heads, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim,
                      cfg.v_head_dim)
    Ld, Lm, E = cfg.first_k_dense_replace, cfg.moe_layers, cfg.n_routed_experts
    I, Ie, Is = (cfg.intermediate_size, cfg.moe_intermediate_size,
                 cfg.moe_intermediate_size * cfg.n_shared_experts)
    return {"embed": (V, H), "input_norm": (L, H), "wq": (L, H, NH * (dn + dr)),
            "wkv_a": (L, H, C + dr), "kv_norm": (L, C), "wkv_b": (L, C, NH * (dn + dv)),
            "wo": (L, NH * dv, H), "post_norm": (L, H), "dense_gate_up": (Ld, 2 * I, H),
            "dense_down": (Ld, H, I), "router": (Lm, H, E),
            "experts_gate_up": (Lm, E, 2 * Ie, H), "experts_down": (Lm, E, H, Ie),
            "shared_gate_up": (Lm, 2 * Is, H), "shared_down": (Lm, H, Is),
            "final_norm": (H,), "lm_head": (H, V)}


def tensor_specs(cfg: DeepseekV2Config) -> list[tuple]:
    """(name, shape, kind, scale) of each tensor of `tensor_shapes` as a
    random init draws it: matrices N(0, 1) times fan_in ** -0.5 (kind
    "normal"), the embedding times H ** -0.5, norm weights 1 + 0.1 N(0, 1)
    (kind "norm")."""
    out = []
    for name, shape in tensor_shapes(cfg).items():
        if name.endswith("norm"):
            out.append((name, shape, "norm", None))
        else:
            out_in = name == "embed" or name.startswith(("dense", "experts", "shared"))
            out.append((name, shape, "normal", shape[-1 if out_in else -2] ** -0.5))
    return out


def init_tensors(gen: torch.Generator, cfg: DeepseekV2Config, device,
                 dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Random tensors of `tensor_specs` from `gen`."""
    out = {}
    for name, shape, kind, scale in tensor_specs(cfg):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        out[name] = (1 + 0.1 * t if kind == "norm" else t * scale).to(dtype)
    return out


def weights_from(t: dict[str, torch.Tensor], cfg: DeepseekV2Config) -> DeepseekV2Weights:
    """The program's weights over tensors named as `tensor_shapes` (bf16):
    views where the layout is the same, W_q | W_kv_a fused, W_kv_b split
    into W_UK and W_UV, the router in f32, the YaRN table."""
    L, C, NH = cfg.num_hidden_layers, cfg.kv_lora_rank, cfg.num_attention_heads
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    kv_b = t["wkv_b"].view(L, C, NH, dn + dv)
    cos, sin = rope_table(cfg, t["embed"].device)
    return DeepseekV2Weights(
        embed=t["embed"], input_norm=t["input_norm"],
        w_qkv_a=torch.cat([t["wq"], t["wkv_a"]], dim=-1), kv_norm=t["kv_norm"],
        w_uk=kv_b[..., :dn].permute(0, 2, 3, 1).contiguous(),
        w_uv=kv_b[..., dn:].permute(0, 2, 1, 3).contiguous(),
        wo=t["wo"], post_norm=t["post_norm"], dense_gate_up=t["dense_gate_up"],
        dense_down=t["dense_down"], router=t["router"].float(),
        experts_gate_up=t["experts_gate_up"], experts_down=t["experts_down"],
        shared_gate_up=t["shared_gate_up"], shared_down=t["shared_down"],
        final_norm=t["final_norm"], lm_head=t["lm_head"], rope_cos=cos, rope_sin=sin)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


class DeepseekV2LM(LMDriver):
    """Prompt ids in, greedy token ids out, under the port's text-LM driver
    (`generate_stream`, `warm`, `steps`, `decode_launches`).
    `kernel_launches()` reads the new kernels' own counts by form."""

    def __init__(self, weights: DeepseekV2Weights, cfg: DeepseekV2Config = DeepseekV2Config(),
                 device="cuda"):
        device = _require_device(device)
        if weights.embed.device != device:
            raise ValueError(f"the weights are on {weights.embed.device}, not {device}")
        self.cfg, self.w = cfg, weights
        super().__init__(device)
        S = cfg.max_seq_len
        width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        self.cache = torch.zeros((cfg.num_hidden_layers, S, width), dtype=torch.bfloat16,
                                 device=device)
        self._dpos = torch.zeros(1, dtype=torch.long, device=device)   # the device position
        self._counts = torch.zeros(len(FORMS), dtype=torch.int64, device=device)
        self._work = mla_attention.workspace(S, cfg.num_attention_heads, cfg.kv_lora_rank,
                                             device)
        self.scale = softmax_scale(cfg)

    # ── the layers ───────────────────────────────────────────────────────

    def _qkv(self, li: int, x: torch.Tensor, cos, sin):
        """Rows x `[T, H]` f32 → q_nope `[T, NH, dn]`, roped q_pe `[T, NH, dr]`
        (f32), the cache rows `[T, C + dr]` (normed latent, roped k_pe)."""
        c, w = self.cfg, self.w
        NH, dn, C = c.num_attention_heads, c.qk_nope_head_dim, c.kv_lora_rank
        T = x.shape[0]
        qa = (_bf(rms_norm(x, w.input_norm[li], c.rms_norm_eps)) @ w.w_qkv_a[li]).float()
        q = qa[:, :NH * c.q_head_dim].view(T, NH, c.q_head_dim)
        kv = qa[:, NH * c.q_head_dim:]
        ckv = rms_norm(kv[:, :C], w.kv_norm[li], c.rms_norm_eps)
        q_pe = rotate(q[..., dn:], cos[:, None], sin[:, None])
        return q[..., :dn], q_pe, torch.cat([ckv, rotate(kv[:, C:], cos, sin)], dim=-1)

    def _mlp(self, li: int, x: torch.Tensor, prefill: bool) -> torch.Tensor:
        """x += the layer's dense MLP or its experts (in place for experts)."""
        c, w = self.cfg, self.w
        h = _bf(rms_norm(x, w.post_norm[li], c.rms_norm_eps))
        if not c.is_moe(li):
            gu = (h @ w.dense_gate_up[li].t()).float()
            i = gu.shape[-1] // 2
            return x + (_bf(F.silu(gu[:, :i]) * gu[:, i:]) @ w.dense_down[li].t()).float()
        mi = li - c.first_k_dense_replace
        ids, wts = route(c, h, w.router[mi])
        name = "moe_experts_prefill" if prefill else "moe_experts_decode"
        k = FORMS.index(name)
        return getattr(moe, name)(x, h, ids, wts, w.experts_gate_up[mi], w.experts_down[mi],
                                  w.shared_gate_up[mi], w.shared_down[mi],
                                  self._counts[k:k + 1])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head's f32 logits `[1, V]` of the last row of x."""
        h = _bf(rms_norm(x[-1:], self.w.final_norm, self.cfg.rms_norm_eps))
        return (h @ self.w.lm_head).float()

    def _prefill_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """The plain (non-absorbed) MLA forward over ids `[P]` from position
        0, the cache rows [0, P) written; the hidden rows `[P, H]` f32."""
        c, w = self.cfg, self.w
        P = ids.shape[0]
        NH, dv = c.num_attention_heads, c.v_head_dim
        cos, sin = w.rope_cos[:P], w.rope_sin[:P]
        causal = torch.ones((P, P), dtype=torch.bool, device=ids.device).tril()
        x = w.embed[ids].float()
        for li in range(c.num_hidden_layers):
            q_nope, q_pe, rows = self._qkv(li, x, cos, sin)
            rows = _bf(rows)             # as the cache holds them, and decode reads them
            self.cache[li, :P] = rows
            latent = rows[:, :c.kv_lora_rank]
            k_nope = torch.einsum("tc,hdc->thd", latent, w.w_uk[li]).float()
            v = torch.einsum("tc,hce->the", latent, w.w_uv[li])
            k_pe = rows[:, c.kv_lora_rank:].float()
            s = (torch.einsum("thd,shd->hts", q_nope, k_nope)
                 + torch.einsum("thr,sr->hts", q_pe, k_pe)) * self.scale
            p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            o = torch.einsum("hts,she->the", _bf(p), v).reshape(P, NH * dv)
            x = x + (o @ w.wo[li]).float()
            x = self._mlp(li, x, prefill=True)
        return x

    def _step(self, tok: torch.Tensor) -> torch.Tensor:
        """One step of id `tok` `[1]` at the device position (its cache row
        written, the position advanced): its hidden row `[1, H]` f32."""
        c, w = self.cfg, self.w
        NH = c.num_attention_heads
        pos = self._dpos
        pos32 = pos.to(torch.int32).reshape(())
        cos, sin = w.rope_cos.index_select(0, pos), w.rope_sin.index_select(0, pos)
        x = w.embed.index_select(0, tok).float()
        for li in range(c.num_hidden_layers):
            q_nope, q_pe, row = self._qkv(li, x, cos, sin)
            self.cache[li].index_copy_(0, pos, _bf(row))
            q_lat = torch.bmm(_bf(q_nope).transpose(0, 1), w.w_uk[li]).float()[:, 0]
            o_lat = mla_attention.mla_decode_attention(q_lat, q_pe[0], self.cache[li], pos32,
                                                       self.scale, self._work,
                                                       self._counts[0:1])
            o = torch.bmm(_bf(o_lat)[:, None], w.w_uv[li])[:, 0].reshape(1, NH * c.v_head_dim)
            x = x + (o @ w.wo[li]).float()
            x = self._mlp(li, x, prefill=False)
        pos += 1
        return x

    # ── the driver's bodies ──────────────────────────────────────────────

    def _prefill_body(self, P: int) -> None:
        host, ids = self._ids[P]
        ids.copy_(host, non_blocking=True)
        first = self._logits(self._prefill_rows(ids)).argmax(dim=-1)
        self._dpos.fill_(P)
        self._tok.copy_(first)
        self._first.copy_(first, non_blocking=True)

    def _chunk_body(self, n: int) -> None:
        tokens, tok = [], self._tok
        for _ in range(n):
            tok = self._logits(self._step(tok)).argmax(dim=-1)
            tokens.append(tok)
        ids = torch.cat(tokens)
        self._tok.copy_(ids[-1:])
        self._out[n].copy_(ids.to(torch.int32), non_blocking=True)

    def _cache_prefix(self, p: int) -> list[torch.Tensor]:
        return [self.cache[:, :p]]

    def _set_position(self, p: int) -> None:
        self._dpos.fill_(p)

    def forced_logits(self, ids, P: int) -> torch.Tensor:
        """The f32 logits `[len(ids) - P + 1, V]` the served path computes
        along `ids`, teacher-forced: the prefill of ids[:P] and its last row,
        then one decode step for each later id. Eager (the graphs' bodies
        op by op); it overwrites the static state, so no stream may be
        parked or running."""
        if self._owner is not None or P < 1 or P > len(ids):
            raise ValueError("forced_logits needs a free LM and 1 <= P <= len(ids)")
        ids = torch.as_tensor(list(ids), dtype=torch.long, device=self.device)
        rows = [self._logits(self._prefill_rows(ids[:P]))]
        self._dpos.fill_(P)
        for i in range(P, ids.shape[0]):
            rows.append(self._logits(self._step(ids[i:i + 1])))
        return torch.cat(rows)

    def kernel_launches(self) -> dict[str, int]:
        """The new kernels' launches by this LM (eager runs and graph replays
        alike), as they count them themselves (a device read)."""
        if self._graphs.cuda:
            self._graphs.stream.synchronize()
        return dict(zip(FORMS, (int(v) for v in self._counts.tolist())))

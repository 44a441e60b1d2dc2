"""The DeepSeek-V2 text LM (`deepseek-v2-lite-voice-agent`): latent attention
(MLA) and routed plus shared experts, served by the port's
`models/deepseek_v2.py::DeepseekV2LM` (its own kernels: `mla_decode_attn`,
`moe_experts_decode`, `moe_experts_prefill`; none of its steps in B1) and
held to the plain float32 `reference/deepseek_v2.py`.

Beside the six functions of a family (`families/__init__.py`), the cost of
one launch of each new kernel (`mla_decode_cost`, `moe_decode_cost`,
`moe_prefill_cost`) and the launch cross-check that their roofline
readers share (`decode_roofline`).
"""

from __future__ import annotations

import sys

from .. import check, costs, weights

FAMILY = {"model_type": "deepseek_v2", "q_lora_rank": None, "scoring_func": "softmax",
          "topk_method": "greedy", "tie_word_embeddings": False, "moe_layer_freq": 1,
          "n_group": 1, "topk_group": 1, "hidden_act": "silu", "attention_bias": False}
KEYS = ("num_hidden_layers", "hidden_size", "intermediate_size", "moe_intermediate_size",
        "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "n_routed_experts", "num_experts_per_tok", "n_shared_experts",
        "first_k_dense_replace", "norm_topk_prob", "routed_scaling_factor", "vocab_size",
        "rms_norm_eps", "rope_theta", "rope_scaling", "max_position_embeddings")
# [out, in] matrices (the MLPs'), per output channel over the last axis;
# the rest of the matrices are [in, out]
OUT_IN = ("dense_gate_up", "dense_down", "experts_gate_up", "experts_down", "shared_gate_up",
          "shared_down")
IN_OUT = ("wq", "wkv_a", "wkv_b", "wo", "router", "lm_head")


def lm_config(cfg: dict) -> dict:
    """The published keys the model and the reference read; a configuration
    of another kind of DeepSeek-V2 (a query LoRA, grouped routing, ...)
    raises."""
    other = {k: cfg.get(k) for k, v in FAMILY.items() if cfg.get(k, v) != v}
    if other:
        raise ValueError(f"the deepseek_v2 family does not take {other}")
    return {k: cfg[k] for k in KEYS}


def moe_layers(c: dict) -> int:
    return c["num_hidden_layers"] - c["first_k_dense_replace"]


def make_weights(cfg: dict, seed: int, device) -> dict:
    """One bf16 buffer, the tensors the port's `weights_from` reads
    (`tensor_specs`: matrices N(0, 1/fan_in), the embedding N(0, 1/H), norms
    1 + 0.1 N(0, 1)), named `lm.<name>` as the reference reads them."""
    import torch
    from qwen_tts_tpu_torch.models import deepseek_v2 as ds

    specs = ds.tensor_specs(ds.DeepseekV2Config.from_published(cfg))
    return weights.draw([(f"lm.{n}", shape, kind, scale) for n, shape, kind, scale in specs],
                        seed, device, torch.bfloat16)


def int8_rounded(t, axis: int):
    """t rounded to int8 per output channel (absmax / 127 over `axis`, the
    input axis) and back to bf16, one leading slice at a time."""
    import torch

    out = torch.empty_like(t)
    for i in range(t.shape[0]):
        x = t[i].float()
        s = x.abs().amax(dim=axis, keepdim=True).clamp_min(1e-8) / 127.0
        out[i] = (torch.round(x / s).clamp(-127, 127) * s).to(t.dtype)
    return out


def _tensors(w: dict) -> dict:
    """The LM's tensors by the names of `tensor_shapes`: the control's
    rounded copies (`lm_control.<name>`) where `build` left them, else the
    drawn ones."""
    prefix = "lm_control." if any(k.startswith("lm_control.") for k in w) else "lm."
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def _lm(w: dict, cfg: dict):
    from qwen_tts_tpu_torch.models import deepseek_v2 as ds

    c = ds.DeepseekV2Config.from_published(cfg)
    t = _tensors(w)
    return ds.DeepseekV2LM(ds.weights_from(t, c), c, device=t["embed"].device)


def build(run, w: dict):
    """`DeepseekV2LM` over the drawn tensors; under `--control` every LM
    matrix rounded to int8 per output channel and back to bf16, the rounded
    copies kept in `w` as `lm_control.<name>` so that the check's numbers
    are the control's."""
    if run.control:
        for name in OUT_IN + IN_OUT:
            t = w[f"lm.{name}"]
            w[f"lm_control.{name}"] = int8_rounded(t if t.dim() > 2 else t[None],
                                                   -1 if name in OUT_IN else -2).reshape(t.shape)
        for k in [k for k in w if k.startswith("lm.")]:
            w.setdefault(f"lm_control.{k[3:]}", w[k])
    return _lm(w, run.lm_cfg)


def check_numbers(w: dict, cfg: dict, replies: list, plan: dict, seed: int) -> dict:
    """Over `check.lm_numbers`' sample of the served replies: `lm_gap`, and
    `lm_logit_median`: the program's logits along each reply
    (teacher-forced through the served path's prefill and decode steps,
    eagerly: `DeepseekV2LM.forced_logits`) against the reference's, a row's
    error the norm of their difference over the norm of the reference's
    logits about their mean, the median over every row checked. The bf16
    program's rows read ~0.02 at the published widths: rounding, and router
    near-ties settled the other way in ~13% of the (row, layer) choices;
    int8 weights read ~0.07, top-5 routing ~0.05 (PERF.md §6). `lm_gap`
    alone cannot tell them apart: its widest sound readings and the int8
    control's smallest lie within ~25%."""
    import torch

    from ..reference import deepseek_v2 as ref

    lm, rows = _lm(w, cfg), []

    def gaps(prompt, reply, stop):
        served = list(reply) + ([stop] if stop is not None else [])
        ids = (list(prompt) + list(reply))[:len(prompt) + len(served) - 1]
        want = ref.logits(w, cfg, ids)[len(prompt) - 1:]
        got = lm.forced_logits(ids, len(prompt))
        spread = (want - want.mean(-1, keepdim=True)).norm(dim=-1)
        rows.append(((got - want).norm(dim=-1) / spread).cpu())
        tokens = torch.tensor(served, device=want.device)
        return want.max(-1).values - want.gather(-1, tokens[:, None])[:, 0]

    out = check.lm_numbers(replies, plan, seed, gaps)
    out["lm_logit_median"] = float(torch.cat(rows).median()) if rows else float("inf")
    return out


def _attention_params(c: dict) -> int:
    H, C, NH = c["hidden_size"], c["kv_lora_rank"], c["num_attention_heads"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return H * NH * (dn + dr) + H * (C + dr) + C * NH * (dn + dv) + NH * dv * H


def _token_params(c: dict) -> int:
    """The weights one token multiplies in the layers: attention, the dense
    MLP, and in each expert layer the router, its k experts and the shared."""
    H, Ie = c["hidden_size"], c["moe_intermediate_size"]
    k, Is = c["num_experts_per_tok"], Ie * c["n_shared_experts"]
    dense = c["first_k_dense_replace"] * 3 * H * c["intermediate_size"]
    experts = moe_layers(c) * (H * c["n_routed_experts"] + 3 * H * (k * Ie + Is))
    return c["num_hidden_layers"] * _attention_params(c) + dense + experts


def _attention_flops(c: dict, rows: float) -> float:
    """Scores and weighted values of one query over `rows` rows, every layer."""
    NH = c["num_attention_heads"]
    d = c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]
    return 2 * c["num_hidden_layers"] * NH * rows * d


def token_flops(cfg: dict, pos: float) -> float:
    """One reply id at position `pos`: its layers (6 routed + 2 shared-width
    experts an expert layer), attention over pos + 1 rows, the head."""
    return (2 * _token_params(cfg) + _attention_flops(cfg, pos + 1)
            + 2 * cfg["hidden_size"] * cfg["vocab_size"])


def prefill_flops(cfg: dict, P: int) -> float:
    """A `P`-id prompt's prefill: its layers over P rows and causal attention."""
    return 2 * P * _token_params(cfg) + _attention_flops(cfg, P * (P + 1) / 2)


def b1_step_cost(cfg: dict, pos: float):
    return None          # its steps run on its own kernels, not in B1


# ── the new kernels' costs ───────────────────────────────────────────────


def mla_decode_cost(cfg: dict, pos: float) -> tuple[float, float]:
    """(bytes, FLOPs) of one `mla_decode_attn` launch at cache row `pos`:
    rows [0, pos] of the latent cache in bf16, the f32 queries (q_lat, q_pe)
    read and the f32 output written once; scores over C + R and values over
    C a head and row."""
    NH, C, R = cfg["num_attention_heads"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    rows = pos + 1
    return rows * (C + R) * 2 + NH * (C + R) * 4 + NH * C * 4, 2 * NH * rows * (2 * C + R)


def _expert_bytes(cfg: dict) -> tuple[int, int]:
    H, Ie = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return 3 * H * Ie * 2, 3 * H * Ie * cfg["n_shared_experts"] * 2


def moe_decode_cost(cfg: dict) -> tuple[float, float]:
    """(bytes, FLOPs) of one `moe_experts_decode` launch: the k chosen
    experts' and the shared expert's bf16 weights read once, the row of h
    (bf16), the ids and weights read, the f32 residual row read and written."""
    H, k = cfg["hidden_size"], cfg["num_experts_per_tok"]
    expert, shared = _expert_bytes(cfg)
    # 2 FLOPs a weight of 2 bytes: the FLOPs equal the weight bytes
    return k * expert + shared + H * 2 + k * 12 + H * 8, k * expert + shared


def moe_prefill_cost(cfg: dict, rows: int, experts: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one `moe_experts_prefill` launch over `rows` rows
    whose choices touch `experts` distinct experts."""
    H, k = cfg["hidden_size"], cfg["num_experts_per_tok"]
    expert, shared = _expert_bytes(cfg)
    nbytes = experts * expert + shared + rows * (H * 2 + k * 12 + H * 8)
    return nbytes, rows * (k * expert + shared)


def decode_roofline(run, form: str, layers: int, cost) -> float | None:
    """The share of the roofline of `form`'s launches in the traced slice, %:
    the sum of each launch's least time (`cost` its (bytes, FLOPs)) over
    their device time. Cross-checks, printed: the trace's events against the
    slice's LM steps x `layers`, and the kernel's own count against the
    host's steps (served and warm-up) x `layers` over the run; None when
    either disagrees (layers skipped in a graph) or nothing ran."""
    s, lm = run.summary, run.state.get("lm")
    if s is None or lm is None or "lm_steps" not in s.c0:
        return None
    steps = s.delta("lm_steps")
    sec, seen = s.kernel_s(form)
    counted = lm.kernel_launches()[form]
    host = (lm.steps + lm.warm_steps) * layers
    print(f"{form}: {seen} events in the trace against {steps} LM steps x {layers} = "
          f"{steps * layers}; {counted} launches by the kernel against {host} host steps x "
          f"layers over the run", file=sys.stderr)
    if seen == 0 or sec <= 0 or seen != steps * layers or counted != host:
        return None
    return 100.0 * seen * costs.bound_s(*cost) / sec


def mean_step_position(run) -> float:
    """The mean cache row of the decode steps the window's replies ran (a
    reply's id i > 0 came from the step at row len(prompt) + i - 1)."""
    rows = [len(rp["prompt"]) + i - 1 for t in run.turns for rp in t["replies"]
            for i in range(1, len(rp["reply"]))]
    return sum(rows) / len(rows) if rows else 64.0

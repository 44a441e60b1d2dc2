"""Operations and bytes of the work the benchmark's cells do, from the shapes.

Frozen copies, so later changes to the program cannot move the yardstick:
`step_cost` is `chip_smoke.py::step_cost` (one decode step: every layer
weight read once in its form, the cache prefix read once, the new K/V
column written, the input row read and the outputs written; 2 FLOPs a
weight, 4 * L * HQ * (pos + 1) * D for attention), `code2wav_flops` is
`chip_smoke.py::code2wav_flops`, and `attention_cost` is
`chip_smoke.py::_attention_bound`'s count for the decode-attention kernel
(each slot's K/V prefix in bf16 and its q, k_new, v_new and out in f32,
read or written once). Decoder sizes are dicts with the keys of
`configs/*.json`; weights are counted in bf16 here (every cell serves
bf16), so no tensor of the program is needed.
"""

from __future__ import annotations

import json
import os

PEAKS = json.load(open(os.path.join(os.path.dirname(__file__), "peaks.json")))


def bound_s(nbytes: float, flops: float, flop_rate: float | None = None) -> float:
    """The least time the chip could take: the slower of moving the bytes
    at the HBM rate and doing the operations at `flop_rate` (bf16 dense)."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / (flop_rate or PEAKS["bf16_flops"]))


def layer_params(c: dict) -> int:
    """Weights of one layer's four matrices."""
    H, I, Q, KV = (c["hidden_size"], c["intermediate_size"], c["num_q_heads"] * c["head_dim"],
                   c["num_kv_heads"] * c["head_dim"])
    return H * (Q + 2 * KV) + Q * H + H * 2 * I + I * H


def step_cost(c: dict, pos: float, with_head: bool, weight_bytes: int = 2,
              kv_row_bytes: int | None = None) -> tuple[float, float]:
    """(bytes, FLOPs) one single-token decode step at cache row `pos` must
    move and do (bf16 weights and cache unless told otherwise)."""
    L, H, V, D = c["num_layers"], c["hidden_size"], c["vocab_size"], c["head_dim"]
    KVH, HQ = c["num_kv_heads"], c["num_q_heads"]
    norms = L * (2 * H + 2 * D) + H
    wbytes = L * layer_params(c) * weight_bytes + norms * 2
    wflops = 2 * L * layer_params(c)
    if with_head:
        wbytes += H * V * weight_bytes
        wflops += 2 * H * V
    row = kv_row_bytes or D * 2
    cache = 2 * L * KVH * pos * row
    io = 2 * L * KVH * row + H * 4 * 2 + (V * 4 if with_head else 0)
    return wbytes + cache + io, wflops + 4 * L * HQ * (pos + 1) * D


def attention_cost(c: dict, positions) -> tuple[float, float]:
    """(bytes, FLOPs) of one decode-attention launch (one layer) over slots
    at `positions` (one per slot in use)."""
    KVH, HQ, D = c["num_kv_heads"], c["num_q_heads"], c["head_dim"]
    nbytes = sum(2 * KVH * p * D * 2 + (2 * HQ + 2 * KVH) * D * 4 for p in positions)
    flops = sum(4 * HQ * (p + 1) * D for p in positions)
    return nbytes, flops


def code2wav_flops(c: dict, frames: int) -> float:
    """Multiply-adds x 2 of one Code2Wav decode of `frames` frames (the
    transformer's products and every conv), from the shapes."""
    h, t = c["hidden_size"], frames
    hd = c["hidden_size"] // c["num_attention_heads"]
    qkv = (c["num_attention_heads"] + 2 * c["num_key_value_heads"]) * hd
    per_layer = t * h * (qkv + c["num_attention_heads"] * hd + 3 * c["intermediate_size"])
    per_layer += 2 * t * min(t, c["sliding_window"]) * c["num_attention_heads"] * hd
    macs = c["num_hidden_layers"] * per_layer
    for r in c["upsampling_ratios"]:
        macs += h * h * r * t                                   # k = r transposed conv
        t *= r
        macs += h * 7 * t + 8 * h * h * t                       # ConvNeXt
    ch = c["decoder_dim"]
    macs += h * ch * 7 * t
    for r in c["upsample_rates"]:
        macs += ch * (ch // 2) * 2 * r * t                      # k = 2r transposed conv
        t, ch = t * r - r, ch // 2
        macs += 3 * (ch * ch * 7 + ch * ch) * t                 # residual units
    return 2.0 * (macs + ch * 7 * t)


def tts_frame_flops(cfg: dict, pos: float) -> float:
    """Model FLOPs of one served frame at talker position `pos`: the talker
    step with its head, the code predictor's 2-row prefill, 14 steps and 15
    heads, and Code2Wav's share of a 10-frame decode."""
    t, cp = cfg["talker"], cfg["code_predictor"]
    flops = step_cost(t, pos, with_head=True)[1]
    flops += 2 * 2 * cp["num_layers"] * layer_params(cp)
    flops += sum(step_cost(cp, p, with_head=False)[1] for p in range(2, 16))
    flops += 2 * (cfg["num_code_groups"] - 1) * cp["hidden_size"] * cp["vocab_size"]
    return flops + code2wav_flops(cfg["code2wav"], 10) / 10


def tts_request_flops(cfg: dict, text_ids: int) -> float:
    """Model FLOPs a request spends before its frames: the text projection
    of its ids and the talker's 8-row prefill."""
    tp, t = cfg["text_projection"], cfg["talker"]
    th = tp["text_hidden_size"]
    proj = 2 * (text_ids + 8) * (th * th + th * tp["hidden_size"])
    return proj + 2 * 8 * t["num_layers"] * layer_params(t)


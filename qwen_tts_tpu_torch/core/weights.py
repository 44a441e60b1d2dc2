"""Weight containers for the port, in the JAX package's layout.

Counterpart of `qwen_tts_tpu/core/weights.py:29-206`. Per-layer tensors are
stacked on a leading `[L, ...]` axis, projection matrices are stored
`[in_features, out_features]` (the hot path is `x @ W`), and Q|K|V and
gate|up are fused on the output axis. Keeping the layout identical lets
`from_jax` convert the JAX package's parameters leaf by leaf and lets the
CUDA decode-step kernel read the same slabs the Pallas kernel streamed.

`load_tts_weights` reads a local checkpoint under the reference key names
(the JAX package's :245-321), through the port's own safetensors reader
(`core/safetensors.py`): the machine with the GPU has no `safetensors`.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .config import DecoderConfig, TTSModelConfig
from .safetensors import SafeTensorsFile

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


def make_rope_table(cfg: DecoderConfig, device="cuda") -> RopeTable:
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


def init_decoder_weights(gen: torch.Generator, cfg: DecoderConfig, device="cuda",
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


def init_tts_weights(seed: int, cfg: TTSModelConfig, device="cuda") -> TTSWeights:
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


# ── checkpoint loading (counterpart of core/weights.py:96-109, 245-321) ────

_LAYER_KEYS = (
    ("input_norm", "input_layernorm.weight", False),
    ("q_norm", "self_attn.q_norm.weight", False),
    ("k_norm", "self_attn.k_norm.weight", False),
    ("wo", "self_attn.o_proj.weight", True),
    ("post_norm", "post_attention_layernorm.weight", False),
    ("w_down", "mlp.down_proj.weight", True),
)
_FUSED_KEYS = (("wqkv", ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                         "self_attn.v_proj.weight")),
               ("w_gate_up", ("mlp.gate_proj.weight", "mlp.up_proj.weight")))


def _checkpoint_file(model_path: str) -> str:
    """`<dir>/model.safetensors`; a path that is not a directory is taken
    as a hub id (downloaded by `huggingface_hub`, which the GPU host lacks)."""
    if os.path.isdir(model_path):
        return os.path.join(model_path, "model.safetensors")
    from huggingface_hub import hf_hub_download

    return hf_hub_download(model_path, "model.safetensors")


def _stack_layers(f: SafeTensorsFile, prefix: str, num_layers: int, device) -> LayerWeights:
    """Stack per-layer torch-layout tensors into bf16 `[L, ...]` on `device`,
    transposing matrices to `[in, out]` and fusing q|k|v and gate|up on the
    output axis."""
    def get(i, suffix, transpose):
        t = f.get(f"{prefix}{i}.{suffix}").to(device)
        return t.t() if transpose else t

    out = {field: torch.stack([get(i, suffix, tr) for i in range(num_layers)]).to(torch.bfloat16)
           for field, suffix, tr in _LAYER_KEYS}
    for field, suffixes in _FUSED_KEYS:
        out[field] = torch.stack([torch.cat([get(i, s, True) for s in suffixes], dim=1)
                                  for i in range(num_layers)]).to(torch.bfloat16)
    return LayerWeights(**out)


def load_tts_weights(model_path: str, cfg: TTSModelConfig | None = None, device="cuda",
                     verbose: bool = True) -> TTSWeights:
    """Qwen3-TTS weights, bf16 on `device`, from `<model_path>/model.safetensors`
    under the reference key names: talker layers under
    `talker.model.layers.*`, the untied `talker.codec_head`, the code
    predictor under `talker.code_predictor.*`, the text projection under
    `talker.text_projection.*`. The file is mapped, and each tensor goes to
    `device` before it is transposed, fused and cast."""
    cfg = cfg or TTSModelConfig()
    path = _checkpoint_file(model_path)
    if verbose:
        print(f"Loading TTS weights from {path}...")
    bf = torch.bfloat16
    f = SafeTensorsFile(path)

    def leaf(name, transpose=False):
        t = f.get(name).to(device)
        return (t.t() if transpose else t).to(dtype=bf, copy=True).contiguous()

    tcfg, ccfg = cfg.talker, cfg.code_predictor
    talker = DecoderWeights(
        layers=_stack_layers(f, "talker.model.layers.", tcfg.num_layers, device),
        final_norm=leaf("talker.model.norm.weight"),
        embed=leaf("talker.model.codec_embedding.weight"),
        lm_head=leaf("talker.codec_head.weight", transpose=True),
        rope=make_rope_table(tcfg, device))
    h, v = ccfg.hidden_size, ccfg.vocab_size
    cp_dec = DecoderWeights(
        layers=_stack_layers(f, "talker.code_predictor.model.layers.", ccfg.num_layers, device),
        final_norm=leaf("talker.code_predictor.model.norm.weight"),
        embed=torch.zeros((v, h), dtype=bf, device=device),
        lm_head=torch.zeros((h, v), dtype=bf, device=device),
        rope=make_rope_table(ccfg, device))
    groups = range(cfg.num_code_groups - 1)
    cp = CodePredictorWeights(
        decoder=cp_dec,
        lm_heads=torch.stack([f.get(f"talker.code_predictor.lm_head.{g}.weight").to(device).t()
                              for g in groups]).to(bf),
        codec_embeds=torch.stack([
            f.get(f"talker.code_predictor.model.codec_embedding.{g}.weight").to(device)
            for g in groups]).to(bf))
    tp = TextProjectionWeights(
        text_embedding=leaf("talker.model.text_embedding.weight"),
        fc1_w=leaf("talker.text_projection.linear_fc1.weight", transpose=True),
        fc1_b=leaf("talker.text_projection.linear_fc1.bias"),
        fc2_w=leaf("talker.text_projection.linear_fc2.weight", transpose=True),
        fc2_b=leaf("talker.text_projection.linear_fc2.bias"))
    if verbose:
        n = sum(math.prod(f.shape(k)) for k in f.keys()) / 1e6
        print(f"Loaded {len(f.keys())} tensors ({n:.1f}M params)")
    return TTSWeights(talker=talker, code_predictor=cp, text_projection=tp)


def load_speaker_encoder(model_path: str, device="cuda") -> dict[str, torch.Tensor]:
    """The checkpoint's `speaker_encoder.*` tensors on `device` (loaded on
    request only: nothing uses them, as in the reference)."""
    f = SafeTensorsFile(_checkpoint_file(model_path))
    return {k: f.get(k).to(device, copy=True) for k in f.keys()
            if k.startswith("speaker_encoder.")}


def tts_state_dict(w: TTSWeights, cfg: TTSModelConfig) -> dict[str, torch.Tensor]:
    """bf16 `TTSWeights` → the reference checkpoint's tensors by key name
    (torch layouts, q|k|v and gate|up split): what `load_tts_weights` reads."""
    def layers(lw: LayerWeights, prefix: str, dc: DecoderConfig):
        splits = {"wqkv": (dc.q_size, dc.kv_size, dc.kv_size),
                  "w_gate_up": (dc.intermediate_size, dc.intermediate_size)}
        out = {}
        for i in range(dc.num_layers):
            for field, suffix, tr in _LAYER_KEYS:
                t = getattr(lw, field)[i]
                out[f"{prefix}{i}.{suffix}"] = t.t() if tr else t
            for field, suffixes in _FUSED_KEYS:
                for s, t in zip(suffixes, getattr(lw, field)[i].split(splits[field], dim=1)):
                    out[f"{prefix}{i}.{s}"] = t.t()
        return out

    tw, cw, tp = w.talker, w.code_predictor, w.text_projection
    state = layers(tw.layers, "talker.model.layers.", cfg.talker)
    state.update(layers(cw.decoder.layers, "talker.code_predictor.model.layers.",
                        cfg.code_predictor))
    state.update({
        "talker.model.norm.weight": tw.final_norm,
        "talker.model.codec_embedding.weight": tw.embed,
        "talker.codec_head.weight": tw.lm_head.t(),
        "talker.code_predictor.model.norm.weight": cw.decoder.final_norm,
        "talker.model.text_embedding.weight": tp.text_embedding,
        "talker.text_projection.linear_fc1.weight": tp.fc1_w.t(),
        "talker.text_projection.linear_fc1.bias": tp.fc1_b,
        "talker.text_projection.linear_fc2.weight": tp.fc2_w.t(),
        "talker.text_projection.linear_fc2.bias": tp.fc2_b,
    })
    for g in range(cw.lm_heads.shape[0]):
        state[f"talker.code_predictor.lm_head.{g}.weight"] = cw.lm_heads[g].t()
        state[f"talker.code_predictor.model.codec_embedding.{g}.weight"] = cw.codec_embeds[g]
    return state


# ── weight-only quantization (counterpart of core/weights.py:327-659) ───────
#
# int8: symmetric, one f32 scale per output channel ([L, 1, out]) or per
# group of input rows ([L, in/G, out]). int4-g128: group-wise, two values
# nibble-packed per int8 byte in the halves layout (byte row r holds input
# row r in the low nibble and row r + in/2 in the high one). Mixed: int8
# attention matrices with int4-g128 MLP matrices in the int4 containers;
# the decode-step kernel and the dense path pick the form of each matrix by
# its shape. The LM head may be int8 with a [1, V] scale (`lm_head_s`).
# Scales are max(absmax, 1e-8) / 127 (or / 7) in f32 and values are
# round-half-even of the value divided by the scale, as in the JAX package,
# so the two quantize the same weights to the same bits.

INT4_GROUP = 128


class QuantLayerWeights(NamedTuple):
    """int8 matrices `[L, in, out]` with f32 scales `[L, ng, out]`."""

    input_norm: torch.Tensor   # [L, H] bf16
    q_norm: torch.Tensor       # [L, D] bf16
    k_norm: torch.Tensor       # [L, D] bf16
    post_norm: torch.Tensor    # [L, H] bf16
    wqkv_q: torch.Tensor       # [L, H, Q+2KV] int8
    wqkv_s: torch.Tensor       # [L, ng, Q+2KV] f32
    wo_q: torch.Tensor         # [L, Q, H] int8
    wo_s: torch.Tensor         # [L, ng, H] f32
    w_gate_up_q: torch.Tensor  # [L, H, 2I] int8
    w_gate_up_s: torch.Tensor  # [L, ng, 2I] f32
    w_down_q: torch.Tensor     # [L, I, H] int8
    w_down_s: torch.Tensor     # [L, ng, H] f32


class Quant4LayerWeights(QuantLayerWeights):
    """The int4-g128 and mixed form: a packed matrix is int8 `[L, in/2,
    out]` with scales `[L, in/128, out]`; an int8 one as above."""

    __slots__ = ()


class QuantDecoderWeights(NamedTuple):
    layers: QuantLayerWeights
    final_norm: torch.Tensor
    embed: torch.Tensor        # bf16
    lm_head: torch.Tensor      # bf16 [H, V], or int8 when lm_head_s is set
    rope: RopeTable
    lm_head_s: torch.Tensor | None = None   # [1, V] f32


class Quant4DecoderWeights(QuantDecoderWeights):
    __slots__ = ()


def _absmax_scale(wf: torch.Tensor, dim: int, qmax: float) -> torch.Tensor:
    return wf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / qmax


def _quant_mat(w: torch.Tensor, group_size: int | None = None):
    """[L, in, out] bf16 → (int8 [L, in, out], f32 scales [L, 1, out], or
    [L, in/G, out] for `group_size` G)."""
    if group_size is None:
        wf = w.float()
        scale = _absmax_scale(wf, 1, 127.0)
        return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale
    L, n_in, n_out = w.shape
    if n_in % group_size:
        raise ValueError(f"in dim {n_in} not divisible by group {group_size}")
    wf = w.float().reshape(L, n_in // group_size, group_size, n_out)
    scale = _absmax_scale(wf, 2, 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.reshape(L, n_in, n_out).to(torch.int8), scale[:, :, 0, :]


def quantize_lm_head(lm_head: torch.Tensor):
    """[H, V] bf16 → (int8 [H, V], f32 [1, V]), per output channel."""
    q, s = _quant_mat(lm_head[None], None)
    return q[0], s[0]


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Integers in [-8, 7], [L, in, out] → packed int8 [L, in/2, out]:
    byte row r = (q[r] & 0xF) | (q[r + in/2] << 4)."""
    half = q.shape[1] // 2
    qi = q.to(torch.int32)
    lo, hi = qi[:, :half] & 0xF, qi[:, half:] & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed int8 [..., in/2, out] → (low, high) sign-extended int32 halves."""
    w32 = p.to(torch.int32)
    return ((w32 & 0xF) ^ 8) - 8, w32 >> 4


def _quant_mat_int4(w: torch.Tensor, group_size: int = INT4_GROUP):
    """[L, in, out] bf16 → (packed int8 [L, in/2, out], f32 [L, in/G, out])."""
    L, n_in, n_out = w.shape
    if n_in % group_size or n_in % 2:
        raise ValueError(f"in dim {n_in} not divisible by group {group_size}")
    ng = n_in // group_size
    if ng % 2:   # each packed half must hold whole groups
        raise ValueError(f"group {group_size} gives {ng} group(s) over in dim {n_in}; "
                         f"the int4 halves packing needs an even group count")
    wf = w.float().reshape(L, ng, group_size, n_out)
    scale = _absmax_scale(wf, 2, 7.0)
    q = torch.clamp(torch.round(wf / scale), -7, 7).reshape(L, n_in, n_out)
    return pack_int4(q), scale[:, :, 0, :]


def _quantized(cls, w: DecoderWeights, mats, quant_head: bool):
    lw = w.layers
    fields = {}
    for name, quant in zip(("wqkv", "wo", "w_gate_up", "w_down"), mats):
        fields[f"{name}_q"], fields[f"{name}_s"] = quant(getattr(lw, name))
    head, head_s = quantize_lm_head(w.lm_head) if quant_head else (w.lm_head, None)
    layer_cls = Quant4LayerWeights if cls is Quant4DecoderWeights else QuantLayerWeights
    return cls(layers=layer_cls(input_norm=lw.input_norm, q_norm=lw.q_norm,
                                k_norm=lw.k_norm, post_norm=lw.post_norm, **fields),
               final_norm=w.final_norm, embed=w.embed, lm_head=head, rope=w.rope,
               lm_head_s=head_s)


def quantize_decoder_weights(w: DecoderWeights, group_size: int | None = None,
                             quant_head: bool = True) -> QuantDecoderWeights:
    """bf16 decoder → int8 weight-only form (per channel, or per group)."""
    q = lambda m: _quant_mat(m, group_size)  # noqa: E731
    return _quantized(QuantDecoderWeights, w, (q,) * 4, quant_head)


def quantize_decoder_weights_int4(w: DecoderWeights, group_size: int = INT4_GROUP,
                                  quant_head: bool = True) -> Quant4DecoderWeights:
    """bf16 decoder → int4 group-wise form (the head stays int8)."""
    q = lambda m: _quant_mat_int4(m, group_size)  # noqa: E731
    return _quantized(Quant4DecoderWeights, w, (q,) * 4, quant_head)


def quantize_decoder_weights_mixed(w: DecoderWeights, group_size: int = INT4_GROUP,
                                   quant_head: bool = True) -> Quant4DecoderWeights:
    """bf16 decoder → int8 per-channel attention + int4-g128 MLP."""
    q4 = lambda m: _quant_mat_int4(m, group_size)  # noqa: E731
    return _quantized(Quant4DecoderWeights, w, (_quant_mat, _quant_mat, q4, q4), quant_head)


QUANTIZERS = {"int8": quantize_decoder_weights, "int4": quantize_decoder_weights_int4,
              "mixed": quantize_decoder_weights_mixed}


def is_packed(qm: torch.Tensor, n_in: int) -> bool:
    """True when a quantized matrix with `n_in` input rows is nibble-packed."""
    return qm.shape[-2] * 2 == n_in


def dequant_mat_slice(qm: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """One layer's int8 matrix [in, out] + scales [ng, out] → bf16 [in, out]."""
    n_in, n_out = qm.shape
    ng = s.shape[0]
    if ng == 1:
        return (qm.float() * s).to(torch.bfloat16)
    wf = qm.float().reshape(ng, n_in // ng, n_out)
    return (wf * s[:, None, :]).reshape(n_in, n_out).to(torch.bfloat16)


def dequant_mat_slice_int4(qm: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """One layer's packed int4 matrix [in/2, out] + scales [ng, out] → bf16 [in, out]."""
    n_in, n_out = qm.shape[0] * 2, qm.shape[1]
    ng = s.shape[0]
    wf = torch.cat(unpack_int4(qm), dim=0).float()
    return (wf.reshape(ng, n_in // ng, n_out) * s[:, None, :]).reshape(
        n_in, n_out).to(torch.bfloat16)


def dequant_mat(qm: torch.Tensor, s: torch.Tensor, n_in: int) -> torch.Tensor:
    """One layer's matrix of either form (picked by shape) → bf16 [n_in, out]."""
    return (dequant_mat_slice_int4 if is_packed(qm, n_in) else dequant_mat_slice)(qm, s)


def _dequantized(q: QuantLayerWeights, packed: tuple[bool, ...]) -> LayerWeights:
    mats = {}
    for name, pk in zip(("wqkv", "wo", "w_gate_up", "w_down"), packed):
        qm, s = getattr(q, f"{name}_q"), getattr(q, f"{name}_s")
        dq = dequant_mat_slice_int4 if pk else dequant_mat_slice
        mats[name] = torch.stack([dq(qm[i], s[i]) for i in range(qm.shape[0])])
    return LayerWeights(input_norm=q.input_norm, q_norm=q.q_norm, k_norm=q.k_norm,
                        post_norm=q.post_norm, **mats)


def dequantize_layer_weights(q: QuantLayerWeights) -> LayerWeights:
    """int8 layers (per channel or per group) → bf16 (tests)."""
    return _dequantized(q, (False,) * 4)


def dequantize_layer_weights_int4(q: Quant4LayerWeights) -> LayerWeights:
    """int4-g128 layers → bf16 (tests)."""
    return _dequantized(q, (True,) * 4)


def dequantize_layer_weights_mixed(q: Quant4LayerWeights) -> LayerWeights:
    """Mixed layers (int8 attention, int4 MLP) → bf16 (tests)."""
    return _dequantized(q, (False, False, True, True))


# ── conversion from the JAX package ─────────────────────────────────────────


def to_torch(a, device="cuda") -> torch.Tensor:
    """One array (numpy, or anything `np.asarray` accepts) → tensor, bit-exact.

    bf16 arrives as an ml_dtypes array, which `torch.from_numpy` rejects, so
    it crosses as its uint16 bit pattern."""
    a = np.array(a, copy=True, order="C")   # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


_TUPLES = {cls.__name__: cls for cls in (
    TTSWeights, DecoderWeights, CodePredictorWeights, TextProjectionWeights,
    LayerWeights, RopeTable, QuantLayerWeights, Quant4LayerWeights,
    QuantDecoderWeights, Quant4DecoderWeights)}


def convert_tuple(cls, tree, device="cuda"):
    """Build `cls` from an object with the same field names (a JAX
    NamedTuple of arrays), recursing into nested tuples: each becomes the
    port's tuple of the same class name, so JAX's quantized trees carry
    across as the port's quantized containers (int8 leaves as int8)."""
    out = {}
    for name in cls._fields:
        leaf = getattr(tree, name)
        if leaf is None:
            out[name] = None
        elif hasattr(leaf, "_fields"):
            out[name] = convert_tuple(_TUPLES[type(leaf).__name__], leaf, device)
        else:
            out[name] = to_torch(leaf, device)
    return cls(**out)


def from_jax(tree, device="cuda") -> TTSWeights:
    """The JAX package's `TTSWeights` (bf16/f32/int8 leaves) → the port's."""
    return convert_tuple(TTSWeights, tree, device)

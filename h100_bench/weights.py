"""Seeded weights, made on the device by the benchmark and handed to both sides.

Each model's parameters are one flat buffer drawn with one `normal_` call
of a `torch.Generator` on the device, in the type they are served in
(bf16 for the decoders and the text projection, f32 for Code2Wav), then
cut into views and scaled tensor by tensor: matrices by fan-in ** -0.5,
embeddings as the port's own random init scales them, norm weights
1 + 0.1 N(0, 1) and Snake parameters 0.1 N(0, 1), so a fault that drops a
norm or an activation's parameters changes the result.

`make_*` returns a flat dict `name -> tensor`, which the reference reads,
and `program_*` builds the port's weight structures from the same tensors.
"""

from __future__ import annotations

import math

import torch

from .reference.tts import CODEC_EOS

NORMS = 0.1        # spread of norm weights around 1
SNAKE = 0.1        # spread of Snake alpha / beta around 0


def _decoder_specs(prefix: str, c: dict, heads: bool):
    """(name, shape, kind, scale) of one Qwen3 decoder in the port's layout:
    per-layer tensors stacked `[L, ...]`, matrices `[in, out]`, q|k|v and
    gate|up fused on the output axis."""
    L, H, I = c["num_layers"], c["hidden_size"], c["intermediate_size"]
    D, Q, KV = c["head_dim"], c["num_q_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
    V = c["vocab_size"]
    out = [
        (f"{prefix}.input_norm", (L, H), "norm", None),
        (f"{prefix}.wqkv", (L, H, Q + 2 * KV), "normal", H ** -0.5),
        (f"{prefix}.q_norm", (L, D), "norm", None),
        (f"{prefix}.k_norm", (L, D), "norm", None),
        (f"{prefix}.wo", (L, Q, H), "normal", Q ** -0.5),
        (f"{prefix}.post_norm", (L, H), "norm", None),
        (f"{prefix}.w_gate_up", (L, H, 2 * I), "normal", H ** -0.5),
        (f"{prefix}.w_down", (L, I, H), "normal", I ** -0.5),
        (f"{prefix}.final_norm", (H,), "norm", None),
    ]
    if heads:
        out += [(f"{prefix}.embed", (V, H), "normal", H ** -0.5),
                (f"{prefix}.lm_head", (H, V), "normal", H ** -0.5)]
    return out


def draw(specs, seed: int, device, dtype) -> dict:
    """One buffer for all `specs`, one normal_ draw, then views scaled in
    place. `specs` are (name, shape, kind, scale): kind "normal" (times
    `scale`), "norm" (1 + 0.1 N(0, 1)) or "snake" (0.1 N(0, 1))."""
    sizes = [math.prod(shape) for _n, shape, _k, _s in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(sum(sizes), dtype=dtype, device=device).normal_(generator=gen)
    out, at = {}, 0
    for (name, shape, kind, scale), n in zip(specs, sizes):
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "normal":
            t.mul_(scale)
        elif kind == "norm":
            t.mul_(NORMS).add_(1.0)
        elif kind == "snake":
            t.mul_(SNAKE)
        out[name] = t
    return out


def make_tts(cfg: dict, seed: int, device) -> dict:
    """Talker, code predictor and text projection, bf16, from `seed`."""
    talker, cp, tp = cfg["talker"], cfg["code_predictor"], cfg["text_projection"]
    groups = cfg["num_code_groups"] - 1
    H, V = cp["hidden_size"], cp["vocab_size"]
    th, ts = tp["text_hidden_size"], tp["hidden_size"]
    specs = _decoder_specs("talker", talker, heads=True) + _decoder_specs("cp", cp, heads=False)
    specs += [("cp.lm_heads", (groups, H, V), "normal", H ** -0.5),
              ("cp.codec_embeds", (groups, V, H), "normal", H ** -0.5),
              ("text.embedding", (tp["text_vocab_size"], th), "normal", 0.02),
              ("text.fc1_w", (th, th), "normal", th ** -0.5),
              ("text.fc1_b", (th,), "normal", 0.02),
              ("text.fc2_w", (th, ts), "normal", th ** -0.5),
              ("text.fc2_b", (ts,), "normal", 0.02)]
    w = draw(specs, seed, device, torch.bfloat16)
    # EOS's logit held at 0, below the best of the other codes: every request
    # runs to its frame cap, so each seed asks for the same work (with the
    # column drawn, some seeds' talkers end many requests within a chunk)
    w["talker.lm_head"][:, CODEC_EOS] = 0
    return w


def make_lm(cfg: dict, seed: int, device) -> dict:
    """The text LM, bf16, from `seed`; its head is the embedding (tied)."""
    return draw(_decoder_specs("lm", cfg, heads=False)
                 + [("lm.embed", (cfg["vocab_size"], cfg["hidden_size"]), "normal",
                     cfg["hidden_size"] ** -0.5)], seed, device, torch.bfloat16)


DILATIONS = (1, 3, 9)


def code2wav_specs(c: dict):
    """(name, shape, kind, scale) of Code2Wav in the torch module's layouts:
    linear weights `[in, out]`, conv `[O, I/g, K]`, transposed conv `[I, O, K]`."""
    h, inter, hd = c["hidden_size"], c["intermediate_size"], c["hidden_size"] // c["num_attention_heads"]
    nh, kvh = c["num_attention_heads"], c["num_key_value_heads"]
    out = [("c2w.embed", (c["codebook_size"] * c["num_quantizers"], h), "normal", 0.02)]
    for i in range(c["num_hidden_layers"]):
        p = f"c2w.layers.{i}"
        out += [(f"{p}.wq", (h, nh * hd), "normal", h ** -0.5),
                (f"{p}.wk", (h, kvh * hd), "normal", h ** -0.5),
                (f"{p}.wv", (h, kvh * hd), "normal", h ** -0.5),
                (f"{p}.wo", (nh * hd, h), "normal", (nh * hd) ** -0.5),
                (f"{p}.w_gate", (h, inter), "normal", h ** -0.5),
                (f"{p}.w_up", (h, inter), "normal", h ** -0.5),
                (f"{p}.w_down", (inter, h), "normal", inter ** -0.5),
                (f"{p}.ln1", (h,), "norm", None), (f"{p}.ln2", (h,), "norm", None),
                (f"{p}.scale_attn", (h,), "normal", c["layer_scale_initial_scale"]),
                (f"{p}.scale_mlp", (h,), "normal", c["layer_scale_initial_scale"])]
    out.append(("c2w.final_norm", (h,), "norm", None))

    def conv(p, o, i, k):
        return [(f"{p}.w", (o, i, k), "normal", (i * k) ** -0.5), (f"{p}.b", (o,), "normal", 0.01)]

    def tconv(p, i, o, k):
        return [(f"{p}.w", (i, o, k), "normal", (i * k) ** -0.5), (f"{p}.b", (o,), "normal", 0.01)]

    for i, r in enumerate(c["upsampling_ratios"]):
        p, q = f"c2w.upsample.{i}", f"c2w.upsample.{i}.convnext"
        out += tconv(f"{p}.up", h, h, r) + conv(f"{q}.dw", h, 1, 7)
        out += [(f"{q}.ln_scale", (h,), "norm", None), (f"{q}.ln_bias", (h,), "normal", 0.02),
                (f"{q}.pw1", (h, 4 * h), "normal", h ** -0.5),
                (f"{q}.pw1_b", (4 * h,), "normal", 0.02),
                (f"{q}.pw2", (4 * h, h), "normal", (4 * h) ** -0.5),
                (f"{q}.pw2_b", (h,), "normal", 0.02),
                (f"{q}.gamma", (h,), "normal", 0.1)]
    dd = c["decoder_dim"]
    out += conv("c2w.dec_pre", dd, h, 7)
    for i, rate in enumerate(c["upsample_rates"]):
        p, ci, co = f"c2w.dec_blocks.{i}", dd // 2 ** i, dd // 2 ** (i + 1)
        out += [(f"{p}.alpha", (ci,), "snake", None), (f"{p}.beta", (ci,), "snake", None)]
        out += tconv(f"{p}.up", ci, co, 2 * rate)
        for u in range(len(DILATIONS)):
            q = f"{p}.units.{u}"
            out += [(f"{q}.alpha1", (co,), "snake", None), (f"{q}.beta1", (co,), "snake", None)]
            out += conv(f"{q}.conv1", co, co, 7)
            out += [(f"{q}.alpha2", (co,), "snake", None), (f"{q}.beta2", (co,), "snake", None)]
            out += conv(f"{q}.conv2", co, co, 1)
    od = dd // 2 ** len(c["upsample_rates"])
    out += [("c2w.dec_alpha", (od,), "snake", None), ("c2w.dec_beta", (od,), "snake", None)]
    out += conv("c2w.dec_post", 1, od, 7)
    return out


def make_code2wav(cfg: dict, seed: int, device) -> dict:
    """Code2Wav in f32, the dtype its configuration serves, from `seed`."""
    return draw(code2wav_specs(cfg), seed, device, torch.float32)


# ── the port's structures, built from the same tensors ──────────────────


def _program_decoder(w: dict, prefix: str, dc, device, heads: bool):
    from qwen_tts_tpu_torch.core.weights import DecoderWeights, LayerWeights, make_rope_table

    layers = LayerWeights(*(w[f"{prefix}.{f}"] for f in LayerWeights._fields))
    if heads:
        embed, lm_head = w[f"{prefix}.embed"], w[f"{prefix}.lm_head"]
    else:   # the code predictor's decoder has none; the port keeps zeros
        embed = torch.zeros((dc.vocab_size, dc.hidden_size), dtype=torch.bfloat16, device=device)
        lm_head = torch.zeros((dc.hidden_size, dc.vocab_size), dtype=torch.bfloat16,
                              device=device)
    return DecoderWeights(layers=layers, final_norm=w[f"{prefix}.final_norm"], embed=embed,
                          lm_head=lm_head, rope=make_rope_table(dc, device))


def program_tts(w: dict, model_config, device):
    """`TTSWeights` of the port over the tensors of `make_tts`."""
    from qwen_tts_tpu_torch.core.weights import (
        CodePredictorWeights,
        TextProjectionWeights,
        TTSWeights,
    )

    cp = CodePredictorWeights(
        decoder=_program_decoder(w, "cp", model_config.code_predictor, device, heads=False),
        lm_heads=w["cp.lm_heads"], codec_embeds=w["cp.codec_embeds"])
    text = TextProjectionWeights(text_embedding=w["text.embedding"], fc1_w=w["text.fc1_w"],
                                 fc1_b=w["text.fc1_b"], fc2_w=w["text.fc2_w"],
                                 fc2_b=w["text.fc2_b"])
    return TTSWeights(talker=_program_decoder(w, "talker", model_config.talker, device, True),
                      code_predictor=cp, text_projection=text)


def program_lm(w: dict, dc, device):
    """The port's text-LM `DecoderWeights` (head tied: a contiguous copy of
    the embedding's transpose, the layout the decode-step kernel streams)."""
    from qwen_tts_tpu_torch.core.weights import DecoderWeights, LayerWeights, make_rope_table

    layers = LayerWeights(*(w[f"lm.{f}"] for f in LayerWeights._fields))
    return DecoderWeights(layers=layers, final_norm=w["lm.final_norm"], embed=w["lm.embed"],
                          lm_head=w["lm.embed"].t().contiguous(),
                          rope=make_rope_table(dc, device))


def program_code2wav(w: dict, c2w_config):
    """The port's `Code2WavWeights` over the tensors of `make_code2wav`
    (its dict names are the tree's dotted paths under `c2w.`)."""
    from qwen_tts_tpu_torch.vocoder.code2wav import build_tree, init_code2wav_weights

    return build_tree(init_code2wav_weights(0, c2w_config, "meta"), lambda p: w["c2w." + p])

"""The Code2Wav vocoder: the public Qwen3-Omni codec decoder, in PyTorch.

Port of `qwen_tts_tpu/vocoder/code2wav.py` (itself a port of transformers'
`Qwen3OmniMoeCode2Wav`, modeling_qwen3_omni_moe.py:3209-3763), redefined
here because that module imports jax. Same config, weight layout and math:

  codes [B, Q, T] → offset residual-codebook embedding, mean over Q
  → 8-layer sliding-window causal transformer at the frame rate (GQA
    attention with RoPE, SwiGLU MLP, RMSNorm, LayerScale residuals)
  → ×2 ×2 transposed-conv upsampling, each followed by a ConvNeXt block
  → pre conv, 4 blocks of [SnakeBeta → strided transposed conv → 3
    dilated residual units], SnakeBeta, post conv, clamp to [-1, 1].

Every conv is causal (left-padded); a transposed conv trims (K - stride)
from both sides, so T frames give `output_samples(T)` = T * hop - deficit
samples. Weights keep torch's conv layouts (`[O, I/g, K]`, `[I, O, K]`)
and linear weights are `[in, out]`, as in the JAX package, so
`code2wav_from_jax` converts its trees leaf by leaf. Activations are
`[B, C, T]` and run through `F.conv1d` / `F.conv_transpose1d`;
`code2wav_apply` computes in the weights' dtype (the "reference" form).
The packed numerics are in `code2wav_fast.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.weights import to_torch


@dataclasses.dataclass(frozen=True)
class Code2WavConfig:
    """Defaults of Qwen3OmniMoeCode2WavConfig (configuration_qwen3_omni_moe.py:1095-1117)."""

    codebook_size: int = 2048
    hidden_size: int = 1024
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    sliding_window: int = 72
    intermediate_size: int = 3072
    layer_scale_initial_scale: float = 0.01
    rms_norm_eps: float = 1e-5
    num_hidden_layers: int = 8
    num_quantizers: int = 16
    upsample_rates: tuple[int, ...] = (8, 5, 4, 3)
    upsampling_ratios: tuple[int, ...] = (2, 2)
    decoder_dim: int = 1536
    rope_theta: float = 10000.0
    sample_rate: int = 24000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates + self.upsampling_ratios)

    @property
    def hop_length(self) -> int:
        """Nominal samples per codec frame."""
        return self.total_upsample

    @property
    def output_deficit(self) -> int:
        """What the waveform lacks against T * hop_length, whatever T:
        output_samples(T) = T * hop_length - output_deficit."""
        return self.hop_length - self.output_samples(1)

    def output_samples(self, frames: int) -> int:
        """Waveform samples for `frames` codec frames."""
        t = frames * math.prod(self.upsampling_ratios)
        for r in self.upsample_rates:
            t = t * r - r
        return t


class Conv(NamedTuple):
    w: torch.Tensor  # [O, I/groups, K]
    b: torch.Tensor  # [O]


class TransConv(NamedTuple):
    w: torch.Tensor  # [I, O, K]
    b: torch.Tensor  # [O]


class TransformerLayer(NamedTuple):
    wq: torch.Tensor        # [H, nh*hd]
    wk: torch.Tensor        # [H, kvh*hd]
    wv: torch.Tensor        # [H, kvh*hd]
    wo: torch.Tensor        # [nh*hd, H]
    w_gate: torch.Tensor    # [H, I]
    w_up: torch.Tensor      # [H, I]
    w_down: torch.Tensor    # [I, H]
    ln1: torch.Tensor       # [H] input RMSNorm
    ln2: torch.Tensor       # [H] post-attention RMSNorm
    scale_attn: torch.Tensor  # [H] LayerScale
    scale_mlp: torch.Tensor   # [H]


class ConvNeXtBlock(NamedTuple):
    dw: Conv                # depthwise, k=7, groups=C
    ln_scale: torch.Tensor  # [C] LayerNorm (eps 1e-6)
    ln_bias: torch.Tensor
    pw1: torch.Tensor       # [C, 4C]
    pw1_b: torch.Tensor
    pw2: torch.Tensor       # [4C, C]
    pw2_b: torch.Tensor
    gamma: torch.Tensor     # [C]


class UpsampleStage(NamedTuple):
    up: TransConv           # k = stride = ratio (no trim)
    convnext: ConvNeXtBlock


class ResidualUnit(NamedTuple):
    alpha1: torch.Tensor    # [C] SnakeBeta
    beta1: torch.Tensor
    conv1: Conv             # k=7, dilation d
    alpha2: torch.Tensor
    beta2: torch.Tensor
    conv2: Conv             # k=1


class DecoderBlock(NamedTuple):
    alpha: torch.Tensor     # [in_dim] SnakeBeta
    beta: torch.Tensor
    up: TransConv           # k=2r, stride r: trims r from both sides
    units: tuple            # 3 ResidualUnits at dilations 1, 3, 9


class Code2WavWeights(NamedTuple):
    embed: torch.Tensor     # [codebook_size * Q, H]
    layers: tuple           # num_hidden_layers TransformerLayers
    final_norm: torch.Tensor
    upsample: tuple         # UpsampleStage per upsampling ratio
    dec_pre: Conv           # H → decoder_dim, k=7
    dec_blocks: tuple       # DecoderBlock per upsample rate
    dec_alpha: torch.Tensor
    dec_beta: torch.Tensor
    dec_post: Conv          # → 1 channel, k=7


DILATIONS = (1, 3, 9)

# ── primitives, on [B, C, T] ─────────────────────────────────────────────


def causal_conv(x: torch.Tensor, c: Conv, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Left-pad (K-1)*d, then the conv (Qwen3OmniMoeCausalConvNet at stride 1)."""
    x = F.pad(x, ((c.w.shape[-1] - 1) * dilation, 0))
    return F.conv1d(x, c.w, c.b, dilation=dilation, groups=groups)


def trim(y: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Drop (k - stride) samples from both ends (Qwen3OmniMoeCausalTransConvNet)."""
    t = k - stride
    return y[..., t:y.shape[-1] - t] if t else y


def trans_conv(x: torch.Tensor, c: TransConv, stride: int) -> torch.Tensor:
    return trim(F.conv_transpose1d(x, c.w, c.b, stride=stride), c.w.shape[-1], stride)


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x + 1/(e^beta + 1e-9) * sin^2(x * e^alpha), per channel."""
    a, b = alpha.exp()[:, None], beta.exp()[:, None]
    return x + (1.0 / (b + 1e-9)) * torch.sin(x * a).square()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 statistics, cast back to x's dtype before the scale."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = h.mean(-1, keepdim=True)
    var = h.var(-1, unbiased=False, keepdim=True)
    return (h - mean) * torch.rsqrt(var + 1e-6) * scale + bias


def convnext_block(x: torch.Tensor, blk: ConvNeXtBlock) -> torch.Tensor:
    """Depthwise causal conv → LayerNorm → MLP (exact GELU) → gamma, residual."""
    h = causal_conv(x, blk.dw, groups=x.shape[1]).transpose(1, 2)
    h = layer_norm(h, blk.ln_scale, blk.ln_bias)
    h = F.gelu(h @ blk.pw1 + blk.pw1_b)
    h = blk.gamma * (h @ blk.pw2 + blk.pw2_b)
    return x + h.transpose(1, 2)


def _rope_rows(cfg: Code2WavConfig, t: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                 device=device) / d))
    freqs = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _attention(cfg: Code2WavConfig, lw: TransformerLayer, x: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape
    nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = (x @ lw.wq).view(b, t, nh, hd).transpose(1, 2)
    k = (x @ lw.wk).view(b, t, kvh, hd).transpose(1, 2)
    v = (x @ lw.wv).view(b, t, kvh, hd).transpose(1, 2)
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    if nh != kvh:
        k = k.repeat_interleave(nh // kvh, dim=1)
        v = v.repeat_interleave(nh // kvh, dim=1)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return out.transpose(1, 2).reshape(b, t, nh * hd) @ lw.wo


def transformer(cfg: Code2WavConfig, w: Code2WavWeights, x: torch.Tensor) -> torch.Tensor:
    """The pre-transformer on [B, T, H], in x's dtype (softmax and norm
    statistics in f32), with a causal mask of `sliding_window` positions."""
    t = x.shape[1]
    cos, sin = (r.to(x.dtype) for r in _rope_rows(cfg, t, x.device))
    idx = torch.arange(t, device=x.device)
    mask = (idx[None, :] <= idx[:, None]) & (idx[:, None] - idx[None, :] < cfg.sliding_window)
    for lw in w.layers:
        x = x + lw.scale_attn * _attention(cfg, lw, rms_norm(x, lw.ln1, cfg.rms_norm_eps),
                                           cos, sin, mask)
        h = rms_norm(x, lw.ln2, cfg.rms_norm_eps)
        x = x + lw.scale_mlp * ((F.silu(h @ lw.w_gate) * (h @ lw.w_up)) @ lw.w_down)
    return rms_norm(x, w.final_norm, cfg.rms_norm_eps)


def embed_codes(cfg: Code2WavConfig, embed: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, Q, T] → the codebooks' rows [B, Q, T, H] (each group offset
    into its own codebook)."""
    offset = torch.arange(cfg.num_quantizers, device=codes.device) * cfg.codebook_size
    return embed[codes.long() + offset[None, :, None]]


# ── forward ──────────────────────────────────────────────────────────────


def code2wav_apply(cfg: Code2WavConfig, w: Code2WavWeights, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, Q, T] (each in [0, codebook_size)) → waveform
    [B, output_samples(T)] in [-1, 1], in the weights' dtype
    (Qwen3OmniMoeCode2Wav.forward, modeling_qwen3_omni_moe.py:3738-3750)."""
    h = transformer(cfg, w, embed_codes(cfg, w.embed, codes).mean(dim=1)).transpose(1, 2)
    for stage, ratio in zip(w.upsample, cfg.upsampling_ratios):
        h = convnext_block(trans_conv(h, stage.up, ratio), stage.convnext)
    h = causal_conv(h, w.dec_pre)
    for blk, rate in zip(w.dec_blocks, cfg.upsample_rates):
        h = trans_conv(snake_beta(h, blk.alpha, blk.beta), blk.up, rate)
        for unit, dil in zip(blk.units, DILATIONS):
            r = causal_conv(snake_beta(h, unit.alpha1, unit.beta1), unit.conv1, dilation=dil)
            h = h + causal_conv(snake_beta(r, unit.alpha2, unit.beta2), unit.conv2)
    h = causal_conv(snake_beta(h, w.dec_alpha, w.dec_beta), w.dec_post)
    return h[:, 0].clamp(-1.0, 1.0)


def chunked_decode(cfg: Code2WavConfig, w: Code2WavWeights, codes: torch.Tensor,
                   chunk_size: int = 300, left_context_size: int = 25,
                   apply_fn=None) -> torch.Tensor:
    """Qwen3OmniMoeCode2Wav.chunked_decode (modeling_qwen3_omni_moe.py:3752-3762):
    each chunk decoded with `left_context_size` frames before it, only the
    new samples kept."""
    fn = apply_fn or code2wav_apply
    hop, t = cfg.total_upsample, codes.shape[-1]
    wavs, start = [], 0
    while start < t:
        end = min(start + chunk_size, t)
        ctx = left_context_size if start - left_context_size > 0 else start
        wavs.append(fn(cfg, w, codes[..., start - ctx:end])[..., ctx * hop:])
        start = end
    return torch.cat(wavs, dim=-1)


# ── random init, conversions ─────────────────────────────────────────────


def init_code2wav_weights(seed: int, cfg: Code2WavConfig, device="cuda",
                          dtype=torch.float32) -> Code2WavWeights:
    """Random weights of the torch module's shapes (fan-in normal
    matrices, zero biases and Snake parameters), drawn on `device`
    ("meta" gives the shapes alone)."""
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device)
    gen.manual_seed(seed)

    def mat(shape, scale=None):
        s = scale if scale is not None else shape[0] ** -0.5
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

    def full(n, v):
        return torch.full((n,), v, dtype=dtype, device=device)

    def conv(o, i, k):
        return Conv(mat((o, i, k), (i * k) ** -0.5), full(o, 0.0))

    def tconv(i, o, k):
        return TransConv(mat((i, o, k), (i * k) ** -0.5), full(o, 0.0))

    h, inter = cfg.hidden_size, cfg.intermediate_size
    nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    ls = cfg.layer_scale_initial_scale

    def layer():
        return TransformerLayer(
            wq=mat((h, nh * hd)), wk=mat((h, kvh * hd)), wv=mat((h, kvh * hd)),
            wo=mat((nh * hd, h)), w_gate=mat((h, inter)), w_up=mat((h, inter)),
            w_down=mat((inter, h)), ln1=full(h, 1.0), ln2=full(h, 1.0),
            scale_attn=full(h, ls), scale_mlp=full(h, ls))

    def convnext(c):
        return ConvNeXtBlock(dw=conv(c, 1, 7), ln_scale=full(c, 1.0), ln_bias=full(c, 0.0),
                             pw1=mat((c, 4 * c)), pw1_b=full(4 * c, 0.0), pw2=mat((4 * c, c)),
                             pw2_b=full(c, 0.0), gamma=full(c, 1e-6))

    def unit(c):
        return ResidualUnit(alpha1=full(c, 0.0), beta1=full(c, 0.0), conv1=conv(c, c, 7),
                            alpha2=full(c, 0.0), beta2=full(c, 0.0), conv2=conv(c, c, 1))

    blocks = []
    for i, rate in enumerate(cfg.upsample_rates):
        i_dim, o_dim = cfg.decoder_dim // 2 ** i, cfg.decoder_dim // 2 ** (i + 1)
        blocks.append(DecoderBlock(alpha=full(i_dim, 0.0), beta=full(i_dim, 0.0),
                                   up=tconv(i_dim, o_dim, 2 * rate),
                                   units=tuple(unit(o_dim) for _ in DILATIONS)))
    out_dim = cfg.decoder_dim // 2 ** len(cfg.upsample_rates)
    return Code2WavWeights(
        embed=mat((cfg.codebook_size * cfg.num_quantizers, h), 0.02),
        layers=tuple(layer() for _ in range(cfg.num_hidden_layers)),
        final_norm=full(h, 1.0),
        upsample=tuple(UpsampleStage(up=tconv(h, h, r), convnext=convnext(h))
                       for r in cfg.upsampling_ratios),
        dec_pre=conv(cfg.decoder_dim, h, 7),
        dec_blocks=tuple(blocks),
        dec_alpha=full(out_dim, 0.0), dec_beta=full(out_dim, 0.0),
        dec_post=conv(1, out_dim, 7))


def _layer_keys(i: int) -> dict[str, tuple[str, bool]]:
    """TransformerLayer field → (torch key of layer i, stored transposed)."""
    p = f"pre_transformer.layers.{i}"
    return {"wq": (f"{p}.self_attn.q_proj.weight", True),
            "wk": (f"{p}.self_attn.k_proj.weight", True),
            "wv": (f"{p}.self_attn.v_proj.weight", True),
            "wo": (f"{p}.self_attn.o_proj.weight", True),
            "w_gate": (f"{p}.mlp.gate_proj.weight", True),
            "w_up": (f"{p}.mlp.up_proj.weight", True),
            "w_down": (f"{p}.mlp.down_proj.weight", True),
            "ln1": (f"{p}.input_layernorm.weight", False),
            "ln2": (f"{p}.post_attention_layernorm.weight", False),
            "scale_attn": (f"{p}.self_attn_layer_scale.scale", False),
            "scale_mlp": (f"{p}.mlp_layer_scale.scale", False)}


def _key_map(cfg: Code2WavConfig) -> dict[str, tuple[str, bool]]:
    """Every leaf of `Code2WavWeights` by dotted path (field names, tuple
    indices) → (the torch module's state_dict key, stored transposed),
    after modeling_qwen3_omni_moe.py:3704-3736."""
    out = {"embed": ("code_embedding.weight", False),
           "final_norm": ("pre_transformer.norm.weight", False)}
    for i in range(cfg.num_hidden_layers):
        out.update({f"layers.{i}.{f}": v for f, v in _layer_keys(i).items()})

    def conv(path, prefix):
        out[f"{path}.w"] = (f"{prefix}.conv.weight", False)
        out[f"{path}.b"] = (f"{prefix}.conv.bias", False)

    for i in range(len(cfg.upsampling_ratios)):
        conv(f"upsample.{i}.up", f"upsample.{i}.0")
        p, q = f"upsample.{i}.convnext", f"upsample.{i}.1"
        conv(f"{p}.dw", f"{q}.dwconv")
        out.update({f"{p}.ln_scale": (f"{q}.norm.weight", False),
                    f"{p}.ln_bias": (f"{q}.norm.bias", False),
                    f"{p}.pw1": (f"{q}.pwconv1.weight", True),
                    f"{p}.pw1_b": (f"{q}.pwconv1.bias", False),
                    f"{p}.pw2": (f"{q}.pwconv2.weight", True),
                    f"{p}.pw2_b": (f"{q}.pwconv2.bias", False),
                    f"{p}.gamma": (f"{q}.gamma", False)})
    conv("dec_pre", "decoder.0")
    n = len(cfg.upsample_rates)
    for i in range(n):
        p, q = f"dec_blocks.{i}", f"decoder.{1 + i}.block"
        out[f"{p}.alpha"], out[f"{p}.beta"] = (f"{q}.0.alpha", False), (f"{q}.0.beta", False)
        conv(f"{p}.up", f"{q}.1")
        for u in range(len(DILATIONS)):
            pu, qu = f"{p}.units.{u}", f"{q}.{2 + u}"
            for a in ("1", "2"):
                out[f"{pu}.alpha{a}"] = (f"{qu}.act{a}.alpha", False)
                out[f"{pu}.beta{a}"] = (f"{qu}.act{a}.beta", False)
                conv(f"{pu}.conv{a}", f"{qu}.conv{a}")
    out["dec_alpha"], out["dec_beta"] = (f"decoder.{1 + n}.alpha", False), (
        f"decoder.{1 + n}.beta", False)
    conv("dec_post", f"decoder.{2 + n}")
    return out


def named_leaves(tree, prefix=""):
    """(dotted path, leaf) of every tensor of a weights tree, in field order."""
    if isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
        return
    for n, sub in (tree._asdict().items() if hasattr(tree, "_fields") else enumerate(tree)):
        yield from named_leaves(sub, f"{prefix}{n}.")


def build_tree(template, leaf, prefix=""):
    """A tree shaped like `template` whose leaves are `leaf(dotted path)`."""
    if isinstance(template, torch.Tensor):
        return leaf(prefix[:-1])
    if hasattr(template, "_fields"):
        return type(template)(*(build_tree(getattr(template, n), leaf, f"{prefix}{n}.")
                                for n in template._fields))
    return tuple(build_tree(t, leaf, f"{prefix}{i}.") for i, t in enumerate(template))


def convert_code2wav_state(state, cfg: Code2WavConfig, device="cuda",
                           dtype=torch.float32) -> Code2WavWeights:
    """A torch `Qwen3OmniMoeCode2Wav` state_dict (tensors or numpy arrays by
    key) → `Code2WavWeights` on `device`: linear weights transposed to
    `[in, out]`, conv weights as they are. A missing key raises KeyError."""
    keys = _key_map(cfg)

    def leaf(path):
        key, transpose = keys[path]
        t = state[key]
        t = (t.detach() if isinstance(t, torch.Tensor) else to_torch(t, "cpu")).to(device)
        return (t.t() if transpose else t).to(dtype=dtype, copy=True).contiguous()

    return build_tree(init_code2wav_weights(0, cfg, "meta"), leaf)


def code2wav_state(w: Code2WavWeights, cfg: Code2WavConfig) -> dict[str, torch.Tensor]:
    """`Code2WavWeights` → the torch module's state_dict (its key names and
    layouts): what `convert_code2wav_state` reads."""
    keys = _key_map(cfg)
    out = {}
    for path, t in named_leaves(w):
        key, transpose = keys[path]
        out[key] = t.t() if transpose else t
    return out


_CLASSES = {c.__name__: c for c in (Conv, TransConv, TransformerLayer, ConvNeXtBlock,
                                    UpsampleStage, ResidualUnit, DecoderBlock, Code2WavWeights)}


def code2wav_from_jax(tree, device="cuda"):
    """The JAX package's `Code2WavWeights` → the port's, leaf by leaf."""
    if hasattr(tree, "_fields"):
        cls = _CLASSES[type(tree).__name__]
        return cls(*(code2wav_from_jax(getattr(tree, n), device) for n in cls._fields))
    if isinstance(tree, tuple):
        return tuple(code2wav_from_jax(t, device) for t in tree)
    return to_torch(tree, device)

"""Code2Wav with the packed numerics of `qwen_tts_tpu/vocoder/code2wav_fast.py`.

The same network as `code2wav.code2wav_apply`, with JAX's "packed" rules
of precision: matrices (linear and conv weights, the codebooks) in the
packing dtype (bf16, or f32), biases, norm scales, the depthwise convs and
the Snake parameters in f32; norm statistics, Snake and the depthwise conv
computed in f32; each product's bias added in f32, and the activation cast
back to the matrix dtype after each op (JAX `code2wav_fast.py:18-21`,
`:134-202`, `:275-302`). The pre-transformer takes its layers in the
matrix dtype, as JAX's reuses `_transformer` on them.

JAX re-expresses the transposed convs as phase matmuls and the k-tap convs
as unfold + matmul: a layout for the TPU's matrix unit, not semantics. Here
the convs stay `F.conv1d` / `F.conv_transpose1d` on `[B, C, T]` (cuDNN on
the GPU), with the bias added after the product in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .code2wav import (
    DILATIONS,
    Code2WavConfig,
    Code2WavWeights,
    Conv,
    ConvNeXtBlock,
    DecoderBlock,
    ResidualUnit,
    TransConv,
    TransformerLayer,
    UpsampleStage,
    embed_codes,
    layer_norm,
    transformer,
    trim,
)


def pack_code2wav_weights(w: Code2WavWeights, dtype=torch.bfloat16) -> Code2WavWeights:
    """Cast to the packed form: matrices to `dtype`, everything else f32.
    Casting a packed tree again changes nothing."""
    f32 = torch.float32

    def conv(c, cls=Conv):
        return cls(c.w.to(dtype), c.b.to(f32))

    def convnext(b: ConvNeXtBlock):
        return ConvNeXtBlock(Conv(b.dw.w.to(f32), b.dw.b.to(f32)), b.ln_scale.to(f32),
                             b.ln_bias.to(f32), b.pw1.to(dtype), b.pw1_b.to(f32),
                             b.pw2.to(dtype), b.pw2_b.to(f32), b.gamma.to(f32))

    def unit(u: ResidualUnit):
        return ResidualUnit(u.alpha1.to(f32), u.beta1.to(f32), conv(u.conv1),
                            u.alpha2.to(f32), u.beta2.to(f32), conv(u.conv2))

    return Code2WavWeights(
        embed=w.embed.to(dtype),
        layers=tuple(TransformerLayer(*(x.to(dtype) for x in lw)) for lw in w.layers),
        final_norm=w.final_norm.to(dtype),
        upsample=tuple(UpsampleStage(conv(s.up, TransConv), convnext(s.convnext))
                       for s in w.upsample),
        dec_pre=conv(w.dec_pre),
        dec_blocks=tuple(DecoderBlock(b.alpha.to(f32), b.beta.to(f32), conv(b.up, TransConv),
                                      tuple(unit(u) for u in b.units)) for b in w.dec_blocks),
        dec_alpha=w.dec_alpha.to(f32), dec_beta=w.dec_beta.to(f32),
        dec_post=conv(w.dec_post))


def _conv(x: torch.Tensor, c: Conv, dilation: int = 1) -> torch.Tensor:
    """Causal conv in the matrix dtype; returns f32 with the bias added."""
    x = F.pad(x, ((c.w.shape[-1] - 1) * dilation, 0))
    return F.conv1d(x, c.w, dilation=dilation).float() + c.b[:, None]


def _tconv(x: torch.Tensor, c: TransConv, stride: int) -> torch.Tensor:
    """Trimmed transposed conv in the matrix dtype; returns f32 with the bias."""
    y = trim(F.conv_transpose1d(x, c.w, stride=stride), c.w.shape[-1], stride)
    return y.float() + c.b[:, None]


def _snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta in f32, cast back to x's dtype."""
    xf = x.float()
    b = 1.0 / (beta.exp()[:, None] + 1e-9)
    return (xf + b * torch.sin(xf * alpha.exp()[:, None]).square()).to(x.dtype)


def _convnext(x: torch.Tensor, c: ConvNeXtBlock) -> torch.Tensor:
    """ConvNeXt block: depthwise conv and LayerNorm in f32, products in the
    matrix dtype with f32 biases and GELU."""
    dt = x.dtype
    h = F.conv1d(F.pad(x.float(), (c.dw.w.shape[-1] - 1, 0)), c.dw.w, c.dw.b,
                 groups=x.shape[1]).transpose(1, 2)
    h = layer_norm(h, c.ln_scale, c.ln_bias).to(dt)
    h = F.gelu((h @ c.pw1).float() + c.pw1_b).to(dt)
    h = (h @ c.pw2).float() + c.pw2_b
    return x + (c.gamma * h).to(dt).transpose(1, 2)


def code2wav_apply_packed(cfg: Code2WavConfig, pw: Code2WavWeights,
                          codes: torch.Tensor) -> torch.Tensor:
    """codes [B, Q, T] → waveform [B, output_samples(T)] f32 in [-1, 1];
    activations in the packed matrix dtype."""
    dt = pw.embed.dtype
    h = embed_codes(cfg, pw.embed, codes).float().mean(dim=1).to(dt)
    h = transformer(cfg, pw, h).transpose(1, 2)
    for stage, ratio in zip(pw.upsample, cfg.upsampling_ratios):
        h = _convnext(_tconv(h, stage.up, ratio).to(dt), stage.convnext)
    h = _conv(h, pw.dec_pre).to(dt)
    for blk, rate in zip(pw.dec_blocks, cfg.upsample_rates):
        h = _tconv(_snake(h, blk.alpha, blk.beta), blk.up, rate).to(dt)
        for unit, dil in zip(blk.units, DILATIONS):
            r = _conv(_snake(h, unit.alpha1, unit.beta1), unit.conv1, dil).to(dt)
            h = h + _conv(_snake(r, unit.alpha2, unit.beta2), unit.conv2).to(dt)
    y = _conv(_snake(h, pw.dec_alpha, pw.dec_beta), pw.dec_post)
    return y[:, 0].clamp(-1.0, 1.0)

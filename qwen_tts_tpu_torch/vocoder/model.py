"""The "fast" vocoder: 16-group codec frames @12.5 Hz → 24 kHz PCM.

Port of `qwen_tts_tpu/vocoder/model.py` (redefined here because that module
imports jax). Same config, weight layout and math: summed per-group code
embeddings → ConvNeXt pre-net → transposed-conv upsampling stages with
residual conv blocks → final conv + tanh, all f32.

Layout: the public functions keep JAX's `[T, C]` activations and its kernel
layouts (`[K, C_in/groups, C_out]` for convs, `[K, C_out, C_in]` for the
transposed convs); convolutions permute to torch's `[N, C, T]` inside.
Two JAX conventions have to be reproduced by hand:
- `jax.nn.gelu` defaults to the tanh approximation;
- `lax.conv_transpose(padding="SAME")` does not flip the kernel and pads
  the zero-inserted input by `_conv_transpose_padding`, so it is written as
  zero insertion + explicit padding + a plain correlation (`F.conv1d`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.weights import convert_tuple, to_torch


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    num_code_groups: int = 16
    codebook_size: int = 2048
    dim: int = 512
    prenet_blocks: int = 4
    upsample_factors: tuple[int, ...] = (8, 6, 5, 4, 2)   # prod = 1920 = 24000/12.5
    upsample_kernels: tuple[int, ...] = (16, 12, 10, 8, 4)
    resblock_kernel: int = 7
    sample_rate: int = 24000

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsample_factors)


class ConvNeXtBlock(NamedTuple):
    dw_kernel: torch.Tensor    # [K, 1, D] depthwise
    norm_scale: torch.Tensor   # [D]
    norm_bias: torch.Tensor    # [D]
    pw1: torch.Tensor          # [D, 4D]
    pw1_b: torch.Tensor        # [4D]
    pw2: torch.Tensor          # [4D, D]
    pw2_b: torch.Tensor        # [D]


class UpsampleStage(NamedTuple):
    ct_kernel: torch.Tensor    # [K, Cout, Cin] conv_transpose kernel
    ct_bias: torch.Tensor      # [Cout]
    res1: torch.Tensor         # [K, Cout, Cout]
    res1_b: torch.Tensor
    res2: torch.Tensor         # [K, Cout, Cout]
    res2_b: torch.Tensor


class VocoderWeights(NamedTuple):
    code_embeds: torch.Tensor            # [G, codebook, D]
    prenet: tuple[ConvNeXtBlock, ...]
    stages: tuple[UpsampleStage, ...]
    out_kernel: torch.Tensor             # [K, C_last, 1]
    out_bias: torch.Tensor               # [1]


def init_vocoder_weights(seed: int, cfg: VocoderConfig, device="cuda") -> VocoderWeights:
    """Seeded random weights on `device` ("meta" gives the shapes alone)."""
    gen = torch.Generator(device="cpu" if torch.device(device).type == "meta" else device)
    gen.manual_seed(seed)

    def mat(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)

    def zeros(n):
        return torch.zeros(n, device=device)

    d = cfg.dim
    prenet = tuple(
        ConvNeXtBlock(dw_kernel=mat((7, 1, d), 7), norm_scale=torch.ones(d, device=device),
                      norm_bias=zeros(d), pw1=mat((d, 4 * d), d), pw1_b=zeros(4 * d),
                      pw2=mat((4 * d, d), 4 * d), pw2_b=zeros(d))
        for _ in range(cfg.prenet_blocks))
    stages, c_in = [], d
    for f, k in zip(cfg.upsample_factors, cfg.upsample_kernels):
        c_out, rk = max(c_in // 2, 16), cfg.resblock_kernel
        stages.append(UpsampleStage(
            ct_kernel=mat((k, c_out, c_in), c_in * k // f), ct_bias=zeros(c_out),
            res1=mat((rk, c_out, c_out), c_out * rk), res1_b=zeros(c_out),
            res2=mat((rk, c_out, c_out), c_out * rk), res2_b=zeros(c_out)))
        c_in = c_out
    return VocoderWeights(
        code_embeds=mat((cfg.num_code_groups, cfg.codebook_size, d), d),
        prenet=prenet, stages=tuple(stages),
        out_kernel=mat((7, c_in, 1), c_in * 7), out_bias=zeros(1))


def vocoder_from_jax(tree, device="cuda") -> VocoderWeights:
    """The JAX package's `VocoderWeights` (f32 leaves) → the port's."""
    return VocoderWeights(
        code_embeds=to_torch(tree.code_embeds, device),
        prenet=tuple(convert_tuple(ConvNeXtBlock, b, device) for b in tree.prenet),
        stages=tuple(convert_tuple(UpsampleStage, s, device) for s in tree.stages),
        out_kernel=to_torch(tree.out_kernel, device),
        out_bias=to_torch(tree.out_bias, device))


def _layer_norm(x, scale, bias, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | float,
            groups: int = 1) -> torch.Tensor:
    """x [T, C_in], kernel [K, C_in//groups, C_out] → [T, C_out], SAME padding
    ((K-1)//2 on the left, as XLA pads)."""
    K = kernel.shape[0]
    left = (K - 1) // 2
    xt = F.pad(x.t()[None], (left, K - 1 - left))
    out = F.conv1d(xt, kernel.permute(2, 1, 0), groups=groups)
    return out[0].t() + bias


def _conv_transpose1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      stride: int) -> torch.Tensor:
    """x [T, C_in], kernel [K, C_out, C_in] → [T*stride, C_out]: JAX's
    `conv_transpose(padding="SAME")` — stride-dilated input, padded by
    (pad_a, pad_b) from `jax._src.lax.convolution._conv_transpose_padding`,
    correlated with the unflipped kernel."""
    T, c_in = x.shape
    K = kernel.shape[0]
    pad_len = K + stride - 2
    pad_a = K - 1 if stride > K - 1 else math.ceil(pad_len / 2)
    xd = x.new_zeros((1, c_in, (T - 1) * stride + 1))
    xd[0, :, ::stride] = x.t()
    xd = F.pad(xd, (pad_a, pad_len - pad_a))
    out = F.conv1d(xd, kernel.permute(1, 2, 0))
    return out[0].t() + bias


def _convnext_block(x: torch.Tensor, b: ConvNeXtBlock) -> torch.Tensor:
    h = _conv1d(x, b.dw_kernel, 0.0, groups=x.shape[-1])
    h = _layer_norm(h, b.norm_scale, b.norm_bias)
    h = F.gelu(h @ b.pw1 + b.pw1_b, approximate="tanh")
    return x + (h @ b.pw2 + b.pw2_b)


def vocoder_decode(cfg: VocoderConfig, w: VocoderWeights, codes: torch.Tensor) -> torch.Tensor:
    """codes [T, 16] int → waveform [T * hop_length] f32 in [-1, 1].

    Group 0 carries talker tokens (vocab 3072, special ids included);
    codes past the codebook are clamped to its last row, as JAX's gather
    does."""
    groups = torch.arange(cfg.num_code_groups, device=codes.device)[:, None]
    idx = codes.t().long().clamp(0, cfg.codebook_size - 1)
    x = w.code_embeds[groups, idx].sum(dim=0)                         # [T, D]
    for blk in w.prenet:
        x = _convnext_block(x, blk)
    for stage, f in zip(w.stages, cfg.upsample_factors):
        x = _conv_transpose1d(F.leaky_relu(x, 0.1), stage.ct_kernel, stage.ct_bias, f)
        r = _conv1d(F.leaky_relu(x, 0.1), stage.res1, stage.res1_b)
        r = _conv1d(F.leaky_relu(r, 0.1), stage.res2, stage.res2_b)
        x = x + r
    x = _conv1d(F.leaky_relu(x, 0.1), w.out_kernel, w.out_bias)
    return torch.tanh(x[:, 0])

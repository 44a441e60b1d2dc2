"""Plain float32 Code2Wav, the Qwen3-Omni codec decoder, and its streaming rule.

Written from the published module (transformers' `Qwen3OmniMoeCode2Wav`):
codes `[16, T]` → mean of the 16 offset codebook embeddings → an
8-layer causal transformer with a sliding window (RMSNorm, rotary
attention, SwiGLU, LayerScale) → two transposed-conv ×2 upsamplings, each
followed by a ConvNeXt block → a causal conv to the decoder width → four
blocks of [SnakeBeta → transposed conv (kernel 2r, stride r, r trimmed
from both ends) → three dilated residual units] → SnakeBeta → causal conv
to one channel → clamp to [-1, 1]. Every conv is causal, so the first t
frames' samples do not depend on later frames.

Streaming: a request's audio arrives in chunks; chunk j holds k_j frames
and is decoded after the codes of chunk j - 1 as left context, keeping
the k_j * hop samples that follow the context's (the first chunk: after
`deficit` samples of silence, the decoder's shortfall of T * hop).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DILATIONS = (1, 3, 9)


def hop(c: dict) -> int:
    return math.prod(c["upsample_rates"]) * math.prod(c["upsampling_ratios"])


def samples(c: dict, frames: int) -> int:
    t = frames * math.prod(c["upsampling_ratios"])
    for r in c["upsample_rates"]:
        t = t * r - r
    return t


def deficit(c: dict) -> int:
    return hop(c) - samples(c, 1)


def _causal(x, w, p, dilation=1, groups=1):
    k = w[p + ".w"].shape[-1]
    return F.conv1d(F.pad(x, ((k - 1) * dilation, 0)), w[p + ".w"], w[p + ".b"],
                    dilation=dilation, groups=groups)


def _up(x, w, p, stride):
    y = F.conv_transpose1d(x, w[p + ".w"], w[p + ".b"], stride=stride)
    t = w[p + ".w"].shape[-1] - stride
    return y[..., t:y.shape[-1] - t] if t else y


def _snake(x, a, b):
    return x + torch.sin(x * a.exp()[:, None]).square() / (b.exp()[:, None] + 1e-9)


def _rms(x, s, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * s


def _transformer(c: dict, w: dict, x: torch.Tensor) -> torch.Tensor:
    T, H = x.shape
    nh, kvh = c["num_attention_heads"], c["num_key_value_heads"]
    hd, eps = H // nh, c["rms_norm_eps"]
    inv = 1.0 / c["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                 device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float(), ang.sin().float()
    i = torch.arange(T, device=x.device)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < c["sliding_window"])

    def rot(t):
        a, b = t[..., :hd // 2], t[..., hd // 2:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    for li in range(c["num_hidden_layers"]):
        p = f"c2w.layers.{li}."
        h = _rms(x, w[p + "ln1"], eps)
        q = rot((h @ w[p + "wq"]).view(T, nh, hd).transpose(0, 1))
        k = rot((h @ w[p + "wk"]).view(T, kvh, hd).transpose(0, 1)).repeat_interleave(nh // kvh, 0)
        v = (h @ w[p + "wv"]).view(T, kvh, hd).transpose(0, 1).repeat_interleave(nh // kvh, 0)
        s = (q @ k.transpose(-1, -2)) / hd ** 0.5
        a = (torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v).transpose(0, 1)
        x = x + w[p + "scale_attn"] * (a.reshape(T, nh * hd) @ w[p + "wo"])
        h = _rms(x, w[p + "ln2"], eps)
        x = x + w[p + "scale_mlp"] * ((F.silu(h @ w[p + "w_gate"]) * (h @ w[p + "w_up"]))
                                      @ w[p + "w_down"])
    return _rms(x, w["c2w.final_norm"], eps)


def decode(c: dict, w: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes `[T, 16]` (clamped to the codebooks) → `samples(T)` f32."""
    w = {k: v.float() for k, v in w.items() if k.startswith("c2w.")}
    cb, nq = c["codebook_size"], c["num_quantizers"]
    codes = codes.long().clamp(0, cb - 1)
    off = torch.arange(nq, device=codes.device) * cb
    x = w["c2w.embed"][codes + off[None, :]].mean(1)             # [T, H]
    h = _transformer(c, w, x).t()[None]                            # [1, H, T]
    for i, r in enumerate(c["upsampling_ratios"]):
        p = f"c2w.upsample.{i}"
        h = _up(h, w, p + ".up", r)
        q = p + ".convnext"
        y = _causal(h, w, q + ".dw", groups=h.shape[1]).transpose(1, 2)
        y = F.layer_norm(y, (y.shape[-1],), w[q + ".ln_scale"], w[q + ".ln_bias"], 1e-6)
        y = F.gelu(y @ w[q + ".pw1"] + w[q + ".pw1_b"]) @ w[q + ".pw2"] + w[q + ".pw2_b"]
        h = h + (w[q + ".gamma"] * y).transpose(1, 2)
    h = _causal(h, w, "c2w.dec_pre")
    for i, r in enumerate(c["upsample_rates"]):
        p = f"c2w.dec_blocks.{i}"
        h = _up(_snake(h, w[p + ".alpha"], w[p + ".beta"]), w, p + ".up", r)
        for u, d in enumerate(DILATIONS):
            q = f"{p}.units.{u}"
            y = _causal(_snake(h, w[q + ".alpha1"], w[q + ".beta1"]), w, q + ".conv1", dilation=d)
            h = h + _causal(_snake(y, w[q + ".alpha2"], w[q + ".beta2"]), w, q + ".conv2")
    h = _causal(_snake(h, w["c2w.dec_alpha"], w["c2w.dec_beta"]), w, "c2w.dec_post")
    return h[0, 0].clamp(-1.0, 1.0)


def stream_audio(c: dict, w: dict, codes: torch.Tensor, chunk_frames: list[int]) -> torch.Tensor:
    """A request's streamed audio from its codes `[F, 16]` cut into chunks
    of `chunk_frames` frames (summing to F), each after the one before."""
    hp, df = hop(c), deficit(c)
    out, at, prev = [], 0, None
    for k in chunk_frames:
        cur = codes[at:at + k]
        if prev is None:
            wav = F.pad(decode(c, w, cur), (df, 0))[:k * hp]
        else:
            off = prev.shape[0] * hp - df
            wav = decode(c, w, torch.cat([prev, cur]))[off:off + k * hp]
        out.append(wav)
        prev, at = cur, at + k
    return torch.cat(out)

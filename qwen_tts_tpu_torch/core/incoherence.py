"""Incoherence processing — the port of `qwen_tts_tpu/core/incoherence.py`:
fold random orthogonal rotations into the weights so that group-wise
low-bit quantization sees gaussian-like matrices, at no cost at inference.

Heavy tails and outlier channels inflate each g=128 group's absmax scale;
multiplying a weight matrix by a random orthogonal Q mixes every entry into
sums of ~H random-sign terms (QuaRot / QuIP). The two folds are exact in
this architecture (the folded model is the same function, up to the bf16
rounding of the folded weights):

1. **Residual-stream rotation** Q `[H, H]` (a randomized Hadamard). RMSNorm
   with gamma = 1 commutes with an orthogonal Q, so once each norm's gamma
   is folded into the matrix it feeds, the residual basis can be rotated:

     embed      -> embed @ Q
     wqkv       -> Q^T @ (diag(gamma_in) wqkv)
     wo         -> wo @ Q
     w_gate_up  -> Q^T @ (diag(gamma_post) w_gate_up)
     w_down     -> w_down @ Q
     lm_head    -> Q^T @ (diag(gamma_final) lm_head)
     the folded norms' weights -> 1

   Rope and q_norm / k_norm act in head space and are untouched.

2. **V/O head rotation** R `[D, D]`, shared by all heads. The value path
   has no rope and no norm between wqkv's v columns and wo's input, so each
   kv head's v columns turn by R and each q head's rows of wo by R^T (every
   q head of a GQA group reads its group's v, so one shared R keeps the fold
   exact). It gaussianizes wo's input axis, where int4's group scales
   live, which fold 1 cannot reach.

The folds are exact for a decoder fed token ids through `w.embed`, as
`benchmarks/exp_weight_stats.py` uses them. The TTS talker also takes rows
of the text projection and codec sums that do not pass through its embed,
so the engine does not fold its weights (nor does the JAX package's).

JAX draws Q's and R's signs from the two halves of a split key; the port
has no JAX keys and takes the numpy seed words of each instead (the words
of `jax.random.split(key)` give JAX's exact Q and R).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .config import DecoderConfig
from .weights import DecoderWeights, LayerWeights


def random_orthogonal(seed_words: Sequence[int], n: int) -> np.ndarray:
    """Randomized-Hadamard orthogonal matrix Q = H_n·D/sqrt(n) (n a power
    of two), else a QR-based random orthogonal; f32 numpy, from a numpy
    generator seeded by `seed_words` (uint32 words)."""
    rng = np.random.default_rng([int(x) for x in seed_words])
    if n & (n - 1) == 0:
        h = np.array([[1.0]], np.float32)
        while h.shape[0] < n:
            h = np.block([[h, h], [h, -h]])
        d = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
        return (h * d[None, :]) / np.sqrt(np.float32(n))
    q, r = np.linalg.qr(rng.standard_normal((n, n)).astype(np.float64))
    return (q * np.sign(np.diag(r))[None, :]).astype(np.float32)


def _fold_in(q: torch.Tensor, gamma: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[L, H, out] -> Q^T @ (diag(gamma_l) @ W_l) per layer, in f32;
    contiguous, as the kernels read it."""
    wf = w.float() * gamma.float()[:, :, None]
    return torch.einsum("ij,lio->ljo", q, wf).to(w.dtype).contiguous()


def _fold_out(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[L, in, H] -> W_l @ Q per layer, in f32."""
    return torch.einsum("lio,oj->lij", w.float(), q).to(w.dtype).contiguous()


def incoherent_decoder_weights(w: DecoderWeights, cfg: DecoderConfig,
                               q_seed: Sequence[int], r_seed: Sequence[int],
                               rotate_vo: bool = True) -> DecoderWeights:
    """The same function's weights with the folds applied (module
    docstring): Q from `q_seed`, R from `r_seed` (used when `rotate_vo`).
    Computed in f32 on the weights' device, returned in their dtypes; every
    folded norm's weights are ones."""
    lw = w.layers
    dev = w.embed.device
    H = w.embed.shape[-1]
    Q = torch.from_numpy(random_orthogonal(q_seed, H)).to(dev)
    wqkv, wo = lw.wqkv, lw.wo
    if rotate_vo:
        D, nq, nkv = cfg.head_dim, cfg.num_q_heads, cfg.num_kv_heads
        R = torch.from_numpy(random_orthogonal(r_seed, D)).to(dev)
        L, v0 = wqkv.shape[0], (nq + nkv) * D          # fused layout: [q | k | v]
        wqkv_f = wqkv.float()
        v = torch.einsum("lhnd,de->lhne", wqkv_f[:, :, v0:].reshape(L, H, nkv, D), R)
        wqkv = torch.cat([wqkv_f[:, :, :v0], v.reshape(L, H, nkv * D)], dim=-1).to(lw.wqkv.dtype)
        wo_f = torch.einsum("ed,lndh->lneh", R.T, wo.float().reshape(L, nq, D, H))
        wo = wo_f.reshape(L, nq * D, H).to(lw.wo.dtype)
    layers = LayerWeights(
        input_norm=torch.ones_like(lw.input_norm),
        wqkv=_fold_in(Q, lw.input_norm, wqkv),
        q_norm=lw.q_norm, k_norm=lw.k_norm,
        wo=_fold_out(wo, Q),
        post_norm=torch.ones_like(lw.post_norm),
        w_gate_up=_fold_in(Q, lw.post_norm, lw.w_gate_up),
        w_down=_fold_out(lw.w_down, Q))
    return w._replace(layers=layers, embed=(w.embed.float() @ Q).to(w.embed.dtype),
                      final_norm=torch.ones_like(w.final_norm),
                      lm_head=_fold_in(Q, w.final_norm[None], w.lm_head[None])[0])

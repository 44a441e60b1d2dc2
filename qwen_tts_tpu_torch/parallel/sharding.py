"""Sharding rules — the port of `qwen_tts_tpu/parallel/sharding.py`: how the
decoder maps onto a (dp, tp) mesh (`parallel/mesh.py`).

JAX places whole arrays with `PartitionSpec`s and lets XLA move data; here
each rank holds only its own shard, and `shard_decoder_weights` /
`shard_cp_weights` return it. Tensor rank r of T holds

- KV groups [r*KVH/T, (r+1)*KVH/T): the `wqkv` columns of those groups' q
  heads, k heads and v heads (fused again as q | k | v), and the matching
  rows of `wo`;
- columns [r*I/T, (r+1)*I/T) of gate and the same columns of up, still
  paired as gate | up in `w_gate_up`, and the matching rows of `w_down`;
- vocab columns [r*V/T, (r+1)*V/T) of `lm_head` (the code predictor's
  `lm_heads` are cut on their vocab axis the same way);
- all of the norms, `q_norm` / `k_norm`, the embeddings and the rope table.

JAX's specs cut the fused axes into T contiguous pieces
(`P(None, None, "tp")` on `wqkv [L, H, Q+2KV]` and `w_gate_up [L, H, 2I]`),
so one piece may hold only q columns and another only v columns, and the
partitioner moves the data a head needs. A rank of the port computes with
what it holds, so it is cut by whole KV groups and paired gate/up columns
instead: its attention needs no other rank, its SwiGLU no other column,
and the function is the same.

A rank runs the plain decoder (`models/decoder.py`) on `local_config(cfg,
mesh)`, HQ/T and KVH/T heads and I/T columns, with `tensor_parallel(mesh)`
passed as `tp`: the `wo` and `w_down` outputs, partial sums over the rank's
heads and columns, are all-reduced over the tp group before each residual
add, and the logits' vocab shards are joined before the argmax, so every
rank returns the whole token. Its cache is `init_state(local_cfg, ...,
slots=B // dp)`: KVH/T heads and B/dp slots, JAX's `batched_state_specs`.
The decode-step kernel computes whole layers, so it does not run on a tp
rank (JAX's sharded step is likewise its plain decoder); the
decode-attention kernel does (`attn_impl="pallas"`, bf16 cache). Quantized
weights are not tp-sharded (as in JAX); under dp they are replicated.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.config import DecoderConfig
from ..core.weights import CodePredictorWeights, DecoderWeights, LayerWeights
from .mesh import axis


class TensorParallel:
    """The collectives of a tp group, as the decoder calls them."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the group's ranks."""
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocab `[..., V]` from each rank's shard `[..., V/T]`,
        in rank order."""
        parts = [torch.empty_like(logits) for _ in range(self.size)]
        dist.all_gather(parts, logits.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)


def tensor_parallel(mesh) -> TensorParallel | None:
    """This rank's tp collectives, or None on a mesh whose tp axis is 1."""
    tp = axis(mesh, "tp")
    return TensorParallel(tp.group, tp.size) if tp.size > 1 else None


def local_config(cfg: DecoderConfig, mesh) -> DecoderConfig:
    """The decoder a tp rank runs: its heads and intermediate columns."""
    t = axis(mesh, "tp").size
    for name in ("num_kv_heads", "intermediate_size"):
        if getattr(cfg, name) % t:
            raise ValueError(f"{name} {getattr(cfg, name)} is not divisible by tp = {t}")
    return dataclasses.replace(cfg, num_q_heads=cfg.num_q_heads // t,
                               num_kv_heads=cfg.num_kv_heads // t,
                               intermediate_size=cfg.intermediate_size // t)


def _cut(x: torch.Tensor, dim: int, r: int, t: int) -> torch.Tensor:
    n = x.shape[dim] // t
    return x.narrow(dim, r * n, n)


def _shard_layers(lw: LayerWeights, r: int, t: int) -> LayerWeights:
    """Rank r of t's KV groups and intermediate columns, copied contiguous."""
    if not isinstance(lw, LayerWeights):
        raise TypeError("tp sharding takes bf16 weights; quantized weights are replicated")
    d = lw.q_norm.shape[-1]
    q = lw.wo.shape[1]
    kv = (lw.wqkv.shape[-1] - q) // 2
    if (kv // d) % t:
        raise ValueError(f"{kv // d} kv heads are not divisible by tp = {t}")
    i = lw.w_down.shape[1]
    if i % t:
        raise ValueError(f"intermediate size {i} is not divisible by tp = {t}")
    wq, wk, wv = lw.wqkv.split([q, kv, kv], dim=-1)
    gate, up = lw.w_gate_up.split([i, i], dim=-1)
    return lw._replace(
        wqkv=torch.cat([_cut(wq, -1, r, t), _cut(wk, -1, r, t), _cut(wv, -1, r, t)], dim=-1),
        wo=_cut(lw.wo, 1, r, t).contiguous(),
        w_gate_up=torch.cat([_cut(gate, -1, r, t), _cut(up, -1, r, t)], dim=-1),
        w_down=_cut(lw.w_down, 1, r, t).contiguous())


def shard_decoder_weights(mesh, w: DecoderWeights) -> DecoderWeights:
    """This rank's shard of bf16 decoder weights (module docstring)."""
    tp = axis(mesh, "tp")
    if w.lm_head.shape[-1] % tp.size:
        raise ValueError(f"vocab {w.lm_head.shape[-1]} is not divisible by tp = {tp.size}")
    return w._replace(layers=_shard_layers(w.layers, tp.index, tp.size),
                      lm_head=_cut(w.lm_head, -1, tp.index, tp.size).contiguous())


def shard_cp_weights(mesh, w: CodePredictorWeights) -> CodePredictorWeights:
    """This rank's shard of bf16 code-predictor weights: its decoder as
    `shard_decoder_weights`, its 15 heads cut on their vocab axis."""
    tp = axis(mesh, "tp")
    if w.lm_heads.shape[-1] % tp.size:
        raise ValueError(f"vocab {w.lm_heads.shape[-1]} is not divisible by tp = {tp.size}")
    return w._replace(decoder=shard_decoder_weights(mesh, w.decoder),
                      lm_heads=_cut(w.lm_heads, -1, tp.index, tp.size).contiguous())

"""Single-token latent attention (MLA): the CUDA kernel, its plain version, the wrapper.

Replaces no TPU kernel: the JAX package has no latent attention. Added for
`models/deepseek_v2.py`'s decode step in the absorbed form. Each cache row
of a layer holds a token's normed latent c_kv (C = 512) and its roped k_pe
(R = 64), `[S, C + R]` bf16. The caller folds W_UK into the query and W_UV
into the output (`q_lat[h] = q_nope[h] W_UK[h]`, `o[h] = o_lat[h] W_UV[h]`,
the standard rewriting, equal in value); the kernel computes, for each of
the heads h,

    o_lat[h] = sum_t softmax_t(scale * (q_lat[h] . c[t] + q_pe[h] . k_pe[t])) c[t]

over the rows t in [0, position], the new token's row (written by the
caller before the call) included, in float32. The position is a device
int32 tensor `[]`, as the decode-attention kernel B3 takes it: nothing on
the host depends on it, so a CUDA graph that captured the call replays it at
the position the tensor holds then.

`csrc/mla_attention.cu`: a grid fixed by the cache's length (`splits`
blocks, 32 from 2,048 rows on); each block takes an equal share of the
rows [0, position] in 16-row tiles for all the heads at once (one read of
each row; blocks past the rows return at once), keeps an online softmax a
head and its float32 output partial, and the last active block to finish
(a ticket in the workspace, which it resets) merges the partials in split
order. What bounds it: the rows' bytes,
(position + 1) x 576 x 2 B, plus the queries and the output in float32
(`h100_bench/families/deepseek_v2.py` counts them); at this cell's
positions (64-104) a launch is latency, not bytes.

On the CPU the wrapper runs `mla_attention_reference`. Every call adds one
to `count` (a device int64 tensor the caller owns), in the kernel on the
card: graph replays count too.
"""

from __future__ import annotations

import math

import torch

from .cuda_lib import check, check_tensor, load_library, stream_of

HEADS, LATENT, ROPE = 16, 512, 64   # the kernel's shapes (csrc/mla_attention.cu)


def splits(S: int) -> int:
    """The kernel's blocks for a cache of S rows."""
    return min(32, max(1, S // 64))


def workspace(S: int, heads: int, latent: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch (float32 partials, maxima and sums of each
    block) and its ticket (int32, zero between launches), allocated once by
    the caller, before any graph captures a launch."""
    n = splits(S) * heads * (latent + 2)
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def mla_attention_reference(q_lat: torch.Tensor, q_pe: torch.Tensor, cache: torch.Tensor,
                            position: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain f32 attention of q_lat `[NH, C]` and q_pe `[NH, R]` over rows
    [0, position] of one layer's cache `[S, C + R]`; `[NH, C]` f32."""
    C = q_lat.shape[-1]
    kv = cache[:int(position) + 1].float()
    s = (q_lat.float() @ kv[:, :C].t() + q_pe.float() @ kv[:, C:].t()) * scale
    return torch.softmax(s, dim=-1) @ kv[:, :C]


def mla_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor, cache: torch.Tensor,
                         position: torch.Tensor, scale: float, work: tuple,
                         count: torch.Tensor) -> torch.Tensor:
    """The latent attention above: q_lat `[NH, C]` and q_pe `[NH, R]` f32, one
    layer's cache `[S, C + R]` bf16, position an int32 tensor `[]` on their
    device (outside [0, S) it raises on the CPU; the kernel clamps it),
    `work` the `workspace` of this cache's length. Returns `[NH, C]` f32."""
    dev = q_lat.device
    S = cache.shape[0]
    if dev.type == "cpu":
        if not 0 <= int(position) < S:
            raise ValueError(f"mla_decode_attention: position {int(position)} outside [0, {S})")
        count += 1
        return mla_attention_reference(q_lat, q_pe, cache, position, scale)
    f32 = torch.float32
    for name, t, shape, dtype in (("q_lat", q_lat, (HEADS, LATENT), f32),
                                  ("q_pe", q_pe, (HEADS, ROPE), f32),
                                  ("cache", cache, (S, LATENT + ROPE), torch.bfloat16),
                                  ("position", position, (), torch.int32),
                                  ("count", count, (1,), torch.int64)):
        check_tensor("mla_decode_attention", name, t, shape, dtype, dev)
    scratch, ticket = work
    if scratch.numel() < splits(S) * HEADS * (LATENT + 2) or any(
            t.data_ptr() % 16 for t in (q_lat, q_pe, cache)):
        raise ValueError("mla_decode_attention: a workspace of this cache's length, and the "
                         "queries and the cache on 16-byte boundaries")
    out = torch.empty((HEADS, LATENT), dtype=f32, device=dev)
    err = load_library().qtts_mla_decode_attention(
        q_lat.data_ptr(), q_pe.data_ptr(), cache.data_ptr(), position.data_ptr(), S, HEADS,
        LATENT, ROPE, scale * math.log2(math.e), out.data_ptr(), scratch.data_ptr(),
        ticket.data_ptr(), splits(S), count.data_ptr(), stream_of(dev))
    check("mla_decode_attention", err)
    return out

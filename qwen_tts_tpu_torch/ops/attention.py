"""Single-token decode attention: the CUDA kernel, its plain version, the wrapper.

Port of `qwen_tts_tpu/ops/attention.py` (`decode_attention` :167, Pallas
body `_decode_attn_kernel` :29): GQA attention of one token's q heads over
the rows [0, position) of one layer of the bf16 KV cache plus the token's
own f32 K/V column, in f32. The cache is only read; the caller writes the
new column. The `"pallas"` backend of `models/decoder.py` runs it in every
layer of a single-token step.

`decode_attention` dispatches on where the tensors are: on the CPU it runs
`decode_attention_reference`; on a CUDA device it launches
`csrc/attention.cu` once, or raises. The kernel is the decode-attention
core of `csrc/attention_core.cuh`, which the decode step's attention stage
shares: a thread-block cluster per kv head whose blocks stream contiguous
64-row ranges of the prefix through a TMA bulk-copy ring, merged by the
cluster's first block through distributed shared memory in a fixed order,
the in-flight column last (no workspace, no atomics: the same bits on every
run). `decode_attention.launches` counts calls of the kernel.
"""

from __future__ import annotations

import torch

from .cuda_lib import check, check_aligned, check_tensor, load_library, stream_of


def decode_attention_reference(q: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, layer_idx: int,
                               position: int) -> torch.Tensor:
    """Plain f32 attention over `cache[layer_idx, :, :position]` plus the
    column. q [HQ, D], k_new / v_new [KVH, D], caches [L, KVH, S, D].
    Returns [HQ, D] f32."""
    HQ, D = q.shape
    KVH = k_new.shape[0]
    qh = q.float().reshape(KVH, HQ // KVH, D)
    k = k_cache[layer_idx, :, :position].float()
    v = v_cache[layer_idx, :, :position].float()
    kn, vn = k_new.float(), v_new.float()
    scale = 1.0 / D ** 0.5
    s_old = torch.einsum("hgd,hsd->hgs", qh, k) * scale
    s_new = (qh * kn[:, None, :]).sum(-1, keepdim=True) * scale
    p = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    out = torch.einsum("hgs,hsd->hgd", p[..., :position], v) + p[..., position:] * vn[:, None, :]
    return out.reshape(HQ, D)


def decode_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     layer_idx: int, position: int) -> torch.Tensor:
    """Attention of q [HQ, D] f32 over rows [0, position) of layer
    `layer_idx` of the bf16 caches [L, KVH, S, D] plus the column
    k_new / v_new [KVH, D] f32. Returns [HQ, D] f32. `layer_idx` and
    `position` are host integers."""
    L, KVH, S, D = k_cache.shape
    HQ = q.shape[0]
    if not 0 <= layer_idx < L or not 0 <= position <= S:
        raise ValueError(f"decode_attention: layer {layer_idx} / position {position} "
                         f"outside a cache of {L} layers x {S} rows")
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_reference(q, k_new, v_new, k_cache, v_cache,
                                          layer_idx, position)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {dev}")
    f32, bf = torch.float32, torch.bfloat16
    for name, t, shape, dtype in (("q", q, (HQ, D), f32), ("k_new", k_new, (KVH, D), f32),
                                  ("v_new", v_new, (KVH, D), f32),
                                  ("k_cache", k_cache, (L, KVH, S, D), bf),
                                  ("v_cache", v_cache, (L, KVH, S, D), bf)):
        check_tensor("decode_attention", name, t, shape, dtype, dev)
    check_aligned("decode_attention", k_cache, v_cache)
    if D != 128 or HQ % KVH or HQ // KVH > 8:
        raise ValueError(f"decode_attention kernel does not take HQ={HQ}, KVH={KVH}, D={D}")

    lib = load_library()
    out = torch.empty((HQ, D), dtype=f32, device=dev)
    err = lib.qtts_decode_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), L, HQ, KVH, S, D, layer_idx, position,
        stream_of(dev))
    check("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

"""Single-token decode attention: the CUDA kernel, its plain version, the wrapper.

Port of `qwen_tts_tpu/ops/attention.py` (`decode_attention` :167, Pallas
body `_decode_attn_kernel` :29): GQA attention of one token's q heads over
the rows [0, position) of one layer of the bf16 KV cache plus the token's
own f32 K/V column, in f32. The cache is only read; the caller writes the
new column. As in the JAX kernel, which reads its position from SMEM, the
position is a device value: an int32 tensor, `[]` for one stream or `[B]`
for B slots whose caches are stacked `[B, L, KVH, S, D]`, each slot at its
own position. Nothing on the host depends on it, so a CUDA graph that
captured a call replays it at the positions the tensor holds then. The
`"pallas"` backend of `models/decoder.py` runs it in every layer of a
single-token step, and the batched path (`runtime/batch.py`) in every
layer of a batched step.

`decode_attention` dispatches on where the tensors are: on the CPU it runs
`decode_attention_reference`; on a CUDA device it launches
`csrc/attention.cu` once, or raises. The kernel is the decode-attention
core of `csrc/attention_core.cuh`, which the decode step's attention stage
shares: a thread-block cluster per slot and kv head whose blocks read the
slot's position and stream their share of the prefix's 64-row tiles
through a TMA bulk-copy ring, merged by the cluster's first block through
distributed shared memory in a fixed order, the in-flight column last (no
workspace, no atomics: the same bits on every run). Its grid is fixed by
the cache's length. `device_launches(dev)` reads the kernel's own count of
its launches on `dev`, eager calls and graph replays alike.
"""

from __future__ import annotations

import torch

from .cuda_lib import check, check_aligned, check_tensor, load_library, stream_of

_COUNTS: dict[int, torch.Tensor] = {}   # device index -> the kernel's launch count


def _count(dev: torch.device) -> torch.Tensor:
    """The device uint64 the kernel adds one to at each launch on `dev`:
    allocated (zeroed) at the first eager launch, never inside a capture,
    which would bake the zeroing into the graph."""
    t = _COUNTS.get(dev.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: run the captured code once before "
                               "capturing it (the launch count would be allocated inside "
                               "the capture)")
        t = _COUNTS[dev.index] = torch.zeros(1, dtype=torch.int64, device=dev)
    return t


def reset_device_launches(dev: torch.device) -> None:
    """Set the kernel's own count of its launches on `dev` to 0 (in stream
    order)."""
    dev = torch.device(dev)
    _count(torch.device("cuda", dev.index if dev.index is not None
                        else torch.cuda.current_device())).zero_()


def device_launches(dev: torch.device) -> int:
    """The kernel's launches on `dev` so far, as it counts them itself (a
    device read: it waits for the device)."""
    dev = torch.device(dev)
    t = _COUNTS.get(dev.index if dev.index is not None else torch.cuda.current_device())
    if t is None:
        return 0
    torch.cuda.synchronize(t.device)
    return int(t.item())


def decode_attention_reference(q: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, layer_idx: int,
                               positions: torch.Tensor,
                               k_scale: torch.Tensor | None = None,
                               v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain f32 attention over `cache[layer_idx, :, :position]` plus the
    column, the rows at or past the position masked: q [HQ, D], k_new /
    v_new [KVH, D], caches [L, KVH, S, D] and positions `[]`, or each with a
    leading slot axis B. An int8 cache takes its f32 row scales
    `[(B,) L, KVH, S]`. Returns [(B,) HQ, D] f32."""
    one = q.dim() == 2
    if one:
        q, k_new, v_new, k_cache, v_cache = (t[None] for t in (q, k_new, v_new, k_cache,
                                                                 v_cache))
        positions = positions.reshape(1)
        k_scale, v_scale = (None if s is None else s[None] for s in (k_scale, v_scale))
    B, HQ, D = q.shape
    KVH, S = k_new.shape[1], k_cache.shape[3]
    qh = q.float().reshape(B, KVH, HQ // KVH, D)
    k = k_cache[:, layer_idx].float()
    v = v_cache[:, layer_idx].float()
    if k_scale is not None:
        k = k * k_scale[:, layer_idx, :, :, None]
        v = v * v_scale[:, layer_idx, :, :, None]
    kn, vn = k_new.float(), v_new.float()
    scale = 1.0 / D ** 0.5
    s_old = torch.einsum("bhgd,bhsd->bhgs", qh, k) * scale
    valid = torch.arange(S, device=q.device) < positions.reshape(B, 1)
    s_old = s_old.masked_fill(~valid[:, None, None, :], float("-inf"))
    s_new = (qh * kn[:, :, None, :]).sum(-1, keepdim=True) * scale
    p = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p[..., :S], v) + p[..., S:] * vn[:, :, None, :]
    out = out.reshape(B, HQ, D)
    return out[0] if one else out


def decode_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     layer_idx: int, positions: torch.Tensor) -> torch.Tensor:
    """Attention of q [HQ, D] f32 over rows [0, position) of layer
    `layer_idx` of the bf16 caches [L, KVH, S, D] plus the column
    k_new / v_new [KVH, D] f32, the position an int32 tensor `[]` on q's
    device; or the same for B slots, each tensor with a leading axis B and
    positions `[B]`. Returns [(B,) HQ, D] f32. `layer_idx` is a host
    integer. A position outside [0, S] raises on the CPU, where reading it
    costs nothing; the kernel clamps it into [0, S], as reading it on the
    host would wait for the device."""
    one = q.dim() == 2
    B = 1 if one else q.shape[0]
    L, KVH, S, D = k_cache.shape[-4:]
    HQ = q.shape[-2]
    lead = () if one else (B,)
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: no kernel for device {dev}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"decode_attention: layer {layer_idx} outside a cache of {L} layers")
    if not isinstance(positions, torch.Tensor) or tuple(positions.shape) != lead \
            or positions.dtype != torch.int32 or positions.device != dev:
        raise ValueError(f"decode_attention: positions are {positions!r}; the call takes "
                         f"an int32 tensor of shape {lead} on {dev}")
    if dev.type == "cpu":
        if bool(((positions < 0) | (positions > S)).any()):
            raise ValueError(f"decode_attention: positions {positions.tolist()} outside "
                             f"[0, {S}]")
        return decode_attention_reference(q, k_new, v_new, k_cache, v_cache,
                                          layer_idx, positions)
    f32, bf = torch.float32, torch.bfloat16
    for name, t, shape, dtype in (("q", q, (*lead, HQ, D), f32),
                                  ("k_new", k_new, (*lead, KVH, D), f32),
                                  ("v_new", v_new, (*lead, KVH, D), f32),
                                  ("k_cache", k_cache, (*lead, L, KVH, S, D), bf),
                                  ("v_cache", v_cache, (*lead, L, KVH, S, D), bf)):
        check_tensor("decode_attention", name, t, shape, dtype, dev)
    check_aligned("decode_attention", k_cache, v_cache)
    if D != 128 or HQ % KVH or HQ // KVH > 8:
        raise ValueError(f"decode_attention kernel does not take HQ={HQ}, KVH={KVH}, D={D}")

    lib = load_library()
    out = torch.empty((*lead, HQ, D), dtype=f32, device=dev)
    err = lib.qtts_decode_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), positions.data_ptr(), B, L, HQ, KVH, S, D,
        layer_idx, HQ * D, KVH * D, L * KVH * S * D, HQ * D, _count(dev).data_ptr(),
        stream_of(dev))
    check("decode_attention", err)
    return out

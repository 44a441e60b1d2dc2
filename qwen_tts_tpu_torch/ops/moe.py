"""Routed plus shared MoE experts: the CUDA kernel, its plain version, the wrappers.

Replaces no TPU kernel: the JAX package has no mixture-of-experts model.
Added for `models/deepseek_v2.py`, whose expert layers hold 64 SwiGLU
experts of width 1,408 (six chosen a token by a float32 router) and the
shared experts, one SwiGLU of width 2,816 that every token takes. For each
row t of h and each chosen expert e with weight w[t, e], and for the shared
expert with weight 1, `csrc/moe_experts.cu` adds into the float32 residual
rows x[t] (in place):

    w * W_down (silu(W_gate h[t]) * (W_up h[t]))

with bf16 weights and h, float32 products and sums. The expert ids and
weights are device tensors: nothing on the host depends on the routing, so
a CUDA graph that captured a launch replays it for whatever experts the
router chose then. Two forms, told apart by name in the device trace:

- `moe_experts_decode`: one row (`ids`, `weights` `[1, k]`); one block a
  64-column tile of a chosen expert's intermediate width (or the shared
  expert's), 6 x 22 + 44 blocks at DeepSeek-V2-Lite's widths;
- `moe_experts_prefill`: T rows; the (row, expert) pairs sorted by expert
  on the device (`_by_expert`), one block an expert's tile over the rows
  that chose it, 8 rows at a time; an expert no row chose is not read.

Neither computes an expert that no row chose. What bounds the decode form
is the chosen experts' bytes: (6 x 3 x 2,048 x 1,408 + 3 x 2,048 x 2,816) x
2 B = 138.4 MB, 41.3 us at 3.35 TB/s (`h100_bench/families/deepseek_v2.py`
counts it). Each block streams its tile's gate and up rows, forms the
activation for its columns in shared memory, multiplies it by the tile's
columns of W_down and adds its share of the output rows with float32
atomics (so the sum's order, and its last bits, vary between runs).

On the CPU the wrappers run `moe_experts_reference`, the same sums in plain
torch over the experts the rows chose. Every call adds one to its form's
entry of `count` (a device int64 tensor the caller owns), in the kernel on
the card: graph replays count too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_lib import check, check_tensor, load_library, stream_of

TILE = 64          # intermediate columns a block owns (kTile in csrc/moe_experts.cu)
MAX_HIDDEN = 2048  # eight 16-byte passes of 256 threads over a row


def swiglu(h: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """f32 `[T, H]` rows through gate|up `[2I, H]` and down `[H, I]`
    (bf16, [out, in]), in f32."""
    gu = h @ gate_up.float().t()
    i = gu.shape[-1] // 2
    return (F.silu(gu[:, :i]) * gu[:, i:]) @ down.float().t()


def moe_experts_reference(x: torch.Tensor, h: torch.Tensor, ids: torch.Tensor,
                          weights: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                          shared_gate_up: torch.Tensor, shared_down: torch.Tensor) -> torch.Tensor:
    """x `[T, H]` f32 += the chosen experts of each row of h `[T, H]` bf16
    (ids `[T, k]`, weights `[T, k]` f32; experts gate|up `[E, 2I, H]`,
    down `[E, H, I]`) and the shared expert (`[2Is, H]`, `[H, Is]`), in
    place. Only the experts some row chose are computed."""
    hf = h.float()
    x += swiglu(hf, shared_gate_up, shared_down)
    for e in ids.unique().tolist():
        rows, slot = (ids == e).nonzero(as_tuple=True)
        x.index_add_(0, rows, swiglu(hf[rows], gate_up[e], down[e]) * weights[rows, slot, None])
    return x


def _check(form: str, x, h, ids, weights, gate_up, down, shared_gate_up, shared_down, count):
    """Shapes, types and devices the kernel takes; (T, E, H, I, Is)."""
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    T, H = h.shape
    E, two_i = gate_up.shape[:2]
    I, Is = two_i // 2, shared_gate_up.shape[0] // 2
    for name, t, shape, dtype in (("x", x, (T, H), f32), ("h", h, (T, H), bf),
                                  ("ids", ids, (T, ids.shape[1]), torch.int64),
                                  ("weights", weights, tuple(ids.shape), f32),
                                  ("gate_up", gate_up, (E, 2 * I, H), bf),
                                  ("down", down, (E, H, I), bf),
                                  ("shared_gate_up", shared_gate_up, (2 * Is, H), bf),
                                  ("shared_down", shared_down, (H, Is), bf),
                                  ("count", count, (1,), torch.int64)):
        check_tensor(form, name, t, shape, dtype, dev)
    if H % 256 or H > MAX_HIDDEN or I % TILE or Is % TILE:
        raise ValueError(f"{form}: the kernel takes H a multiple of 256 up to {MAX_HIDDEN} "
                         f"and widths that are multiples of {TILE}; got H={H}, I={I}, Is={Is}")
    if any(t.data_ptr() % 16 for t in (h, gate_up, down, shared_gate_up, shared_down)):
        raise ValueError(f"{form}: h and the expert weights must start on 16-byte boundaries")
    return T, E, H, I, Is


def moe_experts_decode(x: torch.Tensor, h: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                       shared_gate_up: torch.Tensor, shared_down: torch.Tensor,
                       count: torch.Tensor) -> torch.Tensor:
    """One row: x `[1, H]` f32 += its chosen experts (ids, weights `[1, k]`)
    and the shared expert, in place (the one-row form)."""
    if x.device.type == "cpu":
        count += 1
        return moe_experts_reference(x, h, ids, weights, gate_up, down, shared_gate_up,
                                     shared_down)
    T, E, H, I, Is = _check("moe_experts_decode", x, h, ids, weights, gate_up, down,
                            shared_gate_up, shared_down, count)
    if T != 1:
        raise ValueError(f"moe_experts_decode: one row, not {T}; moe_experts_prefill takes T")
    err = load_library().qtts_moe_experts_decode(
        h.data_ptr(), ids.data_ptr(), weights.data_ptr(), ids.shape[1], gate_up.data_ptr(),
        down.data_ptr(), shared_gate_up.data_ptr(), shared_down.data_ptr(), E, H, I, Is,
        x.data_ptr(), count.data_ptr(), stream_of(x.device))
    check("moe_experts_decode", err)
    return x


def _by_expert(ids: torch.Tensor, weights: torch.Tensor, E: int):
    """The (row, expert) pairs sorted by expert, on the device: (rows
    `[T k]` int32, their weights `[T k]` f32, offsets `[E + 1]` int32 of
    each expert's first pair)."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rows = torch.div(order, ids.shape[1], rounding_mode="floor").to(torch.int32)
    counts = torch.zeros(E + 1, dtype=torch.int64, device=ids.device)
    counts.scatter_add_(0, flat + 1, torch.ones_like(flat))
    return rows, weights.reshape(-1)[order].contiguous(), counts.cumsum(0).to(torch.int32)


def moe_experts_prefill(x: torch.Tensor, h: torch.Tensor, ids: torch.Tensor,
                        weights: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                        shared_gate_up: torch.Tensor, shared_down: torch.Tensor,
                        count: torch.Tensor) -> torch.Tensor:
    """T rows: x `[T, H]` f32 += each row's chosen experts (ids, weights
    `[T, k]`) and the shared expert, in place (the multi-row form)."""
    if x.device.type == "cpu":
        count += 1
        return moe_experts_reference(x, h, ids, weights, gate_up, down, shared_gate_up,
                                     shared_down)
    T, E, H, I, Is = _check("moe_experts_prefill", x, h, ids, weights, gate_up, down,
                            shared_gate_up, shared_down, count)
    rows, w_sorted, offsets = _by_expert(ids, weights, E)
    err = load_library().qtts_moe_experts_prefill(
        h.data_ptr(), T, rows.data_ptr(), w_sorted.data_ptr(), offsets.data_ptr(),
        gate_up.data_ptr(), down.data_ptr(), shared_gate_up.data_ptr(), shared_down.data_ptr(),
        E, H, I, Is, x.data_ptr(), count.data_ptr(), stream_of(x.device))
    check("moe_experts_prefill", err)
    return x

"""One fused decode step: the CUDA kernel, its plain version, and the wrapper.

Port of `qwen_tts_tpu/ops/decode_step.py` (`megakernel_forward` :453, Pallas
body `_megakernel` :98, weight forms `make_mms().mm_scaled` :45-95). One
call runs one token through all L layers — RMSNorm, fused QKV, QK-RMSNorm,
RoPE, the new K/V column written into the cache at `position`,
online-softmax GQA over the cache prefix plus the in-flight column, O-proj,
SwiGLU MLP — then the final RMSNorm and, optionally, the LM head. The same
code serves the 28-layer talker and the 5-layer code predictor, with bf16,
int8 (per channel or per 128-row group), int4-g128 or mixed weights
(`core/weights.py`), the form picked per matrix, and a bf16 or int8 KV
cache (`models/decoder.py::init_state`).

`megakernel_forward` dispatches on where the tensors are: on the CPU it
runs `megakernel_forward_reference` (plain PyTorch, the same rounding
points and the kernel's matrix product `mm_scaled`); on a CUDA device it
launches `csrc/decode_step.cu` (one persistent launch a step) through
ctypes, or raises. The kernel reads the cache row and the M-RoPE section
positions from a device array (`positions`), which each launch advances,
and gathers its rope row from the tables itself, so consecutive steps need
no host-to-device traffic and no host sync. It is built with the port's
other kernels by `ops/cuda_lib.py` at first use.
`megakernel_forward.launches` counts the wrapper's kernel launches; a
CUDA graph that replays a captured step does not pass through the wrapper,
so the kernel also counts its own launches in its workspace
(`device_launches`).

A caller that captures steps into CUDA graphs owns the workspace and the
position arrays those graphs bake in (`Owned`): the module's own keep one
workspace per stream and a bounded cache of position arrays, from which an
array could be evicted and freed under a graph.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Sequence

import torch

from ..core.config import DecoderConfig
from ..core.weights import DecoderWeights, is_packed, unpack_int4
from ..models.decoder import (
    DecodeState,
    forward_layers,
    layer_mat,
    lm_head_logits,
    rope_rows,
)
from .cuda_lib import (
    FORM_BF16,
    FORM_INT4,
    FORM_INT8,
    MAX_SECTIONS,
    QttsDecoder,
    QttsMat,
    check,
    check_aligned,
    check_tensor,
    ints,
    load_library,
    stream_of,
)

GROUP = 128   # the rows of one scale group the kernel's grouped GEMVs take


def _grouped(a: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Σ_g (a_g @ w_g) * s[g]: each group's f32 partial product scaled."""
    ng, n_out = s.shape
    T, n_in = a.shape
    part = torch.einsum("tgk,gkn->gtn", a.reshape(T, ng, n_in // ng),
                        w.reshape(ng, n_in // ng, n_out))
    return (part * s[:, None, :]).sum(dim=0)


def mm_scaled(a: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None) -> torch.Tensor:
    """The kernel's matrix product (JAX `make_mms().mm_scaled`): bf16-rounded
    activations `a [T, in]` times one layer's weights, in f32. bf16 `w`
    (`s` None); int8 `[in, out]` with `s [1, out]` scaling the product or
    `s [ng, out]` scaling each group's partial; packed int4 `[in/2, out]`
    whose low half takes scale rows [0, ng/2) and high half the rest."""
    a = a.to(torch.bfloat16).float()
    if s is None:
        return a @ w.float()
    ng = s.shape[0]
    if is_packed(w, a.shape[1]):
        lo, hi = unpack_int4(w)
        half = a.shape[1] // 2
        return (_grouped(a[:, :half], lo.float(), s[:ng // 2])
                + _grouped(a[:, half:], hi.float(), s[ng // 2:]))
    if ng == 1:
        return (a @ w.float()) * s
    return _grouped(a, w.float(), s)


def megakernel_forward_reference(cfg: DecoderConfig, w: DecoderWeights,
                                 state: DecodeState, embed: torch.Tensor,
                                 cos: torch.Tensor, sin: torch.Tensor,
                                 with_head: bool = True):
    """Plain PyTorch version of the kernel: the dense single-token layer of
    `models/decoder.py` with `mm_scaled` products (same bf16 rounding
    points), cache written in place. Returns (state, logits [V] f32 or
    None, normed [H] f32)."""
    state, normed = forward_layers(cfg, w, state, embed.float()[None, :], cos, sin,
                                   mm=mm_scaled)
    logits = lm_head_logits(w, normed)[0] if with_head else None
    return state, logits, normed[0]


def _mat(kernel: str, name: str, w: torch.Tensor, s: torch.Tensor | None,
         lead: tuple, K: int, N: int, dev) -> QttsMat:
    """Check one matrix ([*lead, K, N] in its form) and describe it."""
    if s is None:
        check_tensor(kernel, name, w, (*lead, K, N), torch.bfloat16, dev)
        return QttsMat(w.data_ptr(), None, FORM_BF16, 1)
    packed = is_packed(w, K)
    ng = s.shape[-2]
    check_tensor(kernel, name, w, (*lead, K // 2 if packed else K, N), torch.int8, dev)
    check_tensor(kernel, f"{name} scales", s, (*lead, ng, N), torch.float32, dev)
    if (packed or ng > 1) and (ng * GROUP != K or (packed and ng % 2)):
        raise ValueError(f"{kernel}: {name} has {ng} scale groups over {K} rows; the "
                         f"kernel takes groups of {GROUP} rows")
    return QttsMat(w.data_ptr(), s.data_ptr(), FORM_INT4 if packed else FORM_INT8, ng)


def decoder_struct(kernel: str, cfg: DecoderConfig, w: DecoderWeights,
                   state: DecodeState, dev: torch.device, with_head: bool) -> QttsDecoder:
    """Check the weights and caches against what `csrc/decode_layer.cuh`
    takes — each matrix bf16, int8 or packed int4 with groups of 128 rows,
    the head bf16 or int8, the cache bf16 or int8 with f32 row scales, all
    contiguous on `dev`, D = 128, at most 8 q heads per kv head, every
    matrix width a multiple of 64 and `max_seq_len` a multiple of 8 — and
    describe them for the C call.
    Raises otherwise."""
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    KVH, D, S, V = cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len, cfg.vocab_size
    Q, KV, bf, lw = cfg.q_size, cfg.kv_size, torch.bfloat16, w.layers
    for name, t, shape in (("input_norm", lw.input_norm, (L, H)),
                           ("q_norm", lw.q_norm, (L, D)), ("k_norm", lw.k_norm, (L, D)),
                           ("post_norm", lw.post_norm, (L, H)),
                           ("final_norm", w.final_norm, (H,))):
        check_tensor(kernel, name, t, shape, bf, dev)
    mats = {name: _mat(kernel, name, *layer_mat(lw, name), (L,), K, N, dev)
            for name, K, N in (("wqkv", H, Q + 2 * KV), ("wo", Q, H),
                               ("w_gate_up", H, 2 * I), ("w_down", I, H))}
    head = QttsMat(None, None, FORM_BF16, 1)
    if with_head:
        head = _mat(kernel, "lm_head", w.lm_head, getattr(w, "lm_head_s", None), (), H, V, dev)
    kv8 = state.k_scale is not None
    for name, t in (("k_cache", state.k_cache), ("v_cache", state.v_cache)):
        check_tensor(kernel, name, t, (L, KVH, S, D), torch.int8 if kv8 else bf, dev)
    if kv8:
        for name, t in (("k_scale", state.k_scale), ("v_scale", state.v_scale)):
            check_tensor(kernel, name, t, (L, KVH, S), torch.float32, dev)
    check_aligned(kernel, state.k_cache, state.v_cache, state.k_scale, state.v_scale)
    if D != 128 or cfg.num_q_heads % KVH or cfg.gqa_groups > 8 or S % 8 or any(
            n % 64 for n in (H, Q + 2 * KV, 2 * I, V)):
        raise ValueError(f"{kernel} kernel does not take this config: {cfg}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return QttsDecoder(
        lw.input_norm.data_ptr(), lw.q_norm.data_ptr(), lw.k_norm.data_ptr(),
        lw.post_norm.data_ptr(), w.final_norm.data_ptr(), mats["wqkv"], mats["wo"],
        mats["w_gate_up"], mats["w_down"], head, state.k_cache.data_ptr(),
        state.v_cache.data_ptr(), ptr(state.k_scale), ptr(state.v_scale),
        L, H, I, cfg.num_q_heads, KVH, D, S, V, cfg.rms_eps)


_WORKSPACES: dict[tuple, torch.Tensor] = {}
_POSITIONS: OrderedDict[tuple, list] = OrderedDict()
_MAX_POSITION_ARRAYS = 16


class Owned:
    """The decode kernel's workspace and position arrays, owned by one
    caller (a runner of CUDA graphs, whose captured launches bake their
    addresses in) and never evicted. While `active()`, every launch of the
    thread that activated them uses them (another thread's launches, such
    as a second model's on its own stream, keep the module's) instead of the module's per-stream workspace and its bounded cache
    of position arrays. Nothing of them may be allocated during a capture:
    run the captured code once eagerly first, the widest decoder first
    (the workspace is sized by it): once `frozen` (the caller's first
    capture), the workspace cannot grow under the graphs. Each array's
    entry is `[int32 tensor, the values it holds when the next launch runs,
    or None when the host does not know them]`."""

    def __init__(self):
        self.workspace: torch.Tensor | None = None
        self.arrays: dict[int, list] = {}      # k_cache data_ptr -> entry
        self.carried: frozenset[int] = frozenset()
        self.frozen = False

    @contextmanager
    def active(self, carried: Sequence[DecodeState] = ()):
        """Launches inside use these arrays. The arrays of the `carried`
        caches are never filled: whatever ran before (an earlier graph)
        leaves them at the positions the launches ask for. Every other array
        whose values the host does not know is filled before its first
        launch, with the positions the host passes."""
        saved = _owner(), self.carried
        _ACTIVE.owner, self.carried = self, frozenset(s.k_cache.data_ptr() for s in carried)
        try:
            yield self
        finally:
            _ACTIVE.owner, self.carried = saved

    def forget(self) -> None:
        """Mark every array's values unknown (after a graph replay, which
        advances them without the host): the next eager launch on a cache
        fills its array, and so does the first launch of a capture."""
        for entry in self.arrays.values():
            entry[1] = None

    def launches(self, frames: bool = False) -> int:
        """The decode kernel's launches with this workspace so far (`frames`:
        only its code-predictor frame launches), as the kernel counts them
        (a device read: it waits for the stream)."""
        return 0 if self.workspace is None else _launch_count(self.workspace, frames)


_ACTIVE = threading.local()   # .owner: the Owned active in this thread


def _owner() -> Owned | None:
    return getattr(_ACTIVE, "owner", None)


def _not_capturing(what: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"decode_step: the {what} would be allocated inside a CUDA graph "
                           f"capture; run the captured code once before capturing it")


def workspace(cfg: DecoderConfig, dev: torch.device) -> torch.Tensor:
    """The kernels' scratch on `dev` for the current stream (or the active
    `Owned`'s): zeroed once (it holds the grid barrier's count, which each
    launch leaves set for the next) and kept, grown for a wider decoder.
    Launches on one stream share it in stream order. `dev` without an
    index is the current card (so "cuda" and "cuda:0" find one workspace)."""
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    lib = load_library()
    n = lib.qtts_workspace_bytes(cfg.hidden_size, cfg.intermediate_size, cfg.num_q_heads,
                                 cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size)
    owner = _owner()
    if owner is not None:
        ws = owner.workspace
        if ws is None or ws.numel() < n:
            _not_capturing("workspace")
            if owner.frozen:
                raise RuntimeError("decode_step: a wider decoder would grow the workspace "
                                   "that captured graphs hold")
            ws = owner.workspace = torch.zeros(n, dtype=torch.uint8, device=dev)
        return ws
    key = (dev.index, stream_of(dev))
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < n:
        ws = torch.zeros(n, dtype=torch.uint8, device=dev)
        _WORKSPACES[key] = ws
    return ws


def _position_entry(state: DecodeState, dev: torch.device) -> list:
    owner = _owner()
    if owner is not None:
        key = state.k_cache.data_ptr()
        entry = owner.arrays.get(key)
        if entry is None:
            _not_capturing("position array")
            entry = owner.arrays[key] = [
                torch.zeros(1 + MAX_SECTIONS, dtype=torch.int32, device=dev), None]
        return entry
    key = (dev.index, stream_of(dev), state.k_cache.data_ptr())
    entry = _POSITIONS.get(key)
    if entry is None:
        entry = [torch.zeros(1 + MAX_SECTIONS, dtype=torch.int32, device=dev), None]
        _POSITIONS[key] = entry
        while len(_POSITIONS) > _MAX_POSITION_ARRAYS:
            _POSITIONS.popitem(last=False)
    _POSITIONS.move_to_end(key)
    return entry


def positions(state: DecodeState, values: Sequence[int], dev: torch.device):
    """The device int32 array of this cache's positions, holding `values`
    (the cache row, then the M-RoPE section positions) when the next launch
    runs: each kernel launch advances the array by its steps, so
    consecutive steps find it set, and only a jump (a new request, a
    replayed position) costs one small fill launch. A carried cache of the
    active `Owned` is never filled. Returns the entry `[tensor, values it
    will hold]`, which the caller advances after its launch."""
    lib = load_library()
    entry = _position_entry(state, dev)
    values = tuple(int(v) for v in values)
    owner = _owner()
    if owner is not None and state.k_cache.data_ptr() in owner.carried:
        entry[1] = values
    if entry[1] != values:
        err = lib.qtts_set_positions(entry[0].data_ptr(), len(values), ints(values),
                                     stream_of(dev))
        entry[1] = None if err else values
        check("set_positions", err)
    return entry


def check_rope(kernel: str, cfg: DecoderConfig, w: DecoderWeights, firsts: Sequence[int],
               steps: int, dev: torch.device) -> None:
    """The rope tables on `dev` as the kernel reads them, and every row a
    run of `steps` steps from the positions `firsts` reads inside them."""
    rows, d2 = w.rope.cos.shape[0], cfg.head_dim // 2
    for name, t in (("rope.cos", w.rope.cos), ("rope.sin", w.rope.sin)):
        check_tensor(kernel, name, t, (rows, d2), torch.float32, dev)
    if min(firsts) < 0 or max(firsts) + steps > rows:
        raise ValueError(f"{kernel}: rope rows [{min(firsts)}, {max(firsts) + steps}) outside "
                         f"the table's {rows} rows")


def rope_spec(cfg: DecoderConfig, mrope_pos: Sequence[int] | None):
    """(sections the kernel rotates by, interleaved flag): none for
    standard RoPE (no M-RoPE config, or no section positions given)."""
    secs = tuple(cfg.mrope_section or ()) if mrope_pos is not None else ()
    if secs and len(mrope_pos) != len(secs):
        raise ValueError(f"mrope_pos {list(mrope_pos)} needs one position per section {secs}")
    if len(secs) > MAX_SECTIONS:
        raise ValueError(f"the kernels take at most {MAX_SECTIONS} M-RoPE sections: {secs}")
    return secs, int(bool(cfg.mrope_interleaved))


def device_launches(cfg: DecoderConfig, dev: torch.device, frames: bool = False) -> int:
    """The decode kernel's launches with the workspace of `dev`'s current
    stream (or of the active `Owned`) so far (`frames`: only its
    code-predictor frame launches, `ops/cp_frame.py`), as the kernel counts
    them in it (a device read: it waits for the stream)."""
    return _launch_count(workspace(cfg, dev), frames)


def _launch_count(ws: torch.Tensor, frames: bool = False) -> int:
    off = load_library().qtts_launch_count_offset() + 8 * frames
    return int(ws[off:off + 8].view(torch.int64).item())


def launch_info(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                with_head: bool = True) -> dict:
    """The persistent grid the decode kernel takes for this decoder on its
    device: blocks, blocks a kv head (at most 16 of them attend), the
    card's cudaOccupancyMaxActiveBlocksPerMultiprocessor and SMs, dynamic
    and static shared memory a block, registers a thread, and
    cudaOccupancyMaxActiveClusters of the kernel in clusters of 8 and of 16
    blocks (-1: the query was refused)."""
    dev = w.embed.device
    dec = decoder_struct("decode_step", cfg, w, state, dev, with_head)
    out = (ctypes.c_int * 9)()
    err = load_library().qtts_launch_info(dec, out)
    info = dict(zip(("grid", "blocks_per_kv_head", "max_blocks_per_sm", "sms",
                     "dynamic_smem", "static_smem", "registers", "max_active_clusters_8",
                     "max_active_clusters_16"), list(out)))
    if err:
        raise RuntimeError(f"decode_step: no co-resident persistent grid ({info}), CUDA "
                           f"error {err}")
    return info


def megakernel_forward(cfg: DecoderConfig, w: DecoderWeights, state: DecodeState,
                       embed: torch.Tensor,
                       mrope_pos: Sequence[int] | None = None,
                       with_head: bool = True):
    """One fused decode step. Returns (state, logits [V] f32 or None when
    `with_head` is False, normed [H] f32). The cache is updated in place."""
    pos = state.position
    if pos >= cfg.max_seq_len:
        raise ValueError(f"decode position {pos} >= max_seq_len {cfg.max_seq_len}")
    dev = embed.device
    if dev.type == "cpu":
        cos, sin = rope_rows(cfg, w.rope, pos, 1, mrope_pos)
        return megakernel_forward_reference(cfg, w, state, embed, cos, sin, with_head)
    if dev.type != "cuda":
        raise ValueError(f"decode_step: no kernel for device {dev}")

    H, V = cfg.hidden_size, cfg.vocab_size
    f32 = torch.float32
    embed = embed.to(f32).contiguous()
    secs, interleaved = rope_spec(cfg, mrope_pos)
    values = (pos, *mrope_pos) if secs else (pos,)
    check_rope("decode_step", cfg, w, values[1:] if secs else values, 1, dev)
    dec = decoder_struct("decode_step", cfg, w, state, dev, with_head)
    check_tensor("decode_step", "embed", embed, (H,), f32, dev)

    lib = load_library()
    ws = workspace(cfg, dev)
    pos_entry = positions(state, values, dev)
    normed = torch.empty(H, dtype=f32, device=dev)
    logits = torch.empty(V, dtype=f32, device=dev) if with_head else None
    err = lib.qtts_decode_step(
        dec, embed.data_ptr(), w.rope.cos.data_ptr(), w.rope.sin.data_ptr(),
        pos_entry[0].data_ptr(), len(secs), interleaved, ints(secs), normed.data_ptr(),
        logits.data_ptr() if with_head else None, ws.data_ptr(), stream_of(dev))
    pos_entry[1] = None if err else tuple(v + 1 for v in values)  # what the launch leaves
    check("decode_step", err)
    megakernel_forward.launches += 1
    return state._replace(position=pos + 1), logits, normed


megakernel_forward.launches = 0

"""A code-predictor frame in one launch of the decode-step kernel: the CUDA
route, its plain version, and the wrapper.

The code predictor fills codebook groups 1..G of a frame from the talker's
hidden state and its codebook-0 token (`models/code_predictor.py`). Its
plain form is a dense 2-row prefill, then per group a head, a sample and a
single-row decoder step. Here the whole frame is one launch of the
decode-step kernel (`csrc/decode_layer.cuh`; `qtts_cp_frame` in
`csrc/generate.cu`) of 1 + G steps from cache row 0: step 0 runs the
talker's hidden and computes no head, step 1 runs row `first_token` of the
talker's embedding table, and after each step n >= 1 come head n - 1, its
sample (top-k of the logits over the temperature, Gumbel noise added by
rank, the argmax; or the plain argmax when greedy) and, as step n + 1's
input, the sampled token's row of codec table n - 1, all on the device.
No TPU kernel has this form: the JAX package's `cp_predict` is one jit over
the same steps. What bounds it on an H100 is the decode step's chain of
stage latencies (PERF.md), ~0.18 ms a step of 5 layers; what it removes is
the plain work between 14 launches (f32 casts of the prefill's and heads'
weights, their f32 products, torch's top-k, ~250 small kernels a frame).

On the CPU `cp_frame` runs `cp_frame_reference`: the same steps as
single-row steps of the kernel's plain version
(`decode_step.megakernel_forward_reference`), the head as the kernel's
product (bf16-rounded activations times bf16 weights, f32 sums) and
`ops/sampling.py::sample_logits`. Against the dense `cp_predict` one
rounding differs: row 1 attends to row 0's K/V read back from the cache
(bf16, the rounding every later row sees), where the dense prefill keeps
them in f32 inside its chunk. The kernel divides the logits by the
temperature in IEEE f32, as the CPU does (torch on the card multiplies by
the reciprocal, at most an ulp away). `cp_frame.frames` counts the frames
the route ran, on the card one launch each (the engine's
`cp_kernel_frames` reads it); the kernel counts its own frame launches in
its workspace (`decode_step.device_launches(..., frames=True)`).
"""

from __future__ import annotations

import torch

from ..core.config import DecoderConfig
from ..core.weights import CodePredictorWeights
from ..models.decoder import DecodeState, matmul, rope_rows
from .cuda_lib import (
    MAX_SAMPLE_VOCAB,
    MAX_TOP_K,
    check,
    check_tensor,
    load_library,
    stream_of,
)
from .decode_step import (
    _mat,
    check_rope,
    decoder_struct,
    megakernel_forward_reference,
    positions,
    workspace,
)
from .sampling import sample_logits


def _greedy(do_sample: bool, temperature: float) -> bool:
    return not do_sample or temperature <= 0.0


def kernel_takes(cfg: DecoderConfig, do_sample: bool, temperature: float,
                 top_k: int) -> bool:
    """Whether the kernel runs this frame: at most 2 q heads a kv head (the
    frame kernel's instantiations; the code predictor has 16 and 8), and
    greedy or top-k with 0 < top_k <= 64 below a vocabulary of at most
    4,096 (its sampling epilogue)."""
    if cfg.gqa_groups > 2:
        return False
    if _greedy(do_sample, temperature):
        return True
    return 0 < top_k <= MAX_TOP_K and top_k < cfg.vocab_size <= MAX_SAMPLE_VOCAB


def cp_frame_reference(cfg: DecoderConfig, w: CodePredictorWeights, state: DecodeState,
                       hidden: torch.Tensor, first_token: torch.Tensor,
                       talker_embed: torch.Tensor, noise: torch.Tensor | None,
                       do_sample: bool, temperature: float, top_k: int, num_groups: int):
    """Plain version: 1 + G single-row steps of the kernel's plain version
    from cache row 0, each group's head, sample and codec row. Returns
    (tokens [G] int32, logits [G, V] f32)."""
    rope, state = w.decoder.rope, state._replace(position=0)
    embed = hidden
    tokens, logits = [], []
    for n in range(1 + num_groups):
        cos, sin = rope_rows(cfg, rope, n, 1)
        state, _, normed = megakernel_forward_reference(cfg, w.decoder, state, embed, cos, sin,
                                                        with_head=False)
        if n == 0:
            embed = talker_embed[first_token.reshape(1)][0]
            continue
        g = n - 1
        row = matmul(normed[None], w.lm_heads[g])[0]
        token = sample_logits(row, do_sample, temperature, top_k,
                              None if noise is None else noise[g])
        tokens.append(token)
        logits.append(row)
        embed = w.codec_embeds[g][token.reshape(1)][0]
    return torch.stack(tokens).to(torch.int32), torch.stack(logits)


def cp_frame(cfg: DecoderConfig, w: CodePredictorWeights, state: DecodeState,
             hidden: torch.Tensor, first_token: torch.Tensor, talker_embed: torch.Tensor,
             noise: torch.Tensor | None = None, do_sample: bool = True,
             temperature: float = 0.9, top_k: int = 50, num_groups: int | None = None,
             return_logits: bool = False):
    """Codebook groups 1..G of one frame (G = `num_groups`, default every
    head) from the talker's post-final-norm hidden `[H]` f32 and its
    codebook-0 token (one element), with the talker's embedding table
    `[*, H]` bf16 and, when sampling, Gumbel noise `[>= G, top_k]` f32.
    The state's cache is written from row 0 (nothing it held is read).
    Returns (tokens [G] int32, the logits [G, V] f32 or None)."""
    G = w.lm_heads.shape[0] if num_groups is None else int(num_groups)
    greedy = _greedy(do_sample, temperature)
    if not greedy and noise is None:
        raise ValueError("sampling needs Gumbel noise")
    if not 1 <= G <= w.lm_heads.shape[0] or 1 + G > cfg.max_seq_len:
        raise ValueError(f"cp_frame: {G} groups of {w.lm_heads.shape[0]} heads in a cache of "
                         f"{cfg.max_seq_len} rows")
    dev = hidden.device
    if dev.type == "cpu":
        tokens, logits = cp_frame_reference(cfg, w, state, hidden, first_token, talker_embed,
                                            noise, do_sample, temperature, top_k, G)
        cp_frame.frames += 1
        return tokens, logits if return_logits else None
    if dev.type != "cuda":
        raise ValueError(f"cp_frame: no kernel for device {dev}")
    if not kernel_takes(cfg, do_sample, temperature, top_k):
        raise ValueError(f"cp_frame: the kernel takes at most 2 q heads a kv head and samples "
                         f"top_k in [1, {MAX_TOP_K}] below a vocabulary of at most "
                         f"{MAX_SAMPLE_VOCAB}, not {cfg.gqa_groups} and top_k {top_k} of "
                         f"{cfg.vocab_size}")
    if state.k_scale is not None:
        raise ValueError("cp_frame: the kernel takes a bf16 cache")

    H, V, heads, f32 = cfg.hidden_size, cfg.vocab_size, w.lm_heads.shape[0], torch.float32
    dec = decoder_struct("cp_frame", cfg, w.decoder, state, dev, with_head=False)
    dec.lm_head = _mat("cp_frame", "lm_heads", w.lm_heads, None, (heads,), H, V, dev)
    check_tensor("cp_frame", "codec_embeds", w.codec_embeds, (heads, V, H), torch.bfloat16, dev)
    check_tensor("cp_frame", "talker_embed", talker_embed, (talker_embed.shape[0], H),
                 torch.bfloat16, dev)
    x = hidden.to(f32).contiguous()
    check_tensor("cp_frame", "hidden", x, (H,), f32, dev)
    if x.data_ptr() % 16:
        raise ValueError("cp_frame: the hidden row must start on a 16-byte boundary")
    first = first_token.reshape(1).to(torch.int32)
    if not greedy:
        check_tensor("cp_frame", "noise", noise, (noise.shape[0], top_k), f32, dev)
        if noise.shape[0] < G:
            raise ValueError(f"cp_frame: noise for {noise.shape[0]} of {G} groups")
    check_rope("cp_frame", cfg, w.decoder, (0,), 1 + G, dev)

    lib = load_library()
    ws = workspace(cfg, dev)
    pos_entry = positions(state, (0,), dev)
    tokens = torch.empty(G, dtype=torch.int32, device=dev)
    logits = torch.empty((G, V), dtype=f32, device=dev) if return_logits else None
    err = lib.qtts_cp_frame(
        dec, x.data_ptr(), first.data_ptr(), talker_embed.data_ptr(), heads,
        w.codec_embeds.data_ptr(), None if greedy else noise.data_ptr(),
        0 if greedy else top_k, float(temperature), w.decoder.rope.cos.data_ptr(),
        w.decoder.rope.sin.data_ptr(), pos_entry[0].data_ptr(), tokens.data_ptr(),
        None if logits is None else logits.data_ptr(), ws.data_ptr(), 1 + G, stream_of(dev))
    pos_entry[1] = None if err else (0,)  # the launch leaves the row where it found it
    check("cp_frame", err)
    cp_frame.frames += 1
    return tokens, logits


cp_frame.frames = 0

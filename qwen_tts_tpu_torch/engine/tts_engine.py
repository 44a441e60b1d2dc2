"""TTS engine: text → talker → code predictor → vocoder → streamed audio.

Port of `qwen_tts_tpu/engine/tts_engine.py`, with its `TTSConfig`: weights
random from `seed` or loaded from a local checkpoint (`model_path`, read
by the port's own safetensors reader), bf16 or weight-only quantized
decoders (`quantize`: int8, int4-g128 or mixed talker; `cp_quantize` for
the code predictor, whose 15 heads and KV cache stay bf16), a bf16 or int8
talker KV cache (`kv_cache`), and the backends "auto" (the CUDA
decode-step kernel on a GPU, the dense path on the CPU), "mega" (the
decode-step kernel), "pallas" (dense layers with the CUDA decode-attention
kernel in every single-token step; the name is the JAX package's) and
"dense" (plain torch). On the CPU every kernel runs its plain version. The
public surface is the same — `initialize()`, `synthesize(text)`, async
`synthesize_streaming(text)`, `get_metrics()` — and so is what a request
computes: the 8-row conditioning prefill and shifted trailing text of the
JAX `first_fn`, a first chunk of one frame and then `chunk_frames`-frame
chunks, EOS as the stop with the word-count cap as fallback.

Two vocoders (`vocoder_backend`), each random from `seed + 1`, loaded from
`vocoder_path`, or silent, per `vocoder_mode` (auto | random | silence):
- "fast", this repo's own decoder: each chunk decoded on its own;
  non-streaming is one decode of all frames, repeat-padded to a bucket.
- "code2wav", the public Qwen3-Omni codec decoder (`vocoder/code2wav.py`),
  in `vocoder_dtype` with the "packed" or "reference" numerics
  (`code2wav_impl`): each chunk decoded with the previous chunk's codes as
  left context and `n * hop` samples kept from `ctx * hop - deficit`, the
  first chunk front-padded by `deficit` samples of silence, so chunks join
  without a gap; a partial last chunk repeat-padded to the chunk size and
  decoded with the previous chunk as context. Non-streaming on the fused
  path is the streamed chunks joined; otherwise windows of
  `code2wav_window` frames with `code2wav_ctx` frames of context, the last
  repeat-padded to a bucket in {W/4, W/2, W}.

`fused_chunks` (default True) is JAX's fused path (`_build_fused_fns`,
`_generate_audio_chunks`): on a GPU each chunk is one replay of a CUDA
graph — `frames_chunk` over its frames, the vocoder (Code2Wav reads the
previous chunk's codes from a device buffer that the graph then
overwrites with its own), and the copies of codes, `valid` flags and
audio into a ring of pinned host slots — and everything from the token
ids to the first audio chunk is one more. The next chunk is enqueued
before the host reads the current one (at most two in flight). Graphs are
captured in `initialize()` (`warmup`) for the `trailing_bucket` text
bucket and `chunk_frames`; a longer text, or streaming at another chunk
size (frames-only graphs, audio decoded outside them), captures its graphs
when a request first needs them. The graphs share one static state; when
a stream that does not hold it enqueues, the engine parks the holder's
state (its cache rows, the decode kernel's position array, carried token,
hidden state, trailing rows and context codes, and the outputs of its
unread chunks) in tensors of that stream and restores the caller's, so
live streams of one engine interleave freely and each yields what it
yields alone. With one live stream nothing is copied. A capture or replay
that fails raises; nothing falls back to the eager loop. On the CPU the
same bodies run eagerly, in the same order. `fused_chunks=False` is the
eager loop: each chunk's ops enqueued from Python and read back before the
next chunk starts, the last chunk cut at the cap, its audio what the fused
path yields. Every backend runs on both paths: "mega" keeps the talker's
position in the decode kernel's own array, "pallas" and "dense" in the
talker state's device position (`models/decoder.py`), which their
single-token steps read and advance, so a replayed graph runs where the
last one left.

`synthesize_batch(texts)` runs B texts as one batch (`runtime/batch.py`,
JAX `synthesize_batch` without the mesh): one batched prefill and one
batched run of frames up to the longest cap, each row of every product a
text's own, the attention the decode-attention kernel on a GPU with a
bf16 cache (backend "dense": its plain version). `runtime/continuous.py`
serves staggered requests in fixed slots on CUDA graphs of its own.

The talker uses the interleaved M-RoPE of the released model
(`mrope_section`, all section positions equal to the cache position for
text-only prompts) unless `mrope=False`.

The device is `TTSConfig.device`, "cuda" unless the caller asks for the
CPU; the engine never falls back to the CPU. TF32 is switched off for
matmuls and cuDNN convolutions, so the f32 parts (the vocoders, the f32
products of the plain paths) keep full f32 precision.

Code-predictor sampling noise comes from a `torch.Generator` seeded from
(engine seed, request number, absolute frame index); the frame's 15 groups
take the rows of one draw. The draws are made outside the graphs, into a
buffer the graph transforms. Codes therefore do not depend on chunking, and
streaming and non-streaming requests with the same request number agree.
"""

from __future__ import annotations

import asyncio
import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import AsyncGenerator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import (
    CODEC_BOS,
    CODEC_NOTHINK,
    CODEC_PAD,
    CODEC_THINK_BOS,
    CODEC_THINK_EOS,
    TTS_BOS,
    TTS_EOS,
    TTS_PAD,
    TTSModelConfig,
)
from ..core.weights import QUANTIZERS, TTSWeights, init_tts_weights, load_tts_weights
from ..models.decoder import init_state
from ..models.text_projection import embed_text_ids
from ..runtime.frame_loop import frames_chunk, talker_prefill
from ..vocoder.code2wav import (
    Code2WavConfig,
    build_tree,
    code2wav_apply,
    init_code2wav_weights,
    named_leaves,
)
from ..vocoder.code2wav_fast import code2wav_apply_packed, pack_code2wav_weights
from ..vocoder.loader import load_code2wav, load_vocoder
from ..vocoder.model import VocoderConfig, init_vocoder_weights, vocoder_decode
from .chunk_graphs import RING, ChunkGraphs, Slot
from .tokenizer import encode_tts_prompt, load_tokenizer

_MASK64 = (1 << 64) - 1
TRAILING_BUCKET = 384          # prompt ids are padded to a multiple
MAX_NEW_TOKENS = 2048          # frame cap above the word-count cap
PREFIX_ROWS = 8                # conditioning rows of the talker prefill
# Code-predictor sampling (the talker is always greedy)
SUBTALKER_TEMPERATURE = 0.9
SUBTALKER_TOP_K = 50


def stream_seed(*parts: int) -> int:
    """Mix integers into one 63-bit generator seed (splitmix64 rounds)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = ((h ^ (p & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


@dataclass
class TTSConfig:
    """Engine configuration: the JAX `TTSConfig`'s fields, defaults and
    meanings, plus `device`."""

    device: str = "cuda"                  # "cpu" runs every kernel's plain version
    model_path: Optional[str] = None      # a directory with model.safetensors; None → random
    vocoder_path: Optional[str] = None    # a file, or a dir with {vocoder,code2wav}.safetensors
    sample_rate: int = 24000
    chunk_frames: int = 10                # ~0.8 s per chunk at 12.5 Hz
    # Reserved, as in JAX: the talker is always greedy; only the subtalker_*
    # fields control sampling (the code predictor's)
    do_sample: bool = True
    temperature: float = 0.9
    top_k: int = 50
    repetition_penalty: float = 1.05
    max_new_tokens: int = MAX_NEW_TOKENS  # frame cap above the word-count cap
    subtalker_do_sample: bool = True      # False: greedy code predictor
    subtalker_temperature: float = SUBTALKER_TEMPERATURE
    subtalker_top_k: int = SUBTALKER_TOP_K
    seed: int = 0
    max_seq_len: int = 8192               # talker KV-cache length
    vocoder_mode: str = "auto"            # auto | random | silence
    vocoder_backend: str = "fast"         # fast | code2wav
    vocoder_dtype: str = "float32"        # code2wav only: float32 | bfloat16
    code2wav_impl: str = "packed"         # packed | reference numerics
    code2wav_config: Optional[Code2WavConfig] = None
    code2wav_window: int = 160            # non-streaming decode window (frames)
    code2wav_ctx: int = 25                # its left-context frames
    trailing_bucket: int = TRAILING_BUCKET
    backend: str = "auto"                 # auto | dense | pallas | mega
    # One CUDA-graph replay per audio chunk, the next chunk enqueued before
    # the current one is read; False: the eager loop
    fused_chunks: bool = True
    # Capture the graphs of one text bucket and `chunk_frames`, and warm the
    # vocoder's shapes, in initialize(): no request pays for either
    warmup: bool = True
    # Weight-only quantization of the talker: False (bf16), True or "int8"
    # (per channel, + int8 LM head), "int4" (group-128, int8 head), "mixed"
    # (int8 attention + int4-g128 MLP). The code predictor then takes
    # `cp_quantize` ("int8" | "int4" | "mixed"); its heads stay bf16.
    quantize: bool | str = False
    kv_cache: str = "bf16"                # talker KV cache: "bf16" | "int8"
    cp_quantize: str = "int8"
    mrope: bool = True                    # interleaved M-RoPE of the released talker
    mrope_section: tuple = (24, 20, 20)


_CHOICES = {"backend": ("auto", "dense", "pallas", "mega"),
            "vocoder_backend": ("fast", "code2wav"),
            "vocoder_mode": ("auto", "random", "silence"),
            "vocoder_dtype": ("float32", "bfloat16"),
            "code2wav_impl": ("packed", "reference")}


def _quant_mode(cfg: TTSConfig):
    """The talker's quantizer name, or False; raises on an unknown knob."""
    for name, allowed in _CHOICES.items():
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}: one of {allowed}")
    mode = "int8" if cfg.quantize is True else cfg.quantize
    if mode not in (False, *QUANTIZERS):
        raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
    if cfg.kv_cache not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_cache {cfg.kv_cache!r}")
    if cfg.cp_quantize not in QUANTIZERS:
        raise ValueError(f"unknown cp_quantize mode {cfg.cp_quantize!r}")
    return mode


class _Stream:
    """One fused request's hold on the graphs' static state: the chunks it
    enqueued and has not read, and while another request holds the state,
    its own copy of it (`parked`) and of its unread chunks' outputs."""

    def __init__(self, Tpad: int):
        self.Tpad = Tpad
        self.pending: list[tuple] = []    # (slot, n, first frame) in the ring, unread
        self.held: dict[tuple, Slot] = {}  # (slot, first frame) -> parked outputs
        self.parked: dict | None = None


class TTSEngine:
    """PyTorch TTS engine (same surface as the JAX `TTSEngine`)."""

    def __init__(self, config: Optional[TTSConfig] = None,
                 model_config: Optional[TTSModelConfig] = None):
        self.config = cfg = config or TTSConfig()
        self._quant_mode = _quant_mode(cfg)
        self._kv_dtype = torch.int8 if cfg.kv_cache == "int8" else torch.bfloat16
        mc = model_config or TTSModelConfig()
        talker = dataclasses.replace(mc.talker, max_seq_len=cfg.max_seq_len)
        if cfg.mrope and talker.mrope_section is None:
            secs = tuple(cfg.mrope_section)
            if sum(secs) != talker.head_dim // 2:
                raise ValueError(f"mrope_section {secs} must sum to head_dim//2 "
                                 f"({talker.head_dim // 2})")
            talker = dataclasses.replace(talker, mrope_section=secs, mrope_interleaved=True)
        self.model_config = dataclasses.replace(mc, talker=talker)
        self.device = torch.device(cfg.device)
        self._c2w = cfg.vocoder_backend == "code2wav"
        if self._c2w:
            self.vocoder_config = cfg.code2wav_config or Code2WavConfig(
                sample_rate=cfg.sample_rate)
            if self.vocoder_config.num_quantizers != mc.num_code_groups:
                raise ValueError(f"code2wav num_quantizers ({self.vocoder_config.num_quantizers})"
                                 f" must match the model's code groups ({mc.num_code_groups})")
        else:
            self.vocoder_config = VocoderConfig(sample_rate=cfg.sample_rate)
        self.sample_rate = self.vocoder_config.sample_rate
        self._initialized = False

    # ── initialization ───────────────────────────────────────────────────

    def initialize(self, weights: Optional[TTSWeights] = None, vocoder_weights=None):
        """Weights (given; else loaded from `model_path`; else random from
        `seed`; quantized here when `quantize` is set, the bf16 decoder
        matrices dropped), the vocoder (given, in the backend's f32 tree;
        else per `vocoder_mode`), constant embeddings; on a GPU also builds
        the kernels, so no request pays for nvcc, and with `warmup` captures
        the graphs of one text bucket (`fused_chunks`) and warms the
        vocoder's shapes. Raises on a CUDA device when the machine has none."""
        if self._initialized:
            return
        cfg, mc, dev = self.config, self.model_config, self.device
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TTSConfig.device is {cfg.device!r} but no CUDA device "
                               f"is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if weights is None:
            weights = (load_tts_weights(cfg.model_path, mc, dev) if cfg.model_path
                       else init_tts_weights(cfg.seed, mc, dev))
        self.weights = weights
        if self._quant_mode:
            cp = self.weights.code_predictor
            self.weights = self.weights._replace(
                talker=QUANTIZERS[self._quant_mode](self.weights.talker),
                code_predictor=cp._replace(decoder=QUANTIZERS[cfg.cp_quantize](
                    cp.decoder, quant_head=False)))
        del weights
        self.tokenizer = load_tokenizer(cfg.model_path)
        self._load_vocoder(vocoder_weights)

        if cfg.backend == "auto":
            self._attn_impl = "mega" if dev.type == "cuda" else "dense"
        else:
            self._attn_impl = cfg.backend
        # the batched path's attention: the kernel (its plain version on the
        # CPU), or the plain version on backend "dense"
        self._batch_impl = "dense" if cfg.backend == "dense" else "pallas"
        secs = mc.talker.mrope_section
        self._mrope_deltas = None if secs is None else [0] * len(secs)

        tp_w, tw = self.weights.text_projection, self.weights.talker
        special = embed_text_ids(tp_w, torch.tensor([TTS_PAD, TTS_BOS, TTS_EOS], device=dev))
        self._tts_pad_embed, self._tts_eos_embed = special[0], special[2]
        role_ids = encode_tts_prompt(self.tokenizer, "")[:3]
        self._role_embeds = embed_text_ids(tp_w, torch.from_numpy(role_ids).long().to(dev))
        codec_embeds = tw.embed[torch.tensor(
            [CODEC_NOTHINK, CODEC_THINK_BOS, CODEC_THINK_EOS, CODEC_PAD, CODEC_BOS],
            device=dev)]
        tts_prefix = torch.cat([special[0:1].expand(3, -1), special[1:2]])
        self._fused_tags = (tts_prefix + codec_embeds[:4]).to(torch.bfloat16)
        self._codec_bos_embed = codec_embeds[4]

        if dev.type == "cuda":
            from ..ops.cuda_lib import load_library

            load_library()
        v = mc.code_predictor.vocab_size
        self._top_k = cfg.subtalker_top_k if 0 < cfg.subtalker_top_k < v else v
        self._gen = torch.Generator(device=dev)
        self._cp_state = init_state(mc.code_predictor, dev)
        self._requests = 0
        self._frames_generated = 0
        self._talker_steps = 0
        self._cp_steps = 0
        self._talker_state = None
        if cfg.fused_chunks:
            self._build_fused_fns()
        if cfg.warmup and dev.type == "cuda":
            self._warmup()
        self._initialized = True

    def _load_vocoder(self, given) -> None:
        """The vocoder's weights (JAX `_load_vocoder` / `_load_code2wav`):
        `given`; else, with vocoder_mode "auto", the file at `vocoder_path`;
        else random from `seed + 1` ("auto" and "random"); else None
        (silence). Code2Wav weights are then cast to their serving form:
        "packed" (matrices in `vocoder_dtype`, the rest f32) or "reference"
        (everything in `vocoder_dtype`). Sets `_frames_decode`."""
        cfg, vc, dev = self.config, self.vocoder_config, self.device
        load, init = ((load_code2wav, init_code2wav_weights) if self._c2w
                      else (load_vocoder, init_vocoder_weights))
        w = given
        if w is None and cfg.vocoder_mode == "auto" and cfg.vocoder_path:
            w = load(cfg.vocoder_path, vc, dev)
        self._vocoder_is_random = w is None and cfg.vocoder_mode in ("auto", "random")
        if self._vocoder_is_random:
            w = init(cfg.seed + 1, vc, dev)
        if w is not None and self._c2w:
            dt = torch.bfloat16 if cfg.vocoder_dtype == "bfloat16" else torch.float32
            if cfg.code2wav_impl == "packed":
                w = pack_code2wav_weights(w, dt)
            else:
                leaves = dict(named_leaves(w))
                w = build_tree(w, lambda path: leaves[path].to(dt))
        self.vocoder_weights = w
        if self._c2w:
            apply = code2wav_apply_packed if cfg.code2wav_impl == "packed" else code2wav_apply
            W = max(cfg.code2wav_window, cfg.code2wav_ctx + 1)
            self._c2w_window, self._c2w_ctx = W, cfg.code2wav_ctx
            self._c2w_buckets = tuple(sorted({max(W // 4, 1), max(W // 2, 1), W}))

            def raw(codes):
                """codes [T, 16] → [output_samples(T)] f32."""
                cl = codes.clamp(0, vc.codebook_size - 1)
                return apply(vc, self.vocoder_weights, cl.t()[None])[0].float()

            self._raw_decode = raw
        self._frames_decode = self._c2w_frames_decode if self._c2w else (
            lambda codes, ctx=None: vocoder_decode(vc, self.vocoder_weights, codes))

    def _c2w_frames_decode(self, codes: torch.Tensor, ctx: torch.Tensor | None = None):
        """codes [n, 16] (after left-context codes ctx [c, 16]) on the device
        → exactly [n * hop] f32 (JAX `frames_decode`): [ctx; codes] decoded
        and the samples kept from c * hop - deficit; without context the
        decode front-padded by `deficit` zeros."""
        vc = self.vocoder_config
        hop, deficit, n = vc.hop_length, vc.output_deficit, codes.shape[0]
        if ctx is None:
            return F.pad(self._raw_decode(codes), (deficit, 0))
        off = ctx.shape[0] * hop - deficit
        return self._raw_decode(torch.cat([ctx, codes]))[off:off + n * hop]

    # ── synthesis ────────────────────────────────────────────────────────

    def synthesize(self, text: str) -> tuple[np.ndarray, int]:
        """Non-streaming synthesis → (waveform f32, sample_rate). On the fused
        path with Code2Wav, the streamed chunks joined (they join without a
        gap by construction); otherwise every frame first, then one vocoder
        decode of them all."""
        self.initialize()
        cf = self.config.chunk_frames
        if self.config.fused_chunks and self._c2w and self.vocoder_weights is not None:
            parts = [a for a, _frames in self._generate_audio_chunks(text, cf)]
            return (np.concatenate(parts) if parts else np.array([], np.float32),
                    self.sample_rate)
        frames = [f for _audio, chunk in self._generate_chunks(text, cf, with_audio=False)
                  for f in chunk]
        return self._decode_to_audio(frames)

    async def synthesize_streaming(
        self, text: str, chunk_frames: Optional[int] = None,
    ) -> AsyncGenerator[tuple[np.ndarray, int], None]:
        """Streaming synthesis: a first chunk of one frame, then
        `chunk_frames`-frame chunks."""
        self.initialize()
        for audio, _frames in self._generate_chunks(
                text, chunk_frames or self.config.chunk_frames, with_audio=True):
            yield audio, self.sample_rate
            await asyncio.sleep(0)

    def synthesize_batch(self, texts: list[str]) -> list[tuple[np.ndarray, int]]:
        """Batched non-streaming synthesis (JAX `synthesize_batch` :738-809,
        without its `mesh`): the B texts' prefixes as one batched prefill,
        then one batched run of frames up to the longest text's cap
        (`runtime/batch.py`); each text keeps its frames up to its EOS or
        cap, decoded as `synthesize` decodes them. Text b takes the next
        request number, which keys its sampling noise: its codes depend on
        that number, not on the other texts or its row (they equal the same
        text's in any batch of B rows, bit for bit; a batch of another size
        rounds its products otherwise)."""
        self.initialize()
        if not texts:
            return []
        from ..runtime.batch import batched_frames, batched_prefill

        mc, cfg, dev = self.model_config, self.config, self.device
        reqs = [self._new_request(t) for t in texts]
        B, Tpad, n = len(texts), max(r[1] for r in reqs), max(r[2] for r in reqs)
        if PREFIX_ROWS + 1 + n > cfg.max_seq_len:
            raise ValueError(f"positions [0, {PREFIX_ROWS + 1 + n}) exceed max_seq_len "
                             f"{cfg.max_seq_len}")
        ids = np.zeros((B, Tpad + 1), dtype=np.int64)
        for b, (content, _, _, _) in enumerate(reqs):
            ids[b, :len(content)], ids[b, Tpad] = content, len(content)
        ids = torch.from_numpy(ids).to(dev)
        trailing = torch.empty((B, Tpad, mc.talker.hidden_size), dtype=torch.bfloat16,
                               device=dev)
        t_len = torch.empty(B, dtype=torch.int32, device=dev)
        prefill = torch.stack([self._prefix(ids[b, :Tpad], ids[b, Tpad], trailing[b], t_len[b])
                               for b in range(B)])
        state, tok, hid = batched_prefill(mc.talker, self.weights.talker, prefill,
                                          attn_impl=self._batch_impl, kv_dtype=self._kv_dtype,
                                          mrope_deltas=self._mrope_deltas)
        uniform = None
        if cfg.subtalker_do_sample:
            uniform = torch.empty((B, n, mc.num_code_groups - 1, self._top_k),
                                  dtype=torch.float32, device=dev)
            for b, r in enumerate(reqs):
                self._draw(r[3], 0, n, uniform[b])
        _, codes, valid, _, _ = batched_frames(
            mc.talker, mc.code_predictor, self.weights.talker, self.weights.code_predictor,
            state, tok, hid, trailing, t_len, torch.zeros(B, dtype=torch.int32, device=dev),
            self._tts_pad_embed, uniform, num_frames=n, do_sample=cfg.subtalker_do_sample,
            temperature=cfg.subtalker_temperature, top_k=cfg.subtalker_top_k,
            attn_impl=self._batch_impl, mrope_deltas=self._mrope_deltas,
            cp_state=init_state(mc.code_predictor, dev, slots=B))
        codes_np, valid_np = codes.cpu().numpy().astype(np.int32), valid.cpu().numpy()
        self._count_steps(B * n)
        self._talker_steps += B                   # the CODEC_BOS steps
        results, kept = [], 0
        for b, r in enumerate(reqs):
            keep = min(int(valid_np[b].sum()), r[2])
            kept += keep
            results.append(self._decode_to_audio([codes_np[b, i] for i in range(keep)]))
        self._frames_generated = kept
        return results

    # ── what every path shares ───────────────────────────────────────────

    def _new_request(self, text: str):
        """Tokenize and number a request: (content ids, padded length, frame
        cap, request number)."""
        cfg = self.config
        content = encode_tts_prompt(self.tokenizer, text)[3:]
        bucket = cfg.trailing_bucket
        Tpad = max(-(-len(content) // bucket) * bucket, bucket)
        word_count = max(len(text.split()), 1)
        max_frames = min(max(int(word_count / 2.5 * 12.5 * 2.0), 25), cfg.max_new_tokens)
        self._requests += 1
        return content, Tpad, max_frames, self._requests

    def _draw(self, request: int, frame0: int, n: int, out: torch.Tensor | None = None):
        """The uniform draws of frames frame0.. frame0+n-1 of a request,
        `[n, 15, top_k]` f32 on the device (into `out` if given): frame f's
        rows from a generator seeded by (seed, request, f), the bits
        `torch.rand` gives. None when the code predictor is greedy."""
        if not self.config.subtalker_do_sample:
            return None
        if out is None:
            out = torch.empty((n, self.model_config.num_code_groups - 1, self._top_k),
                              dtype=torch.float32, device=self.device)
        for i in range(n):
            self._gen.manual_seed(stream_seed(self.config.seed, request, frame0 + i))
            out[i].uniform_(0.0, 1.0, generator=self._gen)
        return out

    def _prefix(self, ids: torch.Tensor, n: torch.Tensor, trailing: torch.Tensor,
                t_len: torch.Tensor) -> torch.Tensor:
        """Text projection and the 8 conditioning rows `[8, H]` (the JAX
        `first_fn`'s), from the padded ids `[Tpad]` and their count `n`
        (0-d), both on the device. Writes the trailing rows `[Tpad, H]` bf16
        (row i the embedding of content id i+1 below n-6, tts_eos at
        max(n-6, 0), zero above) and their count max(n-5, 1) in place."""
        content = embed_text_ids(self.weights.text_projection, ids)
        prefill = torch.cat([self._role_embeds, self._fused_tags,
                             content[:1] + self._codec_bos_embed[None]])
        rows = torch.arange(ids.shape[0], device=ids.device)[:, None]
        eos_pos = (n - 6).clamp_min(0)
        trailing.copy_(torch.where(rows < eos_pos, content.roll(-1, 0),
                                   torch.where(rows == eos_pos, self._tts_eos_embed[None],
                                               torch.zeros_like(content))))
        t_len.copy_((n - 5).clamp_min(1))
        return prefill

    def _start(self, ids: torch.Tensor, n: torch.Tensor, trailing: torch.Tensor,
               t_len: torch.Tensor, state, attn_impl: str | None = None):
        """`_prefix`, then the conditioning prefill and the first talker step
        (the JAX `first_fn` up to its first frame) on `attn_impl` (default:
        the engine's). Returns (state, token, hidden)."""
        prefill = self._prefix(ids, n, trailing, t_len)
        return talker_prefill(self.model_config.talker, self.weights.talker, state, prefill,
                              attn_impl=attn_impl or self._attn_impl,
                              mrope_deltas=self._mrope_deltas)

    def _talker_cache(self):
        """A fresh talker state; on the backends without the decode kernel
        it carries its position on the device, where their single-token
        steps read it."""
        return init_state(self.model_config.talker, self.device, self._kv_dtype,
                          device_pos=self._attn_impl != "mega")

    def _frames(self, state, token, hidden, trailing, t_len, idx0, uniform, n: int):
        """`frames_chunk` over n frames with the engine's weights and options."""
        mc, cfg = self.model_config, self.config
        return frames_chunk(
            mc.talker, mc.code_predictor, self.weights.talker, self.weights.code_predictor,
            state, token, hidden, trailing, t_len, idx0, self._tts_pad_embed, uniform,
            num_frames=n, do_sample=cfg.subtalker_do_sample,
            temperature=cfg.subtalker_temperature, top_k=cfg.subtalker_top_k,
            attn_impl=self._attn_impl, mrope_deltas=self._mrope_deltas,
            cp_state=self._cp_state)

    def _count_steps(self, frames: int, first: bool = False) -> None:
        """Decode steps run: one talker and 14 code-predictor steps a frame
        (the last group needs no step), and the BOS step of a first chunk."""
        self._talker_steps += frames + int(first)
        self._cp_steps += frames * (self.model_config.num_code_groups - 2)

    def _generate_chunks(self, text: str, chunk_size: int, with_audio: bool):
        """Yield (audio f32 or None, frames) per chunk: 1 frame, then
        `chunk_size`, by the fused path or the eager loop."""
        if not self.config.fused_chunks:
            return self._generate_chunks_eager(text, chunk_size, with_audio)
        if chunk_size == self.config.chunk_frames:
            return self._generate_audio_chunks(text, chunk_size)
        return self._generate_codec_chunks(text, chunk_size, with_audio)

    # ── the fused path: one CUDA-graph replay per chunk ──────────────────

    def _build_fused_fns(self):
        """The static buffers the graphs read and write: the talker and
        code-predictor caches, the carried token, hidden state, trailing
        index and length, Code2Wav's context codes, the uniform draws, and
        the ring of host slots. Graphs themselves are captured by `_prepare`."""
        mc, dev = self.model_config, self.device
        self._graphs = ChunkGraphs(dev)
        self._talker = self._talker_cache()
        self._pos = 0                      # the talker's host position
        self._tok = torch.zeros((), dtype=torch.int64, device=dev)
        self._hid = torch.zeros(mc.talker.hidden_size, dtype=torch.float32, device=dev)
        self._idx0 = torch.zeros((), dtype=torch.int32, device=dev)
        self._t_len = torch.zeros((), dtype=torch.int32, device=dev)
        self._trailing: dict[int, torch.Tensor] = {}   # Tpad -> [Tpad, H] bf16
        self._ids: dict[int, tuple] = {}               # Tpad -> (host, device) [Tpad + 1]
        self._uniform: dict[int, torch.Tensor] = {}    # n -> [n, 15, top_k] f32
        self._ctx: dict[int, torch.Tensor] = {}        # n -> [n, 16] codes of the last chunk
        self._out: dict[int, list] = {}                # n -> host output slots
        self._owner: _Stream | None = None
        self._slot = 0

    def _buffers(self, Tpad: int, n: int, slots: int) -> None:
        """Allocate what the graphs of this text bucket and chunk size use."""
        mc, g, dev = self.model_config, self._graphs, self.device
        groups = mc.num_code_groups
        if Tpad not in self._trailing:
            self._trailing[Tpad] = torch.zeros((Tpad, mc.talker.hidden_size),
                                               dtype=torch.bfloat16, device=dev)
            self._ids[Tpad] = (g.host(Tpad + 1, torch.int64),
                               torch.zeros(Tpad + 1, dtype=torch.int64, device=dev))
        for m, k in ((1, 1), (n, slots)):
            if m not in self._uniform:
                self._uniform[m] = torch.zeros((m, groups - 1, self._top_k),
                                               dtype=torch.float32, device=dev)
            if self._c2w and m not in self._ctx:
                self._ctx[m] = torch.zeros((m, groups), dtype=torch.int64, device=dev)
            out = self._out.setdefault(m, [])   # graphs hold these: only ever added to
            while len(out) < k:
                out.append(g.slot(m, groups, self.vocoder_config.hop_length))

    def _body(self, Tpad: int, n: int, slot: int, first: bool, audio: bool,
              ctx: int = 0) -> None:
        """One graph's work: the first chunk from the ids (`first`), or n
        frames from the carried state; the vocoder (`audio`; Code2Wav with
        the `ctx` frames of context codes, 0: none, then its own codes kept
        as the next chunk's context); the outputs copied into host slot
        `slot` of size n."""
        if first:
            host, ids = self._ids[Tpad]
            ids.copy_(host, non_blocking=True)
            state, tok, hid = self._start(ids[:Tpad], ids[Tpad], self._trailing[Tpad],
                                          self._t_len, self._talker._replace(position=0))
            self._idx0.zero_()
        else:
            state, tok, hid = self._talker._replace(position=self._pos), self._tok, self._hid
        state, codes, valid, tok, hid = self._frames(
            state, tok, hid, self._trailing[Tpad], self._t_len, self._idx0,
            self._uniform[n], n)
        self._tok.copy_(tok)
        self._hid.copy_(hid)
        self._idx0.add_(n)
        out = self._out[n][slot]
        out.codes.copy_(codes, non_blocking=True)
        out.valid.copy_(valid, non_blocking=True)
        if audio and self.vocoder_weights is not None:
            wav = self._frames_decode(codes, self._ctx[ctx] if ctx else None)
            if self._c2w:
                self._ctx[n].copy_(codes)
            out.audio.copy_(wav, non_blocking=True)

    def _keys(self, Tpad: int, n: int, audio: bool):
        """The graphs a request of this bucket and chunk size replays:
        (kind, frames, Tpad, slot, context frames). With Code2Wav the second
        chunk (ring slot 1) has the first chunk's one frame as context and
        later chunks a whole chunk."""
        if not audio:
            chunk = [("frames", n, Tpad, 0, 0)]
        elif self._c2w and self.vocoder_weights is not None:
            chunk = list(dict.fromkeys([("chunk", n, Tpad, 1, 1)] + [
                ("chunk", n, Tpad, s, n) for s in range(RING)]))
        else:
            chunk = [("chunk", n, Tpad, s, 0) for s in range(RING)]
        return [("first", 1, Tpad, 0, 0), *chunk]

    def _prepare(self, Tpad: int, n: int, audio: bool = True) -> None:
        """Make sure the graphs of this text bucket and chunk size exist: on
        a GPU, run the first body and a chunk body at each context shape
        once on the graphs' stream (so the kernel arrays, library handles
        and convolution plans they use exist), then capture each missing
        graph. Runs for the stream that holds the state, before its first
        replay; the state it leaves is overwritten by that replay."""
        self._buffers(Tpad, n, RING if audio else 1)
        g = self._graphs
        keys = self._keys(Tpad, n, audio)
        missing = [k for k in keys if k not in g.graphs]
        if not g.cuda or not missing:
            return
        S = self.config.max_seq_len
        if PREFIX_ROWS + 2 + n > S:
            raise ValueError(f"positions [0, {PREFIX_ROWS + 2 + n}) exceed max_seq_len {S}")
        g.stream.wait_stream(torch.cuda.current_stream(self.device))   # weights, buffers
        with g.on_stream():
            self._body(Tpad, 1, 0, first=True, audio=True)
            for ctx in sorted({k[4] for k in keys[1:]}):
                self._pos = PREFIX_ROWS + 2
                self._body(Tpad, n, 0, first=False, audio=audio, ctx=ctx)
        for kind, m, _, slot, ctx in missing:
            first = kind == "first"
            g.capture((kind, m, Tpad, slot, ctx),
                      lambda: self._body(Tpad, m, slot, first, kind != "frames", ctx),
                      carried=() if first else (self._talker,))
        self._pos = 0

    def _warmup(self):
        """On the fused path, capture the graphs of the `trailing_bucket`
        bucket and `chunk_frames` and replay each once. Then warm the
        vocoder at every shape a request decodes outside the graphs: the
        "fast" vocoder at the bucket sizes `_decode_to_audio` pads to (1,
        chunk_frames, ... up to 160 frames); Code2Wav at each window bucket
        with and without context and at a partial last chunk after either
        context."""
        cfg, dev = self.config, self.device
        cf = cfg.chunk_frames
        if cfg.fused_chunks:
            self._prepare(cfg.trailing_bucket, cf)
            keys = self._keys(cfg.trailing_bucket, cf, True)
            room = cfg.max_seq_len - PREFIX_ROWS - 2 - (len(keys) - 1) * cf
            for key in keys[:None if room >= 0 else 1]:
                self._graphs.replay(key, None)
        if self.vocoder_weights is not None:
            zeros = lambda m: torch.zeros((m, self.model_config.num_code_groups),  # noqa: E731
                                          dtype=torch.int64, device=dev)
            if self._c2w:
                for b in self._c2w_buckets:
                    self._raw_decode(zeros(b))
                    self._raw_decode(zeros(self._c2w_ctx + b))
                self._frames_decode(zeros(1))
                for c in (1, cf):
                    self._frames_decode(zeros(cf), zeros(c))
            else:
                sizes, b = [1, cf], cf
                while b < 160:
                    b *= 2
                    sizes.append(b)
                for b in sizes:
                    self._frames_decode(zeros(b))
        torch.cuda.synchronize(dev)
        self._pos = 0

    # parking: several live streams on one set of graphs

    def _carried(self, Tpad: int) -> dict:
        """The static tensors a stream's next replay reads, besides the cache."""
        out = {"tok": self._tok, "hid": self._hid, "idx0": self._idx0, "t_len": self._t_len,
               "trailing": self._trailing[Tpad]}
        if self._talker.pos is not None:
            out["pos"] = self._talker.pos
        out.update({("ctx", m): t for m, t in self._ctx.items()})
        return out

    def _acquire(self, s: _Stream) -> None:
        """Give stream `s` the graphs' static state: park the holder's, restore
        `s`'s. Nothing is copied when `s` holds it already."""
        if self._owner is s:
            return
        if self._owner is not None:
            self._park(self._owner)
        if s.parked is not None:
            self._restore(s)
        self._owner = s

    def _park(self, s: _Stream) -> None:
        """Copy the holder's state into tensors of its own, after its
        in-flight replays: the outputs of its unread chunks, the talker's
        cache rows [0, pos) and the decode kernel's position array, the
        carried tensors, the host position and ring slot."""
        g, st, p = self._graphs, self._talker, self._pos
        for slot, n, base in s.pending:
            g.wait(slot)
            out = self._out[n][slot]
            s.held[(slot, base)] = Slot(out.codes.clone(), out.valid.clone(), out.audio.clone())
        s.pending.clear()
        entry = g.owned.arrays.get(st.k_cache.data_ptr())
        with g.on_stream():
            s.parked = {
                "cache": [t[:, :, :p].clone() for t in (st.k_cache, st.v_cache, st.k_scale,
                                                       st.v_scale) if t is not None],
                "carried": {k: t.clone() for k, t in self._carried(s.Tpad).items()},
                "positions": None if entry is None else entry[0].clone(),
                "pos": p, "slot": self._slot}

    def _restore(self, s: _Stream) -> None:
        """Copy a parked state back into the graphs' static tensors and free it."""
        g, st, d = self._graphs, self._talker, s.parked
        p = d["pos"]
        caches = [t for t in (st.k_cache, st.v_cache, st.k_scale, st.v_scale) if t is not None]
        with g.on_stream():
            for dst, src in zip(caches, d["cache"]):
                dst[:, :, :p].copy_(src)
            carried = self._carried(s.Tpad)
            for k, src in d["carried"].items():
                carried[k].copy_(src)
            if d["positions"] is not None:
                g.owned.arrays[st.k_cache.data_ptr()][0].copy_(d["positions"])
        g.owned.forget()
        self._pos, self._slot = p, d["slot"]
        s.parked = None

    def _release(self, s: _Stream) -> None:
        """A stream ended or was closed: drop what it holds."""
        if self._owner is s:
            self._owner = None
        s.parked, s.held, s.pending = None, {}, []

    def _check_room(self, n: int) -> None:
        """The graphs run whole chunks without the decode wrapper's checks:
        the talker must have room for all n steps, frames past the cap
        included."""
        S = self.config.max_seq_len
        if self._pos + n > S:
            raise ValueError(f"positions [{self._pos}, {self._pos + n}) exceed max_seq_len {S}")

    def _enqueue_first(self, content: np.ndarray, request: int, s: _Stream) -> tuple:
        """Enqueue the first chunk (ids → one frame and its audio) into slot 0."""
        self._acquire(s)
        self._pos = 0
        self._check_room(PREFIX_ROWS + 2)
        g, Tpad = self._graphs, s.Tpad
        g.wait(0)           # the slot's last reader, and the ids' last upload, are done
        host = self._ids[Tpad][0]
        host.zero_()
        host[:len(content)] = torch.from_numpy(np.asarray(content, dtype=np.int64))
        host[Tpad] = len(content)
        with g.on_stream():
            self._draw(request, 0, 1, self._uniform[1])
            g.replay(("first", 1, Tpad, 0, 0), lambda: self._body(Tpad, 1, 0, True, True))
            g.record(0)
        self._slot = 0
        self._pos = PREFIX_ROWS + 2
        self._count_steps(1, first=True)
        self._talker_state = self._talker._replace(position=self._pos)
        s.pending.append((0, 1, 0))
        return 0, 1, 0

    def _enqueue_chunk(self, n: int, request: int, frame0: int, s: _Stream,
                       audio: bool = True) -> tuple:
        """Enqueue the n frames from `frame0` (with their audio) into the
        next slot of the ring (frames-only: the size's one slot)."""
        self._acquire(s)
        self._check_room(n)
        g, Tpad = self._graphs, s.Tpad
        slot = (self._slot + 1) % RING if audio else 0
        ctx = 0
        if audio and self._c2w and self.vocoder_weights is not None:
            ctx = 1 if frame0 == 1 else n
        key = ("chunk" if audio else "frames", n, Tpad, slot, ctx)
        with g.on_stream():
            self._draw(request, frame0, n, self._uniform[n])
            g.replay(key, lambda: self._body(Tpad, n, slot, False, audio, ctx))
            g.record(slot)
        if audio:
            self._slot = slot
        self._pos += n
        self._count_steps(n)
        self._talker_state = self._talker._replace(position=self._pos)
        s.pending.append((slot, n, frame0))
        return slot, n, frame0

    def _read(self, s: _Stream, slot: int, n: int, base: int):
        """A chunk's outputs (codes int32 [n, 16], valid [n], audio [n * hop]):
        from its parked copy, or from its slot once the slot's event passed."""
        held = s.held.pop((slot, base), None)
        if held is None:
            if self._owner is not s:
                raise RuntimeError("a stream read a chunk that neither its ring slot nor "
                                   "its parked state holds")
            self._graphs.wait(slot)
            held = self._out[n][slot]
            s.pending.remove((slot, n, base))
        hop = self.vocoder_config.hop_length
        return (held.codes.numpy().astype(np.int32), held.valid.numpy().copy(),
                held.audio[:n * hop].numpy().copy())

    def _generate_audio_chunks(self, text: str, chunk_size: int):
        """The fused streaming loop (JAX `_generate_audio_chunks` :836-931):
        the first chunk and the next one enqueued before the first read;
        after the first chunk's yield one more, and from then on the next
        chunk enqueued before each blocking read: at most two in flight
        beside the one being read. A full chunk yields the audio of its
        graph; a chunk cut by EOS or the cap yields its kept frames' audio
        (`_terminal_chunk_audio`). Frames past EOS or the cap are computed,
        counted in `get_metrics()`, and dropped."""
        content, Tpad, max_frames, req = self._new_request(text)
        s = _Stream(Tpad)
        try:
            self._acquire(s)
            self._prepare(Tpad, chunk_size)
            q = deque([self._enqueue_first(content, req, s)])
            planned = 1

            def enqueue():
                nonlocal planned
                q.append(self._enqueue_chunk(chunk_size, req, planned, s))
                planned += chunk_size

            if planned < max_frames:
                enqueue()                                  # depth 1 before the first read
            prev = None                                    # the last full chunk's codes
            while q:
                slot, n, base = q.popleft()
                if base >= max_frames:
                    break
                if base > 0 and planned < max_frames:
                    enqueue()                              # depth 2: before the blocking read
                codes, valid, audio = self._read(s, slot, n, base)
                keep = min(int(valid.sum()), max_frames - base)
                frames = [codes[i] for i in range(keep)]
                self._frames_generated = base + keep
                if keep < n:
                    if keep > 0:
                        yield self._terminal_chunk_audio(frames, n, prev), frames
                    return
                if self.vocoder_weights is None:       # silence, of JAX's length
                    audio = self._decode_to_audio(frames)[0]
                yield audio, frames
                prev = codes
                if base + keep >= max_frames:
                    return
                if base == 0 and planned < max_frames:
                    enqueue()                              # refill to depth 2
        finally:
            self._release(s)

    def _terminal_chunk_audio(self, frames: list[np.ndarray], n: int, prev):
        """Audio of a chunk cut short (JAX `_terminal_chunk_audio`): with
        Code2Wav and a chunk before it, repeat-padded to n frames and decoded
        with that chunk as context; otherwise `_decode_to_audio`."""
        if self._c2w and self.vocoder_weights is not None and prev is not None:
            return self._context_chunk_audio(frames, n, prev)
        return self._decode_to_audio(frames)[0]

    def _context_chunk_audio(self, frames: list[np.ndarray], n: int, prev) -> np.ndarray:
        """Code2Wav audio of a chunk's frames after the codes `prev` (None at
        the first chunk): a chunk of fewer than n frames after another is
        repeat-padded to n; the decode is cut back to the frames' samples."""
        k = len(frames)
        cur = np.stack(frames)
        if prev is not None and k < n:
            cur = np.concatenate([cur, np.broadcast_to(cur[-1], (n - k, cur.shape[1]))])
        dev = self.device
        ctx = None if prev is None else torch.from_numpy(np.asarray(prev, np.int64)).to(dev)
        wav = self._frames_decode(torch.from_numpy(cur.astype(np.int64)).to(dev), ctx)
        return wav[: k * self.vocoder_config.hop_length].cpu().numpy()

    def _generate_codec_chunks(self, text: str, chunk_size: int, with_audio: bool):
        """Streaming at a chunk size other than `chunk_frames` (JAX
        `_generate_codec_chunks` :956-1002 and `synthesize_streaming`
        :690-720): the first chunk's graph, then a frames-only graph of
        `chunk_size` frames a chunk, each read before the next is enqueued.
        Audio outside the graphs: "fast" through `_decode_to_audio`; Code2Wav
        with the previous chunk as context (`_context_chunk_audio`)."""
        content, Tpad, max_frames, req = self._new_request(text)
        s = _Stream(Tpad)
        try:
            self._acquire(s)
            self._prepare(Tpad, chunk_size, audio=False)
            produced, alive, prev = 0, True, None
            while alive and produced < max_frames:
                first = produced == 0
                if first:
                    entry = self._enqueue_first(content, req, s)
                else:
                    entry = self._enqueue_chunk(chunk_size, req, produced, s, audio=False)
                codes, valid, audio = self._read(s, *entry)
                keep = min(int(valid.sum()), max_frames - produced)
                alive = bool(valid.all()) and produced + keep < max_frames
                frames = [codes[i] for i in range(keep)]
                produced += keep
                self._frames_generated = produced
                if not keep:
                    continue
                if not with_audio:
                    audio = None
                elif self._c2w and self.vocoder_weights is not None:
                    if not first:                # the first chunk's graph decoded it
                        audio = self._context_chunk_audio(frames, chunk_size, prev)
                    prev = np.stack(frames)
                elif not first or self.vocoder_weights is None:
                    audio = self._decode_to_audio(frames)[0]
                yield audio, frames
        finally:
            self._release(s)

    # ── the eager loop (fused_chunks=False) ──────────────────────────────

    def _generate_chunks_eager(self, text: str, chunk_size: int, with_audio: bool):
        """Each chunk's ops enqueued from Python and read back before the
        next chunk, with the fused path's audio: "fast": a full chunk of a
        bucket's length (1 or `chunk_frames`) is its own vocoder decode, any
        other chunk, of another size or cut short by EOS or the cap, is
        decoded from its kept frames through `_decode_to_audio`, as in the
        JAX engine; Code2Wav: each chunk with the previous one as context."""
        mc, dev = self.model_config, self.device
        hop = self.vocoder_config.hop_length
        content, Tpad, max_frames, req = self._new_request(text)
        ids = np.zeros(Tpad + 1, dtype=np.int64)
        ids[:len(content)], ids[Tpad] = content, len(content)
        ids = torch.from_numpy(ids).to(dev)
        trailing = torch.empty((Tpad, mc.talker.hidden_size), dtype=torch.bfloat16, device=dev)
        t_len = torch.empty((), dtype=torch.int32, device=dev)
        state, token, hidden = self._start(ids[:Tpad], ids[Tpad], trailing, t_len,
                                           self._talker_cache())
        self._count_steps(0, first=True)
        c2w = self._c2w and self.vocoder_weights is not None
        base, prev = 0, None
        while base < max_frames:
            n = 1 if base == 0 else chunk_size
            n_run = min(n, max_frames - base)     # frames past the cap are never kept
            idx0 = torch.full((), base, dtype=torch.int32, device=dev)
            state, codes, valid, token, hidden = self._frames(
                state, token, hidden, trailing, t_len, idx0,
                self._draw(req, base, n_run), n_run)
            self._count_steps(n_run)
            # a full chunk whose length is its own vocoder bucket decodes on
            # the device at once; any other goes through the bucket padding
            direct = (with_audio and not c2w and self.vocoder_weights is not None
                      and n_run == n and self._bucket(n) == n)
            audio = self._frames_decode(codes) if direct else None
            codes_np = codes.cpu().numpy().astype(np.int32)
            keep = int(valid.cpu().sum())
            frames = [codes_np[i] for i in range(keep)]
            self._frames_generated = base + keep
            self._talker_state = state
            if keep > 0 and with_audio:
                if direct and keep == n:
                    audio = audio.cpu().numpy()[: n * hop]
                elif c2w:
                    audio = self._context_chunk_audio(frames, n, prev)
                else:
                    audio = self._decode_to_audio(frames)[0]
            if keep == n:
                yield audio, frames
            else:
                if keep > 0:
                    yield audio, frames
                return
            base, prev = base + n, codes_np

    # ── vocoder ──────────────────────────────────────────────────────────

    def _bucket(self, T: int) -> int:
        """The "fast" vocoder's frame count for T frames: 1, chunk_frames,
        2 x chunk_frames, ... (JAX `_vocoder_bucket`)."""
        bucket = 1
        if T > 1:
            bucket = self.config.chunk_frames
            while bucket < T:
                bucket *= 2
        return bucket

    def _c2w_decode_full(self, stacked: np.ndarray) -> np.ndarray:
        """A whole utterance through Code2Wav in windows of `code2wav_window`
        frames, each after `code2wav_ctx` frames of context (none for the
        first), the last repeat-padded to the smallest window bucket that
        holds it (JAX `_c2w_decode_full`): exactly T * hop samples, the tail
        zero-padded by the conv trims' deficit."""
        vc, dev = self.vocoder_config, self.device
        hop, deficit = vc.hop_length, vc.output_deficit
        W, C = self._c2w_window, self._c2w_ctx
        T, q = stacked.shape
        codes = torch.from_numpy(stacked.astype(np.int64)).to(dev)
        parts, s = [], 0
        while s < T:
            end = min(s + W, T)
            window = codes[s:end]
            if end - s < W:
                bucket = next(b for b in self._c2w_buckets if b >= end - s)
                window = torch.cat([window, window[-1:].expand(bucket - (end - s), q)])
            if s == 0:
                parts.append(self._raw_decode(window))
            else:
                wav = self._raw_decode(torch.cat([codes[s - C:s], window]))
                parts.append(wav[C * hop - deficit:C * hop - deficit + window.shape[0] * hop])
            s = end
        out = torch.cat(parts).cpu().numpy()
        need = T * hop
        if len(out) < need:
            out = np.concatenate([out, np.zeros(need - len(out), np.float32)])
        return out[:need]

    def _decode_to_audio(self, frames: list[np.ndarray]) -> tuple[np.ndarray, int]:
        """Frames → waveform (JAX `_decode_to_audio`). Code2Wav: windowed
        (`_c2w_decode_full`). "fast": the frame count repeat-padded (last
        frame) up to a bucket {1, chunk_frames, 2×chunk_frames, ...} and the
        result cut back to T × hop samples. No vocoder: silence."""
        if not frames:
            return np.array([], dtype=np.float32), self.sample_rate
        T = len(frames)
        if self.vocoder_weights is None:
            seconds = T / self.model_config.frame_rate_hz
            return np.zeros(int(seconds * self.sample_rate), np.float32), self.sample_rate
        stacked = np.stack(frames)
        if self._c2w:
            return self._c2w_decode_full(stacked), self.sample_rate
        bucket = self._bucket(T)
        codes = np.broadcast_to(stacked[-1], (bucket, stacked.shape[1])).copy()
        codes[:T] = stacked
        wav = self._frames_decode(torch.from_numpy(codes).to(self.device))
        return (wav.cpu().numpy()[: T * self.vocoder_config.hop_length],
                self.sample_rate)

    def decode_launches(self) -> int:
        """The decode-step kernel's launches so far, as the kernel counts
        them itself (graph replays included): on the fused path those of
        the engine's graphs and their warm-up runs, on the eager path all
        those of the current stream. A device read; CUDA only."""
        from ..ops.decode_step import device_launches

        if self.config.fused_chunks:
            return self._graphs.launches()
        return device_launches(self.model_config.talker, self.device)

    def get_metrics(self) -> dict:
        """Sample rate, talker cache position, frames kept, and the talker
        and code-predictor decode steps run so far, frames computed past EOS
        or the cap included (each one decode-step launch on the "mega"
        backend, and one decode-attention launch per layer on the "pallas"
        backend)."""
        state = getattr(self, "_talker_state", None)
        return {
            "sample_rate": self.sample_rate,
            "position": 0 if state is None else state.position,
            "frames_generated": getattr(self, "_frames_generated", 0),
            "talker_steps": getattr(self, "_talker_steps", 0),
            "cp_steps": getattr(self, "_cp_steps", 0),
        }

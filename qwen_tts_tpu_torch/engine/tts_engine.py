"""TTS engine: text → talker → code predictor → vocoder → streamed audio.

Port of `qwen_tts_tpu/engine/tts_engine.py` for the "fast" vocoder and
M-RoPE on, with bf16 or weight-only quantized decoders (`quantize`: int8,
int4-g128 or mixed talker; `cp_quantize` for the code predictor, whose 15
heads and KV cache stay bf16) and a bf16 or int8 talker KV cache
(`kv_cache`), and with the backends "auto" (the CUDA
decode-step kernel on a GPU, the dense path on the CPU), "mega" (the
decode-step kernel), "pallas" (dense layers with the CUDA decode-attention
kernel in every single-token step; the name is the JAX package's) and
"dense" (plain torch). On the CPU every kernel runs its plain version. The
public surface is the same — `initialize()`, `synthesize(text)`, async
`synthesize_streaming(text)`, `get_metrics()` — and so is what a request
computes: the 8-row conditioning prefill and shifted trailing text of the
JAX `first_fn`, a first chunk of one frame and then `chunk_frames`-frame
chunks, each decoded by the vocoder on its own, EOS as the stop with the
word-count cap as fallback, and non-streaming as one vocoder decode of all
frames, repeat-padded to a shape bucket.

`fused_chunks` (default True) is JAX's fused path (`_build_fused_fns`,
`_generate_audio_chunks`): on a GPU each chunk is one replay of a CUDA
graph — `frames_chunk` over its frames, the vocoder, and the copies of
codes, `valid` flags and audio into a ring of pinned host slots — and
everything from the token ids to the first audio chunk is one more. The
next chunk is enqueued before the host reads the current one (at most two
in flight). Graphs are captured in `initialize()` (`warmup`) for the
384-id text bucket and `chunk_frames`; a longer text, or streaming at
another chunk size (frames-only graphs, audio through `_decode_to_audio`),
captures its graphs when a request first needs them. The graphs share one
static state, so an engine serves one request at a time: a new request
takes it, and resuming the stream of an earlier one raises. A capture or
replay that fails raises; nothing falls back to the eager loop. On the CPU
the same bodies run eagerly, in the same order. `fused_chunks=False` is
the eager loop (JAX's unfused path): each chunk's ops enqueued from Python
and read back before the next chunk starts, the last chunk cut at the cap.
Backends "pallas" and "dense" keep host positions in their ops' arguments,
so on a GPU they run with `fused_chunks=False` only.

The talker always uses the interleaved (24, 20, 20) M-RoPE of the
released model, with all three section positions equal to the cache
position (text-only prompts), as the JAX default does.

The device is `TTSConfig.device`, "cuda" unless the caller asks for the
CPU; the engine never falls back to the CPU. TF32 is
switched off for matmuls and cuDNN convolutions, so the f32 parts (the
vocoder, the f32 products of the plain paths) keep full f32 precision.

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
from ..core.weights import QUANTIZERS, TTSWeights, init_tts_weights
from ..models.decoder import init_state
from ..models.text_projection import embed_text_ids
from ..runtime.frame_loop import frames_chunk, talker_prefill
from ..vocoder.model import (
    VocoderConfig,
    VocoderWeights,
    init_vocoder_weights,
    vocoder_decode,
)
from .chunk_graphs import RING, ChunkGraphs
from .tokenizer import encode_tts_prompt, load_tokenizer

_MASK64 = (1 << 64) - 1
MROPE_SECTION = (24, 20, 20)   # Qwen3-TTS talker, interleaved layout
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
    """Engine configuration; the fields of the JAX `TTSConfig` that the
    port serves, plus `device`."""

    device: str = "cuda"                  # "cpu" runs every kernel's plain version
    model_path: Optional[str] = None      # None → random weights from `seed`
    vocoder_path: Optional[str] = None
    chunk_frames: int = 10                # ~0.8 s per chunk at 12.5 Hz
    subtalker_do_sample: bool = True      # False: greedy code predictor
    seed: int = 0
    max_seq_len: int = 8192               # talker KV-cache length
    vocoder_backend: str = "fast"
    backend: str = "auto"                 # auto | dense | pallas | mega
    # One CUDA-graph replay per audio chunk, the next chunk enqueued before
    # the current one is read; False: the eager loop
    fused_chunks: bool = True
    # Capture the graphs of the 384-id text bucket and `chunk_frames` in
    # initialize(), so that no request pays for a capture
    warmup: bool = True
    # Weight-only quantization of the talker: False (bf16), True or "int8"
    # (per channel, + int8 LM head), "int4" (group-128, int8 head), "mixed"
    # (int8 attention + int4-g128 MLP). The code predictor then takes
    # `cp_quantize` ("int8" | "int4" | "mixed"); its heads stay bf16.
    quantize: bool | str = False
    kv_cache: str = "bf16"                # talker KV cache: "bf16" | "int8"
    cp_quantize: str = "int8"


def _quant_mode(cfg: TTSConfig):
    """The talker's quantizer name, or False; raises on an unknown knob."""
    mode = "int8" if cfg.quantize is True else cfg.quantize
    if mode not in (False, *QUANTIZERS):
        raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
    if cfg.kv_cache not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_cache {cfg.kv_cache!r}")
    if cfg.cp_quantize not in QUANTIZERS:
        raise ValueError(f"unknown cp_quantize mode {cfg.cp_quantize!r}")
    return mode


def _unsupported(cfg: TTSConfig) -> str | None:
    if cfg.model_path or cfg.vocoder_path:
        return "checkpoint loading (ROADMAP A1-ckpt)"
    if cfg.vocoder_backend != "fast":
        return f"vocoder_backend={cfg.vocoder_backend!r} (ROADMAP A11)"
    if (cfg.fused_chunks and cfg.backend in ("pallas", "dense")
            and torch.device(cfg.device).type == "cuda"):
        return (f"fused_chunks=True with backend={cfg.backend!r} on CUDA: its ops take host "
                f"positions, which a CUDA graph would replay stale (ROADMAP A17); pass "
                f"fused_chunks=False")
    return None


class TTSEngine:
    """PyTorch TTS engine (same surface as the JAX `TTSEngine`)."""

    def __init__(self, config: Optional[TTSConfig] = None,
                 model_config: Optional[TTSModelConfig] = None):
        self.config = config or TTSConfig()
        if self.config.backend not in ("auto", "dense", "pallas", "mega"):
            raise ValueError(f"unknown backend {self.config.backend!r}")
        missing = _unsupported(self.config)
        if missing:
            raise NotImplementedError(f"not ported yet: {missing}")
        self._quant_mode = _quant_mode(self.config)
        self._kv_dtype = torch.int8 if self.config.kv_cache == "int8" else torch.bfloat16
        mc = model_config or TTSModelConfig()
        talker = dataclasses.replace(mc.talker, max_seq_len=self.config.max_seq_len)
        if talker.mrope_section is None:
            talker = dataclasses.replace(talker, mrope_section=MROPE_SECTION,
                                         mrope_interleaved=True)
        self.model_config = dataclasses.replace(mc, talker=talker)
        self.device = torch.device(self.config.device)
        self.vocoder_config = VocoderConfig()
        self.sample_rate = self.vocoder_config.sample_rate
        self._initialized = False

    # ── initialization ───────────────────────────────────────────────────

    def initialize(self, weights: Optional[TTSWeights] = None,
                   vocoder_weights: Optional[VocoderWeights] = None):
        """Weights (given, or random from `seed`; quantized here when
        `quantize` is set, the bf16 decoder matrices dropped), vocoder,
        constant embeddings; on a GPU also builds the kernels, so no
        request pays for nvcc, and with `fused_chunks` and `warmup`
        captures the graphs of the 384-id text bucket. Raises on a CUDA
        device when the machine has none."""
        if self._initialized:
            return
        cfg, mc, dev = self.config, self.model_config, self.device
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TTSConfig.device is {cfg.device!r} but no CUDA device "
                               f"is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.weights = weights if weights is not None else init_tts_weights(cfg.seed, mc, dev)
        if self._quant_mode:
            cp = self.weights.code_predictor
            self.weights = self.weights._replace(
                talker=QUANTIZERS[self._quant_mode](self.weights.talker),
                code_predictor=cp._replace(decoder=QUANTIZERS[cfg.cp_quantize](
                    cp.decoder, quant_head=False)))
        self.tokenizer = load_tokenizer(cfg.model_path)

        self.vocoder_weights = vocoder_weights
        if vocoder_weights is None:
            self.vocoder_weights = init_vocoder_weights(cfg.seed + 1, self.vocoder_config, dev)

        if cfg.backend == "auto":
            self._attn_impl = "mega" if dev.type == "cuda" else "dense"
        else:
            self._attn_impl = cfg.backend
        self._mrope_deltas = [0] * len(mc.talker.mrope_section)

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

        if self._attn_impl in ("mega", "pallas") and dev.type == "cuda":
            from ..ops.cuda_lib import load_library

            load_library()
        v = mc.code_predictor.vocab_size
        self._top_k = SUBTALKER_TOP_K if 0 < SUBTALKER_TOP_K < v else v
        self._gen = torch.Generator(device=dev)
        self._cp_state = init_state(mc.code_predictor, dev)
        self._requests = 0
        self._frames_generated = 0
        self._talker_steps = 0
        self._cp_steps = 0
        self._talker_state = None
        if cfg.fused_chunks:
            self._build_fused_fns()
            if cfg.warmup:
                self._warmup()
        self._initialized = True

    # ── synthesis ────────────────────────────────────────────────────────

    def synthesize(self, text: str) -> tuple[np.ndarray, int]:
        """Non-streaming synthesis → (waveform f32, sample_rate): every frame
        first (on the streaming graphs, their audio unused), then one
        vocoder decode of them all."""
        self.initialize()
        frames = [f for _audio, chunk in
                  self._generate_chunks(text, self.config.chunk_frames, with_audio=False)
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

    # ── what every path shares ───────────────────────────────────────────

    def _request(self, text: str):
        """Tokenize and number a request: (content ids, padded length, frame
        cap, request number)."""
        content = encode_tts_prompt(self.tokenizer, text)[3:]
        Tpad = max(-(-len(content) // TRAILING_BUCKET) * TRAILING_BUCKET, TRAILING_BUCKET)
        word_count = max(len(text.split()), 1)
        max_frames = min(max(int(word_count / 2.5 * 12.5 * 2.0), 25), MAX_NEW_TOKENS)
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

    def _start(self, ids: torch.Tensor, n: torch.Tensor, trailing: torch.Tensor,
               t_len: torch.Tensor, state):
        """Text projection, conditioning prefill and the first talker step
        (the JAX `first_fn` up to its first frame), from the padded ids
        `[Tpad]` and their count `n` (0-d), both on the device. Writes the
        trailing rows `[Tpad, H]` bf16 (row i the embedding of content id
        i+1 below n-6, tts_eos at max(n-6, 0), zero above) and their count
        max(n-5, 1) in place. Returns (state, token, hidden)."""
        mc = self.model_config
        content = embed_text_ids(self.weights.text_projection, ids)
        prefill = torch.cat([self._role_embeds, self._fused_tags,
                             content[:1] + self._codec_bos_embed[None]])
        rows = torch.arange(ids.shape[0], device=ids.device)[:, None]
        eos_pos = (n - 6).clamp_min(0)
        trailing.copy_(torch.where(rows < eos_pos, content.roll(-1, 0),
                                   torch.where(rows == eos_pos, self._tts_eos_embed[None],
                                               torch.zeros_like(content))))
        t_len.copy_((n - 5).clamp_min(1))
        return talker_prefill(mc.talker, self.weights.talker, state, prefill,
                              attn_impl=self._attn_impl, mrope_deltas=self._mrope_deltas)

    def _frames(self, state, token, hidden, trailing, t_len, idx0, uniform, n: int):
        """`frames_chunk` over n frames with the engine's weights and options."""
        mc, cfg = self.model_config, self.config
        return frames_chunk(
            mc.talker, mc.code_predictor, self.weights.talker, self.weights.code_predictor,
            state, token, hidden, trailing, t_len, idx0, self._tts_pad_embed, uniform,
            num_frames=n, do_sample=cfg.subtalker_do_sample,
            temperature=SUBTALKER_TEMPERATURE, top_k=SUBTALKER_TOP_K,
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
        index and length, the uniform draws, and the ring of host slots.
        Graphs themselves are captured by `_prepare`."""
        mc, cfg, dev = self.model_config, self.config, self.device
        self._graphs = ChunkGraphs(dev)
        self._talker = init_state(mc.talker, dev, self._kv_dtype)
        self._pos = 0                      # the talker's host position
        self._tok = torch.zeros((), dtype=torch.int64, device=dev)
        self._hid = torch.zeros(mc.talker.hidden_size, dtype=torch.float32, device=dev)
        self._idx0 = torch.zeros((), dtype=torch.int32, device=dev)
        self._t_len = torch.zeros((), dtype=torch.int32, device=dev)
        self._trailing: dict[int, torch.Tensor] = {}   # Tpad -> [Tpad, H] bf16
        self._ids: dict[int, tuple] = {}               # Tpad -> (host, device) [Tpad + 1]
        self._uniform: dict[int, torch.Tensor] = {}    # n -> [n, 15, top_k] f32
        self._out: dict[int, list] = {}                # n -> host output slots
        self._owner = None
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
            out = self._out.setdefault(m, [])   # graphs hold these: only ever added to
            while len(out) < k:
                out.append(g.slot(m, groups, self.vocoder_config.hop_length))

    def _body(self, Tpad: int, n: int, slot: int, first: bool, audio: bool) -> None:
        """One graph's work: the first chunk from the ids (`first`), or n
        frames from the carried state; the vocoder (`audio`); the outputs
        copied into host slot `slot` of size n."""
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
        if audio:
            out.audio.copy_(vocoder_decode(self.vocoder_config, self.vocoder_weights, codes),
                            non_blocking=True)

    def _keys(self, Tpad: int, n: int, audio: bool):
        """The graphs a request of this bucket and chunk size replays."""
        chunk = [("chunk", n, Tpad, s) for s in range(RING)] if audio else [
            ("frames", n, Tpad, 0)]
        return [("first", 1, Tpad, 0), *chunk]

    def _prepare(self, Tpad: int, n: int, audio: bool = True) -> None:
        """Make sure the graphs of this text bucket and chunk size exist: on
        a GPU, run the first body and a chunk body once on the graphs'
        stream (so the kernel arrays and library handles they use exist),
        then capture each missing graph. Runs before a request's first
        replay; the state it leaves is overwritten by that replay."""
        self._buffers(Tpad, n, RING if audio else 1)
        g = self._graphs
        missing = [k for k in self._keys(Tpad, n, audio) if k not in g.graphs]
        if not g.cuda or not missing:
            return
        S = self.config.max_seq_len
        if PREFIX_ROWS + 2 + n > S:
            raise ValueError(f"positions [0, {PREFIX_ROWS + 2 + n}) exceed max_seq_len {S}")
        g.stream.wait_stream(torch.cuda.current_stream(self.device))   # weights, buffers
        with g.on_stream():
            self._body(Tpad, 1, 0, first=True, audio=True)
            self._pos = PREFIX_ROWS + 2
            self._body(Tpad, n, 0, first=False, audio=audio)
        for kind, m, _, slot in missing:
            first = kind == "first"
            g.capture((kind, m, Tpad, slot),
                      lambda: self._body(Tpad, m, slot, first, kind != "frames"),
                      carried=() if first else (self._talker,))
        self._pos = 0

    def _warmup(self):
        """Capture the graphs of the 384-id bucket and `chunk_frames` and
        replay each once; warm the vocoder at the bucket sizes that
        `_decode_to_audio` pads to (1, chunk_frames, ... up to 160 frames)."""
        if self.device.type != "cuda":
            return
        cf = self.config.chunk_frames
        self._prepare(TRAILING_BUCKET, cf)
        room = self.config.max_seq_len - PREFIX_ROWS - 2 - RING * cf
        for key in self._keys(TRAILING_BUCKET, cf, True)[:RING + 1 if room >= 0 else 1]:
            self._graphs.replay(key, None)
        sizes, b = [1, cf], cf
        while b < 160:
            b *= 2
            sizes.append(b)
        groups = self.model_config.num_code_groups
        for b in sizes:
            vocoder_decode(self.vocoder_config, self.vocoder_weights,
                           torch.zeros((b, groups), dtype=torch.int64, device=self.device))
        torch.cuda.synchronize(self.device)
        self._pos = 0

    def _take_engine(self) -> object:
        """A new request takes the graphs' state: earlier streams stop."""
        self._owner = owner = object()
        return owner

    def _check_owner(self, owner: object) -> None:
        if self._owner is not owner:
            raise RuntimeError("a later request took this engine's graph state: an engine "
                               "serves one fused stream at a time (ROADMAP C)")

    def _check_room(self, n: int) -> None:
        """The graphs run whole chunks without the decode wrapper's checks:
        the talker must have room for all n steps, frames past the cap
        included."""
        S = self.config.max_seq_len
        if self._pos + n > S:
            raise ValueError(f"positions [{self._pos}, {self._pos + n}) exceed max_seq_len {S}")

    def _enqueue_first(self, content: np.ndarray, Tpad: int, request: int,
                       owner: object) -> tuple:
        """Enqueue the first chunk (ids → one frame and its audio) into slot 0."""
        self._check_owner(owner)
        self._pos = 0
        self._check_room(PREFIX_ROWS + 2)
        g = self._graphs
        g.wait(0)           # the slot's last reader, and the ids' last upload, are done
        host = self._ids[Tpad][0]
        host.zero_()
        host[:len(content)] = torch.from_numpy(np.asarray(content, dtype=np.int64))
        host[Tpad] = len(content)
        with g.on_stream():
            self._draw(request, 0, 1, self._uniform[1])
            g.replay(("first", 1, Tpad, 0), lambda: self._body(Tpad, 1, 0, True, True))
            g.record(0)
        self._slot = 0
        self._pos = PREFIX_ROWS + 2
        self._count_steps(1, first=True)
        self._talker_state = self._talker._replace(position=self._pos)
        return 0, 1, 0

    def _enqueue_chunk(self, n: int, Tpad: int, request: int, frame0: int, owner: object,
                       audio: bool = True) -> tuple:
        """Enqueue the n frames from `frame0` (with their audio) into the
        next slot of the ring (frames-only: the size's one slot)."""
        self._check_owner(owner)
        self._check_room(n)
        g = self._graphs
        slot = (self._slot + 1) % RING if audio else 0
        key = ("chunk" if audio else "frames", n, Tpad, slot)
        with g.on_stream():
            self._draw(request, frame0, n, self._uniform[n])
            g.replay(key, lambda: self._body(Tpad, n, slot, False, audio))
            g.record(slot)
        if audio:
            self._slot = slot
        self._pos += n
        self._count_steps(n)
        self._talker_state = self._talker._replace(position=self._pos)
        return slot, n, frame0

    def _read(self, slot: int, n: int, owner: object):
        """Wait for a slot, then copy out (codes int32 [n, 16], valid [n],
        audio [n * hop])."""
        self._check_owner(owner)
        self._graphs.wait(slot)
        out = self._out[n][slot]
        hop = self.vocoder_config.hop_length
        return (out.codes.numpy().astype(np.int32), out.valid.numpy().copy(),
                out.audio[:n * hop].numpy().copy())

    def _generate_audio_chunks(self, text: str, chunk_size: int):
        """The fused streaming loop (JAX `_generate_audio_chunks` :836-931):
        the first chunk and the next one enqueued before the first read;
        after the first chunk's yield one more, and from then on the next
        chunk enqueued before each blocking read: at most two in flight
        beside the one being read. A full chunk yields the audio of its
        graph; a chunk cut by EOS or the cap yields its kept frames through
        `_decode_to_audio`. Frames past EOS or the cap are computed, counted
        in `get_metrics()`, and dropped."""
        hop = self.vocoder_config.hop_length
        content, Tpad, max_frames, request = self._request(text)
        owner = self._take_engine()
        self._prepare(Tpad, chunk_size)
        q = deque([self._enqueue_first(content, Tpad, request, owner)])
        planned = 1

        def enqueue():
            nonlocal planned
            q.append(self._enqueue_chunk(chunk_size, Tpad, request, planned, owner))
            planned += chunk_size

        if planned < max_frames:
            enqueue()                                  # depth 1 before the first read
        while q:
            slot, n, base = q.popleft()
            if base >= max_frames:
                break
            if base > 0 and planned < max_frames:
                enqueue()                              # depth 2: before the blocking read
            codes, valid, audio = self._read(slot, n, owner)
            keep = min(int(valid.sum()), max_frames - base)
            frames = [codes[i] for i in range(keep)]
            self._frames_generated = base + keep
            if keep < n:
                if keep > 0:
                    yield self._decode_to_audio(frames)[0], frames
                return
            yield audio[: n * hop], frames
            if base + keep >= max_frames:
                return
            if base == 0 and planned < max_frames:
                enqueue()                              # refill to depth 2

    def _generate_codec_chunks(self, text: str, chunk_size: int, with_audio: bool):
        """Streaming at a chunk size other than `chunk_frames` (JAX
        `_generate_codec_chunks` :956-1002): the first chunk's graph, then a
        frames-only graph of `chunk_size` frames a chunk, each read before
        the next is enqueued; audio through `_decode_to_audio`."""
        content, Tpad, max_frames, request = self._request(text)
        owner = self._take_engine()
        self._prepare(Tpad, chunk_size, audio=False)
        produced, alive = 0, True
        while alive and produced < max_frames:
            first = produced == 0
            if first:
                slot, n, _ = self._enqueue_first(content, Tpad, request, owner)
            else:
                slot, n, _ = self._enqueue_chunk(chunk_size, Tpad, request, produced, owner,
                                                 audio=False)
            codes, valid, audio = self._read(slot, n, owner)
            keep = min(int(valid.sum()), max_frames - produced)
            alive = bool(valid.all()) and produced + keep < max_frames
            frames = [codes[i] for i in range(keep)]
            produced += keep
            self._frames_generated = produced
            if keep:
                if not with_audio:
                    audio = None
                elif not first:                  # the first chunk's graph decoded it
                    audio = self._decode_to_audio(frames)[0]
                yield audio, frames

    # ── the eager loop (fused_chunks=False) ──────────────────────────────

    def _generate_chunks_eager(self, text: str, chunk_size: int, with_audio: bool):
        """Each chunk's ops enqueued from Python and read back before the
        next chunk: a full chunk of a bucket's length (1 or `chunk_frames`)
        is its own vocoder decode; any other chunk, of another size or cut
        short by EOS or the cap, is decoded from its kept frames through
        `_decode_to_audio`, as in the JAX engine."""
        mc, dev = self.model_config, self.device
        hop = self.vocoder_config.hop_length
        content, Tpad, max_frames, request = self._request(text)
        ids = np.zeros(Tpad + 1, dtype=np.int64)
        ids[:len(content)], ids[Tpad] = content, len(content)
        ids = torch.from_numpy(ids).to(dev)
        trailing = torch.empty((Tpad, mc.talker.hidden_size), dtype=torch.bfloat16, device=dev)
        t_len = torch.empty((), dtype=torch.int32, device=dev)
        state = init_state(mc.talker, dev, self._kv_dtype)
        state, token, hidden = self._start(ids[:Tpad], ids[Tpad], trailing, t_len, state)
        self._count_steps(0, first=True)
        base = 0
        while base < max_frames:
            n = 1 if base == 0 else chunk_size
            n_run = min(n, max_frames - base)     # frames past the cap are never kept
            idx0 = torch.full((), base, dtype=torch.int32, device=dev)
            state, codes, valid, token, hidden = self._frames(
                state, token, hidden, trailing, t_len, idx0,
                self._draw(request, base, n_run), n_run)
            self._count_steps(n_run)
            # a full chunk whose length is its own vocoder bucket decodes on
            # the device at once; any other goes through the bucket padding
            direct = with_audio and n_run == n and self._bucket(n) == n
            audio = None
            if direct:
                audio = vocoder_decode(self.vocoder_config, self.vocoder_weights, codes)
            codes_np = codes.cpu().numpy().astype(np.int32)
            keep = int(valid.cpu().sum())
            frames = [codes_np[i] for i in range(keep)]
            self._frames_generated = base + keep
            self._talker_state = state
            if keep == n:
                if direct:
                    audio = audio.cpu().numpy()[: n * hop]
                elif with_audio:
                    audio = self._decode_to_audio(frames)[0]
                yield audio, frames
            else:
                if keep > 0:
                    yield (self._decode_to_audio(frames)[0] if with_audio else None), frames
                return
            base += n

    # ── vocoder ──────────────────────────────────────────────────────────

    def _bucket(self, T: int) -> int:
        """The vocoder's frame count for T frames: 1, chunk_frames, 2 x
        chunk_frames, ... (JAX `_decode_to_audio`)."""
        bucket = 1
        if T > 1:
            bucket = self.config.chunk_frames
            while bucket < T:
                bucket *= 2
        return bucket

    def _decode_to_audio(self, frames: list[np.ndarray]) -> tuple[np.ndarray, int]:
        """Frames → waveform, the frame count repeat-padded (last frame) up
        to a bucket {1, chunk_frames, 2×chunk_frames, ...} and the result
        cut back to T × hop samples."""
        if not frames:
            return np.array([], dtype=np.float32), self.sample_rate
        T = len(frames)
        bucket = self._bucket(T)
        stacked = np.stack(frames)
        codes = np.broadcast_to(stacked[-1], (bucket, stacked.shape[1])).copy()
        codes[:T] = stacked
        wav = vocoder_decode(self.vocoder_config, self.vocoder_weights,
                             torch.from_numpy(codes).to(self.device))
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

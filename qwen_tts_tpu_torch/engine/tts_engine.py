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

The talker always uses the interleaved (24, 20, 20) M-RoPE of the
released model, with all three section positions equal to the cache
position (text-only prompts), as the JAX default does.

The device is `TTSConfig.device`, "cuda" unless the caller asks for the
CPU; the engine never falls back to the CPU. TF32 is
switched off for matmuls and cuDNN convolutions, so the f32 parts (the
vocoder, the f32 products of the plain paths) keep full f32 precision.

Code-predictor sampling noise comes from a `torch.Generator` seeded from
(engine seed, request number, absolute frame index); the frame's 15 groups
take the rows of one draw. Codes therefore do not depend on chunking, and
streaming and non-streaming requests with the same request number agree.
"""

from __future__ import annotations

import asyncio
import dataclasses
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
from ..ops.sampling import gumbel_noise
from ..runtime.frame_loop import frames_chunk, talker_prefill
from ..vocoder.model import (
    VocoderConfig,
    VocoderWeights,
    init_vocoder_weights,
    vocoder_decode,
)
from .tokenizer import encode_tts_prompt, load_tokenizer

_MASK64 = (1 << 64) - 1
MROPE_SECTION = (24, 20, 20)   # Qwen3-TTS talker, interleaved layout
TRAILING_BUCKET = 384          # prompt ids are padded to a multiple
MAX_NEW_TOKENS = 2048          # frame cap above the word-count cap
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
    return None


class TTSEngine:
    """PyTorch TTS engine (same surface as the JAX `TTSEngine`)."""

    def __init__(self, config: Optional[TTSConfig] = None,
                 model_config: Optional[TTSModelConfig] = None):
        self.config = config or TTSConfig()
        missing = _unsupported(self.config)
        if missing:
            raise NotImplementedError(f"not ported yet: {missing}")
        if self.config.backend not in ("auto", "dense", "pallas", "mega"):
            raise ValueError(f"unknown backend {self.config.backend!r}")
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
        request pays for nvcc. Raises on a CUDA device when the machine
        has none."""
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
        self._requests = 0
        self._frames_generated = 0
        self._talker_steps = 0
        self._cp_steps = 0
        self._talker_state = None
        self._initialized = True

    # ── synthesis ────────────────────────────────────────────────────────

    def synthesize(self, text: str) -> tuple[np.ndarray, int]:
        """Non-streaming synthesis → (waveform f32, sample_rate): every frame
        first, then one vocoder decode of them all."""
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

    # ── core generation loop ─────────────────────────────────────────────

    def _noise_fn(self, request: int):
        """Per-frame Gumbel noise `[15, top_k]` for one request."""
        cfg, mc = self.config, self.model_config
        v = mc.code_predictor.vocab_size
        k = SUBTALKER_TOP_K if 0 < SUBTALKER_TOP_K < v else v
        shape = (mc.num_code_groups - 1, k)
        gen = torch.Generator(device=self.device)

        def noise(frame: int) -> torch.Tensor:
            gen.manual_seed(stream_seed(cfg.seed, request, frame))
            return gumbel_noise(shape, gen, self.device)

        return noise

    def _start(self, content: np.ndarray, Tpad: int):
        """Text projection, conditioning prefill and the first talker step
        (the JAX `first_fn` up to its first frame). Returns
        (state, token, hidden, trailing [Tpad, H] bf16, trailing_len)."""
        mc, dev = self.model_config, self.device
        n = len(content)
        ids = np.zeros(Tpad, dtype=np.int64)
        ids[:n] = content
        content_embeds = embed_text_ids(self.weights.text_projection,
                                        torch.from_numpy(ids).to(dev))
        first_text_bos = content_embeds[:1] + self._codec_bos_embed[None]
        prefill = torch.cat([self._role_embeds, self._fused_tags, first_text_bos])
        # trailing[i] = content[i+1] for i < n-6; tts_eos at n-6 (clamped to 0)
        eos_pos = max(n - 6, 0)
        trailing = torch.zeros_like(content_embeds)
        trailing[:eos_pos] = content_embeds[1:eos_pos + 1]
        trailing[eos_pos] = self._tts_eos_embed
        state = init_state(mc.talker, dev, self._kv_dtype)
        state, token, hidden = talker_prefill(
            mc.talker, self.weights.talker, state, prefill,
            attn_impl=self._attn_impl, mrope_deltas=self._mrope_deltas)
        self._talker_steps += 1
        return state, token, hidden, trailing, max(n - 5, 1)

    def _generate_chunks(self, text: str, chunk_size: int, with_audio: bool):
        """Yield (audio f32 or None, frames) per chunk: 1 frame, then
        `chunk_size`. A full chunk of a bucket's length (1 or
        `chunk_frames`) is its own vocoder decode; any other chunk, of
        another size or cut short by EOS or the cap, is decoded from its
        kept frames through `_decode_to_audio`, as in the JAX engine."""
        cfg, mc = self.config, self.model_config
        hop = self.vocoder_config.hop_length
        content = encode_tts_prompt(self.tokenizer, text)[3:]
        bucket = TRAILING_BUCKET
        Tpad = max(-(-len(content) // bucket) * bucket, bucket)
        word_count = max(len(text.split()), 1)
        max_frames = min(max(int(word_count / 2.5 * 12.5 * 2.0), 25), MAX_NEW_TOKENS)
        self._requests += 1
        noise_fn = self._noise_fn(self._requests) if cfg.subtalker_do_sample else None
        cp_steps_per_frame = mc.num_code_groups - 2   # the last group needs no step

        state, token, hidden, trailing, t_len = self._start(content, Tpad)
        base = 0
        while base < max_frames:
            n = 1 if base == 0 else chunk_size
            n_run = min(n, max_frames - base)     # frames past the cap are never kept
            state, codes, valid, token, hidden = frames_chunk(
                mc.talker, mc.code_predictor, self.weights.talker,
                self.weights.code_predictor, state, token, hidden, trailing,
                t_len, base, self._tts_pad_embed, noise_fn, num_frames=n_run,
                do_sample=cfg.subtalker_do_sample,
                temperature=SUBTALKER_TEMPERATURE, top_k=SUBTALKER_TOP_K,
                attn_impl=self._attn_impl, mrope_deltas=self._mrope_deltas)
            self._talker_steps += n_run
            self._cp_steps += n_run * cp_steps_per_frame
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

    def get_metrics(self) -> dict:
        """Sample rate, talker cache position, frames kept, and the talker
        and code-predictor decode steps run so far (each one decode-step
        launch on the "mega" backend, and one decode-attention launch per
        layer on the "pallas" backend)."""
        state = getattr(self, "_talker_state", None)
        return {
            "sample_rate": self.sample_rate,
            "position": 0 if state is None else state.position,
            "frames_generated": getattr(self, "_frames_generated", 0),
            "talker_steps": getattr(self, "_talker_steps", 0),
            "cp_steps": getattr(self, "_cp_steps", 0),
        }


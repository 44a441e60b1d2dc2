"""Pipecat TTS services over the port's engine and continuous batcher.

Port of `qwen_tts_tpu/serving/pipecat_tts.py`, with the reference's frame
protocol: `run_tts` yields `TTSStartedFrame`, then PCM16
`TTSAudioRawFrame` chunks at 24 kHz, then `TTSStoppedFrame`; `ErrorFrame`
on an exception (then Stopped); no Stopped after the client closed the
generator (`GeneratorExit`: a yield there would be refused); TTFB and
usage metric hooks; engine work deferred to a thread-pool executor so the
pipeline's loop never blocks on weights or graph captures.

- `MegakernelTTSService` (the reference's `MegakernelTTSService`, JAX
  `TPUMegakernelTTSService`) owns one engine: one stream at a time.
- `ContinuousTTSService` (JAX `TPUContinuousTTSService`) submits every
  `run_tts` to a `ContinuousBatcher` shared by its siblings
  (`share=first_service`, or the same `batcher=`), so N pipelines share
  one card through batch slots. All sharing services must run on one
  event loop.

Both run on `TTSConfig.device`, the card unless the config asks for the
CPU. With `pipecat-ai` installed they subclass its `TTSService` and take
its frame types; without it (the GPU host has none) they bind to the
protocol stand-ins of `serving/_frames.py`, the same constructor and the
same frame sequence. `PIPECAT_AVAILABLE` says which.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncGenerator, Optional

import numpy as np

from ..engine.tts_engine import TTSConfig, TTSEngine
from .shared import SharedBatcher

logger = logging.getLogger(__name__)

try:
    from pipecat.frames.frames import (
        ErrorFrame,
        Frame,
        TTSAudioRawFrame,
        TTSStartedFrame,
        TTSStoppedFrame,
    )
    from pipecat.services.tts_service import TTSService

    PIPECAT_AVAILABLE = True
except ImportError:
    from ._frames import (  # noqa: F401 (re-exported protocol stand-ins)
        ErrorFrame,
        Frame,
        TTSAudioRawFrame,
        TTSService,
        TTSStartedFrame,
        TTSStoppedFrame,
    )

    PIPECAT_AVAILABLE = False


def float32_to_pcm16(audio: np.ndarray) -> bytes:
    """Clip and scale f32 [-1, 1] → little-endian int16 bytes (the native C
    path of `runtime/native.py` when a C compiler is there)."""
    from ..runtime.native import f32_to_pcm16

    return f32_to_pcm16(np.asarray(audio))


def _warn_stand_ins(service) -> None:
    if not PIPECAT_AVAILABLE:
        logger.warning("pipecat-ai is not installed: %s runs against the protocol "
                       "stand-ins of serving/_frames.py (the same frame sequence; real "
                       "pipecat pipeline elements would refuse these types)",
                       type(service).__name__)


async def _run_tts(service, text: str, open_stream) -> AsyncGenerator[Frame, None]:
    """The reference's frame sequence around the audio of `open_stream()`,
    a coroutine giving an async iterator of (f32 audio, sample rate),
    awaited once Started is out. The iterator is closed on the way out."""
    closing, stream = False, None
    try:
        await service.start_ttfb_metrics()
        await service.start_tts_usage_metrics(text)
        yield TTSStartedFrame()
        stream = await open_stream()
        first = True
        async for audio, sr in stream:
            if first:
                await service.stop_ttfb_metrics()
                first = False
            yield TTSAudioRawFrame(audio=float32_to_pcm16(audio), sample_rate=sr,
                                   num_channels=1)
    except GeneratorExit:
        # the client hung up mid-stream (the transport aclose()d us): the
        # metric cleanup runs, and no Stopped frame (a yield here would
        # raise "async generator ignored GeneratorExit")
        closing = True
        raise
    except Exception as e:  # noqa: BLE001 - reported in the stream, as the reference does
        logger.exception("TTS generation failed")
        yield ErrorFrame(error=f"TTS error: {e}")
    finally:
        if stream is not None:
            await stream.aclose()   # the engine's stream ends; a batcher's slot frees
        await service.stop_ttfb_metrics()
        if not closing:
            yield TTSStoppedFrame()


class MegakernelTTSService(TTSService):
    """One engine, one stream at a time (the reference's
    MegakernelTTSService)."""

    def __init__(self, *, config: Optional[TTSConfig] = None, sample_rate: int = 24000,
                 chunk_frames: int = 10, model_config=None,
                 engine: Optional[TTSEngine] = None, **kwargs):
        """`engine`: an engine to speak with (its own config then holds);
        otherwise one is built from `config` at the first request."""
        super().__init__(sample_rate=sample_rate, **kwargs)
        _warn_stand_ins(self)
        if engine is None:
            cfg = config or TTSConfig()
            cfg.sample_rate = sample_rate
            cfg.chunk_frames = chunk_frames
            engine = TTSEngine(cfg, model_config=model_config)
        self._engine = engine
        self._engine_ready = False

    def can_generate_metrics(self) -> bool:
        return True

    async def _ensure_engine(self):
        if not self._engine_ready:
            await asyncio.get_running_loop().run_in_executor(None, self._engine.initialize)
            self._engine_ready = True

    def run_tts(self, text: str, context_id: Optional[str] = None
                ) -> AsyncGenerator[Frame, None]:
        """Started, the audio chunks, Stopped (an async generator)."""
        logger.debug("Generating TTS: [%s]", text)

        async def open_stream():
            await self._ensure_engine()
            return self._engine.synthesize_streaming(text)

        return _run_tts(self, text, open_stream)


class ContinuousTTSService(TTSService):
    """N pipelines on one card: every `run_tts` is a request of one shared
    `ContinuousBatcher` (JAX `TPUContinuousTTSService`). Construct the first
    with `config=`/`slots=` (or `batcher=`), its siblings with
    `share=first_service`."""

    def __init__(self, *, batcher=None, share: Optional["ContinuousTTSService"] = None,
                 config: Optional[TTSConfig] = None, slots: int = 4,
                 sample_rate: int = 24000, chunk_frames: int = 10, model_config=None,
                 warm: bool = True, **kwargs):
        super().__init__(sample_rate=sample_rate, **kwargs)
        _warn_stand_ins(self)
        if share is not None:
            self._shared = share._shared
        elif batcher is not None:
            self._shared = SharedBatcher(batcher=batcher)
        else:
            cfg = config or TTSConfig()
            cfg.sample_rate = sample_rate
            cfg.chunk_frames = chunk_frames
            cfg.warmup = False   # the batcher captures its own graphs
            self._shared = SharedBatcher(config=cfg, slots=slots, chunk_frames=chunk_frames,
                                         model_config=model_config, warm=warm)

    def can_generate_metrics(self) -> bool:
        return True

    def run_tts(self, text: str, context_id: Optional[str] = None
                ) -> AsyncGenerator[Frame, None]:
        """Started, the audio chunks, Stopped (an async generator); closed
        early, its request is cancelled and the slot frees at the next
        chunk boundary."""
        logger.debug("Generating TTS (continuous): [%s]", text)

        async def open_stream():
            return (await self._shared.get()).submit(text)

        return _run_tts(self, text, open_stream)

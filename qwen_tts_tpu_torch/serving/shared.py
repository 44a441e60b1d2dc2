"""A lazily built `ContinuousBatcher` shared by many serving front-ends.

Port of `qwen_tts_tpu/serving/shared.py`. One card = one engine = one
batcher, however many front-ends sit on top (Pipecat services, WebSocket
connections). `SharedBatcher.get()` builds the engine and batcher once, in
a thread-pool executor under an asyncio lock so the serving event loop
never blocks on weight init or graph captures, and every later call from
any front-end returns the same batcher at once. The engine runs on
`TTSConfig.device`, the card unless the caller asks for the CPU; nothing
falls back to the CPU.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..engine.tts_engine import TTSConfig, TTSEngine


class SharedBatcher:
    """Lazily built `ContinuousBatcher` shared by N serving front-ends."""

    def __init__(self, *, batcher=None, config: Optional[TTSConfig] = None,
                 slots: int = 4, chunk_frames: int = 10, model_config=None,
                 warm: bool = True):
        self.batcher = batcher
        self._config = config
        self._slots = slots
        self._chunk = chunk_frames
        self._model_config = model_config
        self._warm = warm
        self._lock: Optional[asyncio.Lock] = None

    async def get(self):
        if self.batcher is not None:
            return self.batcher
        if self._lock is None:           # created on the serving loop
            self._lock = asyncio.Lock()
        async with self._lock:
            if self.batcher is None:
                loop = asyncio.get_running_loop()
                self.batcher = await loop.run_in_executor(None, self._build)
        return self.batcher

    def _build(self):
        from ..runtime.continuous import ContinuousBatcher

        engine = TTSEngine(self._config or TTSConfig(warmup=False),
                           model_config=self._model_config)
        engine.initialize()
        batcher = ContinuousBatcher(engine, slots=self._slots, chunk_frames=self._chunk)
        if self._warm:
            # capture every graph, then one pass of every slot, before the
            # first real caller arrives (serve() runs its own event loop:
            # fine in an executor thread)
            batcher.warm()
            batcher.serve(["warm up the batch slots"] * self._slots)
        return batcher

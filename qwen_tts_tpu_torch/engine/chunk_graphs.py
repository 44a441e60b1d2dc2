"""CUDA graphs of the engine's chunk bodies, and the pinned ring their outputs land in.

The engine's fused path (`engine/tts_engine.py`) runs each audio chunk as
one replay of a CUDA graph: the first chunk from the token ids, or
`frames_chunk` over n frames, with the vocoder and the copies of codes,
`valid` flags and audio to pinned host memory. This module holds what the
graphs share: the stream they are captured and replayed on, their memory
pool, the decode kernel's workspace and position arrays they bake in
(`ops/decode_step.py::Owned`), the graphs themselves by key, and a ring of
`RING` pinned output slots, each with an event that the host waits on
before it reads the slot. The host reads one slot while the device fills
the next two, so a slot is rewritten only after the host read it.

On the CPU nothing is captured: `replay` runs the body at once, into
ordinary host tensors, and the events are no-ops. The body, the buffers and
the order of the work are the same.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, NamedTuple, Sequence

import torch

from ..models.decoder import DecodeState
from ..ops.decode_step import Owned

RING = 3   # output slots: one read by the host while two more are in flight


class Slot(NamedTuple):
    """One chunk's outputs on the host (pinned on a GPU)."""

    codes: torch.Tensor   # [n, 16] int64
    valid: torch.Tensor   # [n] bool
    audio: torch.Tensor   # [n * hop] f32


class ChunkGraphs:
    """Graphs by key, captured on one stream into one memory pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.owned = Owned()
        self.graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self.replays = 0
        self._events = [torch.cuda.Event() if self.cuda else None for _ in range(RING)]

    def host(self, shape, dtype) -> torch.Tensor:
        """A zeroed host tensor a graph copies into (pinned on a GPU)."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self.cuda)

    def slot(self, n: int, groups: int, hop: int) -> Slot:
        """Host outputs of one chunk of n frames."""
        return Slot(self.host((n, groups), torch.int64), self.host(n, torch.bool),
                    self.host(n * hop, torch.float32))

    def on_stream(self):
        """Work that belongs with the graphs: enqueued on their stream, with
        the kernel arrays they own."""
        if not self.cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.stream(self.stream))
        stack.enter_context(self.owned.active())
        return stack

    def capture(self, key: tuple, body: Callable[[], None],
                carried: Sequence[DecodeState] = ()) -> None:
        """Capture `body` as the graph of `key`. Run it once on the stream
        first (`on_stream`), so that the kernel arrays it uses exist and the
        libraries it calls are set up. The arrays of `carried` caches are
        not filled in the graph (the graph before it leaves them set); every
        other array the body uses is filled once, at the positions it asks
        for at capture. The garbage collector is off while it captures: a
        dropped object holding graphs (another engine's, in a reference
        cycle) would destroy them mid-capture, which invalidates it. A
        capture that fails raises."""
        graph = torch.cuda.CUDAGraph()
        self.owned.forget()
        self.owned.frozen = True
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with self.owned.active(carried=carried):
                with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                    body()
        finally:
            if collecting:
                gc.enable()
        self.owned.forget()
        self.graphs[key] = graph

    def replay(self, key: tuple, body: Callable[[], None]) -> None:
        """Enqueue the graph of `key` on the stream (on the CPU: run `body`).
        A replay advances the kernels' position arrays without the host, so
        the host's record of them is dropped."""
        self.replays += 1
        if not self.cuda:
            body()
            return
        with torch.cuda.stream(self.stream):
            self.graphs[key].replay()
        self.owned.forget()

    def record(self, slot: int) -> None:
        """Mark slot `slot` written by the work enqueued so far."""
        if self.cuda:
            self._events[slot].record(self.stream)

    def wait(self, slot: int) -> None:
        """Block until slot `slot` holds what was last enqueued into it."""
        if self.cuda:
            self._events[slot].synchronize()

    def launches(self) -> int:
        """The decode kernel's launches by the graphs and their warm-up runs
        (the kernel's own count; a device read behind the stream's work)."""
        if not self.cuda:
            return 0
        with torch.cuda.stream(self.stream):
            return self.owned.launches()

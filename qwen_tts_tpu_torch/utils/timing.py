"""Timing helpers — the port of `qwen_tts_tpu/utils/timing.py`.

CUDA work is enqueued and runs later, so a host clock read right after a
call measures the enqueue. The barrier here is
`torch.cuda.synchronize(device)`, which waits for the work of every stream
on that device, not only the current stream's: the engine's chunk graphs
replay on a stream of their own (`runtime/chunk_graphs.py`), and a
streaming generator closed after a chunk can leave up to two chunks in
flight there (`TTSEngine._generate_audio_chunks`). Tensors on the CPU need
no barrier. Two processes that share a card do not wait for each other's
work: a barrier covers the calling process only.

`span` marks the program's phases (a chunk graph's launch, the host's wait
for its outputs, a request's set-up, ...) while a `torch.profiler` capture
records in the process, whoever started it; otherwise it records nothing.
The records are kept in memory, on `time.perf_counter_ns`, from every
thread (the agent's text LM decodes in an executor thread), until
`take_spans()` hands them over. `torch.profiler.record_function` does not
serve here: it records only on the thread that started the profiler, and
costs ~14 us a call with none running.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler
from torch.utils._pytree import tree_leaves

SPAN_LIMIT = 1 << 16     # records held until taken; past it the oldest go first
_spans: deque = deque(maxlen=SPAN_LIMIT)


def sync(x) -> None:
    """Wait until every CUDA device that holds a tensor of the tree `x`
    (tuples, lists, dicts, named tuples) has finished all its streams'
    work."""
    devices = {leaf.device for leaf in tree_leaves(x)
               if getattr(leaf, "device", None) is not None and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def drain_device(device="cuda") -> None:
    """Wait for all work enqueued so far on `device`, on every stream —
    including chunks that a closed streaming generator left in flight.
    Latency probes (TTFC) call this between runs, or they measure the queue
    their previous run left, not the time to the first chunk."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextmanager
def timed(label: str = "", results: dict | None = None):
    """Host wall time of the block, in seconds into `results[label]`, or
    printed in ms when `results` is None. It does not wait for the device:
    end the block with `sync` where its work must be included."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"{label}: {dt * 1000:.2f} ms")


def bench_fn(fn, *args, warmup: int = 2, repeats: int = 5) -> float:
    """Best-of-`repeats` wall time of `fn(*args)` after `warmup` calls, each
    call followed by `sync` of its result. Returns seconds."""
    for _ in range(warmup):
        sync(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


class span:
    """`with span(name, ident, detail):` records (name, ident, detail,
    thread id, start ns, end ns) on `time.perf_counter_ns` when a torch
    profiler records both where the block starts and where it ends; with
    none it costs one read of the profiler's flag and a branch. `ident` is
    the request's number (the engine's request, the LM's stream); it may
    be set on the span inside the block, once known. `detail` is kept as a
    string (a graph's key). One record buffer serves every thread: appends
    to a deque are atomic under the GIL."""

    __slots__ = ("name", "ident", "detail", "_t0")

    def __init__(self, name: str, ident: int = 0, detail="") -> None:
        self.name, self.ident, self.detail = name, ident, detail
        self._t0 = 0

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 and _profiler._is_profiler_enabled:
            _spans.append((self.name, self.ident, str(self.detail), threading.get_ident(),
                           self._t0, time.perf_counter_ns()))


def take_spans() -> list[tuple]:
    """The span records held, oldest first, and clear them (a record another
    thread appends meanwhile is taken or left, never lost)."""
    out = []
    while _spans:
        try:
            out.append(_spans.popleft())
        except IndexError:
            break
    return out

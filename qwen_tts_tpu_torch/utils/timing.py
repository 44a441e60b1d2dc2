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
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
from torch.utils._pytree import tree_leaves


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

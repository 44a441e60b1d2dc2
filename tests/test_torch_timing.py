"""The port's timing helpers (`qwen_tts_tpu_torch/utils/timing.py`) against
the JAX package's (`qwen_tts_tpu/utils/timing.py`).

`bench_fn` and `timed` are held to JAX's on one fake clock: the same number
of calls, the same best time, the same records. The barrier differs by
design: JAX reads the first leaf back to the host; the port synchronizes
every CUDA device that holds a leaf of the tree (all its streams), and a
tree on the CPU needs none. CUDA is not on this machine, so the barrier's
calls are recorded in place of `torch.cuda.synchronize`; the card runs it
in `chip_smoke.py` (a closed stream's graphs drained)."""

import time
from types import SimpleNamespace

import jax.numpy as jnp
import pytest
import torch

from qwen_tts_tpu.utils import timing as jt
from qwen_tts_tpu_torch.utils import timing as tt


@pytest.fixture
def synced(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    return calls


@pytest.fixture
def clock(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    return now


def test_sync_waits_for_each_cuda_device_of_a_tree(synced):
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    leaf = lambda dev: SimpleNamespace(device=dev)  # noqa: E731 - a tensor's device
    tt.sync({"a": [leaf(cuda0), (leaf(cuda1), leaf(cuda0))], "b": torch.zeros(2), "c": 3})
    assert sorted(synced, key=str) == [cuda0, cuda1]
    synced.clear()
    tt.sync((torch.zeros(3), [torch.ones(1)], None))
    tt.sync([])
    assert synced == []


def test_drain_device_waits_for_every_stream_of_the_card(synced):
    tt.drain_device()
    tt.drain_device("cuda:0")
    tt.drain_device("cpu")
    assert synced == [torch.device("cuda"), torch.device("cuda:0")]


def test_timed_records_as_jax_does(clock, capsys):
    out_j, out_t = {}, {}
    for mod, out in ((jt, out_j), (tt, out_t)):
        clock[0] = 10.0
        with mod.timed("step", out):
            clock[0] += 0.25
        with mod.timed("printed"):
            clock[0] += 0.0125
    assert out_t == out_j == {"step": 0.25}
    printed = capsys.readouterr().out.splitlines()
    assert printed == ["printed: 12.50 ms"] * 2


@pytest.mark.parametrize("warmup, repeats", [(2, 5), (0, 1), (1, 3)])
def test_bench_fn_is_jax_best_of_n(clock, synced, warmup, repeats):
    durations = [0.5, 0.25, 0.375, 0.125, 0.625, 0.1875, 0.3125]   # exact in binary

    def run(mod, make):
        calls = []
        clock[0] = 0.0

        def fn(x):
            clock[0] += durations[len(calls)]
            calls.append(x)
            return make()

        return mod.bench_fn(fn, 7, warmup=warmup, repeats=repeats), calls

    best_j, calls_j = run(jt, lambda: jnp.zeros(2))
    best_t, calls_t = run(tt, lambda: (torch.zeros(2), SimpleNamespace(
        device=torch.device("cuda", 0))))
    assert best_t == best_j == min(durations[warmup:warmup + repeats])
    assert calls_t == calls_j == [7] * (warmup + repeats)
    assert synced == [torch.device("cuda", 0)] * (warmup + repeats)   # a barrier a call

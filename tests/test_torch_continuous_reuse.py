"""First audio on a used batcher (ROADMAP C.1): four requests at once on a
`ContinuousBatcher` that has served a burst before, against a fresh one of
the same config and against JAX's `ContinuousBatcher` on the same history.

The history: six texts on four slots, two of them admitted mid-stream
into the first slots to free (idle slots ride the chunks meanwhile). Then
four texts at once. For each request of that burst: its slot, the chunk
it was admitted before (counted from the burst's first dispatch), the
size of that chunk (the admission quantum, `admit_chunk_frames`) and the
chunks it took to its end. The port's used batcher, a fresh port batcher
and JAX's used batcher schedule the burst alike: no state the port
carries across bursts (idle positions, re-parking, `first_seq`, the id
ring, the ring of output slots) moves an admission or its first chunk.
Tiny model, greedy, `max_seq_len=256`, `chunk_frames=4`."""

import numpy as np
import pytest
import torch

from qwen_tts_tpu_torch.core.config import tiny_test_config
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.runtime.continuous import ContinuousBatcher

HISTORY = ["hello continuous batching", "a second utterance", "third one here",
           "the fourth text", "and a fifth", "six"]
BURST = ["one two three", "four five six seven", "eight", "nine ten eleven twelve thirteen"]
SLOTS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(batcher):
    """Wrap the batcher's `_admit` and `_dispatch` (the port's and JAX's
    share their names and the first and last items of what `_dispatch`
    returns: its sequence number and chunk size)."""
    log = {"admit": [], "dispatch": []}
    real_admit, real_dispatch = batcher._admit, batcher._dispatch

    def admit(req, slot):
        log["admit"].append((req, slot, batcher._seq))
        return real_admit(req, slot)

    def dispatch(n=None):
        out = real_dispatch(n)
        log["dispatch"].append((out[0], out[-1]))
        return out

    batcher._admit, batcher._dispatch = admit, dispatch
    return log


def _schedule(batcher, texts):
    """Serve `texts` at once; per request (in text order): slot, the chunk
    it was admitted before and that chunk's size, counted from the burst's
    first dispatch, and the chunks dispatched while it held its slot."""
    log = _record(batcher)
    seq0 = batcher._seq
    batcher.serve(texts)
    sizes = dict(log["dispatch"])
    out = {}
    for req, slot, seq in log["admit"]:
        held = [s for s, _n in log["dispatch"] if s >= req.first_seq]
        out[req.text] = (slot, req.first_seq - seq0, sizes[req.first_seq],
                         req.emitted, len(held) >= 1)
    return [out[t] for t in texts]


def _port_batcher():
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, seed=0,
                              backend="dense", subtalker_do_sample=False),
                    model_config=tiny_test_config(max_seq_len=256))
    eng.initialize()
    b = ContinuousBatcher(eng, slots=SLOTS, chunk_frames=4, admit_chunk_frames=2)
    b.warm()
    return b


def test_burst_on_a_used_batcher_is_scheduled_as_on_a_fresh_one_and_in_jax():
    from qwen_tts_tpu.core.config import tiny_test_config as j_tiny
    from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig
    from qwen_tts_tpu.engine.tts_engine import TTSEngine as JEngine
    from qwen_tts_tpu.runtime.continuous import ContinuousBatcher as JBatcher

    used = _port_batcher()
    history = _schedule(used, HISTORY)
    assert {h[1] for h in history} == {1, history[4][1]} and history[4][1] > 1  # two mid-stream
    on_used = _schedule(used, BURST)
    on_fresh = _schedule(_port_batcher(), BURST)

    jeng = JEngine(JConfig(max_seq_len=256, chunk_frames=4, seed=0, backend="dense",
                           subtalker_do_sample=False, warmup=False),
                   model_config=j_tiny(max_seq_len=256))
    jeng.initialize()
    jb = JBatcher(jeng, slots=SLOTS, chunk_frames=4, admit_chunk_frames=2)
    assert _schedule(jb, HISTORY) == history
    on_jax = _schedule(jb, BURST)

    # all four admitted before the burst's first chunk, which is the
    # 2-frame admission quantum: first audio is that chunk away
    assert [s[1:3] for s in on_used] == [(1, 2)] * 4
    assert sorted(s[0] for s in on_used) == list(range(SLOTS))
    assert on_used == on_fresh == on_jax
    assert all(np.isfinite(s[3]) and s[3] > 0 for s in on_used)

"""The port's continuous batching (`runtime/continuous.py`), the counterpart
of `tests/test_continuous.py`: staggered admission into fixed slots, EOS/cap
release and slot reuse, determinism, cancellation, the closed graph set
(no capture once warm), speculation budget and owner isolation, re-parking
before the cache's end, fast admission, Code2Wav's per-slot context, and
failures reaching every waiter, also one that already streamed audio (the
JAX batcher ends that one cleanly; the port raises). On the CPU the graphs'
bodies run eagerly in replay order. Tiny model, `max_seq_len=256`,
`chunk_frames=4`; one engine per module where a test does not need a fresh
one."""

import asyncio

import numpy as np
import pytest
import torch

from qwen_tts_tpu_torch.core.config import tiny_test_config
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.runtime import continuous
from qwen_tts_tpu_torch.runtime.continuous import ContinuousBatcher


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_engine(seq=256, **kw):
    cfg = TTSConfig(device="cpu", max_seq_len=seq, chunk_frames=4, seed=0, backend="dense",
                    **kw)
    eng = TTSEngine(cfg, model_config=tiny_test_config(max_seq_len=seq))
    eng.initialize()
    return eng


@pytest.fixture(scope="module")
def eng():
    return make_engine()


def test_serve_more_requests_than_slots(eng):
    """5 texts through 2 slots: every request completes with finite,
    hop-aligned audio, so slots are recycled across admissions."""
    b = ContinuousBatcher(eng, slots=2)
    texts = ["hello continuous batching", "a second utterance", "third one here",
             "the fourth text", "and a fifth"]
    results = b.serve(texts)
    assert len(results) == len(texts)
    hop = eng.vocoder_config.hop_length
    for wav, sr in results:
        assert sr == eng.sample_rate
        assert len(wav) > 0 and len(wav) % hop == 0
        assert np.isfinite(wav).all()
    assert b.active == 0 and not b._pending


def test_staggered_admission_interleaves(eng):
    """A request submitted while another is mid-stream joins a free slot
    and both finish."""
    b = ContinuousBatcher(eng, slots=2)

    async def staggered():
        first_chunks, second_chunks = [], []

        async def first():
            async for a, _ in b.submit("the first somewhat longer request "
                                       "keeps its slot busy for a while"):
                first_chunks.append(a)

        async def second():
            await asyncio.sleep(0)     # let first() start
            async for a, _ in b.submit("short reply"):
                second_chunks.append(a)

        await asyncio.gather(first(), second())
        return first_chunks, second_chunks

    f, s = asyncio.run(staggered())
    assert f and s
    assert np.isfinite(np.concatenate(f)).all() and np.isfinite(np.concatenate(s)).all()


def test_deterministic_given_engine_seed():
    """Two batchers over engines with the same seed give identical audio for
    the same request stream (noise per request number and frame)."""
    w1 = ContinuousBatcher(make_engine(), slots=2).serve(["same text"])
    w2 = ContinuousBatcher(make_engine(), slots=2).serve(["same text"])
    np.testing.assert_array_equal(w1[0][0], w2[0][0])


def test_cancellation_frees_slot(eng):
    """aclose() after the first chunk marks the request cancelled; its slot
    frees at the next chunk boundary and a later request still runs."""
    b = ContinuousBatcher(eng, slots=1)

    async def cancel_then_reuse():
        agen = b.submit("a long text that would stream for many chunks "
                        "if nobody cancelled it midway through")
        async for _a, _sr in agen:
            break
        await agen.aclose()
        return [a async for a, _ in b.submit("short follow up")]

    parts = asyncio.run(cancel_then_reuse())
    assert parts and b.active == 0


def test_cap_bounds_frames(eng):
    """A one-word text caps at the duration heuristic's floor: emitted
    frames never exceed the cap even though chunks are fixed-size."""
    b = ContinuousBatcher(eng, slots=1, chunk_frames=4)
    (wav, _sr), = b.serve(["hi"])
    assert len(wav) // eng.vocoder_config.hop_length <= 25


def test_closed_graph_set(eng):
    """`warm()` prepares every graph (admission, each chunk size); serving
    traffic afterwards, staggered and of different text lengths, prepares
    none and captures none."""
    b = ContinuousBatcher(eng, slots=2, chunk_frames=4, admit_chunk_frames=2)
    b.warm()
    keys, n = set(b._keys()), b.captures
    assert n == len(keys) == 3
    seen = []
    real = b._body
    b._body = lambda key: (seen.append(key), real(key))[1]
    b.serve(["one more text", "and another somewhat longer one", "plus a third"])
    assert b.captures == n and set(seen) <= keys and len(b._g.graphs) == 0


def test_speculation_budget_and_owner_isolation():
    """Depth-2: a single request costs at most ceil(frames/chunk) + 1 chunk
    dispatches (one speculative chunk at drain, the fast-admission chunk
    counted), and a request admitted into a just-freed slot never receives
    the previous occupant's speculative frames: its audio equals a solo run
    with the same request number."""
    e1 = make_engine()
    b = ContinuousBatcher(e1, slots=1, chunk_frames=4, admit_chunk_frames=0)
    calls = {"n": 0}
    orig = b._chunk_call

    def counting(n):
        calls["n"] += 1
        return orig(n)

    b._chunk_call = counting
    (wav, _), = b.serve(["hi"])
    n_chunks = -(-len(wav) // (e1.vocoder_config.hop_length * b.chunk))
    assert calls["n"] <= n_chunks + 1, (calls, n_chunks)

    served = ContinuousBatcher(make_engine(), slots=1, chunk_frames=4).serve(
        ["first occupant speaks", "second occupant text"])
    e3 = make_engine()
    e3._requests = 1                   # occupant 1 took request number 1
    solo = ContinuousBatcher(e3, slots=1, chunk_frames=4).serve(["second occupant text"])
    np.testing.assert_array_equal(served[1][0], solo[0][0])


def test_repark_before_ring_boundary():
    """An idle slot's position is parked again before it can reach
    max_seq_len, from `_collect` only (JAX `_maybe_repark`): at a small
    cache, slot 1 idles while slot 0 serves request after request, and
    every dispatch stays inside the cache."""
    e = make_engine(seq=64)
    b = ContinuousBatcher(e, slots=2, chunk_frames=4)
    parks, real = [], b._park
    b._park = lambda slot: (parks.append((slot, b._pos[slot])), real(slot))[1]
    highest = []
    real_dispatch = b._dispatch
    b._dispatch = lambda n: (highest.append(max(b._pos) + n), real_dispatch(n))[1]
    b.serve([f"text number {i} padded with words" for i in range(3)])
    limit = b._cfg.max_seq_len
    assert max(highest) <= limit
    assert any(p >= limit - 2 * b.chunk - 16 for _s, p in parks[2:]), parks
    assert all(p + 2 * b.chunk + 16 < limit + b.chunk for p in b._pos)
    assert int(b._state.pos.max()) <= limit


def test_fast_admission_first_chunk_is_small(eng):
    """The chunk right after an admission is `admit_chunk_frames` frames;
    later chunks are full-size."""
    b = ContinuousBatcher(eng, slots=2, chunk_frames=4, admit_chunk_frames=2)
    hop = eng.vocoder_config.hop_length

    async def one():
        return [len(a) // hop async for a, _sr in b.submit(
            "a long enough utterance to stream several chunks of audio frames")]

    sizes = asyncio.run(one())
    assert sizes[0] == 2, sizes
    assert max(sizes) == 4 and sum(sizes) > 2


def test_fast_admission_disabled(eng):
    """admit_chunk_frames=0 restores single-size dispatching."""
    b = ContinuousBatcher(eng, slots=1, chunk_frames=4, admit_chunk_frames=0)
    hop = eng.vocoder_config.hop_length

    async def one():
        return [len(a) // hop async for a, _sr in b.submit("hello with no fast admission path")]

    assert asyncio.run(one())[0] == 4


def test_fast_admission_mid_stream_other_slots_unaffected(eng):
    """A small chunk dispatched for a late arrival also advances the
    streaming slot by the small amount; both complete with finite audio."""
    b = ContinuousBatcher(eng, slots=2, chunk_frames=4, admit_chunk_frames=2)

    async def staggered():
        first_parts, second_parts = [], []

        async def first():
            async for a, _ in b.submit("the first long utterance keeps "
                                       "going while a new caller arrives"):
                first_parts.append(a)

        async def second():
            await asyncio.sleep(0.05)
            async for a, _ in b.submit("late arrival"):
                second_parts.append(a)

        await asyncio.gather(first(), second())
        return first_parts, second_parts

    f, s = asyncio.run(staggered())
    assert f and s
    assert np.isfinite(np.concatenate(f)).all() and np.isfinite(np.concatenate(s)).all()


def test_dispatch_loop_failure_propagates_to_waiters(eng):
    """A dead dispatch loop wakes a waiting request with the failure
    chained; the batcher serves the next request."""
    b = ContinuousBatcher(eng, slots=1)
    boom = RuntimeError("simulated device fault")
    orig = b._chunk_call

    def exploding(n):
        raise boom

    b._chunk_call = exploding

    async def drive():
        with pytest.raises(RuntimeError) as ei:
            async for _a, _sr in b.submit("this request hits the fault"):
                pass
        assert ei.value.__cause__ is boom
        b._chunk_call = orig
        return [a async for a, _ in b.submit("recovery request")]

    parts = asyncio.run(drive())
    assert parts and b.active == 0


def test_failure_after_audio_raises_not_a_clean_end(eng):
    """The JAX batcher's fault, not copied (`continuous.py:336-342`): when
    the loop fails after a request streamed audio, JAX ends it with a plain
    end of stream, a truncated utterance its caller cannot tell from a whole
    one. The port raises there too, the failure chained."""
    b = ContinuousBatcher(eng, slots=1, chunk_frames=4, admit_chunk_frames=0)
    boom = RuntimeError("simulated device fault mid-stream")
    orig, calls = b._chunk_call, {"n": 0}

    def fails_third(n):
        calls["n"] += 1
        if calls["n"] == 3:
            raise boom
        return orig(n)

    b._chunk_call = fails_third

    async def drive():
        got = []
        with pytest.raises(RuntimeError, match="truncated") as ei:
            async for a, _sr in b.submit("a long text that streams several chunks before "
                                         "the device fails under it"):
                got.append(a)
        return got, ei.value

    got, err = asyncio.run(drive())
    assert got and err.__cause__ is boom


def _c2w_engine():
    from qwen_tts_tpu_torch.vocoder.code2wav import Code2WavConfig

    c2c = Code2WavConfig(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                         intermediate_size=128, num_hidden_layers=2, decoder_dim=64,
                         codebook_size=64, num_quantizers=16)
    return make_engine(vocoder_backend="code2wav", code2wav_config=c2c,
                       code2wav_impl="reference")


def test_code2wav_fused_matches_host_decode():
    """The per-slot Code2Wav audio of the chunk graphs equals the engine's
    left-context chunk decode of the same codes: the first chunk in the
    utterance-start form, later ones against the previous chunk's codes."""
    e = _c2w_engine()
    b = ContinuousBatcher(e, slots=1, chunk_frames=4, admit_chunk_frames=2)
    recorded = []
    orig = b._chunk_call

    def recording(n):
        ring = orig(n)
        recorded.append((n, b._dev_out[n][0][0].clone()))
        return ring

    b._chunk_call = recording
    (wav, _sr), = b.serve(["fused vocoder parity check text"])
    hop = e.vocoder_config.hop_length
    parts, prev, produced = [], None, 0
    for n, codes in recorded:
        if produced >= len(wav) // hop:
            break                       # the speculative drain chunk
        full = e._frames_decode(codes, prev).numpy()
        take = min(n, len(wav) // hop - produced)
        parts.append(full[:take * hop])
        produced += take
        prev = codes
    np.testing.assert_allclose(wav, np.concatenate(parts)[:len(wav)], atol=2e-4, rtol=1e-3)


def test_code2wav_second_occupant_never_sees_predecessors_ctx():
    """A request admitted into a just-freed slot decodes its first chunk in
    the utterance-start form: its audio equals a solo run."""
    served = ContinuousBatcher(_c2w_engine(), slots=1, chunk_frames=4).serve(
        ["first occupant speaks", "second occupant text"])
    e3 = _c2w_engine()
    e3._requests = 1
    solo = ContinuousBatcher(e3, slots=1, chunk_frames=4).serve(["second occupant text"])
    np.testing.assert_array_equal(served[1][0], solo[0][0])


# ── against the JAX batcher ──────────────────────────────────────────────

def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


STAGGERED = ["short one", "a much longer second request with many more words in it",
             "the third text comes later"]


@pytest.fixture(scope="module")
def jax_served():
    """JAX's `ContinuousBatcher`, greedy, 2 slots, the three texts (the
    third admitted into the first slot to free, while the other slot sits
    at another position). Returns the engine whose weights the port takes
    and, by text, the request's emitted codes and its slot's hidden state
    after each chunk, keyed by the frames dispatched for it so far."""
    from qwen_tts_tpu.core.config import tiny_test_config as j_tiny
    from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig
    from qwen_tts_tpu.engine.tts_engine import TTSEngine as JEngine
    from qwen_tts_tpu.runtime.continuous import ContinuousBatcher as JBatcher

    jeng = JEngine(JConfig(max_seq_len=256, chunk_frames=4, seed=0, backend="dense",
                           subtalker_do_sample=False, warmup=False),
                   model_config=j_tiny(max_seq_len=256))
    jeng.initialize()
    jb = JBatcher(jeng, slots=2, chunk_frames=4, admit_chunk_frames=2)
    log, real = [], jb._dispatch

    def dispatch(n=None):
        occupants = list(jb._reqs)
        seq, codes, *rest = real(n)
        log.append((seq, occupants, np.asarray(codes), np.asarray(jb._hid), rest[-1]))
        return (seq, codes, *rest)

    jb._dispatch = dispatch
    jb.serve(STAGGERED)
    reqs, codes, hidden, frames = {}, {}, {}, {}
    for seq, occupants, c, h, n in log:
        for b, req in enumerate(occupants):
            if req is not None:
                assert req.first_seq <= seq
                reqs[req.text] = req
                codes.setdefault(req.text, []).append(c[b])
                frames[req.text] = frames.get(req.text, 0) + n
                hidden.setdefault(req.text, {})[frames[req.text]] = h[b]
    return jeng, {t: (np.concatenate(codes[t])[:r.emitted], hidden[t]) for t, r in reqs.items()}


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_staggered_requests_match_the_jax_batcher(jax_served, monkeypatch, backend):
    """The port's batcher against JAX's on the same weights and the same
    staggered traffic, greedy: each request's emitted codes equal JAX's, or
    first part at a near tie of the port's logits that chose them (the two
    codes within 2e-2: a bf16 rounding flipped by f32 sums taken in another
    order). Up to that frame, the slot's hidden state after each chunk is
    JAX's (cosine > 0.999), which a code-level match at this size cannot
    show alone: its code-predictor logits have near ties every few frames.
    So the admission graph's rows, position, token, hidden state and
    trailing text land in the right slot, and the chunk graph runs each slot
    from them."""
    from qwen_tts_tpu_torch.core.weights import from_jax
    from qwen_tts_tpu_torch.models.decoder import lm_head_logits
    from qwen_tts_tpu_torch.runtime import frame_loop
    from qwen_tts_tpu_torch.vocoder.model import vocoder_from_jax

    jeng, want = jax_served
    teng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, seed=0,
                               backend=backend, subtalker_do_sample=False),
                     model_config=tiny_test_config(max_seq_len=256))
    teng.initialize(weights=from_jax(jeng.weights, "cpu"),
                    vocoder_weights=vocoder_from_jax(jeng.vocoder_weights, "cpu"))
    b = ContinuousBatcher(teng, slots=2, chunk_frames=4, admit_chunk_frames=2)
    b.warm()
    # the port's logits: the talker's of every step (admission's CODEC_BOS
    # step included), the code predictor's of every frame
    talker, cp = [], []
    real_cp, real_step = frame_loop.cp_predict, frame_loop.decode_step_with_embed

    def cp_predict(*a, **k):
        codes, logits = real_cp(*a, **{**k, "return_logits": True})
        cp.append(logits)
        return codes

    def step(cfg, w, *a, **k):
        state, token, normed = real_step(cfg, w, *a, **k)
        talker.append(lm_head_logits(w, normed))
        return state, token, normed

    monkeypatch.setattr(frame_loop, "cp_predict", cp_predict)
    monkeypatch.setattr(frame_loop, "decode_step_with_embed", step)
    # per request: the logits that chose code 0 of each frame, and each
    # frame's code-predictor logits
    code0, groups, reqs, hidden = {}, {}, {}, {}
    real_admit, real_dispatch = b._admit, b._dispatch

    def admit(req, slot):
        real_admit(req, slot)
        reqs[req.text] = req
        code0[req.text] = [talker[-1]]

    def dispatch(n):
        t0, c0 = len(talker), len(cp)
        occupants = [(s, r, r.frames) for s, r in enumerate(b._reqs) if r is not None]
        out = real_dispatch(n)
        for s, r, f0 in occupants:
            for i in range(n):
                code0[r.text].append(talker[t0 + i][s])
                groups.setdefault(r.text, []).append(cp[c0 + i][s])
            hidden.setdefault(r.text, {})[r.frames] = b._hid[s].clone()
        return out

    b._admit, b._dispatch = admit, dispatch
    b.serve(STAGGERED)
    assert set(reqs) == set(want) == set(STAGGERED)
    assert len({r.first_seq for r in reqs.values()}) == 2   # the third admitted mid-stream
    for text in STAGGERED:
        (jc, jh), req = want[text], reqs[text]
        tc = np.concatenate(req.codes)
        n = min(len(jc), len(tc))
        diff = np.argwhere(jc[:n] != tc[:n])
        f = int(diff[0][0]) if len(diff) else n
        # the hidden state after k frames follows from the codes of frames < k
        same = [k for k in sorted(set(jh) & set(hidden[text])) if k <= f]
        assert same and same[0] == 2, (text, f)   # the first chunk agrees
        for k in same:
            assert _cos(jh[k], hidden[text][k].numpy()) > 0.999, (text, k)
        if not len(diff):
            assert len(jc) == len(tc), text
            continue
        g = int(diff[0][1])
        logits = code0[text][f] if g == 0 else groups[text][f][g - 1]
        assert abs(float(logits[jc[f, g]] - logits[tc[f, g]])) < 2e-2, (text, f, g)


def test_frame_cap_keeps_requests_inside_the_cache():
    """The word-count cap is bounded so a request and the two chunks
    dispatched past it fit in the cache."""
    e = make_engine(seq=64)
    b = ContinuousBatcher(e, slots=1, chunk_frames=4)
    assert b._frame_cap("word " * 200) == 64 - continuous.ADMIT_ROWS - 2 * 4
    assert b._frame_cap("hi") == 25

"""The port's batched path (`runtime/batch.py`) against the JAX package's,
and `TTSEngine.synthesize_batch` against single-text synthesis.

The same weights (`from_jax`) and numpy inputs from a seed go through JAX's
vmapped `batched_prefill` / `batched_frames` and the port's, B = 3, with
slots at different positions: a slot re-admitted through JAX's
`_insert_slot` while the others ran ahead. Greedy, and sampled with the
same draws (JAX's Gumbel values handed to the port in place of its
uniforms) against each slot's JAX `frames_chunk`. Codes must be equal or first part at a near tie (top-2 gap of
the port's logits < 2e-2, a bf16 rounding flipped by f32 sums taken in
another order), hidden states cosine > 0.999, as `tests/test_batch.py`
holds JAX's batch to its sequential path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import tiny_test_config
from qwen_tts_tpu.core.weights import init_tts_weights
from qwen_tts_tpu.runtime import batch as jb
from qwen_tts_tpu.runtime.continuous import _insert_slot
from qwen_tts_tpu_torch.core.weights import from_jax, to_torch
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.models.decoder import lm_head_logits
from qwen_tts_tpu_torch.runtime import batch as tb
from qwen_tts_tpu_torch.runtime import frame_loop

MC = tiny_test_config(max_seq_len=256)
TALKER = dataclasses.replace(MC.talker, mrope_section=(24, 20, 20), mrope_interleaved=True)
DELTAS = (0, 5, 9)
B, T, AHEAD, N = 3, 12, 3, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jw = init_tts_weights(jax.random.PRNGKey(0), MC)
    return jw, from_jax(jw, "cpu")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    h = MC.talker.hidden_size
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    prefill = bf(rng.standard_normal((B, 8, h)))
    trailing = bf(rng.standard_normal((B, T, h)))
    tlen = np.array([T - b for b in range(B)], np.int32)
    pad = bf(rng.standard_normal(h) * 0.1).copy()
    return prefill, trailing, tlen, pad


def _jax_noise(keys, idx0, n, top_k=50):
    """The Gumbel draws JAX's batched frames make: slot b's frame i takes
    fold_in(key_b, idx0_b + i), its group g fold_in(that, g)."""
    out = np.zeros((B, n, 15, top_k), np.float32)
    for b in range(B):
        for i in range(n):
            fk = jax.random.fold_in(keys[b], int(idx0[b]) + i)
            for g in range(15):
                out[b, i, g] = np.asarray(jax.random.gumbel(jax.random.fold_in(fk, g), (top_k,)))
    return out


def _jax_batch_at_different_positions(jw, kv_dtype, seed=1, sample=False):
    """A JAX batch of B slots: all prefilled, run AHEAD frames, then slot 1
    re-admitted (a fresh prefill inserted with `_insert_slot`): slot 1 at
    position 9, the others at 9 + AHEAD. Returns (batch tuple, keys, inputs)."""
    prefill, trailing, tlen, pad = _inputs(seed)
    md = jnp.asarray(DELTAS, jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(seed + 10), B)
    state, tok, hid = jb.batched_prefill(TALKER, jw.talker, jnp.asarray(prefill),
                                         kv_dtype=kv_dtype, mrope_deltas=md)
    tr, tl = jnp.asarray(trailing, jnp.bfloat16), jnp.asarray(tlen)
    state, _, _, tok, hid = jb.batched_frames(
        TALKER, MC.code_predictor, jw.talker, jw.code_predictor, state, tok, hid, tr, tl,
        jnp.zeros((B,), jnp.int32), jnp.asarray(pad), keys, num_frames=AHEAD,
        do_sample=sample, mrope_deltas=md)
    one = jb.batched_prefill(TALKER, jw.talker, jnp.asarray(prefill[1:2]), kv_dtype=kv_dtype,
                             mrope_deltas=md)
    idx0 = jnp.full((B,), AHEAD, jnp.int32)
    batch = (state, tok, hid, tr, tl, idx0)
    fresh = (*one, tr[1:2], tl[1:2], jnp.zeros((1,), jnp.int32))
    batch = _insert_slot(batch, fresh, jnp.int32(1))
    assert np.asarray(batch[0].position).tolist() == [9 + AHEAD, 9, 9 + AHEAD]
    return batch, keys, pad


def _to_port(batch):
    """The JAX batch as the port's: a state of B slots with device positions."""
    state, tok, hid, tr, tl, idx0 = batch
    sc = lambda a: None if a is None else to_torch(a, "cpu")  # noqa: E731
    ts = td.DecodeState(to_torch(state.k_cache, "cpu"), to_torch(state.v_cache, "cpu"), 0,
                        sc(state.k_scale), sc(state.v_scale),
                        torch.from_numpy(np.array(state.position)).to(torch.int32))
    return (ts, torch.from_numpy(np.array(tok)).long(), to_torch(hid, "cpu"),
            to_torch(tr, "cpu"), torch.from_numpy(np.array(tl)),
            torch.from_numpy(np.array(idx0)))


def _recording(monkeypatch):
    """Record the port's talker logits [B, V] and code-predictor logits
    [B, 15, V] per frame."""
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
    return talker, cp


def _equal_or_near_tie(jc, tc, talker, cp):
    """Per slot: codes equal, or the first differing code a near tie of the
    port's logits that chose it (frame f's talker code 0 was chosen by the
    previous frame's talker step)."""
    for b in range(B):
        diff = np.argwhere(jc[b] != tc[b])
        if not len(diff):
            continue
        f, g = (int(x) for x in diff[0])
        logits = (talker[f - 1][b] if f else None) if g == 0 else cp[f][b, g - 1]
        assert logits is not None, (b, f, g)
        top2 = torch.topk(logits, 2).values
        assert float(top2[0] - top2[1]) < 2e-2, (b, f, g, top2)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_batched_frames_greedy_match_jax_at_different_positions(weights, monkeypatch, cache):
    jw, tw = weights
    kv = (jnp.int8, torch.int8) if cache == "int8" else (jnp.bfloat16, torch.bfloat16)
    batch, keys, pad = _jax_batch_at_different_positions(jw, kv[0])
    state, tok, hid, tr, tl, idx0 = _to_port(batch)
    js, jcodes, jvalid, jtok, jhid = jb.batched_frames(
        TALKER, MC.code_predictor, jw.talker, jw.code_predictor, *batch, jnp.asarray(pad),
        keys, num_frames=N, do_sample=False, mrope_deltas=jnp.asarray(DELTAS, jnp.int32))
    talker, cp = _recording(monkeypatch)
    ts, tcodes, tvalid, ttok, thid = tb.batched_frames(
        TALKER, MC.code_predictor, tw.talker, tw.code_predictor, state, tok, hid, tr, tl, idx0,
        torch.from_numpy(pad), None, num_frames=N, do_sample=False, attn_impl="pallas",
        mrope_deltas=DELTAS)
    assert tcodes.shape == (B, N, 16) and tvalid.shape == (B, N)
    assert ts.pos.tolist() == np.asarray(js.position).tolist() == [9 + AHEAD + N, 9 + N,
                                                                   9 + AHEAD + N]
    _equal_or_near_tie(np.asarray(jcodes), tcodes.numpy(), talker, cp)
    if np.array_equal(np.asarray(jcodes), tcodes.numpy()):
        assert _cos(jhid, thid.numpy()).min() > 0.999
        np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())


def test_batched_frames_sampled_match_jax_fed_the_same_draws(weights, monkeypatch):
    """Sampled, each slot against JAX's `frames_chunk` on that slot's rows
    (what `batched_frames` vmaps), fed the same Gumbel draws. JAX's vmapped
    batch itself does not reproduce its per-slot frames here (seed 2: slots
    0 and 1 part from them at frame 1's last group, by more than a near
    tie; not investigated), so the per-slot function is the reference."""
    from qwen_tts_tpu.runtime.frame_loop import frames_chunk as j_frames_chunk

    jw, tw = weights
    batch, keys, pad = _jax_batch_at_different_positions(jw, jnp.bfloat16, seed=2, sample=True)
    state, tok, hid, tr, tl, idx0 = _to_port(batch)
    md = jnp.asarray(DELTAS, jnp.int32)
    jc = np.stack([np.asarray(j_frames_chunk(
        TALKER, MC.code_predictor, jw.talker, jw.code_predictor,
        jax.tree.map(lambda x: x[b], batch[0]), *(x[b] for x in batch[1:]),
        jnp.asarray(pad), keys[b], num_frames=N, do_sample=True, mrope_deltas=md)[1])
        for b in range(B)])
    # the port transforms uniforms into Gumbel noise; hand it JAX's noise itself
    monkeypatch.setattr(frame_loop, "gumbel_from_uniform", lambda u: u)
    noise = torch.from_numpy(_jax_noise(keys, np.asarray(batch[5]), N))
    talker, cp = _recording(monkeypatch)
    _, tcodes, _, _, _ = tb.batched_frames(
        TALKER, MC.code_predictor, tw.talker, tw.code_predictor, state, tok, hid, tr, tl, idx0,
        torch.from_numpy(pad), noise, num_frames=N, do_sample=True, attn_impl="pallas",
        mrope_deltas=DELTAS)
    tc = tcodes.numpy()
    assert (jc[:, 0] == tc[:, 0]).mean() >= 0.9
    for b in range(B):
        # a sampled code parts only at a rank swap: the two codes' logits
        # within 2e-2, so their top-k ranks, and the noise each meets, swap
        # (tests/test_torch_code_predictor.py's rule)
        diff = np.argwhere(jc[b] != tc[b])
        if not len(diff):
            continue
        f, g = (int(x) for x in diff[0])
        assert g >= 1, (b, f)
        logits = cp[f][b, g - 1]
        assert abs(float(logits[jc[b, f, g]] - logits[tc[b, f, g]])) < 2e-2, (b, f, g)


def test_batched_prefill_matches_jax(weights):
    """The batched prefill: first tokens equal, hidden cosine > 0.999, cache
    rows close, positions 9 on the device."""
    jw, tw = weights
    prefill = _inputs(3)[0].copy()
    md = jnp.asarray(DELTAS, jnp.int32)
    js, jt, jh = jb.batched_prefill(TALKER, jw.talker, jnp.asarray(prefill), mrope_deltas=md)
    ts, tt, th = tb.batched_prefill(TALKER, tw.talker, torch.from_numpy(prefill),
                                    attn_impl="pallas", mrope_deltas=DELTAS)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert _cos(jh, th.numpy()).min() > 0.999
    assert ts.pos.tolist() == [9] * B and ts.k_cache.shape[0] == B
    np.testing.assert_allclose(ts.k_cache[:, :, :, :9].float().numpy(),
                               np.asarray(js.k_cache[:, :, :, :9].astype(jnp.float32)),
                               rtol=0, atol=3e-2)


def test_a_slot_does_not_depend_on_its_neighbours(weights):
    """Slot 1 of two batches whose other slots differ: the same codes, the
    same bits of hidden state and cache rows (each slot's rows of every
    product and its own attention)."""
    _, tw = weights

    def run(seed_others):
        prefill, trailing, tlen, pad = (torch.from_numpy(a) for a in _inputs(4))
        others = [torch.from_numpy(a) for a in _inputs(seed_others)]
        for b in (0, 2):
            prefill[b], trailing[b], tlen[b] = others[0][b], others[1][b], others[2][b]
        ts, tok, hid = tb.batched_prefill(TALKER, tw.talker, prefill, attn_impl="pallas",
                                          mrope_deltas=DELTAS)
        ts, codes, valid, _, h = tb.batched_frames(
            TALKER, MC.code_predictor, tw.talker, tw.code_predictor, ts, tok, hid,
            trailing.bfloat16(), tlen, torch.zeros(B, dtype=torch.int32), pad, None,
            num_frames=3, do_sample=False, attn_impl="pallas", mrope_deltas=DELTAS)
        return codes[1], h[1], ts.k_cache[1, :, :, :12]

    (c1, h1, k1), (c2, h2, k2) = run(5), run(6)
    assert torch.equal(c1, c2) and torch.equal(h1, h2) and torch.equal(k1, k2)


# ── TTSEngine.synthesize_batch ───────────────────────────────────────────

TEXTS = ["hello world", "a longer second utterance for the batch", "third",
         "and a fourth one"]


def _engine(weights, **kw):
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, seed=0,
                              backend="dense", **kw), model_config=MC)
    eng.initialize(weights=weights)
    return eng


@pytest.mark.parametrize("form", [{}, {"quantize": "int8"}, {"kv_cache": "int8"},
                                  {"quantize": "int4", "kv_cache": "int8"}])
def test_synthesize_batch_matches_single_texts(weights, monkeypatch, form):
    """B texts in one batch against each text alone on a fresh engine
    (request numbers 1..B either way): hop-aligned audio of each text's
    frames, codes equal or first parting at a near tie of the batch's
    logits (a rank swap of two codes within 2e-2); frames counted."""
    _, tw = weights
    texts = TEXTS if not form else TEXTS[:2]
    eng = _engine(tw, **form)
    seen = []
    real = eng._decode_to_audio
    monkeypatch.setattr(eng, "_decode_to_audio",
                        lambda frames: (seen.append(np.stack(frames)), real(frames))[1])
    talker, cp = _recording(monkeypatch)       # talker[f] chose frame f's code 0
    results = eng.synthesize_batch(texts)
    monkeypatch.undo()
    assert len(results) == len(texts)
    hop = eng.vocoder_config.hop_length
    for wav, sr in results:
        assert sr == eng.sample_rate and wav.dtype == np.float32
        assert len(wav) > 0 and len(wav) % hop == 0 and np.isfinite(wav).all()
    assert eng.get_metrics()["frames_generated"] == sum(len(s) for s in seen)
    single = _engine(tw, **form)
    for b, text in enumerate(texts):
        single._requests = b
        frames = [f for _a, fr in single._generate_chunks(text, 4, with_audio=False)
                  for f in fr]
        one = np.stack(frames)
        n = min(len(one), len(seen[b]))
        diff = np.argwhere(one[:n] != seen[b][:n])
        if not len(diff):
            assert len(one) == len(seen[b])
            wav, _ = results[b]
            np.testing.assert_allclose(wav, real(frames)[0], rtol=0, atol=1e-5)
            continue
        f, g = (int(x) for x in diff[0])
        logits = talker[f][b] if g == 0 else cp[f][b, g - 1]
        assert abs(float(logits[one[f, g]] - logits[seen[b][f, g]])) < 2e-2, (b, f, g)


def test_synthesize_batch_of_nothing_and_of_one(weights):
    _, tw = weights
    eng = _engine(tw)
    assert eng.synthesize_batch([]) == []
    (wav, sr), = eng.synthesize_batch(["just one"])
    assert len(wav) > 0 and sr == eng.sample_rate

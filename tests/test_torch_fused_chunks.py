"""The engine's fused chunk path (one CUDA graph a chunk on a GPU), on the CPU.

On the CPU the graphs' bodies run eagerly, in the order the GPU replays
them, so these tests hold the restructured body (device trailing index and
length, a buffer of uniform draws transformed in the body, one code-predictor
state reset in place) to the eager frame loop it replaces, bit for bit; the
first-chunk body to the JAX engine's `first_fn`; the fused engine to the
eager one; the speculation policy and the room check of the JAX engine's
`_generate_audio_chunks`; and interleaved streams of one engine to the
same streams alone. One `gpu` test
holds a captured chunk to the eager chunk on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import CODEC_EOS, tiny_test_config
from qwen_tts_tpu.core.weights import init_tts_weights
from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig
from qwen_tts_tpu.engine.tts_engine import TTSEngine as JEngine
from qwen_tts_tpu_torch.core.weights import from_jax
from qwen_tts_tpu_torch.engine import tts_engine
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine, stream_seed
from qwen_tts_tpu_torch.models.code_predictor import cp_predict
from qwen_tts_tpu_torch.models.decoder import init_state
from qwen_tts_tpu_torch.models.text_projection import embed_text_ids
from qwen_tts_tpu_torch.ops.sampling import gumbel_noise
from qwen_tts_tpu_torch.runtime import frame_loop
from qwen_tts_tpu_torch.vocoder.model import vocoder_from_jax

TEXT = "hello world"     # 2 words: a cap of 25 frames (10 a word, at least 25)
SEQ = 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_cfg():
    """The suite's tiny widths, with room for a few chunks."""
    return tiny_test_config(max_seq_len=SEQ)


@pytest.fixture(scope="module")
def tiny_weights(tiny_cfg):
    return init_tts_weights(jax.random.PRNGKey(0), tiny_cfg)


@pytest.fixture(scope="module")
def weights(tiny_weights):
    return from_jax(tiny_weights, "cpu")


def _engine(tiny_cfg, weights, vocoder=None, **kw):
    kw = {"device": "cpu", "max_seq_len": SEQ, "chunk_frames": 10, "seed": 3, **kw}
    eng = TTSEngine(TTSConfig(**kw), model_config=tiny_cfg)
    eng.initialize(weights=weights, vocoder_weights=vocoder)
    return eng


@pytest.fixture(scope="module")
def fused(tiny_cfg, weights):
    return _engine(tiny_cfg, weights)


@pytest.fixture(scope="module")
def eager(tiny_cfg, weights, fused):
    return _engine(tiny_cfg, weights, fused.vocoder_weights, fused_chunks=False)


def _chunks(eng, text, k, request, with_audio=True):
    eng._requests = request - 1
    return list(eng._generate_chunks(text, k, with_audio=with_audio))


def _frames(chunks):
    return np.stack([f for _a, fr in chunks for f in fr])


def _eos_after(monkeypatch, calls):
    """Make the talker emit CODEC_EOS from its `calls`-th step of each
    request on (the BOS step counts as the first)."""
    real = frame_loop.decode_step_with_embed
    seen = {"n": 0}

    def step(*a, **k):
        state, token, normed = real(*a, **k)
        seen["n"] += 1
        return state, (torch.tensor(CODEC_EOS) if seen["n"] >= calls else token), normed

    monkeypatch.setattr(frame_loop, "decode_step_with_embed", step)
    return seen


def _old_loop(eng, text, sizes, request, cap):
    """The eager loop this path replaced: trailing text sliced on the host,
    the text row chosen by a host branch on a host index, each frame's
    noise drawn and transformed by `gumbel_noise`, a fresh code-predictor
    state every frame. Returns (codes [n, 16], valid [n]) of every frame
    computed, chunk by chunk as `sizes` says, up to the chunk that holds
    EOS or the `cap`-th frame."""
    mc, w = eng.model_config, eng.weights
    tw, cw = w.talker, w.code_predictor
    content = tts_engine.encode_tts_prompt(eng.tokenizer, text)[3:]
    n, Tpad = len(content), tts_engine.TRAILING_BUCKET
    ids = np.zeros(Tpad, dtype=np.int64)
    ids[:n] = content
    ce = embed_text_ids(w.text_projection, torch.from_numpy(ids))
    prefill = torch.cat([eng._role_embeds, eng._fused_tags, ce[:1] + eng._codec_bos_embed[None]])
    eos_pos = max(n - 6, 0)
    trailing = torch.zeros_like(ce)
    trailing[:eos_pos] = ce[1:eos_pos + 1]
    trailing[eos_pos] = eng._tts_eos_embed
    t_len = max(n - 5, 1)
    state = init_state(mc.talker, "cpu", eng._kv_dtype)
    state, tok, hid = frame_loop.talker_prefill(mc.talker, tw, state, prefill,
                                                attn_impl=eng._attn_impl,
                                                mrope_deltas=eng._mrope_deltas)
    gen, frame, codes, valid = torch.Generator(), 0, [], []
    for size in sizes:
        alive = True
        for _ in range(size):
            gen.manual_seed(stream_seed(eng.config.seed, request, frame))
            noise = gumbel_noise((mc.num_code_groups - 1, eng._top_k), gen, "cpu")
            c = cp_predict(mc.code_predictor, cw, hid, tok, tw.embed, noise=noise,
                           temperature=tts_engine.SUBTALKER_TEMPERATURE,
                           top_k=tts_engine.SUBTALKER_TOP_K, attn_impl=eng._attn_impl)
            e = frame_loop._sum_code_embeddings(c, tw.embed, cw.codec_embeds)
            text_row = trailing[min(frame, Tpad - 1)] if frame < t_len else eng._tts_pad_embed
            alive = alive and int(tok) != CODEC_EOS
            state, tok, hid = frame_loop.decode_step_with_embed(
                mc.talker, tw, state, e + text_row.float(), attn_impl=eng._attn_impl,
                mrope_pos=[state.position + d for d in eng._mrope_deltas])
            codes.append(c.numpy().astype(np.int32))
            valid.append(alive)
            frame += 1
        if not alive or frame >= cap:
            break                       # nothing after this chunk is kept
    return np.stack(codes), np.array(valid)


@pytest.mark.parametrize("k,eos_at", [(10, None), (3, None), (10, 9), (3, 9)])
def test_body_equals_the_old_eager_loop(fused, monkeypatch, k, eos_at):
    """Chunkings 1+10+10+10 and 1+3+3..., through the cap (25 frames) and
    through EOS (the talker's 9th step emits it: 8 frames kept): the kept
    frames equal the old loop's bit for bit, chunk by chunk."""
    sizes = [1] + [k] * (25 // k + 1)
    seen = _eos_after(monkeypatch, eos_at or 10 ** 9)
    want, valid = _old_loop(fused, TEXT, sizes, request=21, cap=25)
    seen["n"] = 0
    got = _chunks(fused, TEXT, k, request=21)
    keep = min(int(valid.sum()), 25)
    assert keep == (8 if eos_at else 25)
    np.testing.assert_array_equal(_frames(got), want[:keep])
    lens = [len(fr) for _a, fr in got]
    assert lens[0] == 1 and all(n == k for n in lens[1:-1]) and sum(lens) == keep


@pytest.fixture(scope="module")
def jax_first(tiny_cfg, tiny_weights):
    jeng = JEngine(JConfig(max_seq_len=SEQ, chunk_frames=10, subtalker_do_sample=False,
                           warmup=False), model_config=tiny_cfg)
    jeng.initialize(weights=tiny_weights)
    return jeng


@pytest.mark.parametrize("n_content", [1, 5, 6, 7, 40])
def test_first_chunk_body_matches_jax_first_fn(tiny_cfg, weights, jax_first, monkeypatch,
                                               n_content):
    """The first-chunk body, from padded ids and a device count, against
    JAX `first_fn` (greedy): trailing rows within one bf16 ulp of JAX's, or
    2e-5 near zero (the text projection's f32 sums in another order), and
    equal to the port's own shifted embeddings with tts_eos at max(n-6, 0)
    and zeros after; t_len = max(n-5, 1); the first frame's codes equal and
    its audio within 1e-5, or the first code that differs at a near tie of
    the code predictor's logits (top-2 gap < 2e-2, the rule of
    `test_torch_engine.py`)."""
    eng = _engine(tiny_cfg, weights, vocoder_from_jax(jax_first.vocoder_weights, "cpu"),
                  subtalker_do_sample=False)
    Tpad = tts_engine.TRAILING_BUCKET
    rng = np.random.default_rng(n_content)
    ids = np.zeros(Tpad, dtype=np.int32)
    ids[:n_content] = rng.integers(0, tiny_cfg.text_projection.text_vocab_size, n_content)
    _, codes, valid, _, _, audio, trailing, t_len = jax_first._first_audio_fn(
        jnp.asarray(ids), jnp.int32(n_content), jax.random.PRNGKey(0))

    cp_logits = []
    real = frame_loop.cp_predict

    def recording(*a, **k):
        c, logits = real(*a, **{**k, "return_logits": True})
        cp_logits.append(logits)
        return c

    monkeypatch.setattr(frame_loop, "cp_predict", recording)
    eng._buffers(Tpad, 10, 3)
    host = eng._ids[Tpad][0]
    host[:Tpad] = torch.from_numpy(ids.astype(np.int64))
    host[Tpad] = n_content
    eng._body(Tpad, 1, 0, first=True, audio=True)
    out = eng._out[1][0]

    assert int(eng._t_len) == int(t_len) == max(n_content - 5, 1)
    got = eng._trailing[Tpad].float().numpy()
    want = np.asarray(trailing.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2e-5)
    own = embed_text_ids(eng.weights.text_projection, torch.from_numpy(ids).long()).float()
    eos_pos = max(n_content - 6, 0)
    np.testing.assert_array_equal(got[:eos_pos], own[1:eos_pos + 1].numpy())
    np.testing.assert_array_equal(got[eos_pos], eng._tts_eos_embed.float().numpy())
    assert not got[eos_pos + 1:].any()
    assert bool(out.valid[0]) == bool(valid[0])
    diff = np.flatnonzero(out.codes.numpy()[0] != np.asarray(codes)[0])
    if len(diff):
        g = int(diff[0])
        assert g >= 1, "talker token differs"
        top2 = torch.topk(cp_logits[0][g - 1], 2).values
        assert float(top2[0] - top2[1]) < 2e-2, (g, top2)
    else:
        np.testing.assert_allclose(out.audio.numpy(), np.asarray(audio), rtol=0, atol=1e-5)


def test_fused_engine_equals_eager_engine(fused, eager):
    """Same chunks, codes and audio, streaming and `synthesize`, for the
    same request numbers (another chunk size: the old-loop test above)."""
    a, b = _chunks(fused, TEXT, 10, 31), _chunks(eager, TEXT, 10, 31)
    assert [len(fr) for _x, fr in a] == [len(fr) for _x, fr in b]
    np.testing.assert_array_equal(_frames(a), _frames(b))
    for (x, _), (y, _) in zip(a, b):
        np.testing.assert_array_equal(x, y)
    fused._requests = eager._requests = 40
    np.testing.assert_array_equal(fused.synthesize(TEXT)[0], eager.synthesize(TEXT)[0])


def test_speculation_depth_and_a_closed_stream(tiny_cfg, weights, fused, monkeypatch):
    """The first chunk and one more enqueued before the first read; then
    never more than two in flight beside the one the host is reading; every
    chunk up to the cap enqueued once. A stream closed with chunks in
    flight, then a new request: the codes of a fresh engine."""
    log = []
    for name in ("_enqueue_first", "_enqueue_chunk", "_read"):
        real = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _real=real, _n=name: (
            log.append(_n), _real(*a))[1])
    chunks = iter(fused._generate_chunks(TEXT, 10, with_audio=True))
    next(chunks)
    assert log == ["_enqueue_first", "_enqueue_chunk", "_read"]
    rest = list(chunks)
    assert [len(fr) for _a, fr in rest] == [10, 10, 4]         # the cap: 25 frames
    in_flight, peak = 0, 0
    for name in log:
        in_flight += 1 if name != "_read" else -1
        peak = max(peak, in_flight)
        if name == "_read":
            assert in_flight <= 2
    assert peak == 3 and log.count("_enqueue_chunk") == 3 and log.count("_read") == 4

    closed = iter(fused._generate_chunks("one two three four five six seven", 10, True))
    next(closed), next(closed)
    closed.close()
    again = _chunks(fused, TEXT, 10, request=51)
    fresh = _chunks(_engine(tiny_cfg, weights, fused.vocoder_weights), TEXT, 10, request=51)
    np.testing.assert_array_equal(_frames(again), _frames(fresh))


def _interleaved(eng, texts, k, request0):
    """Streams of `texts` on one engine, numbered from `request0`, advanced
    one chunk each in turn until all end: their chunks, stream by stream."""
    eng._requests = request0 - 1
    streams = [iter(eng._generate_chunks(t, k, with_audio=True)) for t in texts]
    got, live = [[] for _ in texts], list(range(len(texts)))
    while live:
        for i in list(live):
            chunk = next(streams[i], None)
            if chunk is None:
                live.remove(i)
            else:
                got[i].append(chunk)
    return got


def test_resumed_stream_of_an_earlier_request_raises(fused, monkeypatch):
    """Two live streams of one engine, interleaved chunk by chunk while
    chunks of each are in flight (the one-request-per-engine fault, now
    repaired): resuming the earlier stream raises nothing, and each stream
    yields, bit for bit, the codes and audio it yields alone. The second
    stream takes the engine's state twice with unread chunks of the first
    in the ring (parked), and gives it back."""
    texts = (TEXT, "one two three four five six seven")
    alone = [_chunks(fused, t, 10, request=81 + i) for i, t in enumerate(texts)]
    parks = []
    real = fused._park
    monkeypatch.setattr(fused, "_park", lambda s: (parks.append(len(s.pending)), real(s)))
    got = _interleaved(fused, texts, 10, 81)
    assert len(parks) >= 3 and max(parks) == 2, parks
    for a, b in zip(alone, got):
        assert [len(fr) for _x, fr in a] == [len(fr) for _x, fr in b]
        np.testing.assert_array_equal(_frames(a), _frames(b))
        for (x, _), (y, _) in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert fused._owner is None


def test_room_check_raises_before_the_replay(tiny_cfg, weights, monkeypatch):
    """A chunk that would run past max_seq_len raises the decode step's
    ValueError before its body runs (the graph has no checks of its own)."""
    eng = _engine(tiny_cfg, weights, max_seq_len=16)
    bodies = []
    real = eng._body
    monkeypatch.setattr(eng, "_body", lambda *a, **k: (bodies.append(a), real(*a, **k)))
    with pytest.raises(ValueError, match="exceed max_seq_len 16"):
        list(eng._generate_chunks(TEXT, 10, with_audio=True))
    assert len(bodies) == 1 and eng.get_metrics()["position"] == 10


def test_eager_loop_stops_at_eos_without_speculation(eager, monkeypatch):
    """`fused_chunks=False`: each chunk read before the next, so nothing is
    computed past the chunk that holds EOS."""
    _eos_after(monkeypatch, 4)                        # frames 0-2 kept
    m0 = eager.get_metrics()
    frames = _frames(_chunks(eager, " ".join(["word"] * 20), 4, 61))
    m1 = eager.get_metrics()
    assert len(frames) == 3
    assert m1["talker_steps"] - m0["talker_steps"] == 1 + 1 + 4
    assert m1["cp_steps"] - m0["cp_steps"] == 14 * 5


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_uncapturable_backends_raise_with_fused_chunks_on_cuda(tiny_cfg, weights, fused,
                                                               backend):
    """Backends "pallas" and "dense" used to raise with `fused_chunks=True` on
    CUDA (their ops took host positions). They now build their graphs: the
    engine takes the option, its talker state carries its position on the
    device, and the bodies its graphs replay (run eagerly here) yield the
    eager loop's codes and audio bit for bit, leaving the device position
    where the host's is."""
    TTSEngine(TTSConfig(backend=backend))
    g = _engine(tiny_cfg, weights, fused.vocoder_weights, backend=backend, chunk_frames=4)
    e = _engine(tiny_cfg, weights, fused.vocoder_weights, backend=backend, chunk_frames=4,
                fused_chunks=False)
    assert g._talker.pos is not None and g._talker.pos.dtype == torch.int32
    gc, ec = _chunks(g, TEXT, 4, 81), _chunks(e, TEXT, 4, 81)
    np.testing.assert_array_equal(_frames(gc), _frames(ec))
    for (ga, _), (ea, _) in zip(gc, ec):
        np.testing.assert_array_equal(ga, ea)
    assert int(g._talker.pos) == g._pos


def _to_cuda(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cuda()
    if isinstance(tree, tuple):
        items = [_to_cuda(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


@pytest.mark.gpu
def test_captured_chunks_equal_eager_chunks_on_the_card(tiny_cfg, weights):
    """On the card: the graph path's codes equal the eager loop's bit for
    bit (the same kernels, replayed), streaming and at another chunk size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w = _to_cuda(weights)
    g = _engine(tiny_cfg, w, device="cuda", chunk_frames=4)
    e = _engine(tiny_cfg, w, g.vocoder_weights, device="cuda", chunk_frames=4,
                fused_chunks=False)
    for k in (4, 3):
        np.testing.assert_array_equal(_frames(_chunks(g, TEXT, k, 71)),
                                      _frames(_chunks(e, TEXT, k, 71)))

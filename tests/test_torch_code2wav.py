"""The Code2Wav vocoder in the port, against the JAX package's.

The network at the `TINY` config of `test_code2wav.py` (weights made in
JAX from a synthetic torch state dict, carried over by
`code2wav_from_jax`): `code2wav_apply` and `chunked_decode` in f32 within
the JAX tests' bar (rtol 2e-4, atol 2e-5), the packed numerics in f32 at
the same bar, both numerics in bf16 against JAX's of the same kind at
cosine >= 0.995, and the output length. Then the engine, tiny and on the
CPU, built from `model_path` and `vocoder_path`: its streamed audio equals
the JAX engine's `frames_decode` chain (each chunk after the previous
one's codes, a partial last chunk repeat-padded) on the port's own codes
within 1e-4, on the fused path at `chunk_frames` and at another size and
on the per-frame generator, where JAX's own generator decodes each chunk
without that context (a seam at every chunk, ROADMAP C.3); `synthesize` is
the stream joined; the windowed
whole-utterance decode equals JAX's; the vocoder modes; and interleaved
streams yield what they yield alone."""

import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig
from qwen_tts_tpu.engine.tts_engine import TTSEngine as JEngine
from qwen_tts_tpu.vocoder import code2wav as J
from qwen_tts_tpu.vocoder import code2wav_fast as JF
from qwen_tts_tpu_torch.core import config as tcfg
from qwen_tts_tpu_torch.core import safetensors as tst
from qwen_tts_tpu_torch.core.weights import init_tts_weights, tts_state_dict
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.vocoder import code2wav as T
from qwen_tts_tpu_torch.vocoder.code2wav_fast import code2wav_apply_packed, pack_code2wav_weights

TINY = dict(codebook_size=32, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            sliding_window=5, intermediate_size=96, num_hidden_layers=2, num_quantizers=4,
            upsample_rates=(4, 3), upsampling_ratios=(2,), decoder_dim=32)
# The engine's: 16 code groups, narrower still
ENGINE_C2W = dict(codebook_size=32, hidden_size=32, num_attention_heads=2,
                  num_key_value_heads=1, sliding_window=5, intermediate_size=48,
                  num_hidden_layers=1, num_quantizers=16, upsample_rates=(4, 3),
                  upsampling_ratios=(2,), decoder_dim=16)
TEXT = "hello world"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(cfg: T.Code2WavConfig, seed: int) -> dict:
    """A synthetic torch state dict at the module's own scale: norm scales
    near one, everything else N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in T.code2wav_state(
        T.init_code2wav_weights(0, cfg, "meta"), cfg).items()}
    return {k: (float(k.endswith("norm.weight")) + 0.02 * rng.standard_normal(s)).astype(
        np.float32) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def net():
    jc, tc = J.Code2WavConfig(**TINY), T.Code2WavConfig(**TINY)
    jw = J.convert_code2wav_state(_state(tc, 7), jc)
    codes = np.random.default_rng(0).integers(0, TINY["codebook_size"], (2, 4, 13))
    return jc, tc, jw, T.code2wav_from_jax(jw, "cpu"), codes


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_code2wav_apply_and_chunked_decode_equal_jax(net):
    """f32, T = 13 past the sliding window of 5; chunks of 4 after 2 frames
    of context."""
    jc, tc, jw, tw, codes = net
    apply = jax.jit(partial(J.code2wav_apply, jc))
    want = np.asarray(apply(jw, jnp.asarray(codes, jnp.int32)))
    got = T.code2wav_apply(tc, tw, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, tc.output_samples(13))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    want = np.asarray(J.chunked_decode(jc, jw, jnp.asarray(codes[:1], jnp.int32), chunk_size=4,
                                       left_context_size=2,
                                       apply_fn=lambda _c, w, x: apply(w, x)))
    got = T.chunked_decode(tc, tw, torch.from_numpy(codes[:1]), chunk_size=4,
                           left_context_size=2).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_packed_f32_equals_jax_packed_f32(net):
    jc, tc, jw, tw, codes = net
    want = np.asarray(jax.jit(partial(JF.code2wav_apply_packed, jc))(
        JF.pack_code2wav_weights(jc, jw, dtype=jnp.float32), jnp.asarray(codes, jnp.int32)))
    got = code2wav_apply_packed(tc, pack_code2wav_weights(tw, torch.float32),
                                torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("impl", ["packed", "reference"])
def test_bf16_matches_jax_bf16_of_the_same_impl(net, impl):
    """bf16 against JAX's bf16 of the same numerics: cosine >= 0.995 (and
    the packed form keeps its f32 biases, norms and Snake parameters)."""
    jc, tc, jw, tw, codes = net
    x = jnp.asarray(codes, jnp.int32)
    if impl == "packed":
        want = jax.jit(partial(JF.code2wav_apply_packed, jc))(
            JF.pack_code2wav_weights(jc, jw, dtype=jnp.bfloat16), x)
        pw = pack_code2wav_weights(tw, torch.bfloat16)
        assert pw.dec_blocks[0].alpha.dtype == pw.dec_post.b.dtype == torch.float32
        assert pw.dec_post.w.dtype == pw.layers[0].wq.dtype == torch.bfloat16
        got = code2wav_apply_packed(tc, pw, torch.from_numpy(codes))
    else:
        want = jax.jit(partial(J.code2wav_apply, jc))(
            jax.tree.map(lambda a: a.astype(jnp.bfloat16), jw), x)
        leaves = dict(T.named_leaves(tw))
        got = T.code2wav_apply(tc, T.build_tree(tw, lambda p: leaves[p].bfloat16()),
                               torch.from_numpy(codes))
    assert _cos(got.float().numpy(), np.asarray(want, np.float32)) >= 0.995


def test_output_samples_formula():
    """T frames give T * hop - deficit samples (555 at the public config,
    as JAX computes it), and the network gives that many."""
    for kw in ({}, TINY):
        jc, tc = J.Code2WavConfig(**kw), T.Code2WavConfig(**kw)
        assert tc.hop_length == jc.hop_length and tc.output_deficit == jc.output_deficit
        for t in (1, 2, 7, 13):
            assert tc.output_samples(t) == jc.output_samples(t) == t * tc.hop_length \
                - tc.output_deficit
    assert T.Code2WavConfig().output_deficit == 555 and T.Code2WavConfig().hop_length == 1920
    tc = T.Code2WavConfig(**TINY)
    w = T.init_code2wav_weights(3, tc, "cpu")
    for t in (1, 6):
        wav = T.code2wav_apply(tc, w, torch.zeros((1, 4, t), dtype=torch.long))
        assert wav.shape == (1, tc.output_samples(t)) and float(wav.abs().max()) <= 1.0


# ── the engine ───────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny model.safetensors and code2wav.safetensors (torch key names),
    written by the port's writer."""
    d = tmp_path_factory.mktemp("c2w_ckpt")
    mc = tcfg.tiny_test_config(max_seq_len=128)
    tst.save_file(tts_state_dict(init_tts_weights(4, mc, "cpu"), mc), str(d / "model.safetensors"))
    cfg = T.Code2WavConfig(**ENGINE_C2W)
    tst.save_file(_state(cfg, 9), str(d / "code2wav.safetensors"))
    return str(d)


def _engine(ckpt, monkeypatch=None, **kw):
    if monkeypatch is not None:
        monkeypatch.setitem(sys.modules, "transformers", None)   # as on the GPU host
    kw = {"device": "cpu", "max_seq_len": 128, "chunk_frames": 5, "seed": 3,
          "max_new_tokens": 14, "model_path": ckpt, "vocoder_path": ckpt,
          "vocoder_backend": "code2wav", "code2wav_config": T.Code2WavConfig(**ENGINE_C2W),
          **kw}
    eng = TTSEngine(TTSConfig(**kw), model_config=tcfg.tiny_test_config(max_seq_len=128))
    eng.initialize()
    return eng


@pytest.fixture(scope="module")
def fused(ckpt):
    with pytest.MonkeyPatch.context() as mp:
        return _engine(ckpt, mp)


@pytest.fixture(scope="module")
def jax_vocoder(ckpt):
    """The JAX engine's Code2Wav half, loaded from the same file (no talker)."""
    jeng = JEngine(JConfig(vocoder_backend="code2wav", vocoder_path=ckpt,
                           code2wav_config=J.Code2WavConfig(**ENGINE_C2W), code2wav_window=8,
                           code2wav_ctx=3, warmup=False))
    jeng._load_vocoder()
    assert not jeng._vocoder_is_random
    return jeng


def _chain(jeng, chunks, n):
    """JAX `frames_decode` over the port's chunks: each after the previous
    chunk's codes, a chunk of fewer than n frames after another padded."""
    hop, prev, out = jeng.vocoder_config.hop_length, None, []
    for _audio, frames in chunks:
        cur, k = np.stack(frames), len(frames)
        if prev is not None and k < n:
            cur = np.concatenate([cur, np.broadcast_to(cur[-1], (n - k, cur.shape[1]))])
        wav = jeng._voc_ctx_jit(jeng.vocoder_weights, jnp.asarray(cur),
                                None if prev is None else jnp.asarray(prev))
        out.append(np.asarray(wav, np.float32)[:k * hop])
        prev = cur
    return out


@pytest.mark.parametrize("path,k", [("fused", 5), ("fused", 4), ("eager", 5)])
def test_streamed_audio_equals_jax_frames_decode_chain(ckpt, fused, jax_vocoder,
                                                       monkeypatch, path, k):
    """1 + 5 + 5 + a partial 3 (the cap of 14 frames), and 1 + 4 + 4 + 4 +
    a partial 1 at the non-default size: every chunk's audio within 1e-4 of
    JAX's chain on the same codes; the per-frame generator's codes and audio equal
    the fused path's."""
    eng = fused if path == "fused" else _engine(ckpt, monkeypatch, fused_chunks=False)
    eng._requests = 40
    chunks = list(eng._generate_chunks(TEXT, k, with_audio=True))
    lens = [len(f) for _a, f in chunks]
    assert lens[0] == 1 and sum(lens) == 14 and 0 < lens[-1] < k, lens
    for got, want in zip([a for a, _f in chunks], _chain(jax_vocoder, chunks, k)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if path == "eager":
        fused._requests = 40
        ref = list(fused._generate_chunks(TEXT, k, with_audio=True))
        for (a, fa), (b, fb) in zip(chunks, ref):
            np.testing.assert_array_equal(np.stack(fa), np.stack(fb))
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_generator_keeps_the_left_context_that_jax_drops(ckpt, jax_vocoder, monkeypatch):
    """ROADMAP C.3: JAX's per-frame generator (`synthesize_streaming` with
    `fused_chunks=False`) decodes each buffered chunk alone
    (`_decode_to_audio(buffer)`), so every chunk after the first starts as
    an utterance would: a seam. The port's keeps the previous chunk as left
    context, as both fused paths do (it equals JAX's `frames_decode` chain:
    `test_streamed_audio_equals_jax_frames_decode_chain[eager-5]`); JAX's
    per-chunk decode of the same codes differs from it in the chunk's first
    hop by more than ten times that test's 1e-4 and a tenth of the audio's
    peak."""
    eng = _engine(ckpt, monkeypatch, fused_chunks=False)
    eng._requests = 40
    chunks = list(eng._generate_chunks(TEXT, 5, with_audio=True))
    hop = eng.vocoder_config.hop_length
    assert len(chunks) >= 3
    for audio, frames in chunks[1:]:
        alone, _ = jax_vocoder._decode_to_audio(list(frames))
        assert alone.shape == audio.shape
        head = np.abs(alone[:hop] - audio[:hop]).max()
        assert head > max(10 * 1e-4, 0.1 * float(np.abs(audio).max())), head


def test_synthesize_is_the_stream_joined(fused):
    fused._requests = 50
    stream = [a for a, _f in fused._generate_chunks(TEXT, 5, with_audio=True)]
    fused._requests = 50
    wav, sr = fused.synthesize(TEXT)
    assert sr == fused.sample_rate
    np.testing.assert_array_equal(wav, np.concatenate(stream))


def test_windowed_decode_equals_jax(ckpt, jax_vocoder, monkeypatch):
    """`_decode_to_audio` (the eager path's `synthesize`): windows of 8
    frames after 3 frames of context, the last padded to its bucket of
    {2, 4, 8}, against JAX `_c2w_decode_full` on 19 random frames."""
    eng = _engine(ckpt, monkeypatch, fused_chunks=False, code2wav_window=8, code2wav_ctx=3)
    codes = np.random.default_rng(5).integers(0, 3072, (19, 16)).astype(np.int32)
    got, sr = eng._decode_to_audio(list(codes))
    want = jax_vocoder._c2w_decode_full(codes)
    assert got.shape == want.shape == (19 * eng.vocoder_config.hop_length,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode,path", [("auto", "file"), ("auto", "missing"),
                                       ("random", "file"), ("silence", "file")])
def test_vocoder_modes(ckpt, fused, tmp_path, monkeypatch, mode, path):
    """`vocoder_mode` as in JAX: "auto" loads the file, or falls back to
    random weights when it is missing; "random" ignores it; "silence" has
    no vocoder and streams zeros of the chunks' lengths."""
    eng = _engine(ckpt, monkeypatch, vocoder_mode=mode,
                  vocoder_path=ckpt if path == "file" else str(tmp_path))
    assert eng._vocoder_is_random == (mode == "random" or path == "missing")
    if mode == "silence":
        assert eng.vocoder_weights is None
        chunks = list(eng._generate_chunks(TEXT, 5, with_audio=True))
        assert [len(a) for a, _f in chunks] == [len(f) * 1920 for _a, f in chunks]
        assert not any(a.any() for a, _f in chunks)
    else:
        loaded = dict(T.named_leaves(fused.vocoder_weights))
        same = all(torch.equal(t, loaded[p]) for p, t in T.named_leaves(eng.vocoder_weights))
        assert same == (mode == "auto" and path == "file")


def test_interleaved_streams_with_context_equal_alone(fused):
    """Two Code2Wav streams on one engine, interleaved chunk by chunk: each
    chunk's context codes are parked and restored with the rest, so each
    stream yields, bit for bit, what it yields alone."""
    texts = (TEXT, "one two three")
    alone = []
    for i, t in enumerate(texts):
        fused._requests = 60 + i
        alone.append(list(fused._generate_chunks(t, 5, with_audio=True)))
    fused._requests = 60
    streams = [iter(fused._generate_chunks(t, 5, with_audio=True)) for t in texts]
    got, live = [[], []], [0, 1]
    while live:
        for i in list(live):
            c = next(streams[i], None)
            if c is None:
                live.remove(i)
            else:
                got[i].append(c)
    for a, b in zip(alone, got):
        assert len(a) == len(b) > 2
        for (x, fx), (y, fy) in zip(a, b):
            np.testing.assert_array_equal(np.stack(fx), np.stack(fy))
            np.testing.assert_array_equal(x, y)

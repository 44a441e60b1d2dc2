"""The port's engine — the whole streaming slice — on the CPU.

Against the JAX `TTSEngine` with the same weights (`from_jax`) and text at
the reduced config, greedy: the first frame's 16 codes identical, >= 95% of
the codes of the first 8 frames identical, and the audio of chunks whose
codes are identical within 1e-3. Then the port alone: chunk lengths,
chunking-invariant sampled codes, EOS as the stop, the options that are
not ported yet, and unknown quantization options."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import CODEC_EOS, tiny_test_config
from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig
from qwen_tts_tpu.engine.tts_engine import TTSEngine as JEngine
from qwen_tts_tpu.core.weights import init_tts_weights
from qwen_tts_tpu_torch.core.weights import from_jax
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.runtime import frame_loop
from qwen_tts_tpu_torch.vocoder.model import vocoder_from_jax

TEXT = "Hello from the GPU."


@pytest.fixture(scope="module")
def mc():
    return tiny_test_config(max_seq_len=256)


@pytest.fixture(scope="module")
def engines(mc):
    jw = init_tts_weights(jax.random.PRNGKey(0), mc)
    jeng = JEngine(JConfig(max_seq_len=256, chunk_frames=4, subtalker_do_sample=False,
                           warmup=False), model_config=mc)
    jeng.initialize(weights=jw)
    teng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, subtalker_do_sample=False),
                     model_config=mc)
    teng.initialize(weights=from_jax(jw, "cpu"),
                    vocoder_weights=vocoder_from_jax(jeng.vocoder_weights, "cpu"))
    return jeng, teng


@pytest.fixture(scope="module")
def port(mc):
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, seed=3), model_config=mc)
    eng.initialize()
    return eng


@pytest.fixture(scope="module")
def jax_chunks(engines):
    """The JAX engine's first chunks of TEXT, at least 16 frames."""
    j_chunks = []
    for audio, frames in engines[0]._generate_audio_chunks(TEXT, 4):
        j_chunks.append((audio, frames))
        if sum(len(f) for _, f in j_chunks) >= 16:
            break
    return j_chunks


def _assert_codes_match_jax(j_chunks, teng, monkeypatch):
    import qwen_tts_tpu_torch.models.code_predictor as tcp

    cp_logits = []

    def recording(*a, **k):
        codes, logits = tcp.cp_predict(*a, **{**k, "return_logits": True})
        cp_logits.append(logits)
        return codes

    monkeypatch.setattr(frame_loop, "cp_predict", recording)
    t_chunks = list(teng._generate_chunks(TEXT, 4, with_audio=True))
    jf = np.stack([f for _, fr in j_chunks for f in fr])[:16]
    tf = np.stack([f for _, fr in t_chunks for f in fr])[:16]
    assert len(jf) == len(tf) == 16
    np.testing.assert_array_equal(jf[0], tf[0])
    assert (jf[:8] == tf[:8]).mean() >= 0.95
    diff = np.argwhere(jf != tf)
    if len(diff):
        f, g = diff[0]
        assert g >= 1, "talker token differs"
        top2 = torch.topk(cp_logits[f][g - 1], 2).values
        assert float(top2[0] - top2[1]) < 2e-2, (f, g, top2)
    for (ja, jfr), (ta, tfr) in zip(j_chunks, t_chunks):
        if len(jfr) == len(tfr) and all((a == b).all() for a, b in zip(jfr, tfr)):
            np.testing.assert_allclose(ja, ta, rtol=0, atol=1e-3)


def test_engine_matches_jax_engine(engines, jax_chunks, monkeypatch):
    """Greedy codes equal JAX's; the first code that differs (if any, in 16
    frames) must sit at a near tie of the code predictor's logits (top-2
    gap < 2e-2), where a bf16 rounding that flips after f32 sums taken in
    another order decides the argmax."""
    jeng, teng = engines
    assert teng._attn_impl == jeng._attn_impl == "dense"        # "auto" on the CPU
    _assert_codes_match_jax(jax_chunks, teng, monkeypatch)


def test_pallas_engine_matches_jax_engine(mc, engines, jax_chunks, monkeypatch):
    """The "pallas" backend (the decode-attention kernel's plain version on
    the CPU) against the JAX engine's dense backend, under the rule above;
    its attention runs once per layer of every single-token step and never
    in a prefill."""
    from qwen_tts_tpu_torch.models import decoder as td

    teng = engines[1]
    peng = TTSEngine(TTSConfig(device="cpu", backend="pallas", max_seq_len=256,
                               chunk_frames=4, subtalker_do_sample=False), model_config=mc)
    peng.initialize(weights=teng.weights, vocoder_weights=teng.vocoder_weights)
    assert peng._attn_impl == "pallas"
    calls = []
    real = td.decode_attention
    monkeypatch.setattr(td, "decode_attention", lambda *a: calls.append(a[5]) or real(*a))
    m0 = peng.get_metrics()
    _assert_codes_match_jax(jax_chunks, peng, monkeypatch)
    m1 = peng.get_metrics()
    assert len(calls) == (mc.talker.num_layers * (m1["talker_steps"] - m0["talker_steps"])
                          + mc.code_predictor.num_layers * (m1["cp_steps"] - m0["cp_steps"]))


def test_streaming_chunk_lengths(port):
    async def collect():
        return [a async for a, _sr in port.synthesize_streaming("hello world streaming test")]

    chunks = asyncio.run(collect())
    hop = port.vocoder_config.hop_length
    assert len(chunks) >= 3
    assert len(chunks[0]) == hop
    assert all(len(c) == 4 * hop for c in chunks[1:-1])
    assert 0 < len(chunks[-1]) <= 4 * hop and len(chunks[-1]) % hop == 0
    assert all(c.dtype == np.float32 and np.isfinite(c).all() for c in chunks)


def test_streaming_and_nonstreaming_codes_equal_with_sampling(port):
    """Noise is keyed by (seed, request, absolute frame): chunking 1+4+4...
    and 1+3+3... give the same codes, and `synthesize` decodes them."""
    text = "same text, sampled twice"
    port._requests = 10
    a = [f for _a, fr in port._generate_chunks(text, 4, with_audio=True) for f in fr]
    port._requests = 10
    b = [f for _a, fr in port._generate_chunks(text, 3, with_audio=False) for f in fr]
    port._requests = 10
    wav, _sr = port.synthesize(text)
    assert len(a) == len(b) > 5
    assert all((x == y).all() for x, y in zip(a, b))
    np.testing.assert_array_equal(wav, port._decode_to_audio(a)[0])
    port._requests = 11
    c = [f for _a, fr in port._generate_chunks(text, 4, with_audio=False) for f in fr]
    assert any((x != y).any() for x, y in zip(a, c))     # a new request, new draws


def test_eos_stops_before_the_cap(port, monkeypatch):
    real = frame_loop.frame_step
    calls = {"n": 0}

    def eos_at_3(*a, **k):
        r = real(*a, **k)
        calls["n"] += 1
        return r._replace(next_token=torch.tensor(CODEC_EOS)) if calls["n"] >= 3 else r

    monkeypatch.setattr(frame_loop, "frame_step", eos_at_3)
    text = " ".join(["word"] * 20)                   # cap = 200 frames
    m0 = port.get_metrics()
    frames = [f for _a, fr in port._generate_chunks(text, 4, with_audio=True) for f in fr]
    m1 = port.get_metrics()
    assert len(frames) == 3
    assert m1["frames_generated"] == 3
    # BOS step + chunks 1, 4, and the two chunks of 4 enqueued before the
    # second chunk was read (the fused path's speculation): computed, counted
    # and dropped
    assert m1["talker_steps"] - m0["talker_steps"] == 1 + 1 + 4 + 4 + 4
    assert m1["cp_steps"] - m0["cp_steps"] == 14 * 13


def test_metrics_and_nonstreaming_length(port):
    wav, sr = port.synthesize("metrics check")
    m = port.get_metrics()
    assert sr == m["sample_rate"] == 24000
    assert len(wav) == m["frames_generated"] * port.vocoder_config.hop_length
    assert m["position"] > 0 and np.abs(wav).max() <= 1.0


@pytest.mark.parametrize("kw", [dict(quantize="int2"), dict(kv_cache="fp8"),
                                dict(vocoder_backend="hifigan"), dict(cp_quantize="int3"),
                                dict(vocoder_mode="loud")])
def test_unported_options_raise(kw):
    """Unknown quantize / kv_cache / cp_quantize / vocoder values raise the
    JAX engine's ValueError, when the engine is made. (Checkpoint loading
    and the Code2Wav vocoder are ported: `test_torch_checkpoint.py`,
    `test_torch_code2wav.py`.)"""
    with pytest.raises(ValueError, match="unknown"):
        TTSEngine(TTSConfig(**kw))

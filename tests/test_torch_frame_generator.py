"""The engine's per-frame generator (`fused_chunks=False`) against the JAX
engine's (`_generate_codec_frames` and the buffering of
`synthesize_streaming`), on the CPU at the reduced config.

Greedy, same weights and vocoder: the same number of frames (to the frame
cap, or to an EOS the talker emits at a chosen step in both), no frame
computed past EOS (`get_metrics` counts the BOS step and one talker and 14
code-predictor steps a frame kept, nothing more), the chunk lengths 1, then
`chunk_frames`, then what is left, the codes equal (or the first that
differs at a near tie of the code predictor's logits, top-2 gap < 2e-2, the
rule of `test_torch_engine.py`), and each chunk's "fast" audio within 1e-3
of JAX's `_decode_to_audio` of the same buffer where the codes are equal.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import CODEC_EOS, tiny_test_config
from qwen_tts_tpu.core.weights import init_tts_weights
from qwen_tts_tpu.engine import tts_engine as jte
from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig
from qwen_tts_tpu.engine.tts_engine import TTSEngine as JEngine
from qwen_tts_tpu_torch.core.weights import from_jax
from qwen_tts_tpu_torch.engine import tts_engine as tte
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.runtime import frame_loop
from qwen_tts_tpu_torch.vocoder.model import vocoder_from_jax

TEXT = "hello world"     # 2 words: a cap of 25 frames
SEQ = 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    mc = tiny_test_config(max_seq_len=SEQ)
    jw = init_tts_weights(jax.random.PRNGKey(0), mc)
    jeng = JEngine(JConfig(max_seq_len=SEQ, chunk_frames=4, subtalker_do_sample=False,
                           fused_chunks=False, warmup=False), model_config=mc)
    jeng.initialize(weights=jw)
    teng = TTSEngine(TTSConfig(device="cpu", max_seq_len=SEQ, chunk_frames=4,
                               subtalker_do_sample=False, fused_chunks=False),
                     model_config=mc)
    teng.initialize(weights=from_jax(jw, "cpu"),
                    vocoder_weights=vocoder_from_jax(jeng.vocoder_weights, "cpu"))
    return jeng, teng


def _eos_at(monkeypatch, module, frame: int):
    """Make `module.frame_step`'s `frame`-th call of a request feed
    CODEC_EOS into the next frame (frames 0 .. frame-1 are kept)."""
    real = module.frame_step
    seen = {"n": 0}

    def step(*a, **k):
        r = real(*a, **k)
        seen["n"] += 1
        if seen["n"] >= frame:
            eos = torch.tensor(CODEC_EOS) if module is tte else jax.numpy.int32(CODEC_EOS)
            r = r._replace(next_token=eos)
        return r

    monkeypatch.setattr(module, "frame_step", step)
    return seen


def _stream(eng, text):
    async def run():
        return [np.asarray(a) async for a, _sr in eng.synthesize_streaming(text)]

    return asyncio.run(run())


@pytest.mark.parametrize("eos_frame", [None, 6])
def test_generator_matches_jax_generator(engines, monkeypatch, eos_frame):
    """To the cap (25 frames) and to an EOS fed after frame 6: the frames,
    steps, chunk lengths, codes and "fast" audio of JAX's generator."""
    jeng, teng = engines
    if eos_frame:
        seen = [_eos_at(monkeypatch, m, eos_frame) for m in (jte, tte)]
    cp_logits = []
    real_cp = frame_loop.cp_predict

    def recording(*a, **k):
        c, logits = real_cp(*a, **{**k, "return_logits": True})
        cp_logits.append(logits)
        return c

    monkeypatch.setattr(frame_loop, "cp_predict", recording)
    want = list(jeng._generate_codec_frames(TEXT))
    m0 = teng.get_metrics()
    got = list(teng._generate_codec_frames(TEXT))
    m1 = teng.get_metrics()
    n = eos_frame or 25
    assert len(got) == len(want) == n == m1["frames_generated"]
    assert m1["talker_steps"] - m0["talker_steps"] == 1 + n       # nothing past EOS
    assert m1["cp_steps"] - m0["cp_steps"] == 14 * n
    jf, tf = np.stack(want), np.stack(got)
    np.testing.assert_array_equal(jf[0], tf[0])
    diff = np.argwhere(jf != tf)
    if len(diff):
        f, g = diff[0]
        assert g >= 1, "talker token differs"
        top2 = torch.topk(cp_logits[f][g - 1], 2).values
        assert float(top2[0] - top2[1]) < 2e-2, (f, g, top2)

    if eos_frame:
        for s in seen:
            s["n"] = 0
    j_audio, t_audio = _stream(jeng, TEXT), _stream(teng, TEXT)
    hop = teng.vocoder_config.hop_length
    lens = [len(a) // hop for a in t_audio]
    assert lens == [len(a) // hop for a in j_audio]
    assert lens[0] == 1 and all(k == 4 for k in lens[1:-1]) and sum(lens) == n
    assert 0 < lens[-1] <= 4
    base = 0
    for ja, ta, k in zip(j_audio, t_audio, lens):
        if (jf[base:base + k] == tf[base:base + k]).all():
            np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-3)
        base += k


def test_generator_codes_equal_the_fused_path(engines):
    """The generator and the graphs' bodies (run eagerly here) give the same
    codes bit for bit for the same request number: the noise is drawn per
    (request, frame) on both, here greedy; sampled in
    `test_torch_fused_chunks.py`."""
    _, teng = engines
    fused = TTSEngine(TTSConfig(device="cpu", max_seq_len=SEQ, chunk_frames=4,
                                subtalker_do_sample=False), model_config=teng.model_config)
    fused.initialize(weights=teng.weights, vocoder_weights=teng.vocoder_weights)
    fused._requests = teng._requests = 9
    a = [f for _x, fr in fused._generate_chunks(TEXT, 4, with_audio=True) for f in fr]
    b = list(teng._generate_codec_frames(TEXT))
    np.testing.assert_array_equal(np.stack(a), np.stack(b))

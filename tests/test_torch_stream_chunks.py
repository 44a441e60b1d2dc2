"""Streaming at a chunk size other than `TTSConfig.chunk_frames`, against JAX.

The JAX engine decodes each chunk of such a stream through
`_decode_to_audio`, which repeat-pads the chunk's frames to a bucket {1,
chunk_frames, 2 x chunk_frames, ...}; the vocoder's pre-net sees +-12
frames, so the padding reaches every sample of the chunk. The port must do
the same. Same weights (`from_jax`), greedy, the reduced config: while the
two streams' codes agree, each chunk's audio is within 1e-5 of JAX's (the
port's `_decode_to_audio` on equal frames is within ~1.1e-6 of JAX's)."""

import jax
import numpy as np
import pytest

from qwen_tts_tpu.core.config import tiny_test_config
from qwen_tts_tpu.core.weights import init_tts_weights
from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig
from qwen_tts_tpu.engine.tts_engine import TTSEngine as JEngine
from qwen_tts_tpu_torch.core.weights import from_jax
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.vocoder.model import vocoder_from_jax

TEXT = "Hello from the GPU."
FRAMES = 13          # a first chunk of one frame, then whole chunks of k


@pytest.fixture(scope="module")
def engines():
    mc = tiny_test_config(max_seq_len=256)
    jw = init_tts_weights(jax.random.PRNGKey(0), mc)
    jeng = JEngine(JConfig(max_seq_len=256, chunk_frames=4, subtalker_do_sample=False,
                           warmup=False), model_config=mc)
    jeng.initialize(weights=jw)
    teng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4,
                               subtalker_do_sample=False), model_config=mc)
    teng.initialize(weights=from_jax(jw, "cpu"),
                    vocoder_weights=vocoder_from_jax(jeng.vocoder_weights, "cpu"))
    return jeng, teng


def _first_chunks(chunks, frames: int):
    out = []
    for audio, fr in chunks:
        out.append((audio, fr))
        if sum(len(f) for _, f in out) >= frames:
            break
    return out


@pytest.mark.parametrize("k", [3, 6])
def test_stream_at_other_chunk_size_matches_jax(engines, k):
    jeng, teng = engines
    # the JAX engine's streaming path for chunk_size != chunk_frames
    # (synthesize_streaming with the "fast" vocoder): one fused dispatch per
    # chunk, each chunk's frames through _decode_to_audio
    j = _first_chunks(((jeng._decode_to_audio(c)[0], c) for c in jeng._generate_codec_chunks(
        TEXT, first_chunk=1, chunk_size=k) if c), FRAMES)
    t = _first_chunks(teng._generate_chunks(TEXT, k, with_audio=True), FRAMES)
    hop = teng.vocoder_config.hop_length
    assert [len(f) for _, f in t] == [len(f) for _, f in j] == [1] + [k] * (len(j) - 1)
    compared = 0
    for (ja, jf), (ta, tf) in zip(j, t):
        if not all((a == b).all() for a, b in zip(jf, tf)):
            break                                 # the streams parted: stop here
        assert ta.shape == ja.shape == (len(tf) * hop,)
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-5)
        compared += 1
    assert compared >= 2, compared                # the 1-frame chunk and one of k

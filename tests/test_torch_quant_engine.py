"""The port's engine serving quantized weights and an int8 KV cache, on the CPU.

Against the JAX `TTSEngine(quantize="int8", kv_cache="int8")` with the same
bf16 weights (`from_jax`, each engine quantizing its own copy) and text at
the reduced config, greedy, both on their CPU path (dense layers, one
layer dequantized at a time): the first frame's 16 codes equal, and the
first code that differs (if any, in 16 frames) a near tie (top-2 gap <
2e-2) of the port's code-predictor logits; one such flip changes every
frame after it. (The "mega" path's plain version takes the kernel's
products, `mm_scaled`, which keep int8 weights exact where the dense path
rounds them to bf16; it is held to the Pallas kernel in
tests/test_torch_quant_kernels.py.) Then every talker form with each cache
and each code-predictor form serves a request, and one weight copy is
kept."""

import jax
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import tiny_test_config
from qwen_tts_tpu.core.weights import init_tts_weights
from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig
from qwen_tts_tpu.engine.tts_engine import TTSEngine as JEngine
from qwen_tts_tpu_torch.core.weights import from_jax
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.runtime import frame_loop
from qwen_tts_tpu_torch.vocoder.model import vocoder_from_jax

TEXT = "Hello from the GPU."
QUANT = dict(quantize="int8", kv_cache="int8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite's workers share
    the machine's cores: torch's thread pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mc():
    return tiny_test_config(max_seq_len=256)


@pytest.fixture(scope="module")
def jax_side(mc):
    """The JAX engine's weights, vocoder, first 16 frames of TEXT and backend."""
    jw = init_tts_weights(jax.random.PRNGKey(0), mc)
    jeng = JEngine(JConfig(max_seq_len=256, chunk_frames=4, subtalker_do_sample=False,
                           warmup=False, **QUANT), model_config=mc)
    jeng.initialize(weights=jw)
    frames = []
    for _audio, fr in jeng._generate_audio_chunks(TEXT, 4):
        frames += fr
        if len(frames) >= 16:
            break
    return jw, jeng.vocoder_weights, np.stack(frames)[:16], jeng._attn_impl


def test_quantized_engine_matches_jax_engine(mc, jax_side, monkeypatch):
    import qwen_tts_tpu_torch.models.code_predictor as tcp

    jw, jvoc, jf, j_impl = jax_side
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4,
                              subtalker_do_sample=False, **QUANT),
                    model_config=mc)
    eng.initialize(weights=from_jax(jw, "cpu"), vocoder_weights=vocoder_from_jax(jvoc, "cpu"))
    cp_logits = []

    def recording(*a, **k):
        codes, logits = tcp.cp_predict(*a, **{**k, "return_logits": True})
        cp_logits.append(logits)
        return codes

    monkeypatch.setattr(frame_loop, "cp_predict", recording)
    tf = []
    for _audio, fr in eng._generate_chunks(TEXT, 4, with_audio=False):
        tf += fr
        if len(tf) >= 16:
            break
    tf = np.stack(tf)[:16]
    assert eng._attn_impl == j_impl == "dense"              # "auto" on the CPU
    np.testing.assert_array_equal(jf[0], tf[0])
    diff = np.argwhere(jf != tf)
    if len(diff):
        f, g = diff[0]
        assert g >= 1, "talker token differs"
        top2 = torch.topk(cp_logits[f][g - 1], 2).values
        assert float(top2[0] - top2[1]) < 2e-2, (f, g, top2)


@pytest.mark.parametrize("quantize,kv_cache,cp_quantize", [
    ("int8", "bf16", "int4"), ("int8", "int8", "mixed"), ("int4", "bf16", "int8"),
    ("int4", "int8", "int4"), ("mixed", "bf16", "mixed"), ("mixed", "int8", "int8")])
def test_every_form_serves(mc, quantize, kv_cache, cp_quantize):
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, seed=2,
                              quantize=quantize, kv_cache=kv_cache, cp_quantize=cp_quantize),
                    model_config=mc)
    eng.initialize()
    talker, cp = eng.weights.talker, eng.weights.code_predictor.decoder
    assert talker.lm_head.dtype == torch.int8 and cp.lm_head.dtype == torch.bfloat16
    for dec, form in ((talker, quantize), (cp, cp_quantize)):
        lw = dec.layers
        assert not any(t.dtype == torch.bfloat16 and t.dim() == 3 for t in lw)  # no bf16 copy
        assert (lw.w_down_q.shape[1] * 2 == mc.talker.intermediate_size) == (form != "int8")
        assert (lw.wqkv_q.shape[1] * 2 == mc.talker.hidden_size) == (form == "int4")
    chunks = eng._generate_chunks("two chunks please", 4, with_audio=True)
    for want in (1, 4):
        audio, frames = next(chunks)
        assert len(frames) == want and audio.shape == (want * eng.vocoder_config.hop_length,)
        assert np.isfinite(audio).all()
    state = eng._talker_state
    assert state.k_cache.dtype == (torch.int8 if kv_cache == "int8" else torch.bfloat16)
    assert (state.k_scale is not None) == (kv_cache == "int8")
    # prefill + BOS step, the two chunks read, and the two chunks of 4 that
    # the fused path enqueued ahead of the reads
    assert eng.get_metrics()["position"] == state.position == 9 + 5 + 2 * 4

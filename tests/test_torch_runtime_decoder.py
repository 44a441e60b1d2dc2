"""The port's stateful `TTSDecoder` against the JAX `TTSDecoder(backend="xla")`.

On a tiny talker config, with the same weights (`convert_tuple`) and inputs
made with numpy: a prefill of 8 embeddings, 5 steps from token ids (both
sides fed JAX's tokens), one `step_with_embed`, `position`, `reset` and a
prefill again. Hidden states at the bar of tests/test_megakernel.py
(cosine > 0.999, allclose 2e-2), tokens equal or a near tie of JAX's
logits (top-2 gap < 2e-2). Run on the port's backends "dense", "pallas"
and "mega" (on the CPU the kernels run their plain versions). Then the
same on mixed-quantized weights (int8 attention, int4-g128 MLP, int8 head)
against the JAX decoder on the same quantized tree, with `reset` zeroing
an int8 cache's scales too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import tiny_test_config
from qwen_tts_tpu.core.weights import init_decoder_weights, quantize_decoder_weights_mixed
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.runtime.decoder import TTSDecoder as JDecoder
from qwen_tts_tpu_torch.core.weights import DecoderWeights, Quant4DecoderWeights, convert_tuple
from qwen_tts_tpu_torch.models.decoder import init_state
from qwen_tts_tpu_torch.runtime.decoder import TTSDecoder

CFG = tiny_test_config(max_seq_len=64).talker


@pytest.fixture(scope="module")
def jax_run():
    """Weights, inputs and what the JAX decoder returns for them."""
    jw = init_decoder_weights(jax.random.PRNGKey(13), CFG)
    rng = np.random.default_rng(17)
    prompt = rng.standard_normal((8, CFG.hidden_size)).astype(np.float32)
    embed = rng.standard_normal(CFG.hidden_size).astype(np.float32)
    dec = JDecoder(jw, CFG, backend="xla")
    out = {"prefill": dec.prefill(jnp.asarray(prompt)), "steps": []}
    tok = out["prefill"][0]
    for _ in range(5):
        out["steps"].append((tok, *dec.step(tok)))
        tok = out["steps"][-1][1]
    out["embed_step"] = dec.step_with_embed(jnp.asarray(embed))
    out["position"] = dec.position
    dec.reset()
    out["reset_position"] = dec.position
    out["prefill_again"] = dec.prefill(jnp.asarray(prompt))
    return jw, prompt, embed, out


def _hidden_close(jh, th):
    a, b = np.asarray(jh), th.numpy()
    assert float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.999
    np.testing.assert_allclose(b, a, rtol=2e-2, atol=2e-2)


def _token_ok(jw, jh_before, jtok, ttok):
    """Equal, or JAX's logits at that step have a near tie."""
    if int(jtok) == int(ttok):
        return True
    logits = np.sort(np.asarray(jd.lm_head_logits(jw, jnp.asarray(jh_before)[None]))[0])
    return logits[-1] - logits[-2] < 2e-2


@pytest.mark.parametrize("backend", ["dense", "pallas", "mega"])
def test_decoder_matches_jax(jax_run, backend):
    jw, prompt, embed, want = jax_run
    dec = TTSDecoder(convert_tuple(DecoderWeights, jw, "cpu"), CFG, backend=backend)
    assert torch.equal(dec.embed_weight.view(torch.int16),
                       torch.from_numpy(np.array(jw.embed).view(np.int16)))
    tok, hid = dec.prefill(torch.from_numpy(prompt))
    jtok, jhid = want["prefill"]
    _hidden_close(jhid, hid)
    assert _token_ok(jw, jhid, jtok, tok)
    for fed, jtok, jhid in want["steps"]:
        tok, hid = dec.step(fed)
        _hidden_close(jhid, hid)
        assert _token_ok(jw, jhid, jtok, tok)
    jtok, jhid = want["embed_step"]
    tok, hid = dec.step_with_embed(torch.from_numpy(embed))
    _hidden_close(jhid, hid)
    assert _token_ok(jw, jhid, jtok, tok)
    assert dec.position == want["position"] == 14
    dec.reset()
    assert dec.position == want["reset_position"] == 0
    assert not dec.state.k_cache.any() and not dec.state.v_cache.any()
    tok, hid = dec.prefill(torch.from_numpy(prompt))
    _hidden_close(want["prefill_again"][1], hid)


def test_decoder_rejects_unknown_backend(jax_run):
    jw = jax_run[0]
    with pytest.raises(ValueError, match="backend"):
        TTSDecoder(convert_tuple(DecoderWeights, jw, "cpu"), CFG, backend="xla")


@pytest.mark.parametrize("backend", ["dense", "mega"])
def test_decoder_takes_quantized_weights(backend):
    jw = quantize_decoder_weights_mixed(init_decoder_weights(jax.random.PRNGKey(13), CFG))
    prompt = np.random.default_rng(19).standard_normal((8, CFG.hidden_size)).astype(np.float32)
    jdec = JDecoder(jw, CFG, backend="xla")
    dec = TTSDecoder(convert_tuple(Quant4DecoderWeights, jw, "cpu"), CFG, backend=backend)
    jtok, jhid = jdec.prefill(jnp.asarray(prompt))
    tok, hid = dec.prefill(torch.from_numpy(prompt))
    _hidden_close(jhid, hid)
    assert _token_ok(jw, jhid, jtok, tok)
    for _ in range(3):
        jtok_next, jhid_next = jdec.step(jtok)
        tok, hid = dec.step(jtok)
        _hidden_close(jhid_next, hid)
        assert _token_ok(jw, jhid_next, jtok_next, tok)
        jtok = jtok_next
    dec.state = init_state(CFG, "cpu", torch.int8)
    dec.step(jtok)
    assert dec.state.k_scale.any()
    dec.reset()
    assert dec.position == 0 and not dec.state.k_scale.any() and not dec.state.v_scale.any()

"""The port's decode attention against the JAX Pallas kernel, and the
decoder's `"pallas"` backend against the JAX dense decoder.

Inputs are made with numpy from a seed and rounded to bf16 on both sides
(round to nearest even, the same bits). The JAX kernel runs in interpret
mode with 64-row chunks, as tests/test_attention_kernel.py runs it, and the
tolerance is that test's, rtol = atol = 2e-3. On the CPU the port's
`decode_attention` runs its plain version; the CUDA kernel is compared
with it by the `gpu`-marked test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import tiny_test_config
from qwen_tts_tpu.core.weights import init_decoder_weights
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.ops import attention as ja
from qwen_tts_tpu_torch.core.weights import DecoderWeights, convert_tuple
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.ops import attention as ta


def _inputs(HQ, KVH, L, S, D, position, seed, poison=True):
    """q, k_new, v_new f32 and bf16-valued caches (as f32 numpy), with the
    rows past `position` and the layers other than 1 poisoned, as in
    tests/test_attention_kernel.py."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((HQ, D)).astype(np.float32)
    k_new = rng.standard_normal((KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((KVH, D)).astype(np.float32)
    k = rng.standard_normal((L, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((L, KVH, S, D)).astype(np.float32)
    if poison:
        k[:, :, position:] = 99.0
        v[:, :, position:] = 99.0
        k[0] = -77.0
        k[2] = 77.0
    return q, k_new, v_new, k, v


def _both(q, k_new, v_new, k, v, li, position):
    want = np.asarray(ja.decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), li, position,
        chunk=64, interpret=True))
    got = ta.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(), li, position)
    return want, got


@pytest.mark.parametrize("position", [0, 1, 64, 65, 200, 256])
def test_decode_attention_matches_pallas_interpret(position):
    q, k_new, v_new, k, v = _inputs(16, 8, 3, 256, 128, position, seed=position)
    before = ta.decode_attention.launches
    want, got = _both(q, k_new, v_new, k, v, 1, position)
    assert got.shape == (16, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert np.isfinite(got.numpy()).all()
    assert ta.decode_attention.launches == before        # the CPU never launches


def test_decode_attention_gqa_groups_differ():
    q, k_new, v_new, k, v = _inputs(4, 2, 1, 64, 128, 33, seed=0, poison=False)
    want, got = _both(q, k_new, v_new, k, v, 0, 33)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert not np.allclose(got[0].numpy(), got[1].numpy())


def test_decode_attention_rejects_bad_indices_and_devices():
    q, k_new, v_new, k, v = (torch.from_numpy(a) for a in _inputs(4, 2, 2, 8, 128, 4, 1, poison=False))
    k, v = k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="outside"):
        ta.decode_attention(q, k_new, v_new, k, v, 2, 4)
    with pytest.raises(ValueError, match="outside"):
        ta.decode_attention(q, k_new, v_new, k, v, 0, 9)
    with pytest.raises(ValueError, match="no kernel"):
        ta.decode_attention(q.to("meta"), k_new, v_new, k, v, 0, 4)


CFG = tiny_test_config(max_seq_len=64).talker


@pytest.fixture(scope="module")
def weights():
    jw = init_decoder_weights(jax.random.PRNGKey(11), CFG)
    return jw, convert_tuple(DecoderWeights, jw, "cpu")


def test_pallas_backend_step_matches_jax_dense(weights, monkeypatch):
    """After a dense prefill of 8 rows, 6 single-token steps on the port's
    "pallas" backend against JAX's dense step, fed the same embeddings:
    logits within 2e-2, argmax equal or a near tie (top-2 gap < 2e-2), and
    the attention kernel's wrapper called once per layer and step."""
    jw, tw = weights
    calls = []
    real = ta.decode_attention

    def counting(*a):
        calls.append(a[5:])
        return real(*a)

    monkeypatch.setattr(td, "decode_attention", counting)
    rng = np.random.default_rng(21)
    prompt = rng.standard_normal((8, CFG.hidden_size)).astype(np.float32)
    js, jn = jd.forward_chunk(CFG, jw, jd.init_state(CFG), jnp.asarray(prompt))
    ts, _ = td.forward_chunk(CFG, tw, td.init_state(CFG, "cpu"), torch.from_numpy(prompt),
                             attn_impl="pallas")
    assert calls == []                                   # prefill stays dense
    embed = np.array(jn[-1])
    for step in range(6):
        js, jt, jh = jd.decode_step_with_embed(CFG, jw, js, jnp.asarray(embed))
        ts, tt, th = td.decode_step_with_embed(CFG, tw, ts, torch.from_numpy(embed),
                                               attn_impl="pallas")
        jl = np.asarray(jd.lm_head_logits(jw, jh[None]))[0]
        tl = td.lm_head_logits(tw, th[None])[0].numpy()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-2)
        top2 = np.sort(jl)[-2:]
        assert int(tt) == int(jt) or top2[1] - top2[0] < 2e-2, step
        embed = np.array(jh)
    assert calls == [(li, 8 + s) for s in range(6) for li in range(CFG.num_layers)]
    assert ts.position == 14


@pytest.mark.gpu
@pytest.mark.parametrize("position", [0, 1, 255, 256, 257, 300])
def test_cuda_kernel_matches_plain(position):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    q, k_new, v_new, k, v = (torch.from_numpy(a).cuda()
                             for a in _inputs(16, 8, 3, 512, 128, position, seed=5))
    k, v = k.bfloat16(), v.bfloat16()
    before = ta.decode_attention.launches
    got = ta.decode_attention(q, k_new, v_new, k, v, 1, position)
    assert ta.decode_attention.launches == before + 1
    want = ta.decode_attention_reference(q, k_new, v_new, k, v, 1, position)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-3 * max(1.0, float(want.abs().max()))

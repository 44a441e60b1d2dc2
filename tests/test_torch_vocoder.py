"""The port's "fast" vocoder and text projection against the JAX package.

The vocoder runs in f32 on both sides (atol 1e-4). Its transposed
convolutions reproduce `lax.conv_transpose(padding="SAME")`, which does not
flip the kernel and pads by `_conv_transpose_padding`; both branches of
that padding rule are exercised. The text projection's bf16 output must be
equal, or within one bf16 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.models.text_projection import embed_text_ids as j_embed
from qwen_tts_tpu.vocoder import model as jv
from qwen_tts_tpu_torch.core.weights import from_jax
from qwen_tts_tpu_torch.models.text_projection import embed_text_ids as t_embed
from qwen_tts_tpu_torch.vocoder import model as tv

SMALL = dict(dim=32, prenet_blocks=2, upsample_factors=(4, 2, 3),
             upsample_kernels=(3, 4, 7))   # stride > k-1 for the first stage only


def _codes(T, seed, cfg):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, cfg.codebook_size, (T, cfg.num_code_groups)).astype(np.int32)
    codes[:, 0] = rng.integers(0, 3072, T)      # talker codes exceed the codebook
    return codes


@pytest.mark.parametrize("name,kw,T", [("small", SMALL, 5), ("default", {}, 3)])
def test_vocoder_decode_matches_jax(name, kw, T):
    jcfg, tcfg = jv.VocoderConfig(**kw), tv.VocoderConfig(**kw)
    assert tcfg.hop_length == jcfg.hop_length
    jw = jv.init_vocoder_weights(jax.random.PRNGKey(1), jcfg)
    codes = _codes(T, 0, jcfg)
    a = np.asarray(jv.vocoder_decode(jcfg, jw, jnp.asarray(codes)))
    b = tv.vocoder_decode(tcfg, tv.vocoder_from_jax(jw, "cpu"), torch.from_numpy(codes)).numpy()
    assert b.shape == (T * tcfg.hop_length,)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("K,s", [(16, 8), (12, 6), (10, 5), (8, 4), (4, 2), (3, 4), (2, 5), (5, 1)])
def test_conv_transpose_matches_lax(K, s):
    rng = np.random.default_rng(K * 10 + s)
    x = rng.standard_normal((6, 3)).astype(np.float32)
    k = rng.standard_normal((K, 4, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    a = np.asarray(jv._conv_transpose1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), s))
    t = tv._conv_transpose1d(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), s)
    assert t.shape == (6 * s, 4)
    np.testing.assert_allclose(a, t.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,groups", [(7, 1), (7, 3), (4, 1)])
def test_same_conv1d_matches_lax(K, groups):
    rng = np.random.default_rng(K + groups)
    x = rng.standard_normal((9, 6)).astype(np.float32)
    k = rng.standard_normal((K, 6 // groups, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    a = np.asarray(jv._conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), groups))
    t = tv._conv1d(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), groups)
    np.testing.assert_allclose(a, t.numpy(), rtol=1e-5, atol=1e-5)


def test_embed_text_ids_matches_jax(tiny_weights):
    tp = from_jax(tiny_weights, "cpu").text_projection
    ids = np.array([0, 5, 200, 511, 151671, 151673], dtype=np.int32)  # specials clamp
    a = np.asarray(j_embed(tiny_weights.text_projection, jnp.asarray(ids)).astype(jnp.float32))
    b = t_embed(tp, torch.from_numpy(ids).long())
    assert b.dtype == torch.bfloat16
    b = b.float().numpy()
    ulp = np.abs(a) * 2.0 ** -7 + 1e-30          # one bf16 ulp at |a|
    assert (np.abs(a - b) <= ulp).all()

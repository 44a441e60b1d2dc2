"""The port's plain decoder against the JAX oracle (`qwen_tts_tpu.models.decoder`).

Inputs are made with numpy from a seed and fed to both sides; weights come
from the JAX initialiser through `from_jax`. The sequence test holds the
port to the bar of tests/test_megakernel.py: hidden cosine > 0.999 at every
step, >= 19/20 greedy tokens, cache columns allclose(rtol=atol=2e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import DecoderConfig, tiny_test_config
from qwen_tts_tpu.core.weights import init_decoder_weights
from qwen_tts_tpu.core.weights import make_rope_table as j_rope
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu_torch.core.weights import DecoderWeights, convert_tuple
from qwen_tts_tpu_torch.core.weights import make_rope_table as t_rope
from qwen_tts_tpu_torch.models import decoder as td

CFG = tiny_test_config(max_seq_len=64).talker
MROPE = dataclasses.replace(CFG, mrope_section=(24, 20, 20))


@pytest.fixture(scope="module")
def weights():
    jw = init_decoder_weights(jax.random.PRNGKey(11), CFG)
    return jw, convert_tuple(DecoderWeights, jw, "cpu")


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 256)).astype(np.float32) * 3
    w = rng.standard_normal(256).astype(np.float32)
    a = np.asarray(jd.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    b = td.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 128)).astype(np.float32)
    ang = rng.uniform(0, 6, (3, 1, 64)).astype(np.float32)
    c, s = np.cos(ang), np.sin(ang)
    a = np.asarray(jd.apply_rope(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s)))
    b = td.apply_rope(*(torch.from_numpy(v) for v in (x, c, s))).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("interleaved", [True, False])
def test_mrope_rows_match_jax(interleaved):
    cfg = dataclasses.replace(MROPE, mrope_interleaved=interleaved)
    jm = [np.asarray(m) for m in jd.mrope_section_masks(cfg)]
    tm = [m.numpy() for m in td.mrope_section_masks(cfg, "cpu")]
    for a, b in zip(jm, tm, strict=True):
        np.testing.assert_array_equal(a, b)
    pos = (5, 17, 40)
    jc, js = jd.mrope_rows(cfg, j_rope(cfg), jnp.asarray(pos, jnp.int32), 3)
    tc, ts = td.mrope_rows(cfg, t_rope(cfg, "cpu"), pos, 3)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    # equal section positions reproduce the standard rows bit for bit
    tc2, _ = td.mrope_rows(cfg, t_rope(cfg, "cpu"), (9, 9, 9), 2)
    np.testing.assert_array_equal(tc2.numpy(), t_rope(cfg, "cpu").cos[9:11].numpy())


@pytest.mark.parametrize("T,start", [(1, 0), (1, 37), (5, 0), (5, 21)])
def test_dense_mixed_attention_matches_jax(T, start):
    rng = np.random.default_rng(T * 100 + start)
    h, g, d = CFG.num_kv_heads, CFG.gqa_groups, CFG.head_dim
    q = rng.standard_normal((T, h * g, d)).astype(np.float32)
    kc = rng.standard_normal((T, h, d)).astype(np.float32)
    vc = rng.standard_normal((T, h, d)).astype(np.float32)
    k_old = rng.standard_normal((h, CFG.max_seq_len, d)).astype(np.float32)
    v_old = rng.standard_normal((h, CFG.max_seq_len, d)).astype(np.float32)
    a = jd._dense_mixed_attention(
        CFG, jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(k_old, jnp.bfloat16), jnp.asarray(v_old, jnp.bfloat16),
        jnp.int32(start))
    b = td._dense_mixed_attention(
        CFG, torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(k_old).bfloat16(), torch.from_numpy(v_old).bfloat16(), start)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5, atol=1e-5)


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


@pytest.mark.parametrize("cfg", [CFG, MROPE], ids=["rope", "mrope"])
def test_prefill_then_20_coupled_steps_match_jax(weights, cfg):
    jw, tw = weights
    if cfg.mrope_section is not None:
        jw = jw._replace(rope=j_rope(cfg))
        tw = tw._replace(rope=t_rope(cfg, "cpu"))
    rng = np.random.default_rng(7)
    prompt = rng.standard_normal((8, cfg.hidden_size)).astype(np.float32)
    mp = (lambda p: [p, p, p]) if cfg.mrope_section else (lambda p: None)
    js, jn = jd.forward_chunk(cfg, jw, jd.init_state(cfg), jnp.asarray(prompt),
                              mrope_pos=None if mp(0) is None else jnp.asarray(mp(0)))
    ts, tn = td.forward_chunk(cfg, tw, td.init_state(cfg, "cpu"), torch.from_numpy(prompt),
                              mrope_pos=mp(0))
    assert ts.position == 8
    np.testing.assert_allclose(np.asarray(jn), tn.numpy(), rtol=2e-2, atol=2e-2)
    embed = np.array(jn[-1])
    matches = 0
    for step in range(20):
        p = 8 + step
        js, jt, jh = jd.decode_step_with_embed(
            cfg, jw, js, jnp.asarray(embed),
            mrope_pos=None if mp(p) is None else jnp.asarray(mp(p)))
        ts, tt, th = td.decode_step_with_embed(cfg, tw, ts, torch.from_numpy(embed),
                                               mrope_pos=mp(p))
        assert _cos(np.asarray(jh), th.numpy()) > 0.999, step
        matches += int(jt) == int(tt)
        for jc, tc in ((js.k_cache, ts.k_cache), (js.v_cache, ts.v_cache)):
            np.testing.assert_allclose(np.asarray(jc[:, :, p].astype(jnp.float32)),
                                       tc[:, :, p].float().numpy(),
                                       rtol=2e-2, atol=2e-2)
        embed = np.array(jh)
    assert matches >= 19, matches
    assert ts.position == 28


def test_forward_chunk_rejects_positions_past_the_cache(weights):
    _, tw = weights
    state = td.init_state(CFG, "cpu")._replace(position=CFG.max_seq_len - 2)
    with pytest.raises(ValueError, match="max_seq_len"):
        td.forward_chunk(CFG, tw, state, torch.zeros(3, CFG.hidden_size))


def test_lm_head_logits_match_jax(weights):
    jw, tw = weights
    x = np.random.default_rng(3).standard_normal((2, CFG.hidden_size)).astype(np.float32)
    a = np.asarray(jd.lm_head_logits(jw, jnp.asarray(x)))
    b = td.lm_head_logits(tw, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def test_decoder_config_is_shared():
    # the port keeps its own copy of the config class, equal field for field
    assert td.DecoderConfig is not DecoderConfig
    assert dataclasses.asdict(td.DecoderConfig()) == dataclasses.asdict(DecoderConfig())

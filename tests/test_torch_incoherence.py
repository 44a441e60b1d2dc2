"""The port's incoherence folds (`qwen_tts_tpu_torch/core/incoherence.py`)
against the JAX package's (`qwen_tts_tpu/core/incoherence.py`).

The same weights (JAX's initialiser through `convert_tuple`) are folded by
both, Q and R drawn from the numpy seed words of `jax.random.split(key)`, so
both use the same rotations. `random_orthogonal` must equal JAX's bit for
bit on both its branches. The folds are f32 sums taken in another order and
rounded to bf16, so they must agree within one bf16 step (2^-7 of the
larger value, or of 2^-8 of the matrix's largest entry for values near 0). The folded model's greedy logits must
keep the unfolded model's (`tests/test_incoherence.py`'s tolerance:
cosine > 0.995 and >= 90% of the argmaxes), and the int8 and int4-g128
quantizations of the port's folds must equal JAX's of its folds, but for
entries a bf16 rounding put across a quantization boundary: those within
one quantization step, at most 0.5% of a matrix."""

import jax
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core import incoherence as jinc
from qwen_tts_tpu.core import weights as jwts
from qwen_tts_tpu.core.config import CODEC_BOS, DecoderConfig
from qwen_tts_tpu_torch.core import incoherence as tinc
from qwen_tts_tpu_torch.core import weights as twts
from qwen_tts_tpu_torch.core.config import DecoderConfig as TDecoderConfig
from qwen_tts_tpu_torch.models import decoder as td

SIZES = dict(num_layers=2, hidden_size=256, intermediate_size=512, num_q_heads=4,
             num_kv_heads=2, head_dim=128, vocab_size=512, max_seq_len=64)
JCFG, TCFG = DecoderConfig(**SIZES), TDecoderConfig(**SIZES)
KEY = jax.random.PRNGKey(7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(key) -> list[int]:
    return np.asarray(jax.random.key_data(key), np.uint32).tolist()


@pytest.fixture(scope="module")
def weights():
    jw = jwts.init_decoder_weights(jax.random.PRNGKey(0), JCFG)
    return jw, twts.convert_tuple(twts.DecoderWeights, jw, "cpu")


def _folds(weights, rotate_vo):
    jw, tw = weights
    kq, kr = jax.random.split(KEY)
    jf = jinc.incoherent_decoder_weights(jw, KEY, JCFG, rotate_vo=rotate_vo)
    tf = tinc.incoherent_decoder_weights(tw, TCFG, _words(kq), _words(kr), rotate_vo=rotate_vo)
    return jf, tf


def _leaves(tree):
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.float().numpy() for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("n", [128, 256, 100])   # Hadamard branch, and QR for 100
def test_random_orthogonal_equals_jax(n):
    for key in jax.random.split(KEY):
        np.testing.assert_array_equal(tinc.random_orthogonal(_words(key), n),
                                      jinc.random_orthogonal(key, n))
    q = tinc.random_orthogonal(_words(KEY), n)
    np.testing.assert_allclose(q @ q.T, np.eye(n), atol=1e-4)


@pytest.mark.parametrize("rotate_vo", [False, True])
def test_folds_equal_jax_within_bf16_rounding(weights, rotate_vo):
    jf, tf = _folds(weights, rotate_vo)
    jl, tl = _leaves(jf), [x.float().numpy() for x in jax.tree_util.tree_leaves(
        tf, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert [a.shape for a in jl] == [b.shape for b in tl]
    for a, b in zip(jl, tl):
        floor = np.abs(a).max() * 2 ** -8
        bound = np.maximum(np.maximum(np.abs(a), np.abs(b)), floor) * 2 ** -7
        assert (np.abs(a - b) <= bound).all(), float(np.abs(a - b).max())
    assert all(t.is_contiguous() for t in jax.tree_util.tree_leaves(
        tf, is_leaf=lambda x: isinstance(x, torch.Tensor)))      # as the kernels read them
    assert tf.final_norm.eq(1).all() and tf.layers.input_norm.eq(1).all()
    assert tf.embed.dtype == torch.bfloat16 and tf.lm_head.dtype == torch.bfloat16


def _greedy_logits(cfg, w, steps=12):
    st, tok, out = td.init_state(cfg, "cpu"), CODEC_BOS % cfg.vocab_size, []
    for _ in range(steps):
        st, normed = td.forward_chunk(cfg, w, st, w.embed[tok][None].float())
        logits = td.lm_head_logits(w, normed)[0].double().numpy()
        out.append(logits)
        tok = int(np.argmax(logits))
    return np.stack(out)


@pytest.mark.parametrize("rotate_vo", [False, True])
def test_folded_model_keeps_the_greedy_logits(weights, rotate_vo):
    _, tw = weights
    _, tf = _folds(weights, rotate_vo)
    lo, li = _greedy_logits(TCFG, tw), _greedy_logits(TCFG, tf)
    cos = np.sum(lo * li, -1) / (np.linalg.norm(lo, axis=-1) * np.linalg.norm(li, axis=-1)
                                 + 1e-12)
    assert (cos > 0.995).all(), cos
    assert (lo.argmax(-1) == li.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("form", ["int8", "int4"])
def test_quantized_folds_equal_jax(weights, form):
    jf, tf = _folds(weights, True)
    jq, tq = {"int8": (jwts.quantize_decoder_weights, twts.quantize_decoder_weights),
              "int4": (jwts.quantize_decoder_weights_int4,
                       twts.quantize_decoder_weights_int4)}[form]
    jdq = {"int8": jwts.dequantize_layer_weights,
           "int4": jwts.dequantize_layer_weights_int4}[form]
    tdq = {"int8": twts.dequantize_layer_weights,
           "int4": twts.dequantize_layer_weights_int4}[form]
    jqw, tqw = jq(jf), tq(tf)
    jd, tdl = jdq(jqw.layers), tdq(tqw.layers)
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        a = np.asarray(getattr(jd, name), np.float32)
        b = getattr(tdl, name).float().numpy()
        s = np.asarray(getattr(jqw.layers, f"{name}_s"), np.float32)
        step = np.repeat(s, a.shape[1] // s.shape[1], axis=1)   # one quantization step
        diff = np.abs(a - b)
        assert (diff <= step * 1.01 + 1e-6).all(), (name, float((diff / step).max()))
        assert (diff > 0).mean() <= 5e-3, (name, float((diff > 0).mean()))
    np.testing.assert_allclose(tqw.lm_head_s.numpy(), np.asarray(jqw.lm_head_s), rtol=2 ** -7)

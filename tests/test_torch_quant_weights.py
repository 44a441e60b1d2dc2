"""The port's quantizers, its plain quantized matrix products and its
quant-aware dense prefill against the JAX package.

Weights come from the JAX initialiser (a 2-layer talker at H = 256, D =
128) through `from_jax`; activations are made with numpy from a seed.
Quantizers, packing and dequantizers must equal the JAX package's bit for
bit. `mm_scaled` (the decode-step kernel's product) is held to JAX's
`make_mms().mm_scaled` within f32 summation-order noise (rtol 1e-5, atol
1e-4). The dense prefill (one layer dequantized at a time) is held to JAX's
`forward_chunk` on the same quantized weights at the bar of
tests/test_torch_decoder.py (allclose 2e-2), with an int8 cache's rows
within 1 LSB and its scales within rtol 5e-3 (tests/test_megakernel.py's
kv8 bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core import weights as jwts
from qwen_tts_tpu.core.config import tiny_test_config
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.ops.decode_step import make_mms
from qwen_tts_tpu_torch.core import weights as twts
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.ops.decode_step import mm_scaled

CFG = tiny_test_config(max_seq_len=64).talker
FORMS = {
    "int8": (jwts.quantize_decoder_weights, twts.quantize_decoder_weights, {},
             jwts.dequantize_layer_weights, twts.dequantize_layer_weights),
    "int8_g128": (jwts.quantize_decoder_weights, twts.quantize_decoder_weights,
                  {"group_size": 128}, jwts.dequantize_layer_weights,
                  twts.dequantize_layer_weights),
    "int4": (jwts.quantize_decoder_weights_int4, twts.quantize_decoder_weights_int4, {},
             jwts.dequantize_layer_weights_int4, twts.dequantize_layer_weights_int4),
    "mixed": (jwts.quantize_decoder_weights_mixed, twts.quantize_decoder_weights_mixed, {},
              jwts.dequantize_layer_weights_mixed, twts.dequantize_layer_weights_mixed),
}
PACKED = {"int8": (), "int8_g128": (), "int4": ("wqkv", "wo", "w_gate_up", "w_down"),
          "mixed": ("w_gate_up", "w_down")}
N_IN = {"wqkv": CFG.hidden_size, "wo": CFG.q_size, "w_gate_up": CFG.hidden_size,
        "w_down": CFG.intermediate_size}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite's workers share
    the machine's cores: torch's thread pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bit_exact(jax_tree, torch_tree):
    j_leaves = jax.tree_util.tree_leaves(jax_tree)
    t_leaves = jax.tree_util.tree_leaves(torch_tree)
    assert len(j_leaves) == len(t_leaves) > 0
    for a, b in zip(j_leaves, t_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.dtype.itemsize == b.element_size()
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def bf16_weights():
    jw = jwts.init_decoder_weights(jax.random.PRNGKey(21), CFG)
    return jw, twts.convert_tuple(twts.DecoderWeights, jw, "cpu")


@pytest.fixture(scope="module", params=list(FORMS))
def quantized(request, bf16_weights):
    """(form, JAX quantized weights, the port's from its bf16 copy)."""
    jq, tq, kw, _, _ = FORMS[request.param]
    jw, tw = bf16_weights
    return request.param, jq(jw, **kw), tq(tw, **kw)


def test_quantizers_equal_jax_bit_for_bit(quantized):
    form, jqw, tqw = quantized
    assert type(tqw).__name__ == type(jqw).__name__
    assert type(tqw.layers).__name__ == type(jqw.layers).__name__
    assert tqw.lm_head.dtype == torch.int8 and tqw.lm_head_s.shape == (1, CFG.vocab_size)
    _assert_bit_exact(jqw, tqw)
    # and JAX's quantized tree carries across as the same containers
    carried = twts.convert_tuple(twts.QuantDecoderWeights, jqw, "cpu")
    assert type(carried.layers) is type(tqw.layers)
    _assert_bit_exact(jqw, carried)


def test_dequantizers_equal_jax_bit_for_bit(quantized):
    form, jqw, tqw = quantized
    _, _, _, jdq, tdq = FORMS[form]
    _assert_bit_exact(jdq(jqw.layers), tdq(tqw.layers))
    for name in ("wqkv", "w_down"):
        qm, s = getattr(tqw.layers, f"{name}_q")[1], getattr(tqw.layers, f"{name}_s")[1]
        jm, js = getattr(jqw.layers, f"{name}_q")[1], getattr(jqw.layers, f"{name}_s")[1]
        packed = name in PACKED[form]
        assert twts.is_packed(qm, N_IN[name]) == packed
        j = (jwts.dequant_mat_slice_int4 if packed else jwts.dequant_mat_slice)(jm, js)
        t = (twts.dequant_mat_slice_int4 if packed else twts.dequant_mat_slice)(qm, s)
        np.testing.assert_array_equal(_bits(j), _bits(t))


def test_int4_pack_and_unpack_equal_jax():
    q = np.random.default_rng(0).integers(-8, 8, size=(2, 16, 8)).astype(np.int32)
    jp = jwts.pack_int4(jnp.asarray(q))
    tp = twts.pack_int4(torch.from_numpy(q))
    assert tp.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    for a, b in zip(jwts.unpack_int4(jp), twts.unpack_int4(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(torch.cat(twts.unpack_int4(tp), dim=1).numpy(), q)


def test_mm_scaled_matches_jax(quantized):
    """Every matrix of layer 1 and the int8 head through both products, for
    one row (the kernel's shape; JAX's grouped product takes one row)."""
    _, jqw, tqw = quantized
    _, j_mm = make_mms()
    rng = np.random.default_rng(1)
    pairs = [(getattr(tqw.layers, f"{n}_q")[1], getattr(tqw.layers, f"{n}_s")[1],
              getattr(jqw.layers, f"{n}_q")[1], getattr(jqw.layers, f"{n}_s")[1])
             for n in ("wqkv", "wo", "w_gate_up", "w_down")]
    pairs.append((tqw.lm_head, tqw.lm_head_s, jqw.lm_head, jqw.lm_head_s))
    for (tw, ts, jw, js), n_in in zip(pairs, (*N_IN.values(), CFG.hidden_size)):
        a = rng.standard_normal((1, n_in)).astype(np.float32)
        want = np.asarray(j_mm(jnp.asarray(a, jnp.bfloat16), jw, js))
        got = mm_scaled(torch.from_numpy(a), tw, ts).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_dense_prefill_matches_jax_forward_chunk(quantized, kv):
    """An 8-row prefill, then a 3-row chunk that reads it back."""
    _, jqw, tqw = quantized
    rng = np.random.default_rng(31)
    js = jd.init_state(CFG, jnp.int8 if kv == "int8" else jnp.bfloat16)
    ts = td.init_state(CFG, "cpu", torch.int8 if kv == "int8" else torch.bfloat16)
    for T in (8, 3):
        x = rng.standard_normal((T, CFG.hidden_size)).astype(np.float32)
        js, jn = jd.forward_chunk(CFG, jqw, js, jnp.asarray(x))
        ts, tn = td.forward_chunk(CFG, tqw, ts, torch.from_numpy(x))
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=2e-2, atol=2e-2)
    assert ts.position == int(js.position) == 11
    if kv == "bf16":
        for jc, tc in ((js.k_cache, ts.k_cache), (js.v_cache, ts.v_cache)):
            np.testing.assert_allclose(tc[:, :, :11].float().numpy(),
                                       np.asarray(jc[:, :, :11].astype(jnp.float32)),
                                       rtol=2e-2, atol=2e-2)
        return
    for jc, tc, jsc, tsc in ((js.k_cache, ts.k_cache, js.k_scale, ts.k_scale),
                             (js.v_cache, ts.v_cache, js.v_scale, ts.v_scale)):
        diff = np.abs(tc[:, :, :11].numpy().astype(np.int32)
                      - np.asarray(jc[:, :, :11]).astype(np.int32))
        assert diff.max() <= 1
        np.testing.assert_allclose(tsc[:, :, :11].numpy(), np.asarray(jsc[:, :, :11]),
                                   rtol=5e-3)
    assert not ts.k_scale[:, :, 11:].any()


def test_lm_head_logits_apply_the_int8_scale(quantized):
    _, jqw, tqw = quantized
    x = np.random.default_rng(4).standard_normal((2, CFG.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(td.lm_head_logits(tqw, torch.from_numpy(x)).numpy(),
                               np.asarray(jd.lm_head_logits(jqw, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-4)

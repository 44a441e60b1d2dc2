"""The port's plain attention at the row counts where the CUDA attention core
changes its split, against the JAX Pallas kernels in interpret mode.

The core (`qwen_tts_tpu_torch/csrc/attention_core.cuh`) cuts the prefix into
64-row tiles and a kv head's tiles into ranges, one per block of a cluster
of up to 16: one block up to 64 rows, one tile a block up to 1,024 rows,
two tiles a block from 1,025. The plain versions, which the CUDA kernels are
held to on the card, are held here to the JAX kernels on both sides of
those boundaries:

- `decode_attention_reference` against the Pallas decode-attention kernel
  (64-row chunks) at tests/test_torch_attention.py's bar, rtol = atol =
  2e-3;
- the plain decode step (`megakernel_forward` on the CPU) over a random
  bf16 or int8 cache filled below the position, against the Pallas
  decode-step kernel body at tests/test_torch_megakernel.py's and
  tests/test_torch_quant_kernels.py's bars: normed cosine > 0.999 and
  allclose 2e-2, logits allclose 2e-2, the new bf16 cache column allclose
  2e-2, an int8 row within 1 LSB with its scale within rtol 5e-3.

A 2-layer, 4/2-head, D = 128 talker (the tiny test config's widths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import DecoderConfig
from qwen_tts_tpu.core.weights import init_decoder_weights
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.ops import attention as ja
from qwen_tts_tpu.ops import decode_step as jds
from qwen_tts_tpu_torch.core.weights import DecoderWeights, convert_tuple
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.ops import attention as ta
from qwen_tts_tpu_torch.ops import decode_step as tds

ATTN_S = 1088          # 17 tiles of 64 rows
STEP = DecoderConfig(num_layers=2, hidden_size=256, intermediate_size=512,
                     num_q_heads=4, num_kv_heads=2, head_dim=128,
                     vocab_size=3072, max_seq_len=192)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jw = init_decoder_weights(jax.random.PRNGKey(4), STEP)
    return jw, convert_tuple(DecoderWeights, jw, "cpu")


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


@pytest.mark.parametrize("position", [63, 64, 65, 1024, 1025, 1087])
def test_plain_attention_matches_pallas_at_tile_boundaries(position):
    rng = np.random.default_rng(position)
    HQ, KVH, L, D = 4, 2, 2, 128
    q = rng.standard_normal((HQ, D)).astype(np.float32)
    k_new = rng.standard_normal((KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((KVH, D)).astype(np.float32)
    k = rng.standard_normal((L, KVH, ATTN_S, D)).astype(np.float32)
    v = rng.standard_normal((L, KVH, ATTN_S, D)).astype(np.float32)
    k[:, :, position:] = v[:, :, position:] = 99.0     # rows past the position
    k[0] = -77.0                                        # the other layer
    want = np.asarray(ja.decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), 1, position,
        chunk=64, interpret=True))
    got = ta.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(), 1,
        torch.tensor(position, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def _states(cache: str, pos: int, seed: int):
    """The same random cache, rows [0, pos), as a JAX and a port state."""
    rng = np.random.default_rng(seed)
    shape = (STEP.num_layers, STEP.num_kv_heads, STEP.max_seq_len, STEP.head_dim)
    js = jd.init_state(STEP, jnp.int8 if cache == "int8" else jnp.bfloat16)
    ts = td.init_state(STEP, "cpu", torch.int8 if cache == "int8" else torch.bfloat16)
    fields = {}
    for name in ("k", "v"):
        if cache == "int8":
            rows = rng.integers(-127, 128, shape, dtype=np.int8)
            scales = rng.uniform(0.005, 0.02, shape[:3]).astype(np.float32)
            rows[:, :, pos:] = 0
            scales[:, :, pos:] = 0
            fields[f"{name}_scale"] = scales
        else:
            rows = rng.standard_normal(shape).astype(np.float32)
            rows[:, :, pos:] = 0
        fields[f"{name}_cache"] = rows
    jfields = {f: jnp.asarray(a, jnp.bfloat16 if a.dtype == np.float32 and "cache" in f
                              else None) for f, a in fields.items()}
    tfields = {f: (torch.from_numpy(a).bfloat16() if a.dtype == np.float32 and "cache" in f
                   else torch.from_numpy(a)) for f, a in fields.items()}
    return (js._replace(position=jnp.int32(pos), **jfields),
            ts._replace(position=pos, **tfields))


@pytest.mark.parametrize("cache,position", [("bf16", 63), ("bf16", 64), ("bf16", 65),
                                            ("bf16", 129), ("int8", 64), ("int8", 129)])
def test_plain_step_matches_pallas_at_tile_boundaries(weights, cache, position):
    jw, tw = weights
    js, ts = _states(cache, position, seed=position)
    embed = np.random.default_rng(position + 1).standard_normal(
        STEP.hidden_size).astype(np.float32)
    js, jl, jh = jds.megakernel_forward.__wrapped__(STEP, jw, js, jnp.asarray(embed),
                                                    chunk=64, interpret=True)
    ts, tl, th = tds.megakernel_forward(STEP, tw, ts, torch.from_numpy(embed))
    assert ts.position == int(js.position) == position + 1
    assert _cos(np.asarray(jh), th.numpy()) > 0.999
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
    p = position
    if cache == "bf16":
        for jc, tc in ((js.k_cache, ts.k_cache), (js.v_cache, ts.v_cache)):
            np.testing.assert_allclose(tc[:, :, p].float().numpy(),
                                       np.asarray(jc[:, :, p].astype(jnp.float32)),
                                       rtol=2e-2, atol=2e-2)
    else:
        for jc, tc, jsc, tsc in ((js.k_cache, ts.k_cache, js.k_scale, ts.k_scale),
                                 (js.v_cache, ts.v_cache, js.v_scale, ts.v_scale)):
            d = np.abs(tc[:, :, p].numpy().astype(np.int32)
                       - np.asarray(jc[:, :, p]).astype(np.int32))
            assert d.max() <= 1, d.max()
            np.testing.assert_allclose(tsc[:, :, p].numpy(), np.asarray(jsc[:, :, p]),
                                       rtol=5e-3)

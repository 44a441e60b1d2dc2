"""The quantized decode step and N-step generation against the JAX kernels.

A 2-layer talker (H = 256, D = 128, vocab 3072) with JAX-initialised
weights, quantized by the JAX package and carried across with
`convert_tuple`; embeddings from a numpy seed.

- The plain decode step (`megakernel_forward` on the CPU, `mm_scaled`
  products) against the Pallas kernel body in interpret mode for 3 steps,
  at tests/test_megakernel.py's bars: normed cosine > 0.999 and allclose
  2e-2, logits allclose 2e-2 (its int8-head bar), a bf16 cache column
  allclose 2e-2, an int8 cache row within 1 LSB and its scale within rtol
  5e-3.
- The plain N-step generation on int8 weights and an int8 cache against
  the JAX generation kernel in interpret mode with its test ring and chunk
  (tests/test_generate_kernel.py:238-245), at that file's kv8 bar: >= n - 2
  of n tokens equal. The JAX kernel reads the in-flight token back from its
  ring as int8; the port merges it as an f32 column, as JAX's decode-step
  kernel does, so the caches agree to the int8 grid: dequantized rows with
  a mean relative difference < 2e-2 (the JAX test's aggregate bar).
- The `gpu`-marked tests hold each CUDA form to its plain version, and
  generation to a loop of decode-step launches bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core import weights as jwts
from qwen_tts_tpu.core.config import DecoderConfig
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.ops import decode_step as jds
from qwen_tts_tpu.ops import generate_kernel as jgk
from qwen_tts_tpu_torch.core import weights as twts
from qwen_tts_tpu_torch.core.weights import make_rope_table as t_rope
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.ops import decode_step as tds
from qwen_tts_tpu_torch.ops import generate_kernel as tgk

CFG = DecoderConfig(num_layers=2, hidden_size=256, intermediate_size=512,
                    num_q_heads=4, num_kv_heads=2, head_dim=128,
                    vocab_size=3072, max_seq_len=128)
QUANT = {"int8": (jwts.quantize_decoder_weights, {}),
         "int8_g128": (jwts.quantize_decoder_weights, {"group_size": 128}),
         "int4": (jwts.quantize_decoder_weights_int4, {}),
         "mixed": (jwts.quantize_decoder_weights_mixed, {})}
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite's workers share
    the machine's cores: torch's thread pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_bf16():
    return jwts.init_decoder_weights(jax.random.PRNGKey(4), CFG)


def _quantized(jw, form):
    fn, kw = QUANT[form]
    jqw = fn(jw, **kw)
    return jqw, twts.convert_tuple(twts.QuantDecoderWeights, jqw, "cpu")


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def _rows_close(js, ts, p):
    """Cache column p: bf16 within 2e-2, or int8 within 1 LSB + scales 5e-3."""
    if ts.k_scale is None:
        for jc, tc in ((js.k_cache, ts.k_cache), (js.v_cache, ts.v_cache)):
            np.testing.assert_allclose(tc[:, :, p].float().numpy(),
                                       np.asarray(jc[:, :, p].astype(jnp.float32)),
                                       rtol=2e-2, atol=2e-2)
        return
    for jc, tc, jsc, tsc in ((js.k_cache, ts.k_cache, js.k_scale, ts.k_scale),
                             (js.v_cache, ts.v_cache, js.v_scale, ts.v_scale)):
        d = np.abs(tc[:, :, p].numpy().astype(np.int32) - np.asarray(jc[:, :, p]).astype(np.int32))
        assert d.max() <= 1, d.max()
        np.testing.assert_allclose(tsc[:, :, p].numpy(), np.asarray(jsc[:, :, p]), rtol=5e-3)


@pytest.mark.parametrize("form,kv", [("int8", "int8"), ("int4", "bf16"), ("mixed", "int8")])
def test_plain_step_matches_pallas_kernel_interpret(jax_bf16, form, kv):
    jqw, tqw = _quantized(jax_bf16, form)
    rng = np.random.default_rng(5)
    js, ts = jd.init_state(CFG, KV[kv][0]), td.init_state(CFG, "cpu", KV[kv][1])
    for step in range(3):
        embed = rng.standard_normal(CFG.hidden_size).astype(np.float32)
        js, jl, jh = jds.megakernel_forward.__wrapped__(
            CFG, jqw, js, jnp.asarray(embed), chunk=64, interpret=True)
        ts, tl, th = tds.megakernel_forward(CFG, tqw, ts, torch.from_numpy(embed))
        assert ts.position == int(js.position) == step + 1
        assert _cos(np.asarray(jh), th.numpy()) > 0.999
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
        _rows_close(js, ts, step)
    assert tds.megakernel_forward.launches == 0      # the CPU never launches


def test_plain_generation_matches_jax_kernel_kv8(jax_bf16):
    jqw, tqw = _quantized(jax_bf16, "int8")
    n, first = 12, 7
    js, jtok = jgk.generate_megakernel.__wrapped__(
        CFG, jqw, jd.init_state(CFG, jnp.int8), jnp.int32(first), n, chunk=32,
        copy_cache_in=True, interpret=True, ring_override=16)
    ts, ttok = tgk.generate_megakernel(CFG, tqw, td.init_state(CFG, "cpu", torch.int8),
                                       first, n)
    want, got = np.asarray(jtok), ttok.numpy()
    assert ts.position == int(js.position) == n
    assert (want == got).sum() >= n - 2, (want, got)
    for jc, jsc, tc, tsc in ((js.k_cache, js.k_scale, ts.k_cache, ts.k_scale),
                             (js.v_cache, js.v_scale, ts.v_cache, ts.v_scale)):
        a = np.asarray(jc[:, :, :n]).astype(np.float32) * np.asarray(jsc[:, :, :n])[..., None]
        b = tc[:, :, :n].float().numpy() * tsc[:, :, :n].numpy()[..., None]
        assert np.abs(a - b).mean() / np.abs(a).mean() < 2e-2


def test_plain_generation_equals_step_loop_int4_kv8(jax_bf16):
    """The N-step wrapper runs the decode step's code: its plain version
    equals a loop of `megakernel_forward` bit for bit, M-RoPE deltas on."""
    import dataclasses

    mcfg = dataclasses.replace(CFG, mrope_section=(24, 20, 20), mrope_interleaved=True)
    _, tqw = _quantized(jax_bf16, "int4")
    tqw = tqw._replace(rope=t_rope(mcfg, "cpu"))
    starts, n = (0, 5, 9), 6
    sg, toks = tgk.generate_megakernel(mcfg, tqw, td.init_state(mcfg, "cpu", torch.int8),
                                       11, n, mrope_pos0=starts)
    sl, tok, loop = td.init_state(mcfg, "cpu", torch.int8), torch.tensor([11]), []
    for i in range(n):
        sl, logits, _ = tds.megakernel_forward(mcfg, tqw, sl, tqw.embed[tok][0].float(),
                                               mrope_pos=[s + i for s in starts])
        tok = torch.argmax(logits).reshape(1)
        loop.append(tok)
    assert torch.equal(toks.long(), torch.cat(loop))
    for a, b in zip(sg[:2] + sg[3:], sl[:2] + sl[3:]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_wrapper_rejects_groups_the_kernel_does_not_take(jax_bf16):
    """Grouped scales must cover 128 rows each (the kernel's pass)."""
    jqw = jwts.quantize_decoder_weights(jax_bf16, group_size=64)
    tqw = twts.convert_tuple(twts.QuantDecoderWeights, jqw, "cpu")
    with pytest.raises(ValueError, match="groups of 128"):
        tds.decoder_struct("decode_step", CFG, tqw, td.init_state(CFG, "cpu"),
                           torch.device("cpu"), True)


def _cuda(tree):
    if isinstance(tree, tuple):
        return type(tree)(*[_cuda(x) for x in tree])
    return None if tree is None else tree.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("form,kv", [("int8", "int8"), ("int8_g128", "bf16"),
                                     ("int4", "int8"), ("mixed", "bf16")])
def test_cuda_kernel_matches_plain(jax_bf16, form, kv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tqw = _cuda(_quantized(jax_bf16, form)[1])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state, pos = td.init_state(CFG, "cuda", KV[kv][1]), 37
    rows = torch.randn(state.k_cache[:, :, :pos].shape, generator=gen, device="cuda")
    for i, (cache, scales) in enumerate(((state.k_cache, state.k_scale),
                                         (state.v_cache, state.v_scale))):
        if scales is None:
            cache[:, :, :pos] = (rows + i).bfloat16()
        else:
            cache[:, :, :pos], scales[:, :, :pos] = td.quantize_rows(rows + i)
    state = state._replace(position=pos)
    ref = state._replace(**{f: t.clone() for f, t in state._asdict().items()
                            if isinstance(t, torch.Tensor)})
    embed = torch.randn(CFG.hidden_size, generator=gen, device="cuda")
    before = tds.megakernel_forward.launches
    _, logits, normed = tds.megakernel_forward(CFG, tqw, state, embed)
    assert tds.megakernel_forward.launches == before + 1
    cos, sin = td.rope_rows(CFG, tqw.rope, pos, 1)
    _, ref_logits, ref_normed = tds.megakernel_forward_reference(CFG, tqw, ref, embed, cos, sin)
    torch.cuda.synchronize()
    assert _cos(normed.cpu().numpy(), ref_normed.cpu().numpy()) > 0.999
    torch.testing.assert_close(logits, ref_logits, rtol=0,
                               atol=2e-2 * max(1.0, float(ref_logits.abs().max())))
    if state.k_scale is None:
        torch.testing.assert_close(state.k_cache[:, :, pos].float(),
                                   ref.k_cache[:, :, pos].float(), rtol=2e-2, atol=2e-2)
    else:
        for c, r in ((state.k_cache, ref.k_cache), (state.v_cache, ref.v_cache)):
            assert (c[:, :, pos].int() - r[:, :, pos].int()).abs().max() <= 1
        torch.testing.assert_close(state.k_scale[:, :, pos], ref.k_scale[:, :, pos],
                                   rtol=5e-3, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["int8", "int8_g128", "int4", "mixed"])
def test_cuda_generation_equals_step_loop_kv8(jax_bf16, form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tqw = _cuda(_quantized(jax_bf16, form)[1])
    sk, toks = tgk.generate_megakernel(CFG, tqw, td.init_state(CFG, "cuda", torch.int8), 7, 12)
    sl, tok, loop = td.init_state(CFG, "cuda", torch.int8), torch.tensor([7], device="cuda"), []
    for _ in range(12):
        sl, logits, _ = tds.megakernel_forward(CFG, tqw, sl, tqw.embed[tok][0].float())
        tok = torch.argmax(logits).reshape(1)
        loop.append(tok)
    assert torch.equal(toks.long(), torch.cat(loop))
    for a, b in zip(sk[:2] + sk[3:], sl[:2] + sl[3:]):
        assert (a is None and b is None) or torch.equal(a, b)

"""The port's text LM in its quantized forms against the JAX package's, on
the same numpy-seeded weights at the JAX tests' TINY_LM.

The bf16 weights are quantized by the JAX package (int8 per channel,
int4-g128, mixed: int8 attention and int4-g128 MLP, each with its int8 tied
head `[H, V]` and f32 `[1, V]` scales) and carried across with
`convert_tuple`. `TextLM.generate` gives JAX's greedy tokens exactly on a
bf16 and an int8 KV cache: "dense" and "pallas" against JAX's backend of
the same name (JAX's Pallas attention in interpret mode), "mega" (on the
CPU the decode-step kernel's plain version, head inside the step) against
JAX's dense path, the bar `test_torch_text_lm.py` sets for bf16. One "mega"
step per form is held to JAX's `megakernel_forward` in interpret mode with
the head inside the kernel and outside it (`fuse_head`): logits at rtol
1e-4, or cosine > 0.995 with the same argmax. Tying and quantizing the head
compose in either order. The CUDA kernel at the text LM's full width is
compared with its plain version on the card (`chip_smoke.py` phase 17).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core import weights as jwts
from qwen_tts_tpu.core.config import DecoderConfig as JConfig
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.models import text_lm as jlm
from qwen_tts_tpu.ops import attention as jattn
from qwen_tts_tpu.ops import decode_step as jds
from qwen_tts_tpu_torch.core import weights as twts
from qwen_tts_tpu_torch.core.config import DecoderConfig
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.models import text_lm as tlm
from qwen_tts_tpu_torch.ops import decode_step as tds

TINY = dict(num_layers=2, hidden_size=256, intermediate_size=512, num_q_heads=4,
            num_kv_heads=2, head_dim=128, vocab_size=1024, max_seq_len=128,
            rope_theta=10000.0)
J_TINY, T_TINY = JConfig(**TINY), DecoderConfig(**TINY)
PROMPT = [1, 2, 3, 4]
N_NEW = 17
JAX_QUANT = {"int8": jwts.quantize_decoder_weights, "int4": jwts.quantize_decoder_weights_int4,
             "mixed": jwts.quantize_decoder_weights_mixed}
FORMS = tuple(JAX_QUANT)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bf16():
    """JAX's bf16 weights with the tied head, and the port's copy."""
    jw = jwts.init_decoder_weights(jax.random.PRNGKey(0), J_TINY)
    jw = jw._replace(lm_head=jw.embed.T)
    return jw, tlm.tie_head(twts.convert_tuple(twts.DecoderWeights, jw, "cpu"))


@pytest.fixture(scope="module")
def quantized(bf16):
    """form -> (JAX's quantized weights, the port's copy of them)."""
    jw, _ = bf16
    out = {}
    for form, fn in JAX_QUANT.items():
        jq = fn(jw)
        cls = twts.Quant4DecoderWeights if form != "int8" else twts.QuantDecoderWeights
        out[form] = jq, twts.convert_tuple(cls, jq, "cpu")
    return out


@pytest.fixture(scope="module")
def jax_tokens(quantized):
    """(form, kv) -> JAX's dense greedy tokens."""
    return {(form, kv): jlm.TextLM(jq, J_TINY, kv_cache=kv).generate(PROMPT, N_NEW)
            for form, (jq, _) in quantized.items() for kv in ("bf16", "int8")}


def test_head_is_int8_whatever_the_order_of_tying_and_quantizing(bf16, quantized):
    """`tie_head` on quantized weights quantizes the tied head: it never
    puts a bf16 head back. Quantizing tied weights and tying quantized ones
    give the same int8 head `[H, V]` (contiguous, the layout the kernel
    streams) and f32 scales `[1, V]`, JAX's."""
    _, tw = bf16
    H, V = T_TINY.hidden_size, T_TINY.vocab_size
    for form in FORMS:
        tied_first = twts.QUANTIZERS[form](tw)
        quant_first = tlm.tie_head(twts.QUANTIZERS[form](tw._replace(lm_head=tw.lm_head * 0)))
        jq, pq = quantized[form]
        for w in (tied_first, quant_first, pq):
            assert w.lm_head.dtype == torch.int8 and w.lm_head.shape == (H, V)
            assert w.lm_head.is_contiguous()
            assert w.lm_head_s.dtype == torch.float32 and w.lm_head_s.shape == (1, V)
        assert torch.equal(tied_first.lm_head, quant_first.lm_head)
        assert torch.equal(tied_first.lm_head_s, quant_first.lm_head_s)
        assert torch.equal(pq.lm_head, tied_first.lm_head)
        assert torch.equal(pq.lm_head_s, tied_first.lm_head_s)
    # weights whose head stayed bf16 keep a bf16 tied head
    kept = tlm.tie_head(twts.quantize_decoder_weights(tw, quant_head=False))
    assert kept.lm_head.dtype == torch.bfloat16 and kept.lm_head_s is None


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("form", FORMS)
def test_dense_and_mega_generate_match_jax(quantized, jax_tokens, form, kv):
    """"dense" and "mega" (the decode-step kernel's plain version, the int8
    head inside the step) give JAX's dense tokens."""
    _, tq = quantized[form]
    want = jax_tokens[(form, kv)]
    for impl in ("dense", "mega"):
        lm = tlm.TextLM(tq, T_TINY, attn_impl=impl, kv_cache=kv, device="cpu")
        assert lm.generate(PROMPT, N_NEW) == want, impl
        assert lm.steps == N_NEW - 1
    assert tds.megakernel_forward.launches == 0      # the CPU never launches


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("form", FORMS)
def test_pallas_generate_matches_jax_pallas(quantized, monkeypatch, form, kv):
    """"pallas" against JAX's "pallas" (its Pallas attention in interpret
    mode; on an int8 cache both take the plain attention)."""
    monkeypatch.setattr(jattn, "decode_attention",
                        functools.partial(jattn.decode_attention, chunk=64, interpret=True))
    jq, tq = quantized[form]
    want = jlm.TextLM(jq, J_TINY, attn_impl="pallas", kv_cache=kv).generate(PROMPT, N_NEW)
    lm = tlm.TextLM(tq, T_TINY, attn_impl="pallas", kv_cache=kv, device="cpu")
    assert lm.generate(PROMPT, N_NEW) == want


@pytest.mark.parametrize("fuse_head", [False, True])
@pytest.mark.parametrize("form", FORMS)
def test_mega_step_matches_jax_megakernel(quantized, form, fuse_head):
    """One step of the port's decode step (plain version, int8 head fused)
    after a 4-id prefill against JAX's `megakernel_forward` in interpret
    mode, the head inside the Pallas kernel or after it as JAX runs a head
    above `HEAD_FUSE_LIMIT_MB`."""
    jq, tq = quantized[form]
    js, jtok, _ = jd.prefill(J_TINY, jq, jd.init_state(J_TINY), jq.embed[jnp.asarray(PROMPT)])
    ts, ttok, _ = td.prefill(T_TINY, tq, td.init_state(T_TINY, "cpu"),
                             tq.embed[torch.tensor(PROMPT)])
    assert int(jtok) == int(ttok)
    embed = np.asarray(jq.embed[int(jtok)].astype(jnp.float32))
    _, jl, _ = jds.megakernel_forward.__wrapped__(
        J_TINY, jq, js, jnp.asarray(embed), chunk=64, interpret=True, fuse_head=fuse_head)
    _, tl, _ = tds.megakernel_forward(T_TINY, tq, ts, torch.from_numpy(embed.copy()))
    jl, tl = np.asarray(jl), tl.numpy()
    cos = float(jl @ tl / (np.linalg.norm(jl) * np.linalg.norm(tl)))
    close = np.allclose(tl, jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())
    assert close or (cos > 0.995 and jl.argmax() == tl.argmax()), cos
    assert jl.argmax() == tl.argmax()

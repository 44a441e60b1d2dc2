"""The port's decode-step wrapper and its plain version against the JAX kernel.

On the CPU `megakernel_forward` runs `megakernel_forward_reference`; it is
held to the JAX Pallas kernel (interpret mode, as tests/test_megakernel.py
runs it) for a few steps, and to the JAX dense oracle over 20 coupled steps
at the bar of tests/test_megakernel.py. Both a talker-shaped decoder (codec
vocab 3072) and a code-predictor-shaped one (5 layers, zero head) are
covered. The CUDA kernel itself is compared with the plain version by the
`gpu`-marked test, which runs only where a CUDA device is present."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import DecoderConfig
from qwen_tts_tpu.core.weights import init_decoder_weights
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.ops import decode_step as jds
from qwen_tts_tpu_torch.core.weights import DecoderWeights, convert_tuple
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.ops import decode_step as tds

TALKER = DecoderConfig(num_layers=2, hidden_size=256, intermediate_size=512,
                       num_q_heads=4, num_kv_heads=2, head_dim=128,
                       vocab_size=3072, max_seq_len=128)
CP = DecoderConfig(num_layers=5, hidden_size=256, intermediate_size=512,
                   num_q_heads=4, num_kv_heads=2, head_dim=128,
                   vocab_size=2048, max_seq_len=64)
CASES = {"talker": (TALKER, True), "code_predictor": (CP, False)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    cfg, with_heads = CASES[request.param]
    jw = init_decoder_weights(jax.random.PRNGKey(4), cfg, with_heads=with_heads)
    return cfg, with_heads, jw, convert_tuple(DecoderWeights, jw, "cpu")


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def _cols_close(js, ts, p):
    """Cache column p of the JAX and the port state, bf16 → f32."""
    for jc, tc in ((js.k_cache, ts.k_cache), (js.v_cache, ts.v_cache)):
        np.testing.assert_allclose(np.asarray(jc[:, :, p].astype(jnp.float32)),
                                   tc[:, :, p].float().numpy(), rtol=2e-2, atol=2e-2)


def test_plain_matches_pallas_kernel_interpret(case):
    """<= 3 steps against the Pallas kernel body itself."""
    cfg, with_heads, jw, tw = case
    rng = np.random.default_rng(5)
    js, ts = jd.init_state(cfg), td.init_state(cfg, "cpu")
    for step in range(3):
        embed = rng.standard_normal(cfg.hidden_size).astype(np.float32)
        js, jl, jh = jds.megakernel_forward.__wrapped__(
            cfg, jw, js, jnp.asarray(embed), chunk=64, interpret=True)
        ts, tl, th = tds.megakernel_forward(cfg, tw, ts, torch.from_numpy(embed))
        assert ts.position == int(js.position) == step + 1
        assert _cos(np.asarray(jh), th.numpy()) > 0.999
        np.testing.assert_allclose(np.asarray(jh), th.numpy(), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=2e-2, atol=2e-2)
        _cols_close(js, ts, step)
        if not with_heads:
            assert not tl.any()
    assert tds.megakernel_forward.launches == 0      # the CPU never launches


def test_plain_matches_dense_oracle_20_coupled_steps(case):
    cfg, with_heads, jw, tw = case
    embed = np.random.default_rng(6).standard_normal(cfg.hidden_size).astype(np.float32)
    js, ts = jd.init_state(cfg), td.init_state(cfg, "cpu")
    matches = 0
    for step in range(20):
        js, jt, jh = jd.decode_step_with_embed(cfg, jw, js, jnp.asarray(embed))
        ts, tl, th = tds.megakernel_forward(cfg, tw, ts, torch.from_numpy(embed))
        assert _cos(np.asarray(jh), th.numpy()) > 0.999, step
        matches += int(jt) == int(torch.argmax(tl))
        _cols_close(js, ts, step)
        embed = np.array(jh)
    assert matches >= 19, matches


def test_skipping_the_head_leaves_outputs_unchanged(case):
    cfg, _, _, tw = case
    embed = torch.from_numpy(np.random.default_rng(8).standard_normal(
        cfg.hidden_size).astype(np.float32))
    sa, la, ha = tds.megakernel_forward(cfg, tw, td.init_state(cfg, "cpu"), embed)
    sb, lb, hb = tds.megakernel_forward(cfg, tw, td.init_state(cfg, "cpu"), embed, with_head=False)
    assert lb is None and la.shape == (cfg.vocab_size,)
    assert torch.equal(ha, hb)
    assert torch.equal(sa.k_cache, sb.k_cache) and torch.equal(sa.v_cache, sb.v_cache)


def test_wrapper_rejects_position_past_the_cache(case):
    cfg, _, _, tw = case
    state = td.init_state(cfg, "cpu")._replace(position=cfg.max_seq_len)
    with pytest.raises(ValueError, match="max_seq_len"):
        tds.megakernel_forward(cfg, tw, state, torch.zeros(cfg.hidden_size))


def test_wrapper_has_no_plain_fallback_off_the_cpu(case):
    """Only a CPU tensor takes the plain version; another device raises."""
    cfg, _, _, tw = case
    with pytest.raises(ValueError, match="no kernel"):
        tds.megakernel_forward(cfg, tw, td.init_state(cfg, "cpu"),
                               torch.zeros(cfg.hidden_size, device="meta"))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfg, with_heads, _, tw = case
    tw = td.DecoderWeights(*[
        type(x)(*[t.cuda() for t in x]) if isinstance(x, tuple) else x.cuda() for x in tw])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = td.init_state(cfg, "cuda")
    pos = 37
    state.k_cache[:, :, :pos] = torch.randn(state.k_cache[:, :, :pos].shape,
                                            generator=gen, device="cuda").bfloat16()
    state.v_cache[:, :, :pos] = torch.randn(state.v_cache[:, :, :pos].shape,
                                            generator=gen, device="cuda").bfloat16()
    state = state._replace(position=pos)
    ref_state = state._replace(k_cache=state.k_cache.clone(), v_cache=state.v_cache.clone())
    embed = torch.randn(cfg.hidden_size, generator=gen, device="cuda")
    before = tds.megakernel_forward.launches
    _, logits, normed = tds.megakernel_forward(cfg, tw, state, embed)
    assert tds.megakernel_forward.launches == before + 1
    cos, sin = td.rope_rows(cfg, tw.rope, pos, 1)
    _, ref_logits, ref_normed = tds.megakernel_forward_reference(
        cfg, tw, ref_state, embed, cos, sin)
    torch.cuda.synchronize()
    assert _cos(normed.cpu().numpy(), ref_normed.cpu().numpy()) > 0.999
    torch.testing.assert_close(state.k_cache[:, :, pos].float(),
                               ref_state.k_cache[:, :, pos].float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(state.v_cache[:, :, pos].float(),
                               ref_state.v_cache[:, :, pos].float(), rtol=2e-2, atol=2e-2)
    if with_heads:
        torch.testing.assert_close(logits, ref_logits, rtol=2e-2, atol=2e-2)

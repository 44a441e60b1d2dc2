"""The port's N-step greedy generation against the JAX package.

`generate_megakernel` (on the CPU its plain version) is held to the JAX
Pallas kernel `_gen_kernel` in interpret mode, as tests/test_generate_kernel.py
runs it, at that test's bar: >= 11 of 12 tokens equal, or the first
difference at a near tie (top-2 gap of the port's logits < 2e-2), and the
written cache within 3e-2. The M-RoPE and warm-cache cases are held to a
loop of JAX's dense `decode_step`, which is cheap, so that only the base
case pays for interpret mode. `generate_tokens` is held to JAX's
`generate_tokens`. The CUDA kernel is compared with the plain version by
the `gpu`-marked test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import DecoderConfig
from qwen_tts_tpu.core.weights import init_decoder_weights
from qwen_tts_tpu.core.weights import make_rope_table as j_rope
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.ops import generate_kernel as jgk
from qwen_tts_tpu.runtime.generate import generate_tokens as j_generate_tokens
from qwen_tts_tpu_torch.core.weights import DecoderWeights, convert_tuple, to_torch
from qwen_tts_tpu_torch.core.weights import make_rope_table as t_rope
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.ops import decode_step as tds
from qwen_tts_tpu_torch.ops import generate_kernel as tgk
from qwen_tts_tpu_torch.runtime.generate import generate_tokens

CFG = DecoderConfig(
    num_layers=3, hidden_size=256, intermediate_size=512,
    num_q_heads=4, num_kv_heads=2, head_dim=128,
    vocab_size=512, max_seq_len=128)
MROPE = dataclasses.replace(CFG, mrope_section=(24, 20, 20), mrope_interleaved=True)
N = 12


@pytest.fixture(scope="module")
def weights():
    jw = init_decoder_weights(jax.random.PRNGKey(4), CFG)
    return jw, convert_tuple(DecoderWeights, jw, "cpu")


@pytest.fixture(scope="module")
def jax_kernel_run(weights):
    """The JAX Pallas kernel, interpret mode: (tokens [N], state)."""
    jw, _ = weights
    state, tokens = jgk.generate_megakernel.__wrapped__(
        CFG, jw, jd.init_state(CFG), jnp.int32(7), N, chunk=64, copy_cache_in=True,
        interpret=True)
    return np.asarray(tokens), state


def _jax_dense_loop(cfg, jw, state, token, n, starts=None):
    toks = []
    for i in range(n):
        mp = None if starts is None else jnp.asarray([s + i for s in starts], jnp.int32)
        state, token, _ = jd.decode_step(cfg, jw, state, token, mrope_pos=mp)
        toks.append(int(token))
    return np.array(toks), state


def _first_diff_logits(cfg, tw, state0, first, k, starts=None):
    """The port's plain logits at step k of a run from `state0`."""
    state = state0._replace(k_cache=state0.k_cache.clone(), v_cache=state0.v_cache.clone())
    state, toks = tgk.generate_megakernel(cfg, tw, state, first, k, starts) if k else (
        state, torch.tensor([first]))
    mp = None if starts is None else [s + k for s in starts]
    cos, sin = td.rope_rows(cfg, tw.rope, state.position, 1, mp)
    embed = tw.embed[toks[-1:].long()][0].float()
    _, logits, _ = tds.megakernel_forward_reference(cfg, tw, state, embed, cos, sin)
    return logits


def _assert_agree(cfg, tw, state0, first, want, got, j_cache, t_state, starts=None):
    """>= N-1 tokens equal, or the first difference at a near tie; the
    cache columns written before it within 3e-2."""
    diff = np.flatnonzero(want != got)
    upto = N if not len(diff) else int(diff[0])
    if (want == got).sum() < N - 1:
        top2 = torch.topk(_first_diff_logits(cfg, tw, state0, first, upto, starts), 2).values
        assert float(top2[0] - top2[1]) < 2e-2, (want, got)
    p0 = state0.position
    for jc, tc in zip(j_cache, (t_state.k_cache, t_state.v_cache)):
        np.testing.assert_allclose(np.asarray(jc[:, :, p0:p0 + upto].astype(jnp.float32)),
                                   tc[:, :, p0:p0 + upto].float().numpy(), rtol=3e-2, atol=3e-2)


def test_generate_matches_jax_kernel_interpret(weights, jax_kernel_run):
    jw, tw = weights
    want, jstate = jax_kernel_run
    state0 = td.init_state(CFG, "cpu")
    before = tgk.generate_megakernel.launches
    ts, toks = tgk.generate_megakernel(CFG, tw, td.init_state(CFG, "cpu"), 7, N)
    assert toks.dtype == torch.int32 and toks.shape == (N,)
    assert ts.position == int(jstate.position) == N
    _assert_agree(CFG, tw, state0, 7, want, toks.numpy(), (jstate.k_cache, jstate.v_cache), ts)
    assert tgk.generate_megakernel.launches == before      # the CPU never launches


def test_generate_mrope_ahead_matches_jax_dense_loop(weights):
    jw, tw = weights
    jw, tw = jw._replace(rope=j_rope(MROPE)), tw._replace(rope=t_rope(MROPE, "cpu"))
    starts = (3, 8, 12)                        # ahead of the cache position 0
    want, jstate = _jax_dense_loop(MROPE, jw, jd.init_state(MROPE), jnp.int32(11), N, starts)
    state0 = td.init_state(MROPE, "cpu")
    ts, toks = tgk.generate_megakernel(MROPE, tw, td.init_state(MROPE, "cpu"), 11, N,
                                       mrope_pos0=starts)
    assert ts.position == N
    _assert_agree(MROPE, tw, state0, 11, want, toks.numpy(),
                  (jstate.k_cache, jstate.v_cache), ts, starts)
    # the sections moved the rotation: the standard-RoPE run writes other K columns
    plain, _ = tgk.generate_megakernel(MROPE, tw, td.init_state(MROPE, "cpu"), 11, 1)
    assert not torch.equal(plain.k_cache[:, :, 0], ts.k_cache[:, :, 0])


def test_generate_from_warm_cache_matches_jax_dense_loop(weights):
    jw, tw = weights
    warm_toks, jstate = _jax_dense_loop(CFG, jw, jd.init_state(CFG), jnp.int32(3), 5)
    state0 = td.DecodeState(to_torch(jstate.k_cache, "cpu"), to_torch(jstate.v_cache, "cpu"), 5)
    first = int(warm_toks[-1])
    want, jstate = _jax_dense_loop(CFG, jw, jstate, jnp.int32(first), N)
    ts, toks = tgk.generate_megakernel(
        CFG, tw, state0._replace(k_cache=state0.k_cache.clone(),
                                 v_cache=state0.v_cache.clone()), torch.tensor(first), N)
    assert ts.position == 5 + N
    _assert_agree(CFG, tw, state0, first, want, toks.numpy(),
                  (jstate.k_cache, jstate.v_cache), ts)


def test_generate_rope_table_bound_raises(weights):
    _, tw = weights
    tw = tw._replace(rope=t_rope(MROPE, "cpu"))
    rows = tw.rope.cos.shape[0]
    with pytest.raises(ValueError, match="rope table"):
        tgk.generate_megakernel(MROPE, tw, td.init_state(MROPE, "cpu"), 1, N,
                                mrope_pos0=(0, rows - N + 1, 0))
    with pytest.raises(ValueError, match="max_seq_len"):
        tgk.generate_megakernel(CFG, tw, td.init_state(CFG, "cpu")._replace(position=120),
                                1, N)


def test_generate_wrapper_has_no_plain_fallback_off_the_cpu(weights):
    _, tw = weights
    meta = tw._replace(embed=tw.embed.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tgk.generate_megakernel(CFG, meta, td.init_state(CFG, "cpu"), 1, 2)


def test_generate_tokens_matches_jax(weights, jax_kernel_run):
    """The dense loop against JAX's scan, and against the port's plain
    N-step version, which runs the same arithmetic."""
    jw, tw = weights
    js, want = j_generate_tokens(CFG, jw, jd.init_state(CFG), jnp.int32(7), N)
    ts, toks = generate_tokens(CFG, tw, td.init_state(CFG, "cpu"), 7, N)
    assert toks.dtype == torch.int32 and ts.position == int(js.position) == N
    _assert_agree(CFG, tw, td.init_state(CFG, "cpu"), 7, np.asarray(want), toks.numpy(),
                  (js.k_cache, js.v_cache), ts)
    _, mk = tgk.generate_megakernel(CFG, tw, td.init_state(CFG, "cpu"), 7, N)
    assert torch.equal(mk, toks)


@pytest.mark.gpu
def test_cuda_kernel_matches_step_loop(weights):
    """The N-step kernel shares the decode-step kernel's code: its tokens
    and cache columns equal a loop of decode-step launches bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, tw = weights
    tw = tw._replace(rope=t_rope(MROPE, "cuda"))
    tw = DecoderWeights(*[type(x)(*[t.cuda() for t in x]) if isinstance(x, tuple)
                          else x.cuda() for x in tw])
    starts = (0, 5, 9)
    sk = td.init_state(MROPE, "cuda")
    before = tgk.generate_megakernel.launches
    sk, toks = tgk.generate_megakernel(MROPE, tw, sk, 7, N, mrope_pos0=starts)
    assert tgk.generate_megakernel.launches == before + 1
    sl, tok, loop = td.init_state(MROPE, "cuda"), torch.tensor([7], device="cuda"), []
    for n in range(N):
        sl, logits, _ = tds.megakernel_forward(MROPE, tw, sl, tw.embed[tok][0].float(),
                                               mrope_pos=[s + n for s in starts])
        tok = torch.argmax(logits).reshape(1)
        loop.append(tok)
    assert torch.equal(toks.long(), torch.cat(loop))
    assert torch.equal(sk.k_cache, sl.k_cache) and torch.equal(sk.v_cache, sl.v_cache)

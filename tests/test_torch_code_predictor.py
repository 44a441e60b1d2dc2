"""The port's code predictor and sampler against the JAX package.

Greedy codes must equal JAX's. Handed the Gumbel noise JAX draws
(`gumbel(fold_in(rng, g), (top_k,))` for group g), the port must sample
what JAX's sampler samples from the same logits, and its whole frame must
equal JAX's sampled `cp_predict` up to the first near-tie rank swap. JAX
runs a 15th decoder step whose output nothing reads; the port skips it,
which the greedy equality shows to be harmless."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.models.code_predictor import cp_predict as j_cp_predict
from qwen_tts_tpu.ops.sampling import sample_logits as j_sample
from qwen_tts_tpu_torch.core.weights import from_jax
from qwen_tts_tpu_torch.models import code_predictor as tcp
from qwen_tts_tpu_torch.ops.sampling import gumbel_noise, sample_logits


@pytest.fixture(scope="module")
def both(tiny_cfg, tiny_weights):
    return tiny_cfg, tiny_weights, from_jax(tiny_weights)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal(cfg.talker.hidden_size).astype(np.float32)
    return hidden, int(rng.integers(0, 2048))


def _jax_noise(rng, n_groups, top_k):
    """The draws JAX's cp_predict makes: group g samples with fold_in(rng, g)."""
    return np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(rng, g), (top_k,)))
                     for g in range(n_groups)])


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_codes_equal_jax(both, seed):
    cfg, jw, tw = both
    hidden, first = _inputs(cfg, seed)
    j_codes, j_logits = j_cp_predict(
        cfg.code_predictor, jw.code_predictor, jnp.asarray(hidden), jnp.int32(first),
        jw.talker.embed, jax.random.PRNGKey(0), do_sample=False, return_logits=True)
    t_codes, t_logits = tcp.cp_predict(
        cfg.code_predictor, tw.code_predictor, torch.from_numpy(hidden),
        torch.tensor(first), tw.talker.embed, do_sample=False, return_logits=True)
    np.testing.assert_array_equal(np.asarray(j_codes), t_codes.numpy())
    # bf16 rounding of the hidden state flips differently after f32 sums taken
    # in another order: the bar of tests/test_megakernel.py
    np.testing.assert_allclose(np.asarray(j_logits), t_logits.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("seed", [2, 3])
def test_sampled_codes_follow_jax_draws(both, seed):
    """Handed JAX's Gumbel draws, every group samples exactly the token the
    JAX sampler picks from the same logits. (Whole-frame equality with JAX's
    cp_predict is not a sound test when sampling: one bf16 rounding that
    flips after f32 sums taken in another order moves the logits by ~1e-2,
    about the spacing of the top-50 values, and a rank swap hands two
    candidates each other's noise.)"""
    cfg, jw, tw = both
    hidden, first = _inputs(cfg, seed)
    rng = jax.random.PRNGKey(seed)
    noise = torch.from_numpy(_jax_noise(rng, 15, 50))
    t_codes, t_logits = tcp.cp_predict(
        cfg.code_predictor, tw.code_predictor, torch.from_numpy(hidden),
        torch.tensor(first), tw.talker.embed, do_sample=True, temperature=0.9,
        top_k=50, noise=noise, return_logits=True)
    for g in range(15):
        j_tok = j_sample(jnp.asarray(t_logits[g].numpy()), jax.random.fold_in(rng, g),
                         True, 0.9, 50)
        assert int(j_tok) == int(t_codes[g + 1]), g
    greedy = tcp.cp_predict(cfg.code_predictor, tw.code_predictor, torch.from_numpy(hidden),
                            torch.tensor(first), tw.talker.embed, do_sample=False)
    assert not torch.equal(greedy, t_codes)


@pytest.mark.parametrize("seed", range(8))
def test_sampled_frames_match_jax_cp_predict(both, seed):
    """JAX's `cp_predict` with sampling on and the port's, handed the same
    draws, give the same frame, or frames that first part at a group where
    both pick the same top-k rank (the same noise value) and that rank holds
    two tokens whose JAX logits are within 2e-2: a rank swap, caused by the
    ~1e-2 the logits move when a bf16 rounding flips after f32 sums taken in
    another order. Seeds 0-3 and 7 part so; the others give equal frames."""
    cfg, jw, tw = both
    hidden, first = _inputs(cfg, seed)
    temperature, top_k = 0.9, 50
    rng = jax.random.PRNGKey(seed)
    j_codes, j_logits = j_cp_predict(
        cfg.code_predictor, jw.code_predictor, jnp.asarray(hidden), jnp.int32(first),
        jw.talker.embed, rng, do_sample=True, temperature=temperature, top_k=top_k,
        return_logits=True)
    noise = torch.from_numpy(_jax_noise(rng, 15, top_k))
    t_codes, t_logits = tcp.cp_predict(
        cfg.code_predictor, tw.code_predictor, torch.from_numpy(hidden),
        torch.tensor(first), tw.talker.embed, do_sample=True, temperature=temperature,
        top_k=top_k, noise=noise, return_logits=True)
    j_codes = torch.from_numpy(np.array(j_codes)).long()
    diff = (j_codes != t_codes).nonzero()
    if not len(diff):
        return
    g = int(diff[0, 0])
    assert g >= 1
    jl, tl = torch.from_numpy(np.array(j_logits[g - 1])), t_logits[g - 1]
    assert float((jl - tl).abs().max()) < 2e-2        # the greedy test's bar
    _, j_idx = torch.topk(jl / temperature, top_k)
    _, t_idx = torch.topk(tl / temperature, top_k)
    rank = int((j_idx == j_codes[g]).nonzero()[0, 0])
    assert int(t_idx[rank]) == int(t_codes[g]), "the port picked another rank"
    assert abs(float(jl[j_idx[rank]] - jl[t_idx[rank]])) < 2e-2, (g, rank)


def test_mega_backend_runs_14_steps_with_the_same_codes(both, monkeypatch):
    """The "mega" backend (plain version on the CPU) gives the dense codes
    and runs one single-token step per group except the last."""
    import qwen_tts_tpu_torch.ops.decode_step as ds

    cfg, _, tw = both
    hidden, first = _inputs(cfg, 4)
    args = (cfg.code_predictor, tw.code_predictor, torch.from_numpy(hidden),
            torch.tensor(first), tw.talker.embed)
    calls = []
    real = ds.megakernel_forward

    def counting(*a, **k):
        calls.append(k.get("with_head"))
        return real(*a, **k)

    monkeypatch.setattr(ds, "megakernel_forward", counting)
    dense = tcp.cp_predict(*args, do_sample=False)
    mega = tcp.cp_predict(*args, do_sample=False, attn_impl="mega")
    assert torch.equal(dense, mega)
    assert calls == [False] * 14           # no head, no dead 15th step


@pytest.mark.parametrize("top_k", [50, 0])
def test_sample_logits_matches_jax(top_k):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal(2048).astype(np.float32) * 3
    key = jax.random.PRNGKey(top_k)
    k = top_k or 2048
    noise = np.array(jax.random.gumbel(key, (k,)))
    j_tok = int(j_sample(jnp.asarray(logits), key, True, 0.9, top_k))
    t_tok = int(sample_logits(torch.from_numpy(logits), True, 0.9, top_k,
                              noise=torch.from_numpy(noise)))
    assert j_tok == t_tok
    assert int(sample_logits(torch.from_numpy(logits), False)) == int(np.argmax(logits))


def test_gumbel_noise_is_seeded_and_gumbel_distributed():
    g = torch.Generator()
    g.manual_seed(1)
    a = gumbel_noise((4, 50), g, "cpu")
    g.manual_seed(1)
    assert torch.equal(a, gumbel_noise((4, 50), g, "cpu"))
    big = gumbel_noise((200_000,), g, "cpu")
    assert abs(float(big.mean()) - 0.5772) < 0.02       # Euler–Mascheroni
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.05

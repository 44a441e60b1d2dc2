"""The code predictor's frame as one launch of the decode-step kernel
(`ops/cp_frame.py`), on the CPU through its plain version.

The plain version is the route's CPU path: 16 single-row steps of the
kernel's plain version from cache row 0 (the talker's hidden, then
`first_token`'s talker row, then each group's codec row), with each group's
head, top-k sample with the injected noise (or argmax) between them. It must
give the dense `cp_predict`'s codes, greedy and sampled, over a bf16 and an
int8 code predictor, with logits within the kernel's tolerance: the one
rounding that differs is row 0's K/V, which row 1 reads from the bf16 cache
where the dense prefill keeps them in f32. The engine keeps counting 14
code-predictor steps a frame, and counts in `cp_kernel_frames` the frames
of one stream whose code predictor took the route, never the batched
path's. The plain version is also held to the JAX package's `cp_predict`
on the same inputs and draws. The `gpu` test holds the kernel to the plain
version on the card; the module imports nothing of JAX, so that it runs
there (`pytest --noconftest -m gpu`)."""

import numpy as np
import pytest
import torch

from qwen_tts_tpu_torch.core.weights import QUANTIZERS, from_jax
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.models import code_predictor as tcp
from qwen_tts_tpu_torch.models.decoder import init_state
from qwen_tts_tpu_torch.ops import cp_frame as cpf
from qwen_tts_tpu_torch.ops.sampling import gumbel_noise


@pytest.fixture(scope="module")
def weights(tiny_weights):
    return from_jax(tiny_weights, "cpu")


def _cp(weights, form):
    cp = weights.code_predictor
    if form == "int8":
        cp = cp._replace(decoder=QUANTIZERS["int8"](cp.decoder, quant_head=False))
    return cp


def _inputs(cfg, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    hidden = torch.randn(cfg.talker.hidden_size, generator=g)
    first = torch.randint(0, 2048, (), generator=g)
    return hidden, first, gumbel_noise((15, 50), g, "cpu")


def _cos(a, b):
    return float((a * b).sum() / (a.norm() * b.norm()))


def _first_parting(ref, ref_logits, tokens, logits, noise, bar, T=0.9, top_k=50):
    """The first group at which `tokens [15]` part from `ref [15]` (15 when
    they do not), which must be a near tie of the reference's logits: both
    picked the same rank of their top k (greedy, `noise` None: rank 0) and
    the reference's logits of the two tokens lie within `bar` of each other
    (a rank swap, which hands each the other's noise), or they picked two
    ranks whose noisy scores on the reference's side lie within `bar` / T."""
    parted = (ref.long() != tokens.long()).nonzero()
    g = int(parted[0, 0]) if len(parted) else 15
    if g < 15:
        r_val, r_idx = torch.topk(ref_logits[g] / T, top_k)
        _, t_idx = torch.topk(logits[g] / T, top_k)
        r_rank = int((r_idx == ref[g]).nonzero()[0, 0])
        t_rank = int((t_idx == tokens[g]).nonzero()[0, 0])
        if r_rank == t_rank:
            gap = float(ref_logits[g, ref[g].long()] - ref_logits[g, tokens[g].long()])
            assert abs(gap) < bar, (g, gap)
        else:
            assert noise is not None, "greedy picks rank 0 on both sides"
            scores = r_val + noise[g]
            assert abs(float(scores[r_rank] - scores[t_rank])) < bar / T, g
    return g


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_plain_route_gives_the_dense_codes(tiny_cfg, weights, form, sample, seed):
    """The same codes, or codes that first part at a near tie of the dense
    logits (`_first_parting`; the noise goes by rank:
    test_torch_code_predictor.py's rule). Logits up to it within the bar: the kernel's 2e-2
    (tests/test_torch_megakernel.py) for bf16; 5e-2 for int8, whose dense
    prefill also rounds the dequantized weights to bf16 where the route's
    products keep them exact (tests/test_torch_quant_engine.py)."""
    cfg, cp = tiny_cfg.code_predictor, _cp(weights, form)
    bar = 2e-2 if form == "bf16" else 5e-2
    hidden, first, noise = _inputs(tiny_cfg, seed)
    kw = dict(do_sample=sample, temperature=0.9, top_k=50, noise=noise if sample else None,
              return_logits=True)
    dense, d_logits = tcp.cp_predict(cfg, cp, hidden, first, weights.talker.embed, **kw)
    tokens, logits = cpf.cp_frame(cfg, cp, init_state(cfg, "cpu"), hidden, first,
                                  weights.talker.embed, **kw)
    assert tokens.dtype == torch.int32 and tokens.shape == (15,)
    g = _first_parting(dense[1:], d_logits, tokens, logits, kw["noise"], bar)
    if sample:
        for g_ in range(g):
            assert int(cpf.sample_logits(logits[g_], True, 0.9, 50, noise[g_])) == int(tokens[g_])
    # over the groups both fed the same tokens
    np.testing.assert_allclose(logits[:g + 1].numpy(), d_logits[:g + 1].numpy(), rtol=bar,
                               atol=bar)
    assert min(_cos(a, b) for a, b in zip(logits[:g + 1], d_logits[:g + 1])) > 0.999


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_plain_route_follows_jax(tiny_cfg, tiny_weights, weights, sample, seed):
    """The route's plain version against the JAX package's `cp_predict` on
    the same hidden state and token, sampling with the Gumbel draws JAX
    makes (`gumbel(fold_in(rng, g), (top_k,))` for group g): every token is
    the one JAX's sampler picks from the route's own logits, and the frame
    is JAX's up to a near tie of JAX's logits, the logits within the
    kernel's bar up to there."""
    import jax
    import jax.numpy as jnp

    from qwen_tts_tpu.models.code_predictor import cp_predict as j_cp_predict
    from qwen_tts_tpu.ops.sampling import sample_logits as j_sample

    cfg = tiny_cfg.code_predictor
    hidden, first, _ = _inputs(tiny_cfg, 10 + seed)
    rng = jax.random.PRNGKey(seed)
    noise = torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(jax.random.fold_in(rng, g), (50,))) for g in range(15)]))
    j_codes, j_logits = j_cp_predict(
        cfg, tiny_weights.code_predictor, jnp.asarray(hidden.numpy()), jnp.int32(int(first)),
        tiny_weights.talker.embed, rng, do_sample=sample, temperature=0.9, top_k=50,
        return_logits=True)
    j_codes = torch.from_numpy(np.array(j_codes))
    j_logits = torch.from_numpy(np.array(j_logits, dtype=np.float32))
    tokens, logits = cpf.cp_frame(cfg, weights.code_predictor, init_state(cfg, "cpu"), hidden,
                                  first, weights.talker.embed, noise if sample else None,
                                  sample, 0.9, 50, return_logits=True)
    assert int(j_codes[0]) == int(first)
    for g_ in range(15):
        j_tok = j_sample(jnp.asarray(logits[g_].numpy()), jax.random.fold_in(rng, g_),
                         sample, 0.9, 50)
        assert int(j_tok) == int(tokens[g_]), g_
    g = _first_parting(j_codes[1:], j_logits, tokens, logits, noise if sample else None, 2e-2)
    np.testing.assert_allclose(logits[:g + 1].numpy(), j_logits[:g + 1].numpy(), rtol=2e-2,
                               atol=2e-2)


def test_plain_route_runs_16_single_row_steps(tiny_cfg, weights, monkeypatch):
    """Step 0 from the talker's hidden, step 1 from its token's row, one
    step a group after that but the last: all single rows, none with the
    decoder's own head, from cache row 0 whatever the state held."""
    cfg, cp = tiny_cfg.code_predictor, weights.code_predictor
    hidden, first, _ = _inputs(tiny_cfg, 5)
    calls = []
    real = cpf.megakernel_forward_reference

    def counting(cfg_, w, state, embed, cos, sin, with_head=True):
        calls.append((state.position, tuple(embed.shape), with_head))
        return real(cfg_, w, state, embed, cos, sin, with_head)

    monkeypatch.setattr(cpf, "megakernel_forward_reference", counting)
    used = init_state(cfg, "cpu")._replace(position=40)
    used.k_cache.normal_()
    tokens, logits = cpf.cp_frame(cfg, cp, used, hidden, first, weights.talker.embed,
                                  do_sample=False)
    assert logits is None
    assert calls == [(n, (cfg.hidden_size,), False) for n in range(16)]
    fresh, _ = cpf.cp_frame(cfg, cp, init_state(cfg, "cpu"), hidden, first,
                            weights.talker.embed, do_sample=False)
    assert torch.equal(tokens, fresh)


@pytest.mark.parametrize("do_sample, temperature, top_k, vocab, takes", [
    (False, 0.9, 0, 2048, True), (True, 0.0, 0, 2048, True), (True, 0.9, 50, 2048, True),
    (True, 0.9, 64, 2048, True), (True, 0.9, 65, 2048, False), (True, 0.9, 0, 2048, False),
    (True, 0.9, 2048, 2048, False), (True, 0.9, 50, 8192, False)])
def test_kernel_takes(tiny_cfg, do_sample, temperature, top_k, vocab, takes):
    """The epilogue's sampling: greedy, or 1..64 of a vocabulary up to
    4,096 (sample_logits' argmax of all logits plus noise when top_k does
    not restrict stays plain)."""
    import dataclasses

    cfg = dataclasses.replace(tiny_cfg.code_predictor, vocab_size=vocab)
    assert cpf.kernel_takes(cfg, do_sample, temperature, top_k) is takes
    assert tcp.frame_kernel("mega", "cuda", cfg, do_sample, temperature, top_k) is takes
    assert not tcp.frame_kernel("mega", "cpu", cfg, do_sample, temperature, top_k)
    assert not tcp.frame_kernel("pallas", "cuda", cfg, do_sample, temperature, top_k)
    wide = dataclasses.replace(cfg, num_q_heads=4 * cfg.num_kv_heads)   # 4 q heads a kv head
    assert not cpf.kernel_takes(wide, do_sample, temperature, top_k)


def _engine(tiny_cfg, weights, backend):
    eng = TTSEngine(TTSConfig(device="cpu", backend=backend, max_seq_len=256, chunk_frames=4,
                              seed=3), model_config=tiny_cfg)
    eng.initialize(weights=weights)
    return eng


def test_engine_counts_route_frames_and_14_cp_steps(tiny_cfg, weights, monkeypatch):
    """With the route let onto the CPU, the engine's one-stream frames
    (fused chunks and the per-frame generator) go through it, each counted
    once in `cp_kernel_frames` and as 14 code-predictor steps; the batched
    path and the other backends keep the plain code predictor and count 0."""
    monkeypatch.setattr(tcp, "frame_kernel", lambda attn_impl, *a: attn_impl == "mega")
    routed = []
    real = tcp.cp_frame
    monkeypatch.setattr(tcp, "cp_frame", lambda *a, **k: (routed.append(1), real(*a, **k))[1])
    eng = _engine(tiny_cfg, weights, "mega")
    list(eng._generate_chunks("hello world", 4, with_audio=False))
    m = eng.get_metrics()
    frames = m["talker_steps"] - 1               # the BOS step computes no frame
    assert frames >= 25 and m["cp_kernel_frames"] == frames == len(routed)
    assert m["cp_steps"] == 14 * frames
    eng.config = eng.config.__class__(**{**eng.config.__dict__, "fused_chunks": False})
    list(eng._generate_chunks("hello", 4, with_audio=False))
    m2 = eng.get_metrics()
    assert m2["cp_kernel_frames"] - frames == m2["talker_steps"] - m["talker_steps"] - 1
    eng.synthesize_batch(["hello", "hello world"])
    m3 = eng.get_metrics()
    assert m3["cp_kernel_frames"] == m2["cp_kernel_frames"]
    assert m3["cp_steps"] - m2["cp_steps"] == 14 * (m3["talker_steps"] - m2["talker_steps"] - 2)
    for backend in ("dense", "pallas"):
        other = _engine(tiny_cfg, weights, backend)
        list(other._generate_chunks("hello", 4, with_audio=False))
        assert other.get_metrics()["cp_kernel_frames"] == 0


def test_engine_on_the_cpu_keeps_the_plain_code_predictor(tiny_cfg, weights):
    eng = _engine(tiny_cfg, weights, "mega")
    list(eng._generate_chunks("hello", 4, with_audio=False))
    m = eng.get_metrics()
    assert m["cp_kernel_frames"] == 0 and m["cp_steps"] == 14 * (m["talker_steps"] - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_cuda_frame_matches_plain_route(sample):
    """One launch of the kernel against its plain version on the card: the
    same codes up to a near tie of the plain logits (`_first_parting`),
    logits within the kernel's bar up to there, each token what
    `sample_logits` picks from the kernel's own logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from qwen_tts_tpu_torch.core.config import tiny_test_config
    from qwen_tts_tpu_torch.core.weights import init_tts_weights

    tiny_cfg = tiny_test_config(max_seq_len=64)
    cfg = tiny_cfg.code_predictor
    w = init_tts_weights(7, tiny_cfg, "cuda")
    before = cpf.cp_frame.frames
    for seed in range(8):
        hidden, first, noise = (t.cuda() for t in _inputs(tiny_cfg, seed))
        kw = dict(do_sample=sample, noise=noise if sample else None, return_logits=True)
        tokens, logits = cpf.cp_frame(cfg, w.code_predictor, init_state(cfg, "cuda"), hidden,
                                      first, w.talker.embed, **kw)
        ref_t, ref_l = cpf.cp_frame_reference(cfg, w.code_predictor, init_state(cfg, "cuda"),
                                              hidden, first, w.talker.embed, kw["noise"],
                                              sample, 0.9, 50, 15)
        tokens, logits, ref_t, ref_l = (t.cpu() for t in (tokens, logits, ref_t, ref_l))
        noise = noise.cpu() if sample else None
        g = _first_parting(ref_t, ref_l, tokens, logits, noise, 2e-2)
        torch.testing.assert_close(logits[:g + 1], ref_l[:g + 1], rtol=2e-2, atol=2e-2)
        for g_ in range(15):
            assert int(cpf.sample_logits(logits[g_], sample, 0.9, 50,
                                         None if noise is None else noise[g_])) == int(tokens[g_])
    assert cpf.cp_frame.frames == before + 8

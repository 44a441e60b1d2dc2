"""Backends "pallas" and "dense" on device positions, so CUDA graphs can
capture them (the port's A17): the decode-attention kernel's plain version
with positions `[B]` against the JAX Pallas kernel (interpret mode, one
slot and vmapped over three slots at different positions), the
single-token decoder layer on a device position against JAX's
`forward_chunk` at T = 1 and against the port's host-position path, and
the engines of both backends with `fused_chunks=True` holding and parking
their device position. Inputs are made with numpy from a seed; the kernel
itself is compared with the plain version by the `gpu`-marked tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import tiny_test_config
from qwen_tts_tpu.core.weights import init_decoder_weights
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.ops import attention as ja
from qwen_tts_tpu_torch.core.weights import DecoderWeights, convert_tuple, from_jax, to_torch
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.ops import attention as ta

S = 512                                          # 8 tiles of 64 rows
POSITIONS = (0, 1, 63, 64, 300, S - 1, S)        # item 1's boundaries, and a full cache


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slot(rng, position, HQ=16, KVH=8, L=2, D=128):
    """One slot's inputs: q, k_new, v_new f32 and bf16-valued caches with the
    rows at and past `position` and layer 0 poisoned."""
    q = rng.standard_normal((HQ, D)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((KVH, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((L, KVH, S, D)).astype(np.float32) for _ in range(2))
    k[:, :, position:] = v[:, :, position:] = 99.0
    k[0] = -77.0
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return q, k_new, v_new, bf(k), bf(v)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax(q, kn, vn, k, v, pos):
    return np.asarray(ja.decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), 1, pos, chunk=64, interpret=True))


@pytest.mark.parametrize("position", POSITIONS)
def test_plain_attention_on_a_device_position_matches_pallas(position):
    q, kn, vn, k, v = _slot(np.random.default_rng(position), position)
    want = _jax(q, kn, vn, k, v, position)
    got = ta.decode_attention_reference(
        *(torch.from_numpy(a) for a in (q, kn, vn)), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), 1, torch.tensor(position, dtype=torch.int32))
    assert _rel_l2(got.numpy(), want) < 1e-5


def test_plain_attention_of_three_slots_matches_vmapped_pallas():
    """B = 3 slots at positions 0, 300 and S, each over its own cache: the
    plain version and the wrapper (on the CPU, the plain version) against the
    JAX kernel vmapped over the slots."""
    rng = np.random.default_rng(7)
    positions = (0, 300, S)
    slots = [_slot(rng, p) for p in positions]
    q, kn, vn, k, v = (np.stack(x) for x in zip(*slots))
    want = np.asarray(jax.vmap(
        lambda q_, kn_, vn_, k_, v_, p_: ja.decode_attention(
            q_, kn_, vn_, k_, v_, 1, p_, chunk=64, interpret=True))(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(positions, jnp.int32)))
    args = (*(torch.from_numpy(a) for a in (q, kn, vn)), torch.from_numpy(k).bfloat16(),
            torch.from_numpy(v).bfloat16(), 1, torch.tensor(positions, dtype=torch.int32))
    for got in (ta.decode_attention_reference(*args), ta.decode_attention(*args)):
        assert got.shape == (3, 16, 128)
        for b in range(3):
            assert _rel_l2(got[b].numpy(), want[b]) < 1e-5, b


CFG = dataclasses.replace(tiny_test_config(max_seq_len=64).talker, mrope_section=(24, 20, 20),
                          mrope_interleaved=True)
DELTAS = (0, 5, 9)


@pytest.fixture(scope="module")
def weights():
    jw = init_decoder_weights(jax.random.PRNGKey(5), CFG)
    return jw, convert_tuple(DecoderWeights, jw, "cpu")


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_single_token_layer_on_a_device_position(weights, cache, impl):
    """After an 8-row prefill, 5 single-token steps (M-RoPE deltas 0/5/9)
    on a state carrying its position on the device, against the port's
    host-position path (outputs within 1e-5, the same cache rows) and JAX's
    `forward_chunk` at T = 1 (within the dense step's bar of
    tests/test_torch_decoder.py, 2e-2: the layers' bf16 rounding points
    flip after f32 sums taken in another order; the attention alone is held
    to 1e-5 below), the device position advanced."""
    jw, tw = weights
    kv = (jnp.int8, torch.int8) if cache == "int8" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(3)
    prompt = rng.standard_normal((8, CFG.hidden_size)).astype(np.float32)
    md = jnp.asarray(DELTAS, jnp.int32)
    js, _ = jd.forward_chunk(CFG, jw, jd.init_state(CFG, kv[0]), jnp.asarray(prompt),
                             mrope_pos=md)
    host = td.init_state(CFG, "cpu", kv[1])
    dev = td.init_state(CFG, "cpu", kv[1], device_pos=True)
    host, _ = td.forward_chunk(CFG, tw, host, torch.from_numpy(prompt), mrope_pos=DELTAS)
    dev, _ = td.forward_chunk(CFG, tw, dev, torch.from_numpy(prompt), mrope_pos=DELTAS)
    assert int(dev.pos) == 8
    for step in range(5):
        x = rng.standard_normal((1, CFG.hidden_size)).astype(np.float32)
        mp = [8 + step + d for d in DELTAS]
        js, jn = jd.forward_chunk(CFG, jw, js, jnp.asarray(x), mrope_pos=jnp.asarray(mp))
        host, hn = td.forward_chunk(CFG, tw, host, torch.from_numpy(x), attn_impl=impl,
                                    mrope_pos=mp)
        dev, dn = td.forward_chunk(CFG, tw, dev, torch.from_numpy(x), attn_impl=impl,
                                   mrope_pos=mp)
        np.testing.assert_allclose(dn.numpy(), hn.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(dn.numpy(), np.asarray(jn), rtol=2e-2, atol=2e-2)
    assert int(dev.pos) == dev.position == host.position == 13
    for a, b in zip(dev[:2] + dev[3:5], host[:2] + host[3:5]):
        if a is not None:
            assert torch.equal(a[:, :, :13], b[:, :, :13])
    # JAX's cache rows: bf16 within 2e-2; int8 within one step of rounding
    np.testing.assert_allclose(dev.k_cache[:, :, :13].float().numpy(),
                               np.asarray(js.k_cache[:, :, :13].astype(jnp.float32)),
                               rtol=0, atol=1.0 if cache == "int8" else 2e-2)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("position", [0, 1, 40, 64])
def test_masked_attention_on_a_device_position_matches_jax_dense(cache, position):
    """The single-token attention of a state with device positions (the
    kernel's plain version, masked) against JAX's dense attention at T = 1
    over the same cache, bf16 or int8 with row scales: within 1e-5."""
    rng = np.random.default_rng(position)
    HQ, KVH, D, L, SS = CFG.num_q_heads, CFG.num_kv_heads, CFG.head_dim, 2, 64
    q = rng.standard_normal((1, HQ, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((1, KVH, D)).astype(np.float32) for _ in range(2))
    if cache == "int8":
        k, v = (rng.integers(-127, 128, (L, KVH, SS, D), dtype=np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, (L, KVH, SS)).astype(np.float32) for _ in range(2))
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
        jks, jvs = jnp.asarray(ks[1]), jnp.asarray(vs[1])
        tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    else:
        k, v = (rng.standard_normal((L, KVH, SS, D)).astype(np.float32) for _ in range(2))
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        tk, tv = to_torch(jk, "cpu"), to_torch(jv, "cpu")
        jks = jvs = tks = tvs = None
    want = np.asarray(jd._dense_mixed_attention(
        CFG, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jk[1], jv[1],
        jnp.int32(position), jks, jvs))[0]
    got = ta.decode_attention_reference(
        torch.from_numpy(q[0]), torch.from_numpy(kn[0]), torch.from_numpy(vn[0]), tk, tv, 1,
        torch.tensor(position, dtype=torch.int32), tks, tvs)
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, rtol=1e-5, atol=1e-5)


def test_device_rope_rows_equal_host_rows(weights):
    """The M-RoPE rows gathered by device positions equal the host rows."""
    _, tw = weights
    pos = torch.tensor([0, 7, 30], dtype=torch.int32)
    cos, sin = td.device_rope_rows(CFG, tw.rope, pos, DELTAS)
    for b, p in enumerate(pos.tolist()):
        hc, hs = td.mrope_rows(CFG, tw.rope, [p + d for d in DELTAS], 1)
        assert torch.equal(cos[b], hc) and torch.equal(sin[b], hs)


def test_a_step_past_the_cache_end_raises_on_the_cpu(weights):
    """A single-token step of a slot with no room left refuses on the CPU,
    where reading the device position waits for nothing."""
    _, tw = weights
    st = td.init_state(CFG, "cpu", slots=2)
    x = torch.zeros(2, 1, CFG.hidden_size)
    for pos in ([CFG.max_seq_len, 3], [3, -1]):
        st.pos.copy_(torch.tensor(pos, dtype=torch.int32))
        with pytest.raises(ValueError, match="outside max_seq_len"):
            td.forward_chunk(CFG, tw, st, x, attn_impl="pallas")


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_a_column_past_the_cache_end_stays_in_its_slot_and_head(cache):
    """The device-position cache write (what a step on the card runs, where
    the host does not read positions): slots at S, 5 and -1 write their
    column at rows S - 1, 5 and 0 of their own heads, clamped as JAX's
    `dynamic_update_slice` clamps, and every other row and scale keeps its
    value: nothing lands in the next head's, layer's or slot's rows."""
    kv = torch.int8 if cache == "int8" else torch.bfloat16
    st = td.init_state(CFG, "cpu", kv, slots=3)
    S, KVH, D = CFG.max_seq_len, CFG.num_kv_heads, CFG.head_dim
    for t in (st.k_cache, st.v_cache) + ((st.k_scale, st.v_scale) if kv == torch.int8 else ()):
        t.copy_(torch.arange(t.numel()).reshape(t.shape) % 97 + 1)
    before = [None if t is None else t.clone() for t in (st.k_cache, st.v_cache,
                                                          st.k_scale, st.v_scale)]
    cols = torch.full((3, KVH, 1, D), 0.5)
    rows = td._flat_rows(st, torch.tensor([S, 5, -1], dtype=torch.int32))
    td._write_columns(st, 1, 0, cols, -cols, rows)
    for t, b in zip((st.k_cache, st.v_cache, st.k_scale, st.v_scale), before):
        if t is None:
            continue
        changed = (t != b).reshape(3, CFG.num_layers, KVH, S, -1).any(-1)
        want = torch.zeros_like(changed)
        for slot, row in enumerate((S - 1, 5, 0)):
            want[slot, 1, :, row] = True
        assert torch.equal(changed, want)


@pytest.fixture(scope="module")
def tiny():
    from qwen_tts_tpu.core.weights import init_tts_weights

    mc = tiny_test_config(max_seq_len=256)
    return mc, from_jax(init_tts_weights(jax.random.PRNGKey(0), mc), "cpu")


def _engine(tiny, **kw):
    mc, w = tiny
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, seed=3, **kw),
                    model_config=mc)
    eng.initialize(weights=w)
    return eng


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_interleaved_streams_park_the_device_position(tiny, backend):
    """Two streams of one fused engine, interleaved chunk by chunk, yield
    what each yields alone: a park copies the talker's device position with
    the cache rows, and a restore puts it back."""
    alone = _engine(tiny, backend=backend)
    want = []
    for r, text in enumerate(("first stream of words", "the second stream")):
        alone._requests = 10 + r
        want.append(list(alone._generate_chunks(text, 4, True)))
    eng = _engine(tiny, backend=backend)
    gens, got = [], [[], []]
    for r, text in enumerate(("first stream of words", "the second stream")):
        eng._requests = 10 + r
        gens.append(eng._generate_chunks(text, 4, True))
        got[r].append(next(gens[r]))          # numbers the request, as alone
    live = [True, True]
    while any(live):
        for i, g in enumerate(gens):
            if live[i]:
                try:
                    got[i].append(next(g))
                except StopIteration:
                    live[i] = False
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for (wa, wf), (ga, gf) in zip(w, g):
            np.testing.assert_array_equal(np.stack(wf), np.stack(gf))
            np.testing.assert_array_equal(wa, ga)


def _to_cuda(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cuda()
    if isinstance(tree, tuple):
        items = [_to_cuda(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 4])
def test_cuda_kernel_on_device_positions_matches_plain(slots):
    """One launch a call for B slots at their own positions, within 2e-3 of
    the plain version at every position (a full cache included), the same
    bits on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(slots)
    groups = [(p,) for p in POSITIONS] if slots == 1 else [(0, 1, 63, 64), (300, S - 1, S, 65)]
    for ps in groups:
        sl = [_slot(rng, p) for p in ps]
        q, kn, vn, k, v = (torch.from_numpy(np.stack(x)).cuda() for x in zip(*sl))
        k, v = k.bfloat16(), v.bfloat16()
        pos = torch.tensor(ps, dtype=torch.int32, device="cuda")
        if slots == 1:
            q, kn, vn, k, v, pos = q[0], kn[0], vn[0], k[0], v[0], pos[0]
        before = ta.device_launches(q.device)
        got = ta.decode_attention(q, kn, vn, k, v, 1, pos)
        again = ta.decode_attention(q, kn, vn, k, v, 1, pos)
        want = ta.decode_attention_reference(q, kn, vn, k, v, 1, pos)
        torch.cuda.synchronize()
        assert ta.device_launches(q.device) == before + 2
        assert float((got - want).abs().max()) <= 2e-3 * max(1.0, float(want.abs().max()))
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas", "dense"])
def test_cuda_step_of_a_slot_at_the_cache_end(weights, impl):
    """On the card, a slot at position S takes a step beside a slot at 3:
    the kernel (or its plain version) reads S rows and the column, the
    write lands in the slot's own last rows, and the other slot's output
    and rows are what they are with a neighbour at 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, tw = weights
    w = _to_cuda(tw)
    S = CFG.max_seq_len
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 1, CFG.hidden_size)).astype(np.float32)).cuda()
    runs = []
    for first in (S, 3):
        st = td.init_state(CFG, "cuda", slots=2)
        for t in (st.k_cache, st.v_cache):
            t.copy_(torch.from_numpy(np.random.default_rng(4).standard_normal(
                t.shape).astype(np.float32) * 0.1).bfloat16())
        k0 = st.k_cache.clone()
        st.pos.copy_(torch.tensor([first, 3], dtype=torch.int32))
        st, normed = td.forward_chunk(CFG, w, st, x, attn_impl=impl)
        torch.cuda.synchronize()
        runs.append((st, normed, k0))
    (st, normed, k0), (st3, normed3, _) = runs
    assert bool(torch.isfinite(normed).all())
    assert torch.equal(normed[1], normed3[1]) and torch.equal(st.k_cache[1], st3.k_cache[1])
    changed = (st.k_cache[0] != k0[0]).any(-1)
    assert not bool(changed[:, :, :S - 1].any()) and bool(changed[:, :, S - 1].all())
    assert st.pos.tolist() == [S + 1, 4]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_cuda_graphs_of_the_backend_equal_its_eager_loop(tiny, backend):
    """On the card: the backend's captured chunks give its eager loop's
    codes bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    mc, w = tiny
    w = _to_cuda(w)
    kw = {"device": "cuda", "max_seq_len": 256, "chunk_frames": 4, "seed": 3,
          "backend": backend}
    g = TTSEngine(TTSConfig(**kw), model_config=mc)
    g.initialize(weights=w)
    e = TTSEngine(TTSConfig(**kw, fused_chunks=False), model_config=mc)
    e.initialize(weights=w, vocoder_weights=g.vocoder_weights)
    for eng in (g, e):
        eng._requests = 70
    gc = [f for _a, fr in g._generate_chunks("hello world", 4, False) for f in fr]
    ec = [f for _a, fr in e._generate_chunks("hello world", 4, False) for f in fr]
    np.testing.assert_array_equal(np.stack(gc), np.stack(ec))

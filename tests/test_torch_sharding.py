"""The port's (dp, tp) mesh (`qwen_tts_tpu_torch/parallel/`) on 8 gloo ranks
against the JAX package's sharded decode on its 8 virtual CPU devices
(`tests/test_sharding.py`, `tests/test_batch.py:78-153`).

The parent makes the inputs (JAX's initialiser through `convert_tuple`,
numpy draws from a seed), computes the references (JAX's tp=8 sharded step,
the unsharded steps of both packages, the port's unsharded batch) and
starts one world of 8 ranks (`parallel/launch.py::run_ranks`, a 120 s hard
limit) that runs `tests/_torch_mesh_ranks.py::world8`. Bars:

- the tp=8 step (whole KV groups and paired gate/up columns a rank, the
  `wo` / `w_down` outputs all-reduced, the vocab shards gathered): the
  same token as the unsharded step of either package and as JAX's sharded
  step, hidden state within rtol = atol = 2e-3 of each (JAX's bar);
- a tp=8 code-predictor frame, greedy: the unsharded frame's codes, or a
  first parting at a near tie of the unsharded logits (top-2 gap < 2e-2);
- the (2, 4) dp x tp batched step: each slot's token equal to its
  unsharded single step's in both packages, its hidden within 2e-3;
- the quantized tier's batched frames dp-sharded on (4, 2): each rank's
  frames equal bit for bit a one-process batch of its slot, the sharded
  run deterministic; against the unsharded 4-slot batch, as in JAX's
  scheme (test_sharding.py:135-149), prefill tokens exact (and equal to
  JAX's) and hidden cosine > 0.999. JAX's first-frame agreement >= 0.75
  does not hold for the port (0.55-0.91 over seeds 0-7 of
  `_torch_dp_readings.py`): a slot's rows round otherwise in a batch of 1
  than of 4, a sampled code then swaps top-k rank with a neighbour, and
  the frame's later groups follow the swapped code. So each slot run
  alone is fed the batch's codes (`dp_split_readings`): its talker hidden
  state within cosine 0.999 of the batch's at every step, and in each
  frame the first choice it makes otherwise a rank swap at a near tie
  (the parting code and the one that took its rank within 2e-2 in the
  batch's logits; a greedy code 0 within 2e-2), with at least half of all
  choices equal before their frame's parting; the same on seeds 1-3;
- `synthesize_batch(texts, mesh=)` on (4, 2): 4 results on every rank,
  rank d's texts equal bit for bit to a one-process batch of them at the
  same request numbers, 3 texts refused ("divisible") with the request
  count untouched.

A rank that raises fails its test at once; a world that hangs is killed at
its time limit, and the test fails (`test_a_hung_rank_fails_within_its_limit`)."""

import dataclasses
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import DecoderConfig as JDecoderConfig
from qwen_tts_tpu.core.config import tiny_test_config as j_tiny
from qwen_tts_tpu.core.weights import init_decoder_weights as j_init_decoder
from qwen_tts_tpu.core.weights import init_tts_weights as j_init_tts
from qwen_tts_tpu.core.weights import quantize_decoder_weights as j_quantize
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.parallel import sharding as jsh
from qwen_tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from qwen_tts_tpu.runtime.batch import batched_prefill as j_batched_prefill
from qwen_tts_tpu_torch.core.config import DecoderConfig, tiny_test_config
from qwen_tts_tpu_torch.core.weights import (
    CodePredictorWeights,
    DecoderWeights,
    convert_tuple,
    from_jax,
    init_decoder_weights,
)
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.models.code_predictor import cp_predict
from qwen_tts_tpu_torch.parallel.launch import run_ranks
from qwen_tts_tpu_torch.runtime import frame_loop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh_ranks as ranks  # noqa: E402

SIZES = dict(num_layers=2, hidden_size=256, intermediate_size=512, num_q_heads=16,
             num_kv_heads=8, head_dim=128, vocab_size=3072, max_seq_len=64)
J_CFG, CFG = JDecoderConfig(**SIZES), DecoderConfig(**SIZES)
CP_CFG = dataclasses.replace(CFG, vocab_size=2048)
WORLD, LIMIT_S = 8, 120.0
TOKENS = [1, 2, 3, 4]
N_FRAMES, TOP_K = 3, 50


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _inputs(rng, jw, jtts):
    mc = tiny_test_config(max_seq_len=64)
    h, B = mc.talker.hidden_size, 4
    gen = torch.Generator().manual_seed(3)
    cp = CodePredictorWeights(
        decoder=init_decoder_weights(gen, CP_CFG, "cpu", with_heads=False),
        lm_heads=_bf(rng.standard_normal((15, 256, 2048)) / 16),
        codec_embeds=_bf(rng.standard_normal((15, 2048, 256))))
    return {
        "cfg": CFG, "decoder": convert_tuple(DecoderWeights, jw, "cpu"), "tokens": TOKENS,
        "cp_cfg": CP_CFG, "cp": cp, "cp_hidden": torch.from_numpy(
            rng.standard_normal(256).astype(np.float32)),
        "cp_embed": _bf(rng.standard_normal((3072, 256))),
        "mc": mc, "tts": from_jax(jtts, "cpu"),
        "prefill": _bf(rng.standard_normal((B, 8, h))),
        "trailing": _bf(rng.standard_normal((B, 4, h))),
        "tlen": torch.full((B,), 4, dtype=torch.int32),
        "pad": torch.zeros(h, dtype=torch.bfloat16),
        "uniform": torch.from_numpy(rng.random((B, N_FRAMES, 15, TOP_K)).astype(np.float32)),
    }


def _frames_logged(mc, tts, inp, rows: slice, force=None):
    """`ranks.quantized_frames` of the slots `rows`, logging each talker
    step's (token [B], logits [B, V], normed [B, H]) and each frame's code
    predictor (codes [B, 16], logits [B, 15, V]). `force` ({"tok": [...],
    "cp": [...]}, one entry a call) makes those calls return another run's
    choices, so the run sees that run's inputs all the way."""
    talker, cp, force = [], [], force or {}
    real_cp, real_step = frame_loop.cp_predict, frame_loop.decode_step_with_embed

    def cp_predict_(*a, **k):
        codes, logits = real_cp(*a, **{**k, "return_logits": True})
        cp.append((codes, logits))
        forced = force.get("cp", [])
        return forced[len(cp) - 1] if len(cp) <= len(forced) else codes

    def step(cfg, w, *a, **k):
        state, token, normed = real_step(cfg, w, *a, **k)
        talker.append((token, td.lm_head_logits(w, normed), normed))
        forced = force.get("tok", [])
        return state, (forced[len(talker) - 1] if len(talker) <= len(forced) else token), normed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frame_loop, "cp_predict", cp_predict_)
        mp.setattr(frame_loop, "decode_step_with_embed", step)
        out = ranks.quantized_frames(mc, tts, inp, rows)
    return out, cp, talker


def _rank_swap_gap(a: int, b: int, batch_logits, own_logits) -> float:
    """A sampled choice parted, code a alone and code b in the batch. The
    sampler adds the noise of each top-k rank to the code at that rank, so
    the runs part when rounding swaps two codes' ranks: the smallest gap in
    the batch's logits between a or b and the code that holds its rank in
    the other run (inf when neither code's rank moved)."""
    ob = torch.topk(batch_logits, TOP_K).indices.tolist()
    oo = torch.topk(own_logits, TOP_K).indices.tolist()
    gap = float("inf")
    for c in (a, b):
        for mine, theirs in ((ob, oo), (oo, ob)):
            if c in mine and theirs[mine.index(c)] != c:
                gap = min(gap, abs(float(batch_logits[c] - batch_logits[theirs[mine.index(c)]])))
    return gap


def _cosines(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-9)


def dp_split_readings(mc, tts, inp) -> dict:
    """The quantized tier's 4-slot batch against each slot run as a batch of
    its own, as a dp rank of (4, 2) serves it. Unforced: JAX's first-frame
    agreement and the slots equal end to end. Fed the batch's codes: the
    talker's hidden state at every step and, in each frame, the first
    choice the slot makes otherwise, with its gap (greedy code 0: the two
    codes' logit gap; a sampled code: `_rank_swap_gap`), and the share of
    choices equal before each frame's parting (a frame's later codes
    follow its parted one)."""
    (tok0, hid0, codes, _), bcp, btalk = _frames_logged(mc, tts, inp, slice(0, 4))
    alone = [ranks.quantized_frames(mc, tts, inp, slice(b, b + 1)) for b in range(4)]
    codes_a = np.concatenate([x[2] for x in alone])
    out = {"tok0": tok0, "hid0": hid0, "codes": codes, "alone": alone,
           "first_agree": float((codes_a[:, 0] == codes[:, 0]).mean()),
           "slots_equal": sum(np.array_equal(codes_a[b], codes[b]) for b in range(4)),
           "hidden_cos_min": 1.0, "partings": [], "agree_before_parting": 0.0}
    equal = choices = 0
    for b in range(4):
        force = {"cp": [c[b:b + 1] for c, _ in bcp], "tok": [t[b:b + 1] for t, _, _ in btalk]}
        _, ocp, otalk = _frames_logged(mc, tts, inp, slice(b, b + 1), force)
        out["hidden_cos_min"] = min(out["hidden_cos_min"], *(
            float(_cosines(o[2][0], t[2][b])) for o, t in zip(otalk, btalk)))
        for f in range(len(bcp)):
            own = [int(otalk[f][0][0]), *ocp[f][0][0, 1:].tolist()]
            want = [int(btalk[f][0][b]), *bcp[f][0][b, 1:].tolist()]
            g = next((g for g in range(16) if own[g] != want[g]), 16)
            equal, choices = equal + g, choices + 16
            if g == 16:
                continue
            if g == 0:
                lb = btalk[f][1][b]
                gap = abs(float(lb[own[0]] - lb[want[0]]))
            else:
                gap = _rank_swap_gap(own[g], want[g], bcp[f][1][b, g - 1], ocp[f][1][0, g - 1])
            out["partings"].append((b, f, g, gap))
    out["agree_before_parting"] = equal / choices
    return out


def _seeded_inputs(seed: int) -> tuple:
    """JAX's tiny TTS weights from PRNGKey(seed), as the port's, and the
    quantized tier's frame inputs from numpy's seed."""
    rng = np.random.default_rng(seed)
    mc, B = tiny_test_config(max_seq_len=64), 4
    h = mc.talker.hidden_size
    tts = from_jax(j_init_tts(jax.random.PRNGKey(seed), j_tiny(max_seq_len=64)), "cpu")
    inp = {"prefill": _bf(rng.standard_normal((B, 8, h))),
           "trailing": _bf(rng.standard_normal((B, 4, h))),
           "tlen": torch.full((B,), 4, dtype=torch.int32),
           "pad": torch.zeros(h, dtype=torch.bfloat16),
           "uniform": torch.from_numpy(rng.random((B, N_FRAMES, 15, TOP_K)).astype(np.float32))}
    return mc, tts, inp


def assert_dp_split(r: dict) -> None:
    """The bars on `dp_split_readings` (module docstring)."""
    assert r["hidden_cos_min"] > 0.999, r["hidden_cos_min"]
    for b, f, g, gap in r["partings"]:
        assert gap < 2e-2, (b, f, g, gap)
    assert r["agree_before_parting"] >= 0.5, r["agree_before_parting"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(per-rank results, references): the 8 ranks run while the parent
    computes the references."""
    rng = np.random.default_rng(0)
    jw = j_init_decoder(jax.random.PRNGKey(0), J_CFG)
    jtts = j_init_tts(jax.random.PRNGKey(0), j_tiny(max_seq_len=64))
    inp = _inputs(rng, jw, jtts)
    path = str(tmp_path_factory.mktemp("mesh") / "inputs.pt")
    torch.save(inp, path)
    with ThreadPoolExecutor(1) as pool:
        t0 = time.monotonic()
        fut = pool.submit(run_ranks, ranks.world8, WORLD, path, timeout_s=LIMIT_S)
        ref = {}
        # JAX: unsharded and tp=8 sharded step from token 7 (tests/test_sharding.py)
        state_u, tok_u, hid_u = jd.decode_step(J_CFG, jw, jd.init_state(J_CFG), jnp.int32(7))
        w_sh = jsh.shard_decoder_weights(j_make_mesh(dp=1, tp=8), jw)
        _, tok_s, hid_s = jax.jit(lambda w, s, t: jd.decode_step(J_CFG, w, s, t))(
            w_sh, jd.init_state(J_CFG), jnp.int32(7))
        ref["jax_tp8"] = (int(tok_u), np.asarray(hid_u), int(tok_s), np.asarray(hid_s))
        w = inp["decoder"]
        _, tok, hid = td.decode_step(CFG, w, td.init_state(CFG, "cpu"), torch.tensor([7]))
        ref["tp8"] = (int(tok), hid.numpy())
        ref["steps"] = [(int(t), h.numpy()) for t, h in (
            td.decode_step(CFG, w, td.init_state(CFG, "cpu"), torch.tensor([k]))[1:]
            for k in TOKENS)]
        ref["jax_steps"] = [(int(t), np.asarray(h)) for t, h in (
            jd.decode_step(J_CFG, jw, jd.init_state(J_CFG), jnp.int32(k))[1:]
            for k in TOKENS)]
        ref["cp"] = cp_predict(CP_CFG, inp["cp"], inp["cp_hidden"], torch.tensor(5),
                               inp["cp_embed"], do_sample=False, return_logits=True)
        ref["dp_split"] = dp_split_readings(inp["mc"], inp["tts"], inp)
        jmc = j_tiny(max_seq_len=64)
        _, jtok0, jhid0 = j_batched_prefill(
            jmc.talker, j_quantize(jtts.talker), jnp.asarray(inp["prefill"].float().numpy(),
                                                             jnp.bfloat16),
            kv_dtype=jnp.int8)
        ref["jax_prefill"] = (np.asarray(jtok0), np.asarray(jhid0))
        results = fut.result()
        ref["seconds"] = time.monotonic() - t0
    return results, ref


def test_world_finished_within_its_limit(world):
    results, ref = world
    assert len(results) == WORLD and ref["seconds"] < LIMIT_S


def test_mesh_shapes_and_refusal(world):
    results, _ = world
    for r, out in enumerate(results):
        assert out["mesh"] == ((2, 4), ("dp", "tp"), (r // 4, 2), (r % 4, 4))
        assert "3*3 != 8" in out["mesh_3x3"]


def test_tp_sharded_step_matches_unsharded_and_jax(world):
    results, ref = world
    tok, hid = ref["tp8"]
    jtok_u, jhid_u, jtok_s, jhid_s = ref["jax_tp8"]
    assert tok == jtok_u == jtok_s
    for out in results:
        t, h, kshape = out["tp8"]
        assert t == tok
        assert kshape == (CFG.num_layers, CFG.num_kv_heads // 8, CFG.max_seq_len, CFG.head_dim)
        np.testing.assert_allclose(h, hid, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(h, jhid_s, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(h, jhid_u, rtol=2e-3, atol=2e-3)


def test_tp_sharded_code_predictor_frame(world):
    results, ref = world
    codes, logits = ref["cp"]
    codes, logits = codes.numpy(), logits.numpy()
    for out in results:
        got = out["cp_tp8"]
        diff = np.flatnonzero(got != codes)
        if len(diff):
            g = int(diff[0])
            assert g >= 1
            top2 = np.sort(logits[g - 1])[-2:]
            assert top2[1] - top2[0] < 2e-2, (g, top2)
        else:
            np.testing.assert_array_equal(got, codes)


def test_dp_tp_batched_step_element_by_element(world):
    results, ref = world
    seen = set()
    for out in results:
        d, toks, hids, kshape = out["dp2tp4"]
        assert kshape == (2, CFG.num_layers, CFG.num_kv_heads // 4, CFG.max_seq_len,
                          CFG.head_dim)
        for i, (t, h) in enumerate(zip(toks, hids)):
            b = 2 * d + i
            seen.add(b)
            assert int(t) == ref["steps"][b][0] == ref["jax_steps"][b][0]
            np.testing.assert_allclose(h, ref["steps"][b][1], rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(h, ref["jax_steps"][b][1], rtol=2e-3, atol=2e-3)
    assert seen == set(range(len(TOKENS)))


def test_quantized_batched_frames_dp_sharded_matches_unsharded(world):
    results, ref = world
    r = ref["dp_split"]
    jtok0, jhid0 = ref["jax_prefill"]
    np.testing.assert_array_equal(r["tok0"], jtok0)
    by_dp = {}
    for out in results:
        d, (tok0, hid0, codes, valid), codes2 = out["qframes"]
        np.testing.assert_array_equal(codes, codes2)           # deterministic
        if d in by_dp:
            np.testing.assert_array_equal(codes, by_dp[d][2])   # tp replicates
        by_dp[d] = (tok0, hid0, codes)
        for got, want in zip((tok0, hid0, codes, valid), r["alone"][d]):
            np.testing.assert_array_equal(got, want)            # a batch of its own slot
    tok0 = np.concatenate([by_dp[d][0] for d in range(4)])
    hid0 = np.concatenate([by_dp[d][1] for d in range(4)])
    assert by_dp[0][2].shape == (1, N_FRAMES, 16)
    np.testing.assert_array_equal(tok0, r["tok0"])
    for a in (r["hid0"], jhid0):
        assert (_cosines(a, hid0) > 0.999).all(), _cosines(a, hid0)
    assert_dp_split(r)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dp_split_frames_part_only_at_rank_swaps(seed):
    """`dp_split_readings` on other weights and inputs: the bars hold
    beyond the world's seed."""
    r = dp_split_readings(*_seeded_inputs(seed))
    np.testing.assert_array_equal(np.concatenate([x[0] for x in r["alone"]]), r["tok0"])
    assert (_cosines(r["hid0"], np.concatenate([x[1] for x in r["alone"]])) > 0.999).all()
    assert_dp_split(r)


def test_synthesize_batch_on_a_mesh(world):
    results, _ = world
    first = results[0]["synth"][1]
    for out in results:
        d, res, alone, (requests, frames), sr, hop = out["synth"]
        assert len(res) == len(ranks.TEXTS) and requests == len(ranks.TEXTS)
        for (a, s), (b, _) in zip(res, first):
            assert s == sr and len(a) > 0 and len(a) % hop == 0
            np.testing.assert_array_equal(a, b)                 # every rank, all B
        assert frames == results[0]["synth"][3][1]
        n = len(ranks.TEXTS) // 4
        for (a, _), (b, _) in zip(res[d * n:(d + 1) * n], alone):
            np.testing.assert_array_equal(a, b)


def test_synthesize_batch_refuses_an_indivisible_batch(world):
    results, _ = world
    for out in results:
        msg, requests = out["divisible"]
        d = out["synth"][0]
        assert "divisible" in msg
        assert requests == d + 1          # the refused call numbered nothing


@pytest.mark.parametrize("step", ["decode_step", "forward_chunk"])
def test_a_tp_rank_refuses_the_decode_step_kernel(step):
    """The decode-step kernel computes whole layers: with a tp group it would
    return one rank's partial sums, so a tp rank's "mega" step raises."""
    from qwen_tts_tpu_torch.parallel.sharding import TensorParallel

    cfg = tiny_test_config(max_seq_len=64).talker
    w = init_decoder_weights(torch.Generator().manual_seed(0), cfg, "cpu")
    state = td.init_state(cfg, "cpu")
    tp = TensorParallel(group=None, size=2)
    with pytest.raises(ValueError, match="whole layers"):
        if step == "decode_step":
            td.decode_step(cfg, w, state, torch.tensor([1]), attn_impl="mega", tp=tp)
        else:
            td.forward_chunk(cfg, w, state, w.embed[:1].float(), attn_impl="mega", tp=tp)


def test_a_hung_rank_fails_within_its_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(ranks.hang, 2, timeout_s=15.0)
    assert time.monotonic() - t0 < 60
    with pytest.raises(RuntimeError, match="rank 1 refuses"):
        run_ranks(ranks.fail, 2, timeout_s=60.0)


def test_synthesize_batch_refuses_weights_on_another_card(monkeypatch):
    """An engine built before `make_mesh` bound the rank's card holds its
    weights on another card: `synthesize_batch(mesh=)` raises before it
    numbers a request instead of serving the rank's share there."""
    from types import SimpleNamespace

    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
    from qwen_tts_tpu_torch.parallel import mesh as pmesh

    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=64, seed=0, backend="dense"),
                    model_config=tiny_test_config(max_seq_len=64))
    eng.initialize()
    on_card_0 = SimpleNamespace(embed=SimpleNamespace(device=torch.device("cuda", 0)))
    eng.weights = eng.weights._replace(talker=on_card_0)
    monkeypatch.setattr(pmesh, "axis", lambda mesh, name: pmesh.Axis(0, 1, None))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(RuntimeError, match="make_mesh"):
        eng.synthesize_batch(["one text"], mesh=object())
    assert eng._requests == 0

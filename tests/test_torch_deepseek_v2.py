"""The port's DeepSeek-V2 text LM (`qwen_tts_tpu_torch/models/deepseek_v2.py`)
against the plain float32 reference (`tests/_deepseek_v2_reference.py`) on
the CPU, at a tiny size that keeps every mechanism: one dense and two MoE
layers, 8 routed experts at top-2 and a shared expert, a latent of 32, rope
dims 8 with YaRN (factor 40: the ramp between the correction dims 1 and 3
blends the two frequency sets).

The prefill and then single-token steps through the latent cache (the
absorbed MLA on the attention kernel's plain version, the expert kernel's
plain forms) are compared with the reference's full forward on logits.
Planted faults each fail that comparison. The driver's streams (chunks,
interleaving) give the ids of teacher-forced steps.
"""

import dataclasses
from pathlib import Path

import pytest
import torch

from qwen_tts_tpu_torch.models import deepseek_v2 as ds
from qwen_tts_tpu_torch.ops import mla_attention, moe
from tests import _deepseek_v2_reference as ref

CFG = ds.DeepseekV2Config(
    num_hidden_layers=3, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
    num_attention_heads=2, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
    first_k_dense_replace=1, vocab_size=128, max_position_embeddings=48)
PROMPT = [5, 17, 3, 99, 42, 7, 64, 1, 23, 88]
FORCED = [11, 2, 77, 30, 9, 120, 4, 56]     # teacher-forced ids after the prompt
# The largest logit difference over the reference's spread (std). The bf16
# program (weights, activations and cache in bf16, f32 sums) reads 0.034 at
# the prefill's row and up to 0.100 after eight steps (RMS 0.023): bf16
# rounding, since the same code with f32 activations reads below 2e-5. The
# planted faults read 0.99 (top-1 of 2) to 4.1 (rope pairing).
TOL = 0.25


def published(cfg: ds.DeepseekV2Config) -> dict:
    """The configuration as `config.json` names it (`rope_scaling` nested)."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if not f.name.startswith("yarn_")}
    d["rope_scaling"] = {f.name[5:]: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                         if f.name.startswith("yarn_")}
    return d


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tensors():
    gen = torch.Generator().manual_seed(0)
    t = ds.init_tensors(gen, CFG, "cpu")
    # queries and latents of this tiny width score ~0.1 apart: widen them so
    # that the softmax scale and the rope change the attention weights
    for name in ("wq", "wkv_a"):
        t[name] = (t[name].float() * 4).to(torch.bfloat16)
    return t


@pytest.fixture(scope="module")
def want(tensors):
    """The reference's logits of PROMPT + FORCED, from the prompt's last row."""
    w = {f"lm.{k}": v for k, v in tensors.items()}
    return ref.logits(w, published(CFG), PROMPT + FORCED)[len(PROMPT) - 1:]


def program_logits(tensors) -> torch.Tensor:
    """The program's logits: the prefill's last row, then each forced id's
    step through the cache (`forced_logits`, the benchmark check's path)."""
    lm = ds.DeepseekV2LM(ds.weights_from(tensors, CFG), CFG, device="cpu")
    return lm.forced_logits(PROMPT + FORCED, len(PROMPT))


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.std())


def test_prefill_and_cached_decode_match_the_reference(tensors, want):
    got = program_logits(tensors)
    assert got.shape == want.shape
    assert gap(got, want) < TOL


ROUTE = ds.route


def _top_k_minus_one(cfg, h, router):
    return ROUTE(dataclasses.replace(cfg, num_experts_per_tok=cfg.num_experts_per_tok - 1),
                    h, router)


def _renormalised(cfg, h, router):
    ids, w = ROUTE(cfg, h, router)
    return ids, w / w.sum(-1, keepdim=True)


def _no_mscale(cfg):
    return cfg.q_head_dim ** -0.5


def _half_split(x, cos, sin):
    d = x.shape[-1]
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1) * sin


def _no_shared(form):
    def run(x, h, ids, w, gu, down, sgu, sdown, count):
        return form(x, h, ids, w, gu, down, torch.zeros_like(sgu), sdown, count)
    return run


FAULTS = {
    "top_k_minus_one": lambda mp: mp.setattr(ds, "route", _top_k_minus_one),
    "renormalised_top_k": lambda mp: mp.setattr(ds, "route", _renormalised),
    "shared_expert_dropped": lambda mp: (
        mp.setattr(moe, "moe_experts_prefill", _no_shared(moe.moe_experts_prefill)),
        mp.setattr(moe, "moe_experts_decode", _no_shared(moe.moe_experts_decode))),
    "mscale_dropped": lambda mp: mp.setattr(ds, "softmax_scale", _no_mscale),
    "rope_not_interleaved": lambda mp: mp.setattr(ds, "rotate", _half_split),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_comparison(tensors, want, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert gap(program_logits(tensors), want) > 2 * TOL


def test_streams_give_the_teacher_forced_ids_and_the_reference_agrees(tensors):
    """`generate_stream` through the driver, in chunks and interleaved, gives
    the ids of greedy steps; each lies within the tolerance of the
    reference's best logit."""
    lm = ds.DeepseekV2LM(ds.weights_from(tensors, CFG), CFG, device="cpu")
    whole = [t for ids in lm.generate_stream(PROMPT, 9, chunk=4) for t in ids]
    a, b = lm.generate_stream(PROMPT, 9, chunk=3), lm.generate_stream(PROMPT[:6], 9, chunk=2)
    got_a, got_b = [], []
    for _ in range(5):
        got_a += next(a, [])
        got_b += next(b, [])
    got_a += [t for ids in a for t in ids]
    got_b += [t for ids in b for t in ids]
    assert got_a == whole and len(whole) == 9
    assert got_b == [t for ids in lm.generate_stream(PROMPT[:6], 9, chunk=9) for t in ids]
    assert lm.steps == 4 * 8 and lm.kernel_launches() == {
        "mla_decode_attn": 3 * lm.steps, "moe_experts_decode": 2 * lm.steps,
        "moe_experts_prefill": 2 * 4}
    w = {f"lm.{k}": v for k, v in tensors.items()}
    gaps = ref.reply_gaps(w, published(CFG), PROMPT, whole, None)
    logits = ref.logits(w, published(CFG), PROMPT + whole)
    assert float(gaps.max() / logits.std()) < TOL


def test_the_kernels_plain_forms_compute_only_the_chosen_experts(tensors):
    """The expert kernel's plain form equals each row's chosen experts and
    the shared expert summed by hand; the attention's plain form equals
    softmax attention over rows [0, position]."""
    gen = torch.Generator().manual_seed(1)
    h = torch.randn(3, 64, generator=gen).to(torch.bfloat16)
    ids = torch.tensor([[0, 5], [5, 7], [2, 0]])
    w = torch.rand(3, 2, generator=gen)
    gu, down = tensors["experts_gate_up"][0], tensors["experts_down"][0]
    sgu, sdown = tensors["shared_gate_up"][0], tensors["shared_down"][0]
    count = torch.zeros(1, dtype=torch.int64)
    got = moe.moe_experts_prefill(torch.zeros(3, 64), h, ids, w, gu, down, sgu, sdown, count)
    by_hand = torch.stack([
        moe.swiglu(h[t:t + 1].float(), sgu, sdown)[0]
        + sum(w[t, j] * moe.swiglu(h[t:t + 1].float(), gu[ids[t, j]], down[ids[t, j]])[0]
              for j in range(2)) for t in range(3)])
    torch.testing.assert_close(got, by_hand, rtol=1e-5, atol=1e-5)
    assert int(count) == 1

    cache = torch.randn(10, 40, generator=gen).to(torch.bfloat16)
    q_lat, q_pe = torch.randn(2, 32, generator=gen), torch.randn(2, 8, generator=gen)
    out = mla_attention.mla_decode_attention(q_lat, q_pe, cache, torch.tensor(6, dtype=torch.int32),
                                             0.3, None, count)
    kv = cache[:7].float()
    p = torch.softmax((q_lat @ kv[:, :32].t() + q_pe @ kv[:, 32:].t()) * 0.3, dim=-1)
    torch.testing.assert_close(out, p @ kv[:, :32])
    with pytest.raises(ValueError, match="outside"):
        mla_attention.mla_decode_attention(q_lat, q_pe, cache, torch.tensor(10, dtype=torch.int32),
                                           0.3, None, count)


def test_the_published_yarn_table_and_scale():
    """DeepSeek-V2-Lite's softmax scale 192 ** -0.5 * 1.2608 ** 2 and its cos
    / sin as the reference computes them."""
    cfg = ds.DeepseekV2Config(max_position_embeddings=256)
    assert abs(ds.softmax_scale(cfg) - 0.114721) < 1e-5
    assert ds.softmax_scale(cfg) == ref.softmax_scale(published(cfg))
    cos, sin = ds.rope_table(cfg, "cpu")
    rc, rs = ref.cos_sin(published(cfg), 256, "cpu")
    assert torch.equal(cos, rc) and torch.equal(sin, rs)


def test_the_benchmark_holds_a_byte_identical_copy_of_the_reference():
    here = Path(__file__).resolve().parent
    copy = here.parent / "h100_bench" / "reference" / "deepseek_v2.py"
    assert copy.read_bytes() == (here / "_deepseek_v2_reference.py").read_bytes()

"""The port's text LM (`qwen_tts_tpu_torch/models/text_lm.py`) against the
JAX package's, on the same numpy-seeded weights at the JAX tests' TINY_LM.

`TextLM.generate` and `generate_stream` give JAX's greedy tokens exactly on
"dense" and "pallas" (JAX's Pallas attention in interpret mode), bf16 and
int8 KV; the port's "mega" (on the CPU the decode-step kernel's plain
version, head fused) gives JAX's dense tokens, and one step of it is held
to JAX's `megakernel_forward` in interpret mode with the head inside the
kernel and outside it (`fuse_head`), logits at rtol 1e-4 (or cosine >
0.995 with the same argmax). `load_text_lm_weights` reads a synthetic
checkpoint written by the `safetensors` package into the bits JAX's loader
reads, with `transformers` blocked. The CUDA kernel at the text LM's width
is compared with its plain version on the card (`chip_smoke.py` phase 17).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import DecoderConfig as JConfig
from qwen_tts_tpu.core.weights import init_decoder_weights
from qwen_tts_tpu.models import decoder as jd
from qwen_tts_tpu.models import text_lm as jlm
from qwen_tts_tpu.ops import attention as jattn
from qwen_tts_tpu.ops import decode_step as jds
from qwen_tts_tpu_torch.core.config import DecoderConfig
from qwen_tts_tpu_torch.core.safetensors import save_file
from qwen_tts_tpu_torch.core.weights import DecoderWeights, convert_tuple, to_torch
from qwen_tts_tpu_torch.models import decoder as td
from qwen_tts_tpu_torch.models import text_lm as tlm
from qwen_tts_tpu_torch.ops import decode_step as tds

TINY = dict(num_layers=2, hidden_size=256, intermediate_size=512, num_q_heads=4,
            num_kv_heads=2, head_dim=128, vocab_size=1024, max_seq_len=128,
            rope_theta=10000.0)
J_TINY, T_TINY = JConfig(**TINY), DecoderConfig(**TINY)
PROMPT = [1, 2, 3, 4]
N_NEW = 17


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX weights, the port's copy), the head tied to the embedding."""
    jw = init_decoder_weights(jax.random.PRNGKey(0), J_TINY)
    jw = jw._replace(lm_head=jw.embed.T)
    return jw, tlm.tie_head(convert_tuple(DecoderWeights, jw, "cpu"))


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """JAX's "pallas" path with its Pallas attention in interpret mode, as
    the JAX package's own tests run it on the CPU."""
    monkeypatch.setattr(jattn, "decode_attention",
                        functools.partial(jattn.decode_attention, chunk=64, interpret=True))


def _port(w, impl="dense", kv="bf16"):
    return tlm.TextLM(w, T_TINY, attn_impl=impl, kv_cache=kv, device="cpu")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_generate_matches_jax(weights, impl, kv, request):
    jw, tw = weights
    if impl == "pallas":
        request.getfixturevalue("jax_pallas_interpret")
    want = jlm.TextLM(jw, J_TINY, attn_impl=impl, kv_cache=kv).generate(PROMPT, N_NEW)
    lm = _port(tw, impl, kv)
    assert lm.kv_dtype == (torch.int8 if kv == "int8" else torch.bfloat16)
    got = lm.generate(PROMPT, N_NEW)
    assert got == want
    assert lm.steps == N_NEW - 1


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mega_generate_matches_jax_dense(weights, kv):
    """The decode-step kernel's plain version (the head inside the step)
    gives JAX's tokens."""
    jw, tw = weights
    want = jlm.TextLM(jw, J_TINY, kv_cache=kv).generate(PROMPT, N_NEW)
    assert _port(tw, "mega", kv).generate(PROMPT, N_NEW) == want


@pytest.mark.parametrize("impl", ["dense", "pallas", "mega"])
def test_generate_stream_any_chunking_and_stop_ids(weights, impl):
    """Streamed ids are `generate`'s at every chunk size; a stop id ends the
    stream without being yielded, as in JAX's stream."""
    jw, tw = weights
    lm = _port(tw, impl)
    ref = lm.generate(PROMPT, N_NEW)
    for chunk in (1, 4, 5, 32):
        streamed = [t for b in lm.generate_stream(PROMPT, max_new_tokens=N_NEW, chunk=chunk)
                    for t in b]
        assert streamed == ref, chunk
    stop = ref[5]
    streamed = [t for b in lm.generate_stream(PROMPT, max_new_tokens=N_NEW, chunk=3,
                                              stop_ids=(stop,)) for t in b]
    want = [t for b in jlm.TextLM(jw, J_TINY).generate_stream(
        PROMPT, max_new_tokens=N_NEW, chunk=3, stop_ids=(stop,)) for t in b]
    assert streamed == want == ref[:ref.index(stop)]
    assert list(lm.generate_stream(PROMPT, chunk=3, stop_ids=(ref[0],))) == []


def test_tied_head_convention(weights):
    """lm_head = embed.T (reference: model.py:92), kept as a contiguous
    [H, V] copy for the kernel: a different embedding changes the head."""
    _, tw = weights
    assert tw.lm_head.is_contiguous() and tw.lm_head.shape == (256, 1024)
    assert torch.equal(tw.lm_head, tw.embed.t())
    other = tlm.tie_head(tw._replace(embed=tw.embed.flip(0)))
    assert torch.equal(other.lm_head, tw.embed.flip(0).t())
    assert len(_port(other).generate([5, 6], 4)) == 4


@pytest.mark.parametrize("fuse_head", [False, True])
def test_mega_step_matches_jax_megakernel(weights, fuse_head):
    """One step of the port's decode step (plain version, head fused) after
    a 4-id prefill against JAX's `megakernel_forward` in interpret mode,
    the head inside the Pallas kernel or after it."""
    jw, tw = weights
    js, jtok, _ = jd.prefill(J_TINY, jw, jd.init_state(J_TINY), jw.embed[jnp.asarray(PROMPT)])
    ts, ttok, _ = td.prefill(T_TINY, tw, td.init_state(T_TINY, "cpu"),
                             tw.embed[torch.tensor(PROMPT)])
    assert int(jtok) == int(ttok)
    for step in range(3):
        embed = np.asarray(jw.embed[int(jtok)].astype(jnp.float32))
        js, jl, jh = jds.megakernel_forward.__wrapped__(
            J_TINY, jw, js, jnp.asarray(embed), chunk=64, interpret=True,
            fuse_head=fuse_head)
        ts, tl, th = tds.megakernel_forward(T_TINY, tw, ts, torch.from_numpy(embed.copy()))
        jl, tl = np.asarray(jl), tl.numpy()
        cos = float(jl @ tl / (np.linalg.norm(jl) * np.linalg.norm(tl)))
        close = np.allclose(tl, jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())
        assert close or (cos > 0.995 and jl.argmax() == tl.argmax()), (step, cos)
        assert jl.argmax() == tl.argmax()
        jtok = int(jl.argmax())
    assert tds.megakernel_forward.launches == 0      # the CPU never launches


def _synthetic_checkpoint(path, cfg: DecoderConfig, seed: int):
    """A Qwen3 checkpoint of f32 tensors under the reference key names,
    written by the `safetensors` package."""
    from safetensors.numpy import save_file as np_save

    rng = np.random.default_rng(seed)
    H, I, Q, KV, D = (cfg.hidden_size, cfg.intermediate_size, cfg.q_size, cfg.kv_size,
                      cfg.head_dim)
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, H), "model.norm.weight": (H,)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (H,),
                       p + "post_attention_layernorm.weight": (H,),
                       p + "self_attn.q_norm.weight": (D,), p + "self_attn.k_norm.weight": (D,),
                       p + "self_attn.q_proj.weight": (Q, H), p + "self_attn.k_proj.weight": (KV, H),
                       p + "self_attn.v_proj.weight": (KV, H), p + "self_attn.o_proj.weight": (H, Q),
                       p + "mlp.gate_proj.weight": (I, H), p + "mlp.up_proj.weight": (I, H),
                       p + "mlp.down_proj.weight": (H, I)})
    np_save({k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in shapes.items()},
            str(path / "model.safetensors"))


def _leaves(w):
    return list(w.layers) + [w.final_norm, w.embed, w.lm_head, w.rope.cos, w.rope.sin]


def test_load_text_lm_weights_matches_jax_loader(tmp_path, monkeypatch):
    """Both loaders on one checkpoint, `transformers` blocked: the same bits
    in every leaf, the tied head, no tokenizer; and the port's writer
    (`text_lm_state_dict` + `save_file`) round-trips the port's weights."""
    monkeypatch.setitem(sys.modules, "transformers", None)   # import raises
    _synthetic_checkpoint(tmp_path, T_TINY, seed=3)
    jw, jtok = jlm.load_text_lm_weights(str(tmp_path), J_TINY, verbose=False)
    tw, ttok = tlm.load_text_lm_weights(str(tmp_path), T_TINY, device="cpu", verbose=False)
    assert jtok is None and ttok is None
    for a, b in zip(_leaves(jw), _leaves(tw)):
        a = to_torch(a, "cpu")
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert tw.lm_head.is_contiguous()

    out = tmp_path / "round_trip"
    out.mkdir()
    save_file(tlm.text_lm_state_dict(tw, T_TINY), str(out / "model.safetensors"))
    back, _ = tlm.load_text_lm_weights(str(out), T_TINY, device="cpu", verbose=False)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tw), _leaves(back)))


def test_text_lm_checks_its_arguments(weights):
    _, tw = weights
    with pytest.raises(ValueError, match="attn_impl"):
        tlm.TextLM(tw, T_TINY, attn_impl="xla", device="cpu")
    with pytest.raises(ValueError, match="kv_cache"):
        tlm.TextLM(tw, T_TINY, kv_cache="fp8", device="cpu")
    with pytest.raises(ValueError, match="weights are on"):
        tlm.TextLM(tw, T_TINY, device="meta")

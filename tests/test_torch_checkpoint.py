"""Checkpoint loading in the port, against the JAX package's loaders.

On synthetic files with the reference key names (as
`test_checkpoint_loading.py` builds them): the port's safetensors reader
against `safetensors.numpy` (bf16 compared as bit patterns) and its
refusal of malformed headers; `load_tts_weights` and
`load_speaker_encoder` against JAX's, leaf for leaf, bit for bit; the
vocoder loaders against JAX's in every case that loads and every case that
degrades to None; and an engine built from `model_path` against one handed
the same weights."""

import dataclasses
import json
import struct
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from qwen_tts_tpu.core import weights as jweights
from qwen_tts_tpu.core.config import (
    DecoderConfig,
    TextProjectionConfig,
    TTSModelConfig,
)
from qwen_tts_tpu.vocoder import code2wav as jc2w
from qwen_tts_tpu.vocoder import loader as jloader
from qwen_tts_tpu.vocoder import model as jvoc
from qwen_tts_tpu_torch.core import config as tcfg
from qwen_tts_tpu_torch.core import safetensors as tst
from qwen_tts_tpu_torch.core.weights import (
    from_jax,
    init_tts_weights,
    load_speaker_encoder,
    load_tts_weights,
    tts_state_dict,
)
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.vocoder import code2wav as tc2w
from qwen_tts_tpu_torch.vocoder import loader as tloader
from qwen_tts_tpu_torch.vocoder import model as tvoc

_DEC = dict(num_layers=2, hidden_size=64, intermediate_size=96, num_q_heads=4,
            num_kv_heads=2, head_dim=16)
_TP = dict(text_vocab_size=80, text_hidden_size=32, hidden_size=64)
TALKER = DecoderConfig(**_DEC, vocab_size=48, max_seq_len=32)
CP = DecoderConfig(**_DEC, vocab_size=40, max_seq_len=16)
MC = TTSModelConfig(talker=TALKER, code_predictor=CP, text_projection=TextProjectionConfig(**_TP))
TMC = tcfg.TTSModelConfig(talker=tcfg.DecoderConfig(**_DEC, vocab_size=48, max_seq_len=32),
                          code_predictor=tcfg.DecoderConfig(**_DEC, vocab_size=40, max_seq_len=16),
                          text_projection=tcfg.TextProjectionConfig(**_TP))
VOC = dict(codebook_size=16, dim=32, prenet_blocks=1, upsample_factors=(2, 2),
           upsample_kernels=(4, 4))
C2W = dict(codebook_size=32, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
           sliding_window=5, intermediate_size=96, num_hidden_layers=2, num_quantizers=4,
           upsample_rates=(4, 3), upsampling_ratios=(2,), decoder_dim=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer_tensors(rng, prefix, i, cfg):
    """One layer's tensors in torch layout ([out_features, in_features])."""
    h, q, kv, inter, d = (cfg.hidden_size, cfg.q_size, cfg.kv_size, cfg.intermediate_size,
                          cfg.head_dim)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {f"{prefix}{i}.input_layernorm.weight": f(h),
            f"{prefix}{i}.self_attn.q_proj.weight": f(q, h),
            f"{prefix}{i}.self_attn.k_proj.weight": f(kv, h),
            f"{prefix}{i}.self_attn.v_proj.weight": f(kv, h),
            f"{prefix}{i}.self_attn.q_norm.weight": f(d),
            f"{prefix}{i}.self_attn.k_norm.weight": f(d),
            f"{prefix}{i}.self_attn.o_proj.weight": f(h, q),
            f"{prefix}{i}.post_attention_layernorm.weight": f(h),
            f"{prefix}{i}.mlp.gate_proj.weight": f(inter, h),
            f"{prefix}{i}.mlp.up_proj.weight": f(inter, h),
            f"{prefix}{i}.mlp.down_proj.weight": f(h, inter)}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reduced model.safetensors (f32) with the full reference key set, a
    speaker encoder beside it, written by `safetensors.numpy`."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    h, tp = TALKER.hidden_size, MC.text_projection
    state = {}
    for i in range(TALKER.num_layers):
        state.update(_layer_tensors(rng, "talker.model.layers.", i, TALKER))
        state.update(_layer_tensors(rng, "talker.code_predictor.model.layers.", i, CP))
    state.update({
        "talker.model.norm.weight": f(h),
        "talker.model.codec_embedding.weight": f(TALKER.vocab_size, h),
        "talker.codec_head.weight": f(TALKER.vocab_size, h),
        "talker.code_predictor.model.norm.weight": f(h),
        "talker.model.text_embedding.weight": f(tp.text_vocab_size, tp.text_hidden_size),
        "talker.text_projection.linear_fc1.weight": f(tp.text_hidden_size, tp.text_hidden_size),
        "talker.text_projection.linear_fc1.bias": f(tp.text_hidden_size),
        "talker.text_projection.linear_fc2.weight": f(tp.hidden_size, tp.text_hidden_size),
        "talker.text_projection.linear_fc2.bias": f(tp.hidden_size),
        "speaker_encoder.proj.weight": f(8, 8),
        "speaker_encoder.proj.bias": f(8)})
    for g in range(15):
        state[f"talker.code_predictor.lm_head.{g}.weight"] = f(CP.vocab_size, h)
        state[f"talker.code_predictor.model.codec_embedding.{g}.weight"] = f(CP.vocab_size, h)
    d = tmp_path_factory.mktemp("ckpt")
    st_save(state, str(d / "model.safetensors"))
    return str(d)


def _leaves(tree, prefix=""):
    if tree is None or isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    items = tree._asdict().items() if hasattr(tree, "_fields") else enumerate(tree)
    for k, v in items:
        out.update(_leaves(v, f"{prefix}.{k}"))
    return out


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert torch.equal(la[k], lb[k]), k


def test_load_tts_weights_equals_jax(checkpoint):
    """Leaf for leaf, bit for bit: the bf16 casts, transposes, q|k|v and
    gate|up fusion, the zero CP embed and head, and the rope tables."""
    want = from_jax(jweights.load_tts_weights(checkpoint, MC, verbose=False), "cpu")
    got = load_tts_weights(checkpoint, TMC, "cpu", verbose=False)
    _assert_trees_equal(got, want)
    assert got.talker.layers.wqkv.dtype == torch.bfloat16


def test_load_speaker_encoder_equals_jax(checkpoint):
    want = jweights.load_speaker_encoder(checkpoint)
    got = load_speaker_encoder(checkpoint, "cpu")
    assert set(got) == set(want) == {"speaker_encoder.proj.weight", "speaker_encoder.proj.bias"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def _bits(a) -> np.ndarray:
    """An array's bits: 16-bit floats as uint16, the rest as they are."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype.itemsize == 2 and a.is_floating_point() \
            else a.numpy()
    return a.view(np.int16) if a.dtype in (ml_dtypes.bfloat16, np.float16) else a


@pytest.mark.parametrize("writer", ["safetensors", "port"])
def test_reader_equals_safetensors_numpy(checkpoint, tmp_path, writer):
    """The port's reader on the checkpoint, and on a file of every dtype
    it reads (bf16, f16, f32, i32, i64, u8, bool, an empty and a 0-d
    tensor) written by either writer, equals `safetensors.numpy`."""
    rng = np.random.default_rng(1)
    tensors = {"bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
               "f16": rng.standard_normal(7).astype(np.float16),
               "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
               "i32": rng.integers(-9, 9, 5).astype(np.int32),
               "i64": rng.integers(-9, 9, (2, 2)).astype(np.int64),
               "u8": rng.integers(0, 255, 9).astype(np.uint8),
               "bool": rng.integers(0, 2, 3).astype(bool),
               "empty": np.zeros((0, 4), np.float32),
               "scalar": np.asarray(2.5, np.float32)}
    path = str(tmp_path / "all.safetensors")
    (st_save if writer == "safetensors" else tst.save_file)(tensors, path)
    for p in (path, f"{checkpoint}/model.safetensors"):
        want, got = st_load(p), tst.load_file(p)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


def _raw_file(path, header: dict, data: bytes):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["overlap", "past_end", "size", "dtype", "header_past_end"])
def test_reader_refuses_malformed_headers(tmp_path, case):
    a = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    b = {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}
    header = {"overlap": {"a": a, "b": {**b, "data_offsets": [4, 12]}},
              "past_end": {"a": a, "b": {**b, "data_offsets": [8, 24], "shape": [4]}},
              "size": {"a": {**a, "shape": [3]}},
              "dtype": {"a": {**a, "dtype": "F8"}},
              "header_past_end": {"a": a}}[case]
    path = str(tmp_path / "bad.safetensors")
    _raw_file(path, header, bytes(16))
    if case == "header_past_end":
        with open(path, "r+b") as f:
            f.write(struct.pack("<Q", 10 ** 6))
    with pytest.raises(ValueError):
        tst.SafeTensorsFile(path)


# ── vocoder loaders ──────────────────────────────────────────────────────


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in jloader._flatten(tree).items()}


@pytest.fixture(scope="module")
def voc_state():
    """A small "fast" vocoder's flat state (the repo's own key names)."""
    w = jvoc.init_vocoder_weights(jax.random.PRNGKey(3), jvoc.VocoderConfig(**VOC))
    return _np_tree(w)


def _voc_case(state, case):
    if case == "native":
        return state
    if case == "prefixed":
        return {f"model.{k}": v for k, v in state.items()}
    if case == "by_shape":                           # one leaf under an unknown name
        out = dict(state)
        out["external.out.kernel"] = out.pop("out_kernel")
        return out
    if case == "ambiguous":                          # two same-shape leaves renamed
        out = dict(state)
        out["x.a"], out["x.b"] = out.pop("prenet.0.pw1_b"), out.pop("stages.0.ct_bias") + 0
        out["x.c"] = np.zeros_like(out["x.a"])
        return out
    if case == "collapse":                           # 'model.x' and 'x'
        return {**state, "model.out_bias": state["out_bias"]}
    if case == "wrong_shape":
        return {**state, "out_bias": np.zeros(3, np.float32)}
    raise ValueError(case)


@pytest.mark.parametrize("case", ["native", "prefixed", "by_shape", "ambiguous", "collapse",
                                  "wrong_shape", "missing_file"])
def test_load_vocoder_equals_jax(tmp_path, voc_state, case):
    """The "fast" vocoder's loader against JAX's: the same tree where JAX's
    loads, None where JAX's gives None (ambiguous shape, two keys that
    collapse to one name, a wrong shape, no file)."""
    path = str(tmp_path / "vocoder.safetensors")
    if case != "missing_file":
        st_save(_voc_case(voc_state, case), path)
    want = jloader.load_vocoder(str(tmp_path), jvoc.VocoderConfig(**VOC))
    got = tloader.load_vocoder(str(tmp_path), tvoc.VocoderConfig(**VOC), "cpu")
    assert (got is None) == (want is None), case
    assert (want is None) == (case in ("ambiguous", "collapse", "wrong_shape", "missing_file"))
    if want is not None:
        _assert_trees_equal(got, tvoc.vocoder_from_jax(want, "cpu"))


def test_save_vocoder_round_trip(tmp_path):
    """The port's writer, read back by the port's loader and by JAX's."""
    w = tvoc.init_vocoder_weights(4, tvoc.VocoderConfig(**VOC), "cpu")
    path = str(tmp_path / "v.safetensors")
    tloader.save_vocoder(path, w)
    _assert_trees_equal(tloader.load_vocoder(path, tvoc.VocoderConfig(**VOC), "cpu"), w)
    _assert_trees_equal(tvoc.vocoder_from_jax(
        jloader.load_vocoder(path, jvoc.VocoderConfig(**VOC)), "cpu"), w)


@pytest.fixture(scope="module")
def c2w_state():
    """A tiny Code2Wav's torch state_dict (numpy, torch key names)."""
    w = tc2w.init_code2wav_weights(5, tc2w.Code2WavConfig(**C2W), "cpu")
    return {k: v.numpy().copy() for k, v in tc2w.code2wav_state(
        w, tc2w.Code2WavConfig(**C2W)).items()}


@pytest.mark.parametrize("case", ["file", "dir", "prefixed", "nested_prefixes", "collapse",
                                  "wrong_dims", "missing_key", "missing_file"])
def test_load_code2wav_equals_jax(tmp_path, c2w_state, case):
    """Code2Wav's loader against JAX's: the torch module's own keys (the
    top-level `decoder.` kept), from a file or a directory, under wrapper
    prefixes; None for two keys that collapse to one name, wrong dims, a
    missing key, no file."""
    state = dict(c2w_state)
    if case == "prefixed":
        state = {f"speech_tokenizer.{k}": v for k, v in state.items()}
    elif case == "nested_prefixes":
        state = {f"speech_tokenizer.model.code2wav.{k}": v for k, v in state.items()}
    elif case == "collapse":
        state["model.decoder.0.conv.weight"] = state["decoder.0.conv.weight"]
    elif case == "wrong_dims":
        state["code_embedding.weight"] = np.zeros((3, 3), np.float32)
    elif case == "missing_key":
        del state["pre_transformer.norm.weight"]
    path = tmp_path / "code2wav.safetensors"
    if case != "missing_file":
        st_save(state, str(path))
    where = str(tmp_path) if case == "dir" else str(path)
    want = jloader.load_code2wav(where, jc2w.Code2WavConfig(**C2W))
    got = tloader.load_code2wav(where, tc2w.Code2WavConfig(**C2W), "cpu")
    assert (got is None) == (want is None), case
    assert (want is None) == (case in ("collapse", "wrong_dims", "missing_key", "missing_file"))
    if want is not None:
        _assert_trees_equal(got, tc2w.code2wav_from_jax(want, "cpu"))


# ── the engine ───────────────────────────────────────────────────────────


def test_engine_from_model_path_equals_engine_given_the_weights(tmp_path, monkeypatch):
    """A tiny engine built from `model_path` (a checkpoint the port's writer
    made under the reference key names) streams the codes and audio of an
    engine handed the same weights; without `transformers`, as on the GPU
    host, the tokenizer falls back to the byte tokenizer."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    mc = tcfg.tiny_test_config(max_seq_len=128)
    w = init_tts_weights(6, mc, "cpu")
    tst.save_file(tts_state_dict(w, mc), str(tmp_path / "model.safetensors"))
    loaded = load_tts_weights(str(tmp_path), mc, "cpu", verbose=False)
    _assert_trees_equal(loaded, w)
    kw = dict(device="cpu", max_seq_len=128, chunk_frames=4, seed=2, max_new_tokens=9)
    a = TTSEngine(TTSConfig(model_path=str(tmp_path), **kw), model_config=mc)
    b = TTSEngine(TTSConfig(**kw), model_config=mc)
    a.initialize()
    b.initialize(weights=w)
    assert type(a.tokenizer).__name__ == "FallbackTokenizer"
    ca = list(a._generate_chunks("hello world", 4, with_audio=True))
    cb = list(b._generate_chunks("hello world", 4, with_audio=True))
    assert [len(f) for _x, f in ca] == [len(f) for _x, f in cb]
    np.testing.assert_array_equal(np.stack([f for _x, fr in ca for f in fr]),
                                  np.stack([f for _x, fr in cb for f in fr]))
    for (x, _), (y, _) in zip(ca, cb):
        np.testing.assert_array_equal(x, y)


def test_tts_config_fields_equal_jax():
    """The port's TTSConfig has every field of JAX's, with the same default
    (`device` apart)."""
    from qwen_tts_tpu.engine.tts_engine import TTSConfig as JConfig

    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TTSConfig)}
    assert tf.pop("device") == "cuda"
    assert tf == jf

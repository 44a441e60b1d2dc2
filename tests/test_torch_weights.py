"""The port's weight bridge and its independence from JAX.

`from_jax` must carry every parameter of the JAX package across bit for bit
(bf16 as its uint16 pattern), and the port must import on a machine that
has no JAX at all."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from qwen_tts_tpu.core.config import tiny_test_config
from qwen_tts_tpu.vocoder.model import VocoderConfig as JVocoderConfig
from qwen_tts_tpu.vocoder.model import init_vocoder_weights as j_init_vocoder
from qwen_tts_tpu_torch.core import weights as tw
from qwen_tts_tpu_torch.vocoder.model import vocoder_from_jax

REPO = Path(__file__).resolve().parent.parent


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bit_exact(jax_tree, torch_tree):
    j_leaves = jax.tree_util.tree_leaves(jax_tree)
    t_leaves = jax.tree_util.tree_leaves(torch_tree)
    assert len(j_leaves) == len(t_leaves) > 0
    for a, b in zip(j_leaves, t_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.dtype.itemsize == b.element_size()
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_from_jax_bit_exact(tiny_weights):
    port = tw.from_jax(tiny_weights, "cpu")
    assert isinstance(port, tw.TTSWeights)
    assert port.talker.layers.wqkv.dtype == torch.bfloat16
    assert port.talker.rope.cos.dtype == torch.float32
    _assert_bit_exact(tiny_weights, port)


def test_vocoder_from_jax_bit_exact():
    cfg = JVocoderConfig(dim=32, prenet_blocks=2)
    jw = j_init_vocoder(jax.random.PRNGKey(3), cfg)
    _assert_bit_exact(jw, vocoder_from_jax(jw, "cpu"))


def test_rope_table_matches_jax():
    from qwen_tts_tpu.core.weights import make_rope_table as j_rope

    cfg = tiny_test_config(max_seq_len=64).talker
    for c in (cfg, cfg.__class__(**{**cfg.__dict__, "mrope_section": (24, 20, 20)})):
        jr, tr = j_rope(c), tw.make_rope_table(c, "cpu")
        np.testing.assert_array_equal(np.asarray(jr.cos), tr.cos.numpy())
        np.testing.assert_array_equal(np.asarray(jr.sin), tr.sin.numpy())


def test_init_tts_weights_seeded_layout():
    cfg = tiny_test_config(max_seq_len=64)
    a = tw.init_tts_weights(5, cfg, "cpu")
    b = tw.init_tts_weights(5, cfg, "cpu")
    c = tw.init_tts_weights(6, cfg, "cpu")
    t = cfg.talker
    assert a.talker.layers.wqkv.shape == (t.num_layers, t.hidden_size,
                                          t.q_size + 2 * t.kv_size)
    assert a.talker.layers.w_gate_up.shape == (t.num_layers, t.hidden_size,
                                               2 * t.intermediate_size)
    assert a.code_predictor.lm_heads.shape == (15, cfg.code_predictor.hidden_size,
                                               cfg.code_predictor.vocab_size)
    assert not a.code_predictor.decoder.lm_head.any()      # CP head is zeros
    assert torch.equal(a.talker.layers.wqkv, b.talker.layers.wqkv)
    assert not torch.equal(a.talker.layers.wqkv, c.talker.layers.wqkv)


_BLOCK_JAX = """
import importlib.abc, sys
class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, NoJax())
import qwen_tts_tpu_torch
import qwen_tts_tpu_torch.engine.tts_engine
import qwen_tts_tpu_torch.ops.decode_step
import qwen_tts_tpu_torch.runtime.frame_loop
import qwen_tts_tpu_torch.vocoder.model
assert not any(m.split('.')[0] in ('jax', 'jaxlib') for m in sys.modules)
print('ok')
"""


def test_port_imports_without_jax():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pkg = REPO / "qwen_tts_tpu_torch"
    sources = [p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts]
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) > 10
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "jaxlib"), (path, line)


@pytest.mark.parametrize("ml", [True, False])
def test_to_torch_dtypes(ml):
    import ml_dtypes

    x = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    if ml:
        x = x.astype(ml_dtypes.bfloat16)
    t = tw.to_torch(x, "cpu")
    assert t.dtype == (torch.bfloat16 if ml else torch.float32)
    np.testing.assert_array_equal(_bits(x), _bits(t))

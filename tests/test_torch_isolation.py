"""The port stands alone: it imports neither JAX nor the JAX package, keeps
copies of the host-only modules it needs that equal the JAX package's, and
runs on the GPU unless asked for the CPU."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen_tts_tpu.core import config as jcfg
from qwen_tts_tpu.engine import tokenizer as jtok
from qwen_tts_tpu_torch.core import config as tcfg
from qwen_tts_tpu_torch.engine import tokenizer as ttok
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL_BLOCKED = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = tuple(sys.argv[1:])
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import qwen_tts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(qwen_tts_tpu_torch.__path__,
                                              'qwen_tts_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m.split('.')[0] in BLOCKED for m in sys.modules), sorted(sys.modules)
print(" ".join(names))
"""
_JAX = ("jax", "jaxlib", "qwen_tts_tpu")


def _import_all(*blocked: str) -> list[str]:
    """Import every module of the port and `chip_smoke` in a fresh process
    with `blocked` packages refused; the module names."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL_BLOCKED, *blocked], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_port_imports_nothing_of_jax_or_the_jax_package():
    names = _import_all(*_JAX)
    assert len(names) >= 20          # every module was imported
    assert {"qwen_tts_tpu_torch.core.safetensors", "qwen_tts_tpu_torch.vocoder.code2wav",
            "qwen_tts_tpu_torch.vocoder.code2wav_fast",
            "qwen_tts_tpu_torch.vocoder.loader", "qwen_tts_tpu_torch.runtime.batch",
            "qwen_tts_tpu_torch.runtime.continuous"} <= set(names)


def test_port_imports_no_file_or_tokenizer_library_at_module_level():
    """The GPU host has neither `safetensors` nor `transformers`: the port
    reads checkpoints itself and imports the tokenizer and hub libraries
    only inside the calls that use them."""
    assert len(_import_all(*_JAX, "safetensors", "transformers", "huggingface_hub")) >= 20


def test_smoke_blocker_refuses_jax_and_the_jax_package():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    blocker = chip_smoke._NoJax()
    for name in ("jax", "jax.numpy", "jaxlib", "qwen_tts_tpu", "qwen_tts_tpu.core.config"):
        with pytest.raises(ImportError):
            blocker.find_spec(name)
    assert blocker.find_spec("qwen_tts_tpu_torch.core.config") is None
    assert blocker.find_spec("torch") is None


@pytest.mark.parametrize("make", ["DecoderConfig", "TTSModelConfig", "tiny_test_config",
                                  "TALKER_CONFIG", "CODE_PREDICTOR_CONFIG"])
def test_config_copy_equals_jax(make):
    a, b = getattr(jcfg, make), getattr(tcfg, make)
    a, b = (a() if callable(a) else a), (b() if callable(b) else b)
    assert type(a) is not type(b)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_token_constants_equal_jax():
    names = [n for n in dir(jcfg) if n.isupper() and isinstance(getattr(jcfg, n), int)
             and n.startswith(("CODEC_", "TTS_", "NUM_", "CODE_PREDICTOR_"))]
    assert len(names) >= 12
    for n in names:
        assert getattr(tcfg, n) == getattr(jcfg, n), n


@pytest.mark.parametrize("text", ["Hello from the GPU.", "", "ünïcode <|im_end|> text\n"])
def test_tokenizer_copy_equals_jax(text):
    a = jtok.encode_tts_prompt(jtok.load_tokenizer(None), text)
    b = ttok.encode_tts_prompt(ttok.load_tokenizer(None), text)
    np.testing.assert_array_equal(a, b)
    assert ttok.FallbackTokenizer().decode(b) == jtok.FallbackTokenizer().decode(a)


def test_engine_defaults_to_the_gpu():
    assert TTSConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default engine runs on it")
    eng = TTSEngine(TTSConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.initialize()

"""Vocoder weight files: save, load, convert.

Port of `qwen_tts_tpu/vocoder/loader.py`, on the port's own safetensors
reader (`core/safetensors.py`). Two sources load:
  1. the repo's own flat-key files (`save_vocoder`: a tree's field names
     and tuple indices joined by dots), matched key for key;
  2. `convert_vocoder_state`, a best-effort mapper for external
     checkpoints: keys lose one known wrapper prefix (`speech_tokenizer.`,
     `model.`, `decoder.`), match by name, then by unique shape.
Code2Wav loads from the torch module's state_dict key names
(`load_code2wav`). Every loader returns None on a missing file, two source
keys that collapse to one name, a leaf that is ambiguous by shape, or
shapes that disagree with the config: the engine then falls back to
random weights or silence (`TTSConfig.vocoder_mode`).
"""

from __future__ import annotations

import os

import torch

from ..core.safetensors import load_file, save_file
from .code2wav import (
    Code2WavConfig,
    Code2WavWeights,
    named_leaves,
    convert_code2wav_state,
    init_code2wav_weights,
)
from .model import VocoderConfig, VocoderWeights, init_vocoder_weights

_STRIP_PREFIXES = ("speech_tokenizer.", "model.", "decoder.")
# A failed load of any of these kinds degrades to None
_LOAD_ERRORS = (OSError, ValueError, KeyError, RuntimeError, TypeError)


def _rebuild(template, flat: dict[str, torch.Tensor], device):
    """A tree like `template` (leaves give the dtype) from flat dotted keys."""
    def rec(tree, prefix):
        if isinstance(tree, torch.Tensor):
            return flat[prefix[:-1]].to(device=device, dtype=tree.dtype, copy=True)
        if hasattr(tree, "_fields"):
            return type(tree)(*(rec(getattr(tree, n), f"{prefix}{n}.") for n in tree._fields))
        return tuple(rec(t, f"{prefix}{i}.") for i, t in enumerate(tree))
    return rec(template, "")


def _template(cfg: VocoderConfig) -> VocoderWeights:
    return init_vocoder_weights(0, cfg, "meta")


def save_vocoder(path: str, w) -> None:
    """Write a vocoder tree under its flat dotted keys."""
    save_file(dict(named_leaves(w)), path)


def _normalize_keys(state: dict) -> dict | None:
    """Strip at most one wrapper prefix a key (stripping them all would map
    'model.decoder.x' and 'x' to one name). None when two source keys
    normalize to one name: a dict would drop one of them silently, and its
    leaf could then bind a wrong tensor by shape."""
    out = {}
    for k, v in state.items():
        for p in _STRIP_PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
                break
        if k in out:
            return None
        out[k] = v
    return out


def convert_vocoder_state(state: dict, cfg: VocoderConfig,
                          device="cuda") -> VocoderWeights | None:
    """Map an external flat state dict onto the "fast" vocoder's tree: each
    leaf by its key after prefix normalization, else by the one unclaimed
    tensor of its shape. None unless every leaf resolves without ambiguity."""
    template = _template(cfg)
    ref = dict(named_leaves(template))
    src = _normalize_keys(state)
    if src is None:
        return None
    resolved, unclaimed, missing = {}, dict(src), []
    for key, proto in ref.items():
        if key in unclaimed:
            if tuple(unclaimed[key].shape) != tuple(proto.shape):
                return None
            resolved[key] = unclaimed.pop(key)
        else:
            missing.append(key)
    for key in missing:
        shape = tuple(ref[key].shape)
        candidates = [k for k, v in unclaimed.items() if tuple(v.shape) == shape]
        if len(candidates) != 1:
            return None
        resolved[key] = unclaimed.pop(candidates[0])
    return _rebuild(template, resolved, device)


def load_vocoder(path: str, cfg: VocoderConfig, device="cuda") -> VocoderWeights | None:
    """The "fast" vocoder from `<path>` (a file) or `<path>/vocoder.safetensors`:
    the repo's own format first, then `convert_vocoder_state`. None on any
    failure."""
    if os.path.isdir(path):
        path = os.path.join(path, "vocoder.safetensors")
    if not os.path.exists(path):
        return None
    try:
        flat = load_file(path)
        template = _template(cfg)
        ref = dict(named_leaves(template))
        if set(ref) == set(flat):
            if any(tuple(flat[k].shape) != tuple(ref[k].shape) for k in ref):
                return None
            return _rebuild(template, flat, device)
        return convert_vocoder_state(flat, cfg, device)
    except _LOAD_ERRORS:
        return None


def load_code2wav(path: str, cfg: Code2WavConfig, device="cuda") -> Code2WavWeights | None:
    """Code2Wav weights (f32) from `<path>` (a file) or
    `<path>/code2wav.safetensors`, under the torch module's state_dict names
    (modeling_qwen3_omni_moe.py:3704-3736), each key stripped of the
    wrappers `speech_tokenizer.`, `model.` and `code2wav.` (not `decoder.`,
    a key of the module's own). None on any failure, on two keys that
    collapse to one name, and on shapes other than the config's."""
    if path and os.path.isdir(path):
        path = os.path.join(path, "code2wav.safetensors")
    if not path or not os.path.exists(path):
        return None
    try:
        normalized = {}
        for k, v in load_file(path).items():
            for p in ("speech_tokenizer.", "model.", "code2wav."):
                if k.startswith(p):
                    k = k[len(p):]
            if k in normalized:
                return None
            normalized[k] = v
        w = convert_code2wav_state(normalized, cfg, device)
        want = dict(named_leaves(init_code2wav_weights(0, cfg, "meta")))
        ok = all(tuple(t.shape) == tuple(want[p].shape) for p, t in named_leaves(w))
        return w if ok else None
    except _LOAD_ERRORS:
        return None

"""The Qwen3-0.6B text language model on the port's decoder core.

Port of `qwen_tts_tpu/models/text_lm.py`: the 28-layer decoder of the TTS
talker with the 151,936-id text vocabulary, embeddings tied to the LM head
(`lm_head = embed.T`) and rope theta 10,000. One decoder implementation
serves the three model families (text LM, talker, code predictor).

The decode-step kernel (`ops/decode_step.py`, backend "mega") keeps the
head inside its one launch at this vocabulary too: the JAX package moves a
head above `HEAD_FUSE_LIMIT_MB` out of its Pallas kernel because it does
not fit VMEM, a TPU rule the port does not have. The kernel streams the
head as a contiguous `[H, V]` matrix in 64-column tiles, so the tied head
is kept as its own contiguous copy of `embed.T` (311 MB in bf16 beside the
embedding's 311 MB) rather than a view of the `[V, H]` embedding; the
product is the same (bf16 inputs, f32 accumulation, argmax of the f32
logits).

`TextLM.generate` prefills the prompt densely and then runs greedy
single-token steps; `generate_stream` yields them `chunk` at a time, each
chunk a loop of steps enqueued without a host sync (the token stays on the
device) and read back once. Backends: "mega" (the decode-step kernel a
step), "pallas" (plain layers with the decode-attention kernel; the plain
attention on an int8 cache, as in JAX), "dense" (plain torch). On the CPU
every kernel runs its plain version.
"""

from __future__ import annotations

import torch

from ..core.config import DecoderConfig
from ..core.safetensors import SafeTensorsFile
from ..core.weights import (
    _FUSED_KEYS,
    _LAYER_KEYS,
    DecoderWeights,
    _checkpoint_file,
    _stack_layers,
    init_decoder_weights,
    make_rope_table,
)
from ..models.decoder import init_state, prefill
from ..runtime.generate import generate_tokens

TEXT_LM_CONFIG = DecoderConfig(
    num_layers=28,
    vocab_size=151936,
    max_seq_len=2048,
    rope_theta=10000.0,
)

def _require_device(device) -> torch.device:
    """`device` as a torch.device with its index ("cuda" → the current
    card); raises when it is a CUDA device and the machine has none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device is {str(device)!r} but no CUDA device is available; "
                               f"pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tie_head(w: DecoderWeights) -> DecoderWeights:
    """The weights with the LM head tied to the embedding: a contiguous
    `[H, V]` copy of `embed.T`, the layout the decode-step kernel streams."""
    return w._replace(lm_head=w.embed.t().contiguous())


def init_text_lm_weights(seed: int, cfg: DecoderConfig = TEXT_LM_CONFIG,
                         device="cuda") -> DecoderWeights:
    """Random bf16 text-LM weights from `seed` (the JAX package's scales),
    the head tied."""
    dev = _require_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tie_head(init_decoder_weights(gen, cfg, dev))


def load_text_lm_weights(model_path: str = "Qwen/Qwen3-0.6B",
                         cfg: DecoderConfig = TEXT_LM_CONFIG, device="cuda",
                         verbose: bool = True):
    """Qwen3-0.6B from `<model_path>/model.safetensors` (a path that is not
    a directory is a hub id, downloaded by `huggingface_hub`), bf16 on
    `device`, read with the port's own safetensors reader. Returns
    (DecoderWeights, tokenizer or None): the head tied to the embedding;
    the tokenizer `transformers`' for `model_path`, None when that
    library or the tokenizer files are missing."""
    dev = _require_device(device)
    path = _checkpoint_file(model_path)
    if verbose:
        print(f"Loading text LM from {path}...")
    f = SafeTensorsFile(path)

    def leaf(name):
        return f.get(name).to(dev).to(dtype=torch.bfloat16, copy=True).contiguous()

    w = tie_head(DecoderWeights(
        layers=_stack_layers(f, "model.layers.", cfg.num_layers, dev),
        final_norm=leaf("model.norm.weight"),
        embed=leaf("model.embed_tokens.weight"),
        lm_head=torch.empty(0, dtype=torch.bfloat16, device=dev),
        rope=make_rope_table(cfg, dev)))
    tokenizer = None
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_path)
    except Exception:   # no transformers, or no tokenizer files: ids only
        pass
    return w, tokenizer


def text_lm_state_dict(w: DecoderWeights, cfg: DecoderConfig) -> dict[str, torch.Tensor]:
    """bf16 text-LM weights → the Qwen3 checkpoint's tensors by key name
    (torch layouts, q|k|v and gate|up split, no separate head: it is tied):
    what `load_text_lm_weights` reads."""
    splits = {"wqkv": (cfg.q_size, cfg.kv_size, cfg.kv_size),
              "w_gate_up": (cfg.intermediate_size, cfg.intermediate_size)}
    out = {"model.embed_tokens.weight": w.embed, "model.norm.weight": w.final_norm}
    for i in range(cfg.num_layers):
        for field, suffix, tr in _LAYER_KEYS:
            t = getattr(w.layers, field)[i]
            out[f"model.layers.{i}.{suffix}"] = t.t() if tr else t
        for field, suffixes in _FUSED_KEYS:
            for s, t in zip(suffixes, getattr(w.layers, field)[i].split(splits[field], dim=1)):
                out[f"model.layers.{i}.{s}"] = t.t()
    return out


def _prefill_ids(cfg: DecoderConfig, w: DecoderWeights, ids: torch.Tensor,
                 kv_dtype=torch.bfloat16):
    """A fresh cache, the dense prefill of the embedded ids `[T]` and the
    first greedy token (a device tensor). Returns (state, token, normed)."""
    state = init_state(cfg, w.embed.device, kv_dtype)
    return prefill(cfg, w, state, w.embed[ids])


class TextLM:
    """Prompt ids in, greedy token ids out (JAX `TextLM`). `kv_cache="int8"`
    stores the cache per row quantized, as the talker's int8 cache."""

    def __init__(self, weights: DecoderWeights, cfg: DecoderConfig = TEXT_LM_CONFIG,
                 tokenizer=None, attn_impl: str = "dense", kv_cache: str = "bf16",
                 device="cuda"):
        if attn_impl not in ("dense", "pallas", "mega"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}: dense, pallas or mega")
        if kv_cache not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_cache {kv_cache!r}: bf16 or int8")
        self.device = _require_device(device)
        if weights.embed.device != self.device:
            raise ValueError(f"the weights are on {weights.embed.device}, not {self.device}")
        self.cfg = cfg
        self.w = weights
        self.tokenizer = tokenizer
        self.attn_impl = attn_impl
        self.kv_dtype = torch.int8 if kv_cache == "int8" else torch.bfloat16
        self.steps = 0   # single-token decode steps run (the prefill's token excluded)

    def _prefill(self, prompt_ids):
        ids = torch.as_tensor(list(prompt_ids), dtype=torch.long).to(self.device)
        state, first, _ = _prefill_ids(self.cfg, self.w, ids, self.kv_dtype)
        return state, first

    def _steps(self, state, token, n: int):
        """n greedy steps from the device token: (state, tokens [n] on the
        device), enqueued without a host sync."""
        self.steps += n
        return generate_tokens(self.cfg, self.w, state, token, n, attn_impl=self.attn_impl)

    def generate(self, prompt_ids, max_new_tokens: int = 64) -> list[int]:
        """Greedy generation of `max_new_tokens` ids: the prompt's dense
        prefill gives the first, single-token steps the rest."""
        state, first = self._prefill(prompt_ids)
        out = [int(first)]
        if max_new_tokens > 1:
            _, tokens = self._steps(state, first, max_new_tokens - 1)
            out += tokens.tolist()
        return out[:max_new_tokens]

    def generate_stream(self, prompt_ids, max_new_tokens: int = 256, chunk: int = 32,
                        stop_ids: tuple = ()):
        """Greedy generation yielding lists of ids as they decode: the first
        id alone, then `chunk` at a time, each chunk read back once. Ends
        before a stop id (which is not yielded). The ids are `generate`'s,
        whatever the chunk size."""
        state, tok = self._prefill(prompt_ids)
        first = int(tok)
        if first in stop_ids:
            return
        yield [first]
        produced = 1
        while produced < max_new_tokens:
            n = min(chunk, max_new_tokens - produced)
            state, tokens = self._steps(state, tok, n)
            tok = tokens[-1:]
            host = tokens.tolist()
            for i, t in enumerate(host):
                if t in stop_ids:
                    if i:
                        yield host[:i]
                    return
            yield host
            produced += n

"""The Qwen3-0.6B text language model on the port's decoder core.

Port of `qwen_tts_tpu/models/text_lm.py`: the 28-layer decoder of the TTS
talker with the 151,936-id text vocabulary, embeddings tied to the LM head
(`lm_head = embed.T`) and rope theta 10,000. One decoder implementation
serves the three model families (text LM, talker, code predictor).

The decode-step kernel (`ops/decode_step.py`, backend "mega") keeps the
head inside its one launch at this vocabulary too, bf16 or int8: the JAX
package moves a head above `HEAD_FUSE_LIMIT_MB` out of its Pallas kernel
because it does not fit VMEM, a TPU rule the port does not have. The
kernel streams the head as a contiguous `[H, V]` matrix in 64-column
tiles, so the tied head is kept as its own contiguous copy of `embed.T`
(311 MB in bf16, 155 MB in int8 with f32 `[1, V]` scales, beside the
embedding's 311 MB) rather than a view of the `[V, H]` embedding; the
product is JAX's (bf16 inputs, int8 → bf16 exact, f32 accumulation, times
the column scale, argmax of the f32 logits).

`TextLM.generate` prefills the prompt densely and then runs greedy
single-token steps; `generate_stream` yields them `chunk` at a time. On a
GPU the prefill and each chunk are one CUDA-graph replay each (`TextLM`).
Backends: "mega" (the decode-step kernel a step), "pallas" (plain layers
with the decode-attention kernel; the plain attention on an int8 cache, as
in JAX), "dense" (plain torch). On the CPU every kernel runs its plain
version.
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
    quantize_lm_head,
)
from ..models.decoder import init_state, prefill
from ..ops import decode_step
from ..runtime.generate import generate_tokens
from ..runtime.lm_driver import LMDriver, chunk_lengths  # noqa: F401  (callers import it here)

TEXT_LM_CONFIG = DecoderConfig(
    num_layers=28,
    vocab_size=151936,
    max_seq_len=2048,
    rope_theta=10000.0,
)
GENERATE_CHUNK = 32   # `generate`'s ids a graph replay

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
    `[H, V]` copy of `embed.T`, the layout the decode-step kernel streams.
    Weights whose head is int8 (`lm_head_s` set) get the tied head
    quantized the same way, so tying and quantizing compose in either
    order."""
    head = w.embed.t().contiguous()
    if getattr(w, "lm_head_s", None) is not None:
        q, s = quantize_lm_head(head)
        return w._replace(lm_head=q, lm_head_s=s)
    return w._replace(lm_head=head)


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


class TextLM(LMDriver):
    """Prompt ids in, greedy token ids out (JAX `TextLM`): Qwen3's bodies on
    the port's text-LM driver (`runtime/lm_driver.py`). `kv_cache="int8"`
    stores the cache per row quantized, as the talker's int8 cache. The
    weights are bf16 (`tie_head`) or a quantized form of them
    (`core/weights.py::QUANTIZERS`: int8, int4-g128 or mixed layers, each
    with its int8 head).

    On a GPU the prompt's prefill and each chunk of `generate_stream` are
    one replay of a CUDA graph each, as JAX runs `_prefill_ids` and each
    chunk's `generate_tokens` as one jitted dispatch: the prefill graph of a
    prompt length uploads the ids from pinned memory, runs the dense
    prefill into the LM's own static state and copies the first token to
    pinned memory; the graph of chunk length n runs n single-token steps
    from the carried token and copies their ids out. The host reads each
    graph's tokens (one read behind an event) before it enqueues the next.
    A length is captured at its first use (where JAX compiles) or ahead of
    traffic by `warm`. The graphs are captured on the LM's own stream, pool
    and decode-kernel arrays (`runtime/chunk_graphs.py`), in the thread-local
    capture mode, so another thread (the TTS engine's) may replay its own
    graphs meanwhile. "mega" keeps its position in the decode kernel's
    position array, which the prefill graph sets; "pallas" and "dense" in
    the state's device position, which the prefill graph zeroes first.
    Streams may interleave, as JAX's, each with a state of its own: the
    static state is held by one stream at a time, and a stream that resumes
    after another ran parks the holder's (its cache rows, carried token and
    position) and restores its own, as the TTS engine does for its live
    streams. On the CPU the same bodies run eagerly, in the same order.
    While a profiler records, a stream's prefill and each chunk record the
    spans `lm.prefill` and `lm.chunk` (`utils/timing.py::span`), numbered
    by the stream (a chunk's length in its detail), beside the graphs'
    `lm.launch` and `lm.wait`."""

    def __init__(self, weights: DecoderWeights, cfg: DecoderConfig = TEXT_LM_CONFIG,
                 tokenizer=None, attn_impl: str = "dense", kv_cache: str = "bf16",
                 device="cuda"):
        if attn_impl not in ("dense", "pallas", "mega"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}: dense, pallas or mega")
        if kv_cache not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_cache {kv_cache!r}: bf16 or int8")
        device = _require_device(device)
        if weights.embed.device != device:
            raise ValueError(f"the weights are on {weights.embed.device}, not {device}")
        self.cfg = cfg
        self.w = weights
        self.tokenizer = tokenizer
        self.attn_impl = attn_impl
        self.kv_dtype = torch.int8 if kv_cache == "int8" else torch.bfloat16
        super().__init__(device)
        g = self._graphs
        self._state = init_state(cfg, device, self.kv_dtype, device_pos=attn_impl != "mega")
        if g.cuda and attn_impl == "mega":
            with g.on_stream():     # the kernel's workspace, before any graph holds it
                decode_step.workspace(cfg, device)

    # ── the graphs' bodies ───────────────────────────────────────────────

    def _prefill_body(self, P: int) -> None:
        """The uploaded ids `[P]` embedded and prefilled into the static
        state from position 0; the first token carried and copied out. On
        "mega" the decode kernel's position array is set to P."""
        host, ids = self._ids[P]
        ids.copy_(host, non_blocking=True)
        if self._state.pos is not None:     # a 1-id prompt prefills at it
            self._state.pos.zero_()
        state, first, _ = prefill(self.cfg, self.w, self._state._replace(position=0),
                                  self.w.embed[ids])
        if self._graphs.cuda and self.attn_impl == "mega":
            decode_step.positions(state, (P,), self.device)
        self._tok.copy_(first.reshape(1))
        self._first.copy_(first.reshape(1), non_blocking=True)

    def _chunk_body(self, n: int) -> None:
        """n greedy steps from the carried token at the host position; their
        ids copied out, the last carried."""
        state = self._state._replace(position=self._pos)
        _, tokens = generate_tokens(self.cfg, self.w, state, self._tok, n,
                                    attn_impl=self.attn_impl)
        self._tok.copy_(tokens[-1:])
        self._out[n].copy_(tokens, non_blocking=True)

    def _cache_prefix(self, p: int) -> list[torch.Tensor]:
        st = self._state
        return [t[:, :, :p] for t in (st.k_cache, st.v_cache, st.k_scale, st.v_scale)
                if t is not None]

    def _set_position(self, p: int) -> None:
        """The state's device position, or on "mega" the decode kernel's
        array."""
        st = self._state
        if st.pos is not None:
            st.pos.fill_(p)
        elif self._graphs.cuda:
            decode_step.positions(st, (p,), self.device)

    def _carried(self) -> tuple:
        return (self._state,)

    # ── public API ───────────────────────────────────────────────────────

    def generate(self, prompt_ids, max_new_tokens: int = 64) -> list[int]:
        """Greedy generation of `max_new_tokens` ids: the prompt's prefill
        gives the first, single-token steps the rest, GENERATE_CHUNK at a
        time (JAX: one scan of them all; the ids are the same)."""
        return [t for ids in self.generate_stream(prompt_ids, max_new_tokens,
                                                  chunk=GENERATE_CHUNK) for t in ids]

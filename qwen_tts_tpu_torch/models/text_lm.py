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
from ..runtime.chunk_graphs import ChunkGraphs
from ..models.decoder import init_state, prefill
from ..ops import decode_step
from ..runtime.generate import generate_tokens
from ..utils.timing import span

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


def chunk_lengths(max_new_tokens: int, chunk: int) -> tuple[int, ...]:
    """The chunk lengths a stream of `max_new_tokens` ids runs after the
    prefill's first: `chunk`, and the remainder's (JAX compiles one scan for
    each)."""
    rest = max(max_new_tokens - 1, 0)
    return tuple(sorted({n for n in (min(chunk, rest), rest % chunk) if n > 0}))


class _Stream:
    """One `generate_stream`'s claim on the LM's static state: `parked`
    holds its copy of the state while another stream holds it; `number`
    names its spans."""

    __slots__ = ("parked", "number")

    def __init__(self, number: int = 0):
        self.parked: dict | None = None
        self.number = number


class TextLM:
    """Prompt ids in, greedy token ids out (JAX `TextLM`). `kv_cache="int8"`
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
        self.device = _require_device(device)
        if weights.embed.device != self.device:
            raise ValueError(f"the weights are on {weights.embed.device}, not {self.device}")
        self.cfg = cfg
        self.w = weights
        self.tokenizer = tokenizer
        self.attn_impl = attn_impl
        self.kv_dtype = torch.int8 if kv_cache == "int8" else torch.bfloat16
        self.steps = 0   # single-token decode steps run (the prefill's token excluded)
        self._streams = 0   # streams begun, which number them
        dev = self.device
        self._graphs = g = ChunkGraphs(dev, "lm")
        self._state = init_state(cfg, dev, self.kv_dtype, device_pos=attn_impl != "mega")
        self._pos = 0                                   # the host position
        self._tok = torch.zeros(1, dtype=torch.long, device=dev)   # the carried token
        self._first = g.host(1, torch.long)             # the prefill's token, on the host
        self._ids: dict[int, tuple] = {}                # prompt length -> (host, device)
        self._out: dict[int, torch.Tensor] = {}         # chunk length -> host ids [n]
        self._owner: _Stream | None = None              # the stream that holds the state
        if g.cuda and attn_impl == "mega":
            with g.on_stream():     # the kernel's workspace, before any graph holds it
                decode_step.workspace(cfg, dev)

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

    # ── capture and replay ───────────────────────────────────────────────

    def _buffers(self, P: int, lengths) -> None:
        g = self._graphs
        if P not in self._ids:
            self._ids[P] = (g.host(P, torch.long),
                            torch.zeros(P, dtype=torch.long, device=self.device))
        for n in lengths:
            if n not in self._out:
                self._out[n] = g.host(n, torch.int32)

    def _prepare(self, P: int, lengths=()) -> None:
        """The graphs of prompt length P and chunk lengths `lengths`: each
        missing one run once on the graphs' stream (from position P, as a
        stream would run it), then captured. The state they leave is
        overwritten by the next prefill."""
        cfg, g = self.cfg, self._graphs
        if P < 1 or P > cfg.max_seq_len:
            raise ValueError(f"a prompt of {P} ids does not fit max_seq_len {cfg.max_seq_len}")
        self._buffers(P, lengths)
        keys = [("prefill", P)] + [("chunk", n) for n in lengths]
        missing = [k for k in keys if k not in g.graphs]
        if not g.cuda or not missing:
            return
        if self._owner is not None:     # the runs below overwrite the state
            self._park(self._owner)
            self._owner = None
        g.stream.wait_stream(torch.cuda.current_stream(self.device))
        for kind, m in missing:
            if kind == "chunk" and P + m > cfg.max_seq_len:
                raise ValueError(f"positions [{P}, {P + m}) exceed max_seq_len "
                                 f"{cfg.max_seq_len}")
            with g.on_stream():
                self._prefill_body(P)
                self._pos = P
                if kind == "chunk":
                    self._chunk_body(m)
            if kind == "prefill":
                g.capture(("prefill", P), lambda: self._prefill_body(P))
            else:
                g.capture(("chunk", m), lambda: self._chunk_body(m),
                          carried=(self._state,))
        self._pos = 0

    def warm(self, prompt_len: int, chunk_lengths=()) -> None:
        """Capture the prefill graph of `prompt_len` ids and the graphs of
        `chunk_lengths` ahead of traffic (on the CPU: nothing to capture)."""
        self._prepare(prompt_len, tuple(chunk_lengths))

    def _replay(self, key: tuple, body, ident: int) -> None:
        """Enqueue a graph for stream `ident` and wait until its outputs are
        on the host."""
        g = self._graphs
        with g.on_stream():
            g.replay(key, body, ident)
            g.record(0)
        g.wait(0, ident)

    # ── parking: several streams on one static state ─────────────────────

    def _acquire(self, s: _Stream) -> None:
        """Give stream `s` the static state: park the holder's, restore
        `s`'s. Nothing is copied when `s` holds it already."""
        if self._owner is s:
            return
        if self._owner is not None:
            self._park(self._owner)
        if s.parked is not None:
            self._restore(s)
        self._owner = s

    def _park(self, s: _Stream) -> None:
        """Copy the holder's cache rows [0, pos), carried token and host
        position into tensors of its own (its device position equals the
        host's between replays)."""
        st, p = self._state, self._pos
        with self._graphs.on_stream():
            s.parked = {"cache": [t[:, :, :p].clone() for t in (st.k_cache, st.v_cache,
                                                               st.k_scale, st.v_scale)
                                  if t is not None],
                        "tok": self._tok.clone(), "pos": p}

    def _restore(self, s: _Stream) -> None:
        """Copy a parked state back into the static tensors, set the device
        position (the state's, or on "mega" the decode kernel's array) and
        free the copy."""
        g, st, d = self._graphs, self._state, s.parked
        p = d["pos"]
        caches = [t for t in (st.k_cache, st.v_cache, st.k_scale, st.v_scale) if t is not None]
        g.owned.forget()
        with g.on_stream():
            for dst, src in zip(caches, d["cache"]):
                dst[:, :, :p].copy_(src)
            self._tok.copy_(d["tok"])
            if st.pos is not None:
                st.pos.fill_(p)
            elif g.cuda:
                decode_step.positions(st, (p,), self.device)
        self._pos = p
        s.parked = None

    def _release(self, s: _Stream) -> None:
        """A stream ended or was closed: drop what it holds."""
        if self._owner is s:
            self._owner = None
        s.parked = None

    def _prefill(self, prompt_ids, lengths, s: _Stream | None = None) -> int:
        """Upload the prompt, replay its prefill graph for stream `s` (for
        none when None: the state is left unheld); the first token."""
        ids = list(prompt_ids)
        P = len(ids)
        self._prepare(P, lengths)
        self._acquire(s or _Stream())
        if s is None:
            self._owner = None
        self._ids[P][0].copy_(torch.tensor(ids, dtype=torch.long))
        if self._graphs.cuda:     # the caller's work on the weights comes first
            self._graphs.stream.wait_stream(torch.cuda.current_stream(self.device))
        self._replay(("prefill", P), lambda: self._prefill_body(P), s.number if s else 0)
        self._pos = P
        return int(self._first[0])

    def _chunk(self, n: int, ident: int = 0) -> list[int]:
        """Replay the graph of n steps from the carried token (for stream
        `ident`); their ids."""
        if self._pos + n > self.cfg.max_seq_len:
            raise ValueError(f"positions [{self._pos}, {self._pos + n}) exceed max_seq_len "
                             f"{self.cfg.max_seq_len}")
        self._replay(("chunk", n), lambda: self._chunk_body(n), ident)
        self._pos += n
        self.steps += n
        return self._out[n].tolist()

    def decode_launches(self) -> int:
        """The decode-step kernel's launches by this LM's graphs and their
        warm-up runs, as the kernel counts them (a device read; CUDA)."""
        return self._graphs.launches()

    # ── public API ───────────────────────────────────────────────────────

    def generate(self, prompt_ids, max_new_tokens: int = 64) -> list[int]:
        """Greedy generation of `max_new_tokens` ids: the prompt's prefill
        gives the first, single-token steps the rest, GENERATE_CHUNK at a
        time (JAX: one scan of them all; the ids are the same)."""
        return [t for ids in self.generate_stream(prompt_ids, max_new_tokens,
                                                  chunk=GENERATE_CHUNK) for t in ids]

    def generate_stream(self, prompt_ids, max_new_tokens: int = 256, chunk: int = 32,
                        stop_ids: tuple = ()):
        """Greedy generation yielding lists of ids as they decode: the first
        id alone, then `chunk` at a time, each chunk one graph replay read
        back once, the next enqueued only after that read (JAX's stream).
        Ends before a stop id (which is not yielded). The ids are
        `generate`'s, whatever the chunk size."""
        if max_new_tokens < 1:
            return
        self._streams += 1
        me = _Stream(self._streams)
        try:
            with span("lm.prefill", me.number):
                first = self._prefill(prompt_ids, chunk_lengths(max_new_tokens, chunk), me)
            if first in stop_ids:
                return
            yield [first]
            produced = 1
            while produced < max_new_tokens:
                n = min(chunk, max_new_tokens - produced)
                self._acquire(me)
                with span("lm.chunk", me.number, n):
                    host = self._chunk(n, me.number)
                for i, t in enumerate(host):
                    if t in stop_ids:
                        if i:
                            yield host[:i]
                        return
                yield host
                produced += n
        finally:
            self._release(me)

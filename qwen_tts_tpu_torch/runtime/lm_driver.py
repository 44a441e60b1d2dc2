"""The text LM's stream driver: prefill and chunk graphs, parking, spans.

A text LM of the port (`models/text_lm.py::TextLM` for Qwen3,
`models/deepseek_v2.py::DeepseekV2LM`) is this driver and its model's
bodies. The driver owns what is the same for every model: the CUDA graphs
of the prompt's prefill (one a prompt length) and of each chunk length on
the LM's own `ChunkGraphs` (stream, pool, decode-kernel arrays, captured in
the thread-local mode), the pinned buffers the graphs read and write, the
stream protocol of `generate_stream` (the first id from the prefill, then
`chunk` ids a replay, the host reading each graph's ids before it enqueues
the next), parking and restoring the static state when streams interleave,
the spans `lm.prefill` and `lm.chunk` (beside the graphs' `lm.launch` and
`lm.wait`), and the count of decode steps.

A model gives four things:

- `_prefill_body(P)`: the uploaded ids `self._ids[P][1]` embedded and
  prefilled into the static state from position 0, the device position set
  to P, the first token carried in `self._tok` and copied to `self._first`;
- `_chunk_body(n)`: n greedy steps from the carried token at the host
  position `self._pos`, their ids copied to `self._out[n]`, the last
  carried;
- `_cache_prefix(p)`: views of the static cache's rows [0, p), which a
  park copies out and a restore copies back;
- `_set_position(p)`: the device position a restore sets;

and `_carried()`, the caches whose decode-kernel position arrays a chunk
graph must not fill (those the prefill graph sets). On the CPU nothing is
captured and the same bodies run eagerly, in the same order.
"""

from __future__ import annotations

import torch

from ..utils.timing import span
from .chunk_graphs import ChunkGraphs


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


class LMDriver:
    """Prompt ids in, greedy token ids out, one graph replay a prefill or a
    chunk on a GPU. Subclasses set `self.cfg` (with `max_seq_len`) and the
    static state, and give the bodies above."""

    def __init__(self, device: torch.device):
        self.device = device
        self.steps = 0        # single-token decode steps run (the prefill's token excluded)
        self.warm_steps = 0   # steps run eagerly before a chunk graph's capture
        self._streams = 0     # streams begun, which number them
        self._graphs = g = ChunkGraphs(device, "lm")
        self._pos = 0                                   # the host position
        self._tok = torch.zeros(1, dtype=torch.long, device=device)   # the carried token
        self._first = g.host(1, torch.long)             # the prefill's token, on the host
        self._ids: dict[int, tuple] = {}                # prompt length -> (host, device)
        self._out: dict[int, torch.Tensor] = {}         # chunk length -> host ids [n]
        self._owner: _Stream | None = None              # the stream that holds the state

    # ── the model's part ─────────────────────────────────────────────────

    def _prefill_body(self, P: int) -> None:
        raise NotImplementedError

    def _chunk_body(self, n: int) -> None:
        raise NotImplementedError

    def _cache_prefix(self, p: int) -> list[torch.Tensor]:
        raise NotImplementedError

    def _set_position(self, p: int) -> None:
        raise NotImplementedError

    def _carried(self) -> tuple:
        return ()

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
                    self.warm_steps += m
            if kind == "prefill":
                g.capture(("prefill", P), lambda: self._prefill_body(P))
            else:
                g.capture(("chunk", m), lambda: self._chunk_body(m), carried=self._carried())
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
        p = self._pos
        with self._graphs.on_stream():
            s.parked = {"cache": [t.clone() for t in self._cache_prefix(p)],
                        "tok": self._tok.clone(), "pos": p}

    def _restore(self, s: _Stream) -> None:
        """Copy a parked state back into the static tensors, set the device
        position and free the copy."""
        g, d = self._graphs, s.parked
        p = d["pos"]
        g.owned.forget()
        with g.on_stream():
            for dst, src in zip(self._cache_prefix(p), d["cache"]):
                dst.copy_(src)
            self._tok.copy_(d["tok"])
            self._set_position(p)
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
        warm-up runs, as the kernel counts them (a device read; CUDA; 0 for
        a model whose steps do not run in it)."""
        return self._graphs.launches()

    # ── public API ───────────────────────────────────────────────────────

    def generate_stream(self, prompt_ids, max_new_tokens: int = 256, chunk: int = 32,
                        stop_ids: tuple = ()):
        """Greedy generation yielding lists of ids as they decode: the first
        id alone, then `chunk` at a time, each chunk one graph replay read
        back once, the next enqueued only after that read (JAX's stream).
        Ends before a stop id (which is not yielded). The ids are the same
        whatever the chunk size."""
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

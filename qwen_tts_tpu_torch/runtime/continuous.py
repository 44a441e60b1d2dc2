"""Continuous batching: requests admitted into fixed batch slots as they come.

Port of `qwen_tts_tpu/runtime/continuous.py`. A batcher keeps B persistent
slots over the batched frame path (`runtime/batch.py`) and serves
staggered requests on them; a slot that finishes early takes the next
request while the others keep streaming. Its contracts are JAX's:

- every chunk runs `n` frames AND their audio for ALL slots as one replay
  of a CUDA graph (`batched_frames` + the vocoder of each slot, fused), one
  graph a chunk size n in {`admit_chunk_frames`, `chunk_frames`}; with
  Code2Wav a chunk decodes against the previous chunk's codes (a device
  buffer the graph then overwrites), so its graphs are keyed by the
  previous chunk's size too, and each slot's audio is the context form or
  the utterance-start form, chosen on the device by whether the slot's
  occupant had a chunk before (a fresh occupant never decodes against its
  predecessor's codes);
- the dispatch loop runs DEPTH-2: chunk k+1 is enqueued before chunk k is
  read back, and the blocking read waits in a worker thread
  (`run_in_executor`), so the event loop keeps serving cancellations and
  consumers while the device computes;
- a request joins at a chunk boundary through ONE captured admission
  graph: its `text_bucket`-padded ids (uploaded from a ring of pinned
  buffers) through text projection, the 8-row conditioning prefix, the
  prefill and the CODEC_BOS step into the graph's own one-stream state,
  whose 9 cache rows, position, token, hidden state and trailing text are
  then copied into the free slot's rows in place (the slot index is a
  device value; the batched cache is never copied, as JAX donates it);
- the chunk right after an admission is `admit_chunk_frames` frames, so
  the fresh request's first audio is a couple of frames of compute away;
- a request leaves when its EOS lands or its frame cap is hit (results of
  chunks dispatched before its admission belong to the slot's previous
  occupant: the `first_seq` guard); a closed stream frees its slot at the
  next chunk boundary;
- every graph is captured by `warm()` (run at the first request if the
  caller did not), so traffic never captures one;
- an idle slot still rides through each chunk and its position advances;
  `_maybe_repark` re-parks it (position, token, hidden state, text length
  and index to zero) before it could reach `max_seq_len`, and only from
  `_collect`, as JAX does;
- when the dispatch loop fails, every waiting request is woken and raises
  the failure, chained. JAX ends a request that already streamed audio
  with a clean end of stream instead (`continuous.py:336-342`), which
  hides a truncated utterance; the port raises for it too.

Each slot's sampling noise is drawn per (request number, absolute frame)
as the engine draws it (`TTSEngine._draw`), the request number taken from
the engine at admission, so a request's codes depend on its number, not on
its slot or its neighbours (bit for bit at one slot count).
Frame caps are the engine's word-count caps, bounded so that a request and
the chunks dispatched past its cap fit in the cache.

On the CPU the graphs' bodies run eagerly in the same order.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncGenerator, Optional

import numpy as np
import torch

from ..engine.chunk_graphs import RING, ChunkGraphs, Slot
from ..engine.tokenizer import encode_tts_prompt
from ..models.decoder import init_state
from .batch import batched_frames

ADMIT_ROWS = 9      # cache rows of an admission: 8 prefill positions + the CODEC_BOS step
ID_BUFFERS = 4      # pinned buffers the admissions' ids are uploaded from, in turn


@dataclass
class _Request:
    text: str
    cap: int
    queue: asyncio.Queue = field(default_factory=asyncio.Queue)
    number: int = 0          # the engine's request number: its sampling noise
    frames: int = 0          # frames dispatched for it: the next one's index
    emitted: int = 0
    codes: list = field(default_factory=list)   # [n, 16] arrays of the frames emitted
    cancelled: bool = False
    failure: Optional[BaseException] = None
    # the first chunk-dispatch sequence number that holds this request's
    # state: earlier (speculative) chunks of its slot are its predecessor's
    first_seq: int = 0


class ContinuousBatcher:
    """Schedules staggered TTS requests onto B persistent batch slots.

    Usage (any number of concurrent callers)::

        batcher = ContinuousBatcher(engine, slots=4)
        batcher.warm()
        async for audio, sr in batcher.submit(text):
            ...

    The dispatch loop starts with the first request and ends when the last
    one drains. `chunk_frames` is the scheduling quantum.
    """

    def __init__(self, engine, slots: int = 4, chunk_frames: Optional[int] = None,
                 text_bucket: Optional[int] = None, admit_chunk_frames: Optional[int] = 2):
        engine.initialize()
        self.eng = engine
        self.slots = slots
        self.chunk = chunk_frames or engine.config.chunk_frames
        small = admit_chunk_frames or 0
        self.small = small if 0 < small < self.chunk else 0
        self.text_bucket = text_bucket or engine.config.trailing_bucket
        mc, dev = engine.model_config, engine.device
        self._cfg, self._cp_cfg = mc.talker, mc.code_predictor
        self._groups = mc.num_code_groups
        self._impl = engine._batch_impl
        self._c2w = engine._c2w and engine.vocoder_weights is not None
        self._hop = engine.vocoder_config.hop_length
        self._sizes = [self.chunk] + ([self.small] if self.small else [])
        B, H, T, kv = slots, self._cfg.hidden_size, self.text_bucket, engine._kv_dtype
        if ADMIT_ROWS + 2 * self.chunk + 16 >= self._cfg.max_seq_len:
            raise ValueError(f"max_seq_len {self._cfg.max_seq_len} leaves no room for chunks "
                             f"of {self.chunk} frames")
        self._g = g = ChunkGraphs(dev)
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=dev)
        # the slots' state, which every graph reads and writes in place
        self._state = init_state(self._cfg, dev, kv, slots=B)
        self._cp_state = init_state(self._cp_cfg, dev, slots=B)
        self._tok = zeros(B, dtype=torch.int64)
        self._hid = zeros(B, H)
        self._trail = zeros(B, T, H, dtype=torch.bfloat16)
        self._tlen = zeros(B, dtype=torch.int32)
        self._tidx0 = zeros(B, dtype=torch.int32)
        self._had = zeros(B, dtype=torch.bool)   # the occupant had a chunk: Code2Wav context
        # the admission graph's own one-stream state and inputs: ids, count, slot
        self._one = init_state(self._cfg, dev, kv, device_pos=True)
        self._one_trail = zeros(T, H, dtype=torch.bfloat16)
        self._one_tlen = zeros(dtype=torch.int32)
        self._ids = zeros(T + 2, dtype=torch.int64)
        self._id_host = [g.host(T + 2, torch.int64) for _ in range(ID_BUFFERS)]
        self._id_events = [torch.cuda.Event() if g.cuda else None for _ in range(ID_BUFFERS)]
        self._id_next = 0
        L, KVH, S = self._cfg.num_layers, self._cfg.num_kv_heads, self._cfg.max_seq_len
        # flat cache rows [0, ADMIT_ROWS) of every layer and kv head of slot 0
        lh = torch.arange(L * KVH, device=dev)[:, None] * S
        self._rows = (lh + torch.arange(ADMIT_ROWS, device=dev)[None, :]).reshape(-1)
        self._slot_rows = L * KVH * S
        top_k = engine._top_k
        self._uniform = {n: zeros(B, n, self._groups - 1, top_k) for n in self._sizes}
        self._dev_out = {n: (zeros(B, n, self._groups, dtype=torch.int64),
                             zeros(B, n, dtype=torch.bool), zeros(B, n * self._hop))
                         for n in self._sizes}
        self._host = {n: [Slot(g.host((B, n, self._groups), torch.int64),
                               g.host((B, n), torch.bool), g.host((B, n * self._hop),
                                                                  torch.float32))
                          for _ in range(RING)] for n in self._sizes}
        self._ctx = {n: zeros(B, n, self._groups, dtype=torch.int64)
                     for n in self._sizes} if self._c2w else {}
        self._ring = 0
        self._prev_n: Optional[int] = None   # the last chunk's size: Code2Wav's context
        self._warm = False
        self.captures = 0                     # graphs captured (bodies prepared on the CPU)

        self._reqs: list[Optional[_Request]] = [None] * B
        self._pos = [0] * B          # host mirror of each slot's cache position
        self._seq = 0                # chunk-dispatch sequence number
        self._pending: deque[_Request] = deque()
        self._task: Optional[asyncio.Task] = None

    # ── the graphs' bodies ───────────────────────────────────────────────

    def _admit_body(self) -> None:
        """Admission: the uploaded ids `[T]`, their count and the slot index
        through the engine's first-chunk prefix, prefill and CODEC_BOS step
        into the one-stream state, then its rows into the slot's, in place."""
        T, st, one = self.text_bucket, self._state, self._one
        slot = self._ids[T + 1:T + 2]
        one, tok, hid = self.eng._start(self._ids[:T], self._ids[T], self._one_trail,
                                        self._one_tlen, one._replace(position=0),
                                        attn_impl=self._impl)
        rows = self._rows + slot * self._slot_rows
        D = self._cfg.head_dim
        for dst, src in ((st.k_cache, one.k_cache), (st.v_cache, one.v_cache)):
            dst.view(-1, D).index_copy_(0, rows, src[:, :, :ADMIT_ROWS].reshape(-1, D))
        for dst, src in ((st.k_scale, one.k_scale), (st.v_scale, one.v_scale)):
            if dst is not None:
                dst.view(-1).index_copy_(0, rows, src[:, :, :ADMIT_ROWS].reshape(-1))
        st.pos.index_copy_(0, slot, one.pos.reshape(1))
        self._tok.index_copy_(0, slot, tok.reshape(1))
        self._hid.index_copy_(0, slot, hid[None])
        self._trail.index_copy_(0, slot, self._one_trail[None])
        self._tlen.index_copy_(0, slot, self._one_tlen.reshape(1))
        self._tidx0.index_fill_(0, slot, 0)
        self._had.index_fill_(0, slot, False)

    def _chunk_body(self, n: int, ctx_n: int) -> None:
        """n frames of every slot, their audio, and the outputs into the
        device buffers of size n; Code2Wav decodes against the `ctx_n`
        frames of the previous chunk."""
        eng, mc, cfg = self.eng, self.eng.model_config, self.eng.config
        _, codes, valid, tok, hid = batched_frames(
            mc.talker, mc.code_predictor, eng.weights.talker, eng.weights.code_predictor,
            self._state, self._tok, self._hid, self._trail, self._tlen, self._tidx0,
            eng._tts_pad_embed, self._uniform[n] if cfg.subtalker_do_sample else None,
            num_frames=n, do_sample=cfg.subtalker_do_sample,
            temperature=cfg.subtalker_temperature, top_k=cfg.subtalker_top_k,
            attn_impl=self._impl, mrope_deltas=eng._mrope_deltas, cp_state=self._cp_state)
        self._tok.copy_(tok)
        self._hid.copy_(hid)
        self._tidx0.add_(n)
        out_codes, out_valid, out_audio = self._dev_out[n]
        out_codes.copy_(codes)
        out_valid.copy_(valid)
        if eng.vocoder_weights is not None:
            for b in range(self.slots):
                if self._c2w:
                    # both forms, chosen per slot: the context form after the
                    # occupant's first chunk, the utterance-start form before
                    wav = torch.where(self._had[b], eng._frames_decode(codes[b],
                                                                       self._ctx[ctx_n][b]),
                                      eng._frames_decode(codes[b]))
                else:
                    wav = eng._frames_decode(codes[b])
                out_audio[b].copy_(wav)
            if self._c2w:
                self._ctx[n].copy_(codes)
        self._had.fill_(True)

    def _keys(self) -> list[tuple]:
        """Every graph: the admission, and a chunk graph per size (× the
        previous chunk's size with Code2Wav)."""
        prev = self._sizes if self._c2w else [0]
        return [("admit",)] + [("chunk", n, p) for n in self._sizes for p in prev]

    def _body(self, key: tuple):
        if key[0] == "admit":
            return self._admit_body
        n, p = key[1], key[2] or self.chunk
        return lambda: self._chunk_body(n, p)

    def warm(self) -> None:
        """Capture every graph (on the CPU: run every body once), then park
        every slot. Traffic after this captures nothing."""
        if self._warm:
            return
        g = self._g
        if g.cuda:
            g.stream.wait_stream(torch.cuda.current_stream(self.eng.device))
        for key in self._keys():
            with g.on_stream():
                self._body(key)()
            if g.cuda:
                g.capture(key, self._body(key))
            self.captures += 1
        for b in range(self.slots):
            self._park(b)
        self._prev_n = None
        if g.cuda:
            torch.cuda.synchronize(self.eng.device)
        self._warm = True

    # ── public API ───────────────────────────────────────────────────────

    async def submit(self, text: str) -> AsyncGenerator[tuple[np.ndarray, int], None]:
        """Queue a request; yield its audio chunks as they are produced."""
        self.warm()
        req = _Request(text=text, cap=self._frame_cap(text))
        self._pending.append(req)
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())
        try:
            while True:
                audio = await req.queue.get()
                if audio is None:
                    if req.failure is not None:
                        raise RuntimeError(
                            f"batch dispatch loop failed after {req.emitted} frames of this "
                            f"request's audio" + (": its audio is truncated" if req.emitted
                                                  else "")) from req.failure
                    return
                yield audio, self.eng.sample_rate
        finally:
            req.cancelled = True   # early aclose: free the slot next chunk

    def serve(self, texts: list[str]) -> list[tuple[np.ndarray, int]]:
        """Synchronous convenience: serve all texts (admitted as slots free
        up), return the joined audio of each text, in order."""
        async def gather():
            async def one(text):
                parts = [a async for a, _sr in self.submit(text)]
                return np.concatenate(parts) if parts else np.array([], np.float32)
            return await asyncio.gather(*[one(t) for t in texts])

        return [(w, self.eng.sample_rate) for w in asyncio.run(gather())]

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._reqs)

    @property
    def pending(self) -> int:
        """Requests queued behind the slots (admission backlog)."""
        return sum(not r.cancelled for r in self._pending)

    # ── scheduling loop ──────────────────────────────────────────────────

    async def _run(self):
        """Depth-2 dispatch loop: chunk k+1 is enqueued (admissions before
        it) before chunk k is read, so the read and the emits overlap the
        device's work. A request finishing in chunk k has one speculative
        chunk computed before its slot frees."""
        try:
            inflight = None
            while True:
                self._admit_pending()
                fresh = any(r is not None and r.frames == 0 for r in self._reqs)
                n = self.small if (fresh and self.small) else self.chunk
                new = self._dispatch(n) if self.active else None
                if inflight is not None:
                    await self._collect(inflight)
                inflight = new
                if inflight is None and not self._pending and not self.active:
                    return
                await asyncio.sleep(0)
        except BaseException as e:
            # a dead loop must not strand its consumers: wake every waiter
            # with the failure
            for req in list(self._reqs) + list(self._pending):
                if req is not None:
                    req.failure = e
                    req.queue.put_nowait(None)
            self._reqs = [None] * self.slots
            self._pending.clear()
            raise

    def _frame_cap(self, text: str) -> int:
        """The engine's cap (~2.5 words/s at 12.5 frames/s, 2x headroom, at
        least 25 frames, at most `max_new_tokens`), bounded so the request
        and the two chunks dispatched past it fit in the cache."""
        words = max(len(text.split()), 1)
        cap = min(max(int(words / 2.5 * 12.5 * 2.0), 25), self.eng.config.max_new_tokens)
        return min(cap, self._cfg.max_seq_len - ADMIT_ROWS - 2 * self.chunk)

    def _admit_pending(self):
        while self._pending:
            if self._pending[0].cancelled:     # its consumer left before admission
                self._pending.popleft()
                continue
            try:
                slot = self._reqs.index(None)
            except ValueError:
                return
            self._admit(self._pending.popleft(), slot)

    def _admit(self, req: _Request, slot: int):
        """Upload the request's bucket-padded ids and replay the admission
        graph into `slot`; the request is in the slot from the next chunk."""
        eng, g, T = self.eng, self._g, self.text_bucket
        content = encode_tts_prompt(eng.tokenizer, req.text)[3:][:T]
        i = self._id_next
        self._id_next = (i + 1) % ID_BUFFERS
        if g.cuda:
            self._id_events[i].synchronize()   # its last upload has run
        host = self._id_host[i]
        host.zero_()
        host[:len(content)] = torch.from_numpy(np.asarray(content, dtype=np.int64))
        host[T], host[T + 1] = len(content), slot
        eng._requests += 1
        req.number = eng._requests
        with g.on_stream():
            self._ids.copy_(host, non_blocking=True)
            if g.cuda:
                self._id_events[i].record(g.stream)
            g.replay(("admit",), self._admit_body)
        self._reqs[slot] = req
        req.first_seq = self._seq + 1   # present from the next dispatch on
        self._pos[slot] = ADMIT_ROWS

    def _park(self, slot: int):
        """Back to an empty slot at position 0 (the rows past it are never read)."""
        with self._g.on_stream():
            for t in (self._state.pos, self._tok, self._hid, self._tlen, self._tidx0,
                      self._had):
                t[slot].zero_()
        self._pos[slot] = 0

    def _maybe_repark(self, slot: int):
        """An idle slot keeps riding the chunks and its position keeps
        advancing: park it again before it could reach the cache's end."""
        if self._pos[slot] + 2 * self.chunk + 16 >= self._cfg.max_seq_len:
            self._park(slot)

    def _chunk_call(self, n: int) -> int:
        """Enqueue one n-frame chunk for all slots (its uniform draws, the
        graph, the copies of its outputs to the next pinned ring slot and
        that slot's event). Returns the ring slot; nothing is read back."""
        g, eng = self._g, self.eng
        key = ("chunk", n, self._prev_n or self.chunk if self._c2w else 0)
        ring = self._ring
        self._ring = (ring + 1) % RING
        with g.on_stream():
            if eng.config.subtalker_do_sample:
                for b, req in enumerate(self._reqs):
                    if req is not None:
                        eng._draw(req.number, req.frames, n, self._uniform[n][b])
            g.replay(key, self._body(key))
            for dst, src in zip(self._host[n][ring], self._dev_out[n]):
                dst.copy_(src, non_blocking=True)
            g.record(ring)
        return ring

    def _dispatch(self, n: int):
        """One chunk for all slots; the host mirrors (positions, frame
        counts, sequence number, context size) advance at dispatch time."""
        S = self._cfg.max_seq_len
        if max(self._pos) + n > S:
            raise RuntimeError(f"slot positions {self._pos} + {n} frames exceed max_seq_len {S}")
        ring = self._chunk_call(n)
        self._prev_n = n
        for b, req in enumerate(self._reqs):
            self._pos[b] += n
            if req is not None:
                req.frames += n
        self._seq += 1
        return self._seq, ring, n

    async def _collect(self, inflight):
        """Read one dispatched chunk back (waiting in a worker thread, so
        the event loop keeps serving) and emit each request's audio."""
        seq, ring, n = inflight
        await asyncio.get_running_loop().run_in_executor(None, self._g.wait, ring)
        out = self._host[n][ring]
        codes, valid, audio = out.codes.numpy(), out.valid.numpy(), out.audio.numpy()
        for b in range(self.slots):
            req = self._reqs[b]
            if req is None:
                self._maybe_repark(b)
                continue
            if req.first_seq > seq:
                continue   # a speculative chunk of the slot's previous occupant
            n_valid = int(valid[b].sum())
            take = min(n_valid, req.cap - req.emitted)
            done = req.cancelled or n_valid < n or req.emitted + take >= req.cap
            if take > 0 and not req.cancelled:
                req.queue.put_nowait(audio[b, :take * self._hop].copy())
                req.codes.append(codes[b, :take].copy())
                req.emitted += take
            if done:
                req.queue.put_nowait(None)
                self._reqs[b] = None
                self._maybe_repark(b)

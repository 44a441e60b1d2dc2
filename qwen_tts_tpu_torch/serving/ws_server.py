"""Live WebSocket TTS server over the continuous batcher.

Port of `qwen_tts_tpu/serving/ws_server.py`: every connection submits into
ONE shared `ContinuousBatcher` (`runtime/continuous.py`), so K concurrent
clients cost one batched stream on the card instead of K engines. The
WebSocket protocol itself is the port's own (`serving/_websocket.py`, on
asyncio streams): the GPU host has no `websockets` package, and the server
runs the same code everywhere.

Wire protocol (one in-flight request per connection; control frames are
read CONCURRENTLY with streaming, so cancel/ping work mid-utterance):

  client → server (text frame, JSON):
    {"type": "synthesize", "text": "...", "id": "optional-id"}
    {"type": "cancel"}           barge-in: stop the in-flight request
    {"type": "ping"}

  server → client:
    {"type": "started", "id": ..., "sample_rate": 24000}    (text/JSON)
    <binary frames>  PCM16 little-endian mono audio chunks
    {"type": "stopped", "id": ..., "chunks": N, "samples": M}
    {"type": "cancelled", "id": ..., "chunks": N, "samples": M}
    {"type": "error", "id": ..., "message": "..."}
    {"type": "pong", "active": N, "pending": M, "slots": B}

`cancel` is the voice agent's barge-in: the synthesis task is cancelled,
the `cancelled` terminal is sent at once from the reader loop, and late
chunks are discarded (flag-gated under the send lock), so no audio frame
of a stream follows its terminal. The batch slot frees at the next chunk
boundary. A disconnect mid-stream takes the same path. `--max-pending N`
refuses a request when every slot is busy and N requests already wait.

A terminal's `chunks` and `samples` count exactly the audio frames of the
stream that went onto the wire before it: a frame is counted under the
send lock as it is handed to the connection, which writes it before it can
be interrupted (the JAX server counts after the send returns, so a cancel
landing inside a send leaves the count one short of what the client saw).

CLI:  python -m qwen_tts_tpu_torch.serving.ws_server --port 8766 --slots 4 \\
          [--quantize int8|int4|mixed] [--kv-cache int8] [--max-seq 2048] \\
          [--max-pending 8]
Client helper: `synthesize_ws(uri, text)`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import time
from typing import Optional

import numpy as np

from ._websocket import ConnectionClosed, connect, serve
from .shared import SharedBatcher

logger = logging.getLogger(__name__)


def _pcm16(audio: np.ndarray) -> bytes:
    from ..runtime.native import f32_to_pcm16

    return f32_to_pcm16(np.asarray(audio))


class _Stream:
    """Per-request wire state shared between the synthesis task and the
    reader loop's barge-in path. `terminal_sent` is the single-writer gate
    (checked and set under the connection's send lock): after the terminal
    frame goes out, no audio frame of this stream may follow."""

    __slots__ = ("rid", "chunks", "samples", "terminal_sent")

    def __init__(self, rid: str):
        self.rid = rid
        self.chunks = 0
        self.samples = 0
        self.terminal_sent = False


class TTSWebSocketServer:
    """Serve TTS over WebSocket; all connections share one batcher."""

    def __init__(self, shared: SharedBatcher, host: str = "127.0.0.1",
                 port: int = 8766, max_pending: Optional[int] = None):
        self.shared = shared
        self.host = host
        self.port = port
        self.max_pending = max_pending
        self._server = None

    def _at_capacity(self) -> bool:
        b = self.shared.batcher
        return (self.max_pending is not None and b is not None
                and b.active >= b.slots and b.pending >= self.max_pending)

    async def _synthesize(self, ws, send_lock, stream: _Stream, text: str) -> None:
        """Stream one utterance; runs as a task so the reader loop keeps
        serving cancel and ping. Its terminal is `stopped`, or `cancelled`
        on barge-in or disconnect."""
        rid = stream.rid
        try:
            batcher = await self.shared.get()
            async with send_lock:
                if stream.terminal_sent:
                    return
                await ws.send(json.dumps(
                    {"type": "started", "id": rid, "sample_rate": batcher.eng.sample_rate}))
            chunks = batcher.submit(text)
            try:
                async for audio, _sr in chunks:
                    pcm = _pcm16(audio)
                    async with send_lock:
                        if stream.terminal_sent:
                            return
                        # counted as it goes onto the wire: send() writes the
                        # frame before it first yields
                        stream.chunks += 1
                        stream.samples += int(audio.shape[0])
                        await ws.send(pcm)
            finally:
                await chunks.aclose()   # a request left early frees its slot next chunk
            await self._send_terminal(ws, send_lock, stream, "stopped")
        except asyncio.CancelledError:
            # barge-in or disconnect: submit()'s finally marks the request
            # cancelled and the slot frees at the next chunk boundary; the
            # reader's cancel path has usually sent the terminal already
            try:
                await self._send_terminal(ws, send_lock, stream, "cancelled")
            except Exception:       # connection already gone
                pass
            raise
        except ConnectionClosed:
            pass                    # the client left: nothing to tell it
        except Exception as e:  # noqa: BLE001 - keep the connection alive
            logger.exception("synthesis failed for %s", rid)
            try:
                async with send_lock:
                    if not stream.terminal_sent:
                        stream.terminal_sent = True
                        await ws.send(json.dumps(
                            {"type": "error", "id": rid,
                             "message": f"{type(e).__name__}: {e}"}))
            except Exception:       # the send failed: connection gone
                pass

    @staticmethod
    async def _send_terminal(ws, send_lock, stream: _Stream, kind: str) -> None:
        """Send the stream's terminal frame exactly once (flag-guarded)."""
        async with send_lock:
            if stream.terminal_sent:
                return
            stream.terminal_sent = True
            await ws.send(json.dumps({"type": kind, "id": stream.rid,
                                      "chunks": stream.chunks, "samples": stream.samples}))

    async def handle(self, ws) -> None:
        """One connection: a reader loop plus at most one in-flight
        synthesis task, so control frames work mid-stream."""
        counter = 0
        send_lock = asyncio.Lock()
        current: Optional[tuple[asyncio.Task, _Stream]] = None

        async def error(rid, message):
            async with send_lock:
                await ws.send(json.dumps({"type": "error", "id": rid, "message": message}))

        try:
            async for message in ws:
                if isinstance(message, bytes):
                    await error(None, "binary frames are not valid requests")
                    continue
                try:
                    req = json.loads(message)
                except json.JSONDecodeError:
                    await error(None, "request is not valid JSON")
                    continue
                kind = req.get("type") if isinstance(req, dict) else None

                if kind == "ping":
                    b = self.shared.batcher
                    async with send_lock:
                        await ws.send(json.dumps(
                            {"type": "pong", "active": b.active if b else 0,
                             "pending": b.pending if b else 0, "slots": b.slots if b else 0}))
                elif kind == "cancel":
                    if current is not None and not current[0].done():
                        task, stream = current
                        task.cancel()
                        # the terminal goes out now; the flag discards late
                        # chunks instead of waiting for the task to drain
                        await self._send_terminal(ws, send_lock, stream, "cancelled")
                    current = None
                elif kind == "synthesize" and req.get("text"):
                    if current is not None and not current[0].done():
                        await error(req.get("id"), "one in-flight request per connection "
                                                   '(send {"type": "cancel"} to barge in)')
                        continue
                    if self._at_capacity():
                        await error(req.get("id"), f"server at capacity (pending >= "
                                                   f"{self.max_pending}); retry later")
                        continue
                    counter += 1
                    stream = _Stream(req.get("id", f"req-{counter}"))
                    current = (asyncio.create_task(
                        self._synthesize(ws, send_lock, stream, req["text"])), stream)
                else:
                    await error(req.get("id") if isinstance(req, dict) else None,
                                'expected {"type": "synthesize", "text": ...} | "cancel" | '
                                '"ping"')
        finally:
            if current is not None and not current[0].done():
                current[0].cancel()    # disconnect mid-stream: free the slot
                try:
                    await current[0]
                except asyncio.CancelledError:
                    pass

    async def start(self) -> None:
        self._server = await serve(self.handle, self.host, self.port, max_size=None)
        if self.port == 0:   # ephemeral: publish the bound port
            self.port = self._server.sockets[0].getsockname()[1]
        logger.info("TTS WebSocket server on ws://%s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        await self.start()
        try:
            await asyncio.get_running_loop().create_future()  # run until ^C
        finally:
            await self.stop()


async def synthesize_ws(uri: str, text: str, rid: Optional[str] = None
                        ) -> tuple[np.ndarray, int, dict]:
    """Client helper: one synthesize round trip → (f32 audio, sample rate,
    the `stopped` frame)."""
    async with connect(uri, max_size=None) as ws:
        payload = {"type": "synthesize", "text": text}
        if rid is not None:
            payload["id"] = rid
        await ws.send(json.dumps(payload))

        started = json.loads(await ws.recv())
        if started.get("type") == "error":
            raise RuntimeError(started["message"])
        if started.get("type") != "started":
            raise RuntimeError(f"expected a started frame, got {started}")
        sr = started["sample_rate"]

        pcm = bytearray()
        while True:
            msg = await ws.recv()
            if isinstance(msg, bytes):
                pcm.extend(msg)
                continue
            final = json.loads(msg)
            if final.get("type") == "error":
                raise RuntimeError(final["message"])
            if final.get("type") != "stopped":
                raise RuntimeError(f"expected a stopped frame, got {final}")
            break
    audio = np.frombuffer(bytes(pcm), np.int16).astype(np.float32) / 32767.0
    return audio, sr, final


def main(argv: Optional[list[str]] = None) -> None:
    from ..engine.tts_engine import TTSConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8766)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk-frames", type=int, default=10)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--quantize", default=None, choices=["int8", "int4", "mixed"])
    ap.add_argument("--kv-cache", default=None, choices=["int8"])
    ap.add_argument("--cp-quantize", default=None, choices=["int8", "int4", "mixed"])
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the slot-warming pass (the first request then pays for "
                         "the graph captures)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="refuse new requests when all slots are busy and this many are "
                         "already queued (default: unbounded)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = TTSConfig(max_seq_len=args.max_seq, warmup=False)
    if args.quantize:
        cfg.quantize = args.quantize
    if args.kv_cache:
        cfg.kv_cache = args.kv_cache
    if args.cp_quantize:
        cfg.cp_quantize = args.cp_quantize
    shared = SharedBatcher(config=cfg, slots=args.slots, chunk_frames=args.chunk_frames,
                           warm=not args.no_warm)
    server = TTSWebSocketServer(shared, host=args.host, port=args.port,
                                max_pending=args.max_pending)
    t0 = time.perf_counter()

    async def run():
        # build and warm before accepting connections: no client waits for
        # the weights or the graph captures
        await shared.get()
        logger.info("cold->ready %.1f s (quantize=%s kv=%s slots=%d)",
                    time.perf_counter() - t0, args.quantize, args.kv_cache, args.slots)
        await server.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()

"""The port's WebSocket server (`qwen_tts_tpu_torch/serving/ws_server.py`) on
its own RFC 6455 framing (`serving/_websocket.py`), live on localhost.

The counterparts of `tests/test_ws_server.py`'s seven tests, each driven
by two clients: the independent `websockets` package and the port's own
client. Tiny engines on the CPU share one `ContinuousBatcher`. The
barge-in test asserts the exact accounting of the port's server: the
`cancelled` terminal counts every audio frame the client received before
it, no more. Framing edge cases against raw sockets and an echo server:
7-, 16- and 64-bit lengths (a 70,000-byte binary frame), a fragmented
text message, an unmasked client frame refused with 1002, a bad
handshake refused with 400, pings, and the closing handshake from either
side.
"""

import asyncio
import base64
import json
import os
import struct

import numpy as np
import pytest
import torch
from websockets.asyncio.client import connect as ws_connect

from qwen_tts_tpu_torch.core.config import tiny_test_config
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.runtime.continuous import ContinuousBatcher
from qwen_tts_tpu_torch.serving import _websocket as wsp
from qwen_tts_tpu_torch.serving.shared import SharedBatcher
from qwen_tts_tpu_torch.serving.ws_server import TTSWebSocketServer, synthesize_ws

CLIENTS = {"websockets": ws_connect, "port": wsp.connect}
LONG = "the user talks over this long reply now"   # 8 words: an 80-frame cap


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config() -> TTSConfig:
    return TTSConfig(device="cpu", max_seq_len=256, vocoder_mode="random", seed=0,
                     trailing_bucket=16, chunk_frames=4, warmup=False)


def _batcher(slots: int) -> ContinuousBatcher:
    eng = TTSEngine(_config(), model_config=tiny_test_config(max_seq_len=256))
    eng.initialize()
    return ContinuousBatcher(eng, slots=slots, chunk_frames=4)


@pytest.fixture(scope="module")
def batcher2():
    return _batcher(2)


@pytest.fixture(scope="module")
def batcher1():
    return _batcher(1)


@pytest.fixture(params=sorted(CLIENTS))
def connect(request):
    return CLIENTS[request.param]


def _run(server, drive):
    """Start the server, run `drive(uri)`, stop the server."""
    async def main():
        await server.start()
        try:
            return await drive(f"ws://{server.host}:{server.port}")
        finally:
            await server.stop()
    return asyncio.run(main())


async def _drained(batcher):
    for _ in range(200):
        if batcher.active == 0:
            return True
        await asyncio.sleep(0.05)
    return False


async def _to_terminal(ws):
    """(audio bytes, audio frames, the terminal JSON frame)."""
    nbytes = frames = 0
    while True:
        msg = await ws.recv()
        if isinstance(msg, bytes):
            nbytes, frames = nbytes + len(msg), frames + 1
            continue
        return nbytes, frames, json.loads(msg)


async def _round_trip(connect, uri, text, rid):
    if connect is wsp.connect:
        audio, sr, fin = await synthesize_ws(uri, text, rid=rid)
        return audio.shape[0] * 2, sr, fin
    async with connect(uri, max_size=None) as ws:
        await ws.send(json.dumps({"type": "synthesize", "text": text, "id": rid}))
        started = json.loads(await ws.recv())
        assert started["type"] == "started"
        nbytes, _n, fin = await _to_terminal(ws)
        return nbytes, started["sample_rate"], fin


def test_protocol_errors_and_ping_without_engine(connect):
    """Malformed requests and pings are answered without building the
    engine: the server is healthy before (and without) the card."""
    shared = SharedBatcher(config=_config(), slots=2, chunk_frames=4,
                           model_config=tiny_test_config(max_seq_len=256), warm=False)
    server = TTSWebSocketServer(shared, port=0)

    async def drive(uri):
        async with connect(uri) as ws:
            await ws.send("this is not json")
            err = json.loads(await ws.recv())
            assert err["type"] == "error" and "JSON" in err["message"]
            await ws.send(json.dumps({"type": "synthesize"}))            # no text
            assert json.loads(await ws.recv())["type"] == "error"
            await ws.send(b"\x00\x01")                                   # binary request
            assert json.loads(await ws.recv())["type"] == "error"
            await ws.send(json.dumps([1, 2]))                            # not an object
            assert json.loads(await ws.recv())["type"] == "error"
            await ws.send(json.dumps({"type": "ping"}))
            assert json.loads(await ws.recv()) == {"type": "pong", "active": 0,
                                                   "pending": 0, "slots": 0}
            await ws.send(json.dumps({"type": "cancel"}))                # no-op
            await ws.send(json.dumps({"type": "ping"}))
            assert json.loads(await ws.recv())["type"] == "pong"

    _run(server, drive)
    assert server.shared.batcher is None       # never built


def test_concurrent_clients_share_one_batcher(connect, batcher2):
    server = TTSWebSocketServer(SharedBatcher(batcher=batcher2), port=0)

    async def drive(uri):
        return await asyncio.gather(
            _round_trip(connect, uri, "first websocket client", "a"),
            _round_trip(connect, uri, "the second client at the same time", "b"))

    results = _run(server, drive)
    for (nbytes, sr, fin), rid in zip(results, "ab"):
        assert sr == 24000 and fin["id"] == rid
        assert fin["type"] == "stopped" and fin["chunks"] >= 1
        assert nbytes == 2 * fin["samples"] > 0
    assert batcher2.active == 0


def test_midstream_disconnect_frees_slot_and_server_survives(connect, batcher2):
    server = TTSWebSocketServer(SharedBatcher(batcher=batcher2), port=0)

    async def drive(uri):
        async with connect(uri, max_size=None) as ws:
            await ws.send(json.dumps({"type": "synthesize", "id": "gone", "text": LONG}))
            assert json.loads(await ws.recv())["type"] == "started"
            msg = await ws.recv()
            assert isinstance(msg, bytes) and len(msg) > 0
            # hang up mid-stream (leaving the context closes the connection)
        nbytes, _sr, fin = await _round_trip(connect, uri, "a fresh client after it", "after")
        assert fin["chunks"] >= 1 and nbytes > 0
        assert await _drained(batcher2)

    _run(server, drive)


def test_cancel_barges_in_and_connection_stays_usable(connect, batcher2):
    """`cancel` mid-stream: the `cancelled` terminal counts exactly the audio
    frames the client received, none follows it, and the same connection
    synthesizes again."""
    server = TTSWebSocketServer(SharedBatcher(batcher=batcher2), port=0)

    async def drive(uri):
        async with connect(uri, max_size=None) as ws:
            await ws.send(json.dumps({"type": "synthesize", "id": "barged", "text": LONG}))
            assert json.loads(await ws.recv())["type"] == "started"
            first = await ws.recv()
            assert isinstance(first, bytes) and len(first) > 0
            await ws.send(json.dumps({"type": "cancel"}))
            nbytes, frames, fin = await _to_terminal(ws)
            assert fin["type"] == "cancelled" and fin["id"] == "barged"
            assert fin["chunks"] == frames + 1                  # the first one included
            assert 2 * fin["samples"] == nbytes + len(first)

            await ws.send(json.dumps({"type": "synthesize", "id": "next",
                                      "text": "the reply after the interruption"}))
            nxt = await ws.recv()
            assert not isinstance(nxt, bytes), "audio leaked after the cancelled terminal"
            assert json.loads(nxt) == {"type": "started", "id": "next", "sample_rate": 24000}
            nbytes, frames, fin = await _to_terminal(ws)
            assert fin["type"] == "stopped" and fin["id"] == "next"
            assert fin["chunks"] == frames and 2 * fin["samples"] == nbytes > 0
        assert await _drained(batcher2)

    _run(server, drive)


def test_second_synthesize_while_streaming_is_refused(connect, batcher2):
    server = TTSWebSocketServer(SharedBatcher(batcher=batcher2), port=0)

    async def drive(uri):
        async with connect(uri, max_size=None) as ws:
            await ws.send(json.dumps({"type": "synthesize", "id": "one",
                                      "text": "the first utterance is still streaming"}))
            assert json.loads(await ws.recv())["type"] == "started"
            await ws.send(json.dumps({"type": "synthesize", "id": "two", "text": "too soon"}))
            got_err = fin = None
            while fin is None:
                msg = await ws.recv()
                if isinstance(msg, bytes):
                    continue
                frame = json.loads(msg)
                if frame["type"] == "error":
                    got_err = frame
                elif frame["type"] == "stopped":
                    fin = frame
            assert got_err is not None and got_err["id"] == "two"
            assert "cancel" in got_err["message"]
            assert fin["id"] == "one" and fin["chunks"] >= 1

    _run(server, drive)


def test_backpressure_refuses_when_queue_full(connect, batcher1):
    """--max-pending 0 with the one slot busy: a new request is refused with
    a capacity error; once the slot frees it is served."""
    server = TTSWebSocketServer(SharedBatcher(batcher=batcher1), port=0, max_pending=0)

    async def drive(uri):
        async with connect(uri, max_size=None) as w1, connect(uri, max_size=None) as w2:
            await w1.send(json.dumps({"type": "synthesize", "id": "hog", "text": LONG}))
            assert json.loads(await w1.recv())["type"] == "started"
            assert isinstance(await w1.recv(), bytes)         # the slot is taken
            await w2.send(json.dumps({"type": "synthesize", "id": "late", "text": "hello"}))
            err = json.loads(await w2.recv())
            assert err["type"] == "error" and err["id"] == "late"
            assert "capacity" in err["message"]
            _b, _n, fin = await _to_terminal(w1)
            assert fin["type"] == "stopped" and fin["chunks"] >= 1
            assert await _drained(batcher1)
            await w2.send(json.dumps({"type": "synthesize", "id": "retry", "text": "hello"}))
            assert json.loads(await w2.recv())["type"] == "started"
            _b, _n, fin = await _to_terminal(w2)
            assert fin["type"] == "stopped"

    _run(server, drive)


def test_sequential_requests_reuse_connection(connect, batcher2):
    server = TTSWebSocketServer(SharedBatcher(batcher=batcher2), port=0)

    async def drive(uri):
        async with connect(uri, max_size=None) as ws:
            for rid, text in (("r1", "request number one"), ("r2", "and request number two")):
                await ws.send(json.dumps({"type": "synthesize", "text": text, "id": rid}))
                assert json.loads(await ws.recv()) == {"type": "started", "id": rid,
                                                       "sample_rate": 24000}
                nbytes, frames, fin = await _to_terminal(ws)
                assert fin["type"] == "stopped" and fin["id"] == rid
                assert fin["chunks"] == frames and 2 * fin["samples"] == nbytes > 0

    _run(server, drive)


# ── framing ──────────────────────────────────────────────────────────────


@pytest.mark.parametrize("n", [0, 1, 125, 126, 65535, 65536, 70_000])
@pytest.mark.parametrize("masked", [False, True])
def test_frame_lengths_round_trip(n, masked):
    """7-, 16- and 64-bit lengths, masked or not, parse back to the payload."""
    payload = os.urandom(n)
    key = os.urandom(4) if masked else None
    raw = wsp.encode_frame(wsp.OP_BINARY, payload, mask_key=key)
    head = 2 + (0 if n < 126 else 2 if n < 65536 else 8) + (4 if masked else 0)
    assert len(raw) == head + n and (raw[1] & 0x7F) == (n if n < 126 else 126 if n < 65536
                                                         else 127)

    async def parse():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        ws = wsp.WebSocket(reader, _NullWriter(), client=not masked, max_size=None)
        return await ws._read_frame()

    assert asyncio.run(parse()) == (True, wsp.OP_BINARY, payload)


class _NullWriter:
    def get_extra_info(self, name):
        return None

    def is_closing(self):
        return False

    def write(self, data):
        pass

    def close(self):
        pass


async def _echo(ws):
    async for message in ws:
        await ws.send(message)


def _echo_run(drive):
    async def main():
        server = await wsp.serve(_echo, "127.0.0.1", 0, max_size=None)
        try:
            return await drive(f"ws://127.0.0.1:{server.sockets[0].getsockname()[1]}", server)
        finally:
            server.close()
            await server.wait_closed()
    return asyncio.run(main())


def test_large_binary_frame_both_ways(connect):
    """A 70,000-byte binary frame (a 64-bit length) to the server and back."""
    big = os.urandom(70_000)

    async def drive(uri, _server):
        async with connect(uri, max_size=None) as ws:
            await ws.send(big)
            assert await ws.recv() == big

    _echo_run(drive)


def test_websockets_client_fragments_and_pings():
    """The `websockets` package's fragmented text message is joined, and its
    ping is answered with a pong."""
    async def drive(uri, _server):
        async with ws_connect(uri) as ws:
            await ws.send(iter(["héllo, ", "frag", "mented"]))
            assert await ws.recv() == "héllo, fragmented"
            await asyncio.wait_for(await ws.ping(b"abc"), 5)

    _echo_run(drive)


def _masked(opcode, payload, fin=True):
    return wsp.encode_frame(opcode, payload, fin, mask_key=os.urandom(4))


async def _read_raw_frame(reader):
    b0, b1 = await reader.readexactly(2)
    assert not b1 & 0x80                       # the server never masks
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
    return b0, await reader.readexactly(n)


def test_fragmented_message_with_a_ping_between_its_frames():
    """A text message in three frames (text, continuation, continuation)
    with a ping between them: the pong comes at once, then the joined
    message."""
    async def drive(uri, server):
        reader, writer = await _raw_handshake(server.sockets[0].getsockname()[1])
        writer.write(_masked(wsp.OP_TEXT, "héllo, ".encode(), fin=False)
                     + _masked(wsp.OP_PING, b"abc")
                     + _masked(wsp.OP_CONT, b"frag", fin=False)
                     + _masked(wsp.OP_CONT, b"mented"))
        assert await _read_raw_frame(reader) == (0x80 | wsp.OP_PONG, b"abc")
        assert await _read_raw_frame(reader) == (0x80 | wsp.OP_TEXT,
                                                 "héllo, fragmented".encode())
        writer.write(_masked(wsp.OP_CLOSE, struct.pack("!H", 1000)))
        b0, body = await _read_raw_frame(reader)
        assert b0 == 0x80 | wsp.OP_CLOSE and struct.unpack("!H", body[:2])[0] == 1000
        assert await reader.read() == b""       # the server closed the TCP connection
        writer.close()

    _echo_run(drive)


def test_close_handshake_both_ways(connect):
    """Client-initiated: the server echoes the close (1000). Server-initiated
    (the server stops): the client sees 1001."""
    async def drive(uri, server):
        async with connect(uri) as ws:
            await ws.send("x")
            assert await ws.recv() == "x"
        assert ws.close_code == 1000
        ws2 = await connect(uri).__aenter__()
        await ws2.send("y")
        assert await ws2.recv() == "y"
        server.close()
        with pytest.raises(Exception) as info:
            await asyncio.wait_for(ws2.recv(), 10)
        assert ws2.close_code == 1001, info.value

    _echo_run(drive)


async def _raw_handshake(port: int):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
    head = await reader.readuntil(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 101") and wsp.accept_key(key).encode() in head
    return reader, writer


def test_unmasked_client_frame_is_refused():
    """A client frame without a mask gets a close frame with 1002 and the
    connection closed, per RFC 6455 §5.1."""
    async def drive(uri, server):
        reader, writer = await _raw_handshake(server.sockets[0].getsockname()[1])
        writer.write(wsp.encode_frame(wsp.OP_TEXT, b"unmasked"))
        b0, b1 = await reader.readexactly(2)
        assert b0 == 0x80 | wsp.OP_CLOSE and not b1 & 0x80
        body = await reader.readexactly(b1 & 0x7F)
        assert struct.unpack("!H", body[:2])[0] == 1002
        assert await reader.read() == b""           # the server closed the TCP connection
        writer.close()

    _echo_run(drive)


def test_bad_handshake_gets_400():
    """A request without a key is answered 400 and closed; the port's client
    refuses a server that answers without upgrading."""
    async def bad_request(uri, server):
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", server.sockets[0].getsockname()[1])
        writer.write(b"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n\r\n")
        assert (await reader.read()).startswith(b"HTTP/1.1 400")
        writer.close()

    _echo_run(bad_request)

    async def not_upgrading():
        async def plain_http(reader, writer):
            await reader.readuntil(b"\r\n\r\n")
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n")
            writer.close()

        plain = await asyncio.start_server(plain_http, "127.0.0.1", 0)
        port = plain.sockets[0].getsockname()[1]
        try:
            with pytest.raises(wsp.InvalidHandshake):
                await wsp.connect(f"ws://127.0.0.1:{port}/").__aenter__()
        finally:
            plain.close()
            await plain.wait_closed()

    asyncio.run(not_upgrading())


def test_synthesize_ws_audio_matches_its_accounting(batcher2):
    """The port's client helper: f32 audio of `samples` samples."""
    server = TTSWebSocketServer(SharedBatcher(batcher=batcher2), port=0)
    audio, sr, fin = _run(server, lambda uri: synthesize_ws(uri, "hello from the helper"))
    assert sr == 24000 and fin["type"] == "stopped"
    assert audio.dtype == np.float32 and audio.shape[0] == fin["samples"] > 0
    assert np.abs(audio).max() <= 1.0

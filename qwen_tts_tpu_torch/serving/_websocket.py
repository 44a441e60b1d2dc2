"""WebSocket (RFC 6455) connections, server and client, on asyncio streams.

The port's WebSocket server (`serving/ws_server.py`) must run where the
`websockets` package is not installed, so the protocol it needs is here,
on the standard library alone:

- the opening handshake: a GET with `Upgrade: websocket`, `Connection:
  Upgrade`, `Sec-WebSocket-Version: 13` and a 16-byte `Sec-WebSocket-Key`,
  answered by `101 Switching Protocols` with `Sec-WebSocket-Accept` =
  base64(SHA-1(key + the RFC's GUID)); anything else gets `400` and is
  closed. No extension or subprotocol is negotiated;
- frames: FIN, no reserved bits, opcode, a 7-bit length or 126 + 16 bits or
  127 + 64 bits, a 4-byte mask; text (UTF-8), binary, continuation, close,
  ping and pong. A client masks every frame it sends and a server refuses
  an unmasked one (close 1002), as a client refuses a masked one. A
  fragmented message is joined from its continuation frames; control
  frames may come between them. A ping is answered with a pong carrying
  its payload; invalid UTF-8 in a text message closes with 1007, a message
  above `max_size` with 1009;
- the closing handshake: a close frame is answered with a close frame of
  the same code, then the server closes the TCP connection; `close()`
  sends one and waits (at most `CLOSE_TIMEOUT` seconds) for the peer's.

A connection is read by whoever awaits `recv()` (or iterates it): pings
and closes are answered there. `send()` writes the whole frame to the
transport before it first yields (then waits for the transport to drain),
so a task cancelled inside `send()` has still sent its frame, and frames
sent by concurrent tasks never interleave.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import hashlib
import logging
import os
import struct
from typing import Awaitable, Callable, Optional
from urllib.parse import urlsplit

logger = logging.getLogger(__name__)

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
_OPCODES = (OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG)
CLOSE_TIMEOUT = 5.0        # seconds to wait for the peer's close frame
HANDSHAKE_TIMEOUT = 10.0   # seconds for the opening handshake's request or answer
DEFAULT_MAX_SIZE = 1 << 20


class ConnectionClosed(Exception):
    """The connection is closed: `code` (1000 normal, 1001 going away, 1002
    protocol error, 1006 lost without a close frame, 1007 invalid UTF-8,
    1009 too big) and the close frame's reason."""

    def __init__(self, code: int, reason: str = ""):
        super().__init__(f"connection closed: {code} {reason}".rstrip())
        self.code, self.reason = code, reason


class InvalidHandshake(Exception):
    """The server did not accept the client's opening handshake."""


class _ProtocolError(Exception):
    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code


def accept_key(key: str) -> str:
    """The `Sec-WebSocket-Accept` answering the client's `Sec-WebSocket-Key`."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


def apply_mask(data: bytes, key: bytes) -> bytes:
    """`data` XOR the 4-byte `key` repeated (masking and unmasking alike)."""
    n = len(data)
    if not n:
        return data
    pad = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(pad, "little")).to_bytes(n, "little")


def encode_frame(opcode: int, payload: bytes, fin: bool = True,
                 mask_key: Optional[bytes] = None) -> bytes:
    """One frame: header, length in 7, 16 or 64 bits, mask key, payload."""
    n, m = len(payload), 0x80 if mask_key is not None else 0
    head = bytearray([(0x80 if fin else 0) | opcode])
    if n < 126:
        head.append(m | n)
    elif n < 1 << 16:
        head.append(m | 126)
        head += struct.pack("!H", n)
    else:
        head.append(m | 127)
        head += struct.pack("!Q", n)
    if mask_key is not None:
        head += mask_key
        payload = apply_mask(payload, mask_key)
    return bytes(head) + payload


def _close_payload(code: int, reason: str) -> bytes:
    return struct.pack("!H", code) + reason.encode()[:123]


class WebSocket:
    """One open connection (after the handshake), client or server side."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, *,
                 client: bool, max_size: Optional[int] = DEFAULT_MAX_SIZE):
        self._reader, self._writer = reader, writer
        self._client = client
        self.max_size = max_size
        self.close_code: Optional[int] = None   # set once the connection is closed
        self.close_reason = ""
        self._close_sent = False
        self._reading = False
        self._closed = asyncio.Event()

    # ── writing ──────────────────────────────────────────────────────────

    def _write(self, opcode: int, payload: bytes, fin: bool = True) -> None:
        if self.close_code is not None or self._writer.is_closing():
            raise ConnectionClosed(self.close_code or 1006, self.close_reason)
        key = os.urandom(4) if self._client else None
        self._writer.write(encode_frame(opcode, payload, fin, key))

    async def _drain(self) -> None:
        try:
            await self._writer.drain()
        except ConnectionError:
            self._abort(1006)
            raise ConnectionClosed(1006, "connection lost") from None

    async def send(self, message) -> None:
        """Send a text (str) or binary (bytes-like) message as one frame."""
        if self._close_sent:
            raise ConnectionClosed(self.close_code or 1000, "close frame sent")
        if isinstance(message, str):
            self._write(OP_TEXT, message.encode())
        else:
            self._write(OP_BINARY, bytes(message))
        await self._drain()

    async def _send_close(self, code: int, reason: str = "") -> None:
        if self._close_sent:
            return
        self._close_sent = True
        self._write(OP_CLOSE, _close_payload(code, reason))
        await self._drain()

    # ── reading ──────────────────────────────────────────────────────────

    async def _read_frame(self):
        b0, b1 = await self._reader.readexactly(2)
        fin, opcode, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        if b0 & 0x70:
            raise _ProtocolError(1002, "reserved bits set")
        if opcode not in _OPCODES:
            raise _ProtocolError(1002, f"unknown opcode {opcode}")
        if n == 126:
            n = struct.unpack("!H", await self._reader.readexactly(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", await self._reader.readexactly(8))[0]
            if n >> 63:
                raise _ProtocolError(1002, "64-bit length with its top bit set")
        if opcode >= OP_CLOSE and (not fin or n > 125):
            raise _ProtocolError(1002, "fragmented or oversized control frame")
        if masked == self._client:
            raise _ProtocolError(1002, "masked frame from the server" if self._client
                                 else "unmasked frame from the client")
        if self.max_size is not None and n > self.max_size:
            raise _ProtocolError(1009, f"frame of {n} bytes above max_size {self.max_size}")
        key = await self._reader.readexactly(4) if masked else None
        payload = await self._reader.readexactly(n)
        return fin, opcode, apply_mask(payload, key) if key else payload

    async def _next_message(self):
        kind, parts, size = None, [], 0
        while True:
            fin, op, data = await self._read_frame()
            if op == OP_PING:
                self._write(OP_PONG, data)
                await self._drain()
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                await self._peer_closed(data)
                raise ConnectionClosed(self.close_code, self.close_reason)
            if op == OP_CONT and kind is None:
                raise _ProtocolError(1002, "continuation frame outside a message")
            if op != OP_CONT and kind is not None:
                raise _ProtocolError(1002, "new message inside a fragmented one")
            kind = kind if op == OP_CONT else op
            parts.append(data)
            size += len(data)
            if self.max_size is not None and size > self.max_size:
                raise _ProtocolError(1009, f"message above max_size {self.max_size}")
            if fin:
                break
        payload = b"".join(parts)
        if kind == OP_BINARY:
            return payload
        try:
            return payload.decode("utf-8")
        except UnicodeDecodeError:
            raise _ProtocolError(1007, "invalid UTF-8 in a text message") from None

    async def recv(self):
        """The next message: str for text, bytes for binary. Answers pings
        and the peer's close on the way; raises `ConnectionClosed` once the
        connection is closed."""
        if self.close_code is not None:
            raise ConnectionClosed(self.close_code, self.close_reason)
        self._reading = True
        try:
            return await self._next_message()
        except (asyncio.IncompleteReadError, ConnectionError):
            self._abort(1006, "connection lost")
            raise ConnectionClosed(1006, "connection lost") from None
        except _ProtocolError as e:
            await self._fail(e.code, str(e))
            raise ConnectionClosed(e.code, str(e)) from None
        finally:
            self._reading = False

    def __aiter__(self):
        return self._messages()

    async def _messages(self):
        """Messages until the connection closes (however it closes)."""
        while True:
            try:
                yield await self.recv()
            except ConnectionClosed:
                return

    # ── closing ──────────────────────────────────────────────────────────

    async def _peer_closed(self, data: bytes) -> None:
        """The peer's close frame: answer it with its code (unless ours was
        sent first), then close the connection."""
        if len(data) == 1:
            raise _ProtocolError(1002, "close frame with a 1-byte payload")
        code = struct.unpack("!H", data[:2])[0] if data else 1005
        reason = data[2:].decode("utf-8", "replace")
        if not self._close_sent:
            try:
                await self._send_close(1000 if code == 1005 else code, "")
            except ConnectionClosed:
                pass
        self._abort(code, reason)

    async def _fail(self, code: int, reason: str) -> None:
        try:
            await self._send_close(code, reason)
        except ConnectionClosed:
            pass
        self._abort(code, reason)

    def _abort(self, code: int, reason: str = "") -> None:
        if self.close_code is None:
            self.close_code, self.close_reason = code, reason
        self._closed.set()
        self._writer.close()

    async def close(self, code: int = 1000, reason: str = "") -> None:
        """The closing handshake: send a close frame, wait for the peer's
        (read here, or by a task already inside `recv()`), close the TCP
        connection."""
        if self.close_code is not None:
            return
        try:
            await self._send_close(code, reason)
            if self._reading:
                await asyncio.wait_for(self._closed.wait(), CLOSE_TIMEOUT)
            else:
                while self.close_code is None:
                    await asyncio.wait_for(self.recv(), CLOSE_TIMEOUT)
        except (ConnectionClosed, asyncio.TimeoutError):
            pass
        self._abort(code, reason)


# ── server ───────────────────────────────────────────────────────────────


def _headers(head: bytes) -> tuple[str, dict[str, str]]:
    lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if sep:
            headers[name.strip().lower()] = value.strip()
    return lines[0], headers


def _tokens(value: str) -> set[str]:
    return {t.strip().lower() for t in value.split(",")}


async def _server_handshake(reader, writer, max_size) -> Optional[WebSocket]:
    """Read and answer the opening handshake: the connection, or None
    (after a 400 answer) when the request is not a WebSocket upgrade."""
    try:
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), HANDSHAKE_TIMEOUT)
        request, headers = _headers(head)
        method, _path, _version = request.split(" ", 2)
        key = headers.get("sec-websocket-key", "")
        ok = (method == "GET" and "websocket" in _tokens(headers.get("upgrade", ""))
              and "upgrade" in _tokens(headers.get("connection", ""))
              and headers.get("sec-websocket-version") == "13"
              and len(base64.b64decode(key, validate=True)) == 16)
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, asyncio.TimeoutError,
            ConnectionError, ValueError, binascii.Error):
        ok = False
    if not ok:
        writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n"
                     b"Connection: close\r\n\r\n")
        writer.close()
        return None
    writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                  "Connection: Upgrade\r\n"
                  f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n").encode())
    await writer.drain()
    return WebSocket(reader, writer, client=False, max_size=max_size)


class Server:
    """A listening WebSocket server: each connection's handshake, then
    `handler(ws)`; when the handler returns the connection is closed."""

    def __init__(self, handler: Callable[[WebSocket], Awaitable[None]],
                 max_size: Optional[int]):
        self._handler = handler
        self._max_size = max_size
        self._server: Optional[asyncio.base_events.Server] = None
        self._tasks: set[asyncio.Task] = set()
        self.connections: set[WebSocket] = set()

    @property
    def sockets(self):
        return self._server.sockets if self._server is not None else ()

    async def _on_connect(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        ws = None
        try:
            ws = await _server_handshake(reader, writer, self._max_size)
            if ws is None:
                return
            self.connections.add(ws)
            await self._handler(ws)
        except ConnectionClosed:
            pass            # the peer left while the handler wrote to it
        except Exception:   # noqa: BLE001 - one connection's fault, not the server's
            logger.exception("WebSocket handler failed")
        finally:
            if ws is not None:
                self.connections.discard(ws)
                await ws.close()
            self._tasks.discard(task)

    def close(self) -> None:
        """Stop accepting; close every open connection (going away, 1001)."""
        if self._server is not None:
            self._server.close()
        for ws in list(self.connections):
            asyncio.ensure_future(ws.close(1001, "server shutting down"))

    async def wait_closed(self) -> None:
        if self._tasks:
            await asyncio.wait(set(self._tasks), timeout=2 * CLOSE_TIMEOUT)
        if self._server is not None:
            await self._server.wait_closed()


async def serve(handler: Callable[[WebSocket], Awaitable[None]], host: str, port: int,
                max_size: Optional[int] = DEFAULT_MAX_SIZE) -> Server:
    """Listen on host:port (port 0: any free port, see `Server.sockets`)."""
    server = Server(handler, max_size)
    server._server = await asyncio.start_server(server._on_connect, host, port)
    return server


# ── client ───────────────────────────────────────────────────────────────


class connect:
    """`async with connect("ws://host:port/path") as ws:` — the client's
    handshake, and the closing handshake on exit."""

    def __init__(self, uri: str, max_size: Optional[int] = DEFAULT_MAX_SIZE):
        self.uri, self.max_size = uri, max_size
        self.ws: Optional[WebSocket] = None

    async def __aenter__(self) -> WebSocket:
        u = urlsplit(self.uri)
        if u.scheme != "ws" or not u.hostname:
            raise ValueError(f"not a ws:// URI: {self.uri!r}")
        port = u.port or 80
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        reader, writer = await asyncio.open_connection(u.hostname, port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((f"GET {path} HTTP/1.1\r\nHost: {u.hostname}:{port}\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        try:
            await writer.drain()
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), HANDSHAKE_TIMEOUT)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError, ConnectionError) as e:
            writer.close()
            raise InvalidHandshake(f"no handshake answer from {self.uri}: {e!r}") from None
        status, headers = _headers(head)
        if status.split(" ")[1:2] != ["101"] or headers.get(
                "sec-websocket-accept") != accept_key(key):
            writer.close()
            raise InvalidHandshake(f"{self.uri} refused the upgrade: {status!r}")
        self.ws = WebSocket(reader, writer, client=True, max_size=self.max_size)
        return self.ws

    async def __aexit__(self, *exc) -> None:
        await self.ws.close()

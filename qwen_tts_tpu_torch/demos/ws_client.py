"""Demo: concurrent clients against the live WebSocket TTS server.

Port of `demos/demo_ws_client.py` on the port's own WebSocket client
(`serving/_websocket.py::connect`; the GPU host has no `websockets`).
Start the server (one process, one card):

    python -m qwen_tts_tpu_torch.serving.ws_server --port 8766 --slots 4 \\
        [--quantize mixed --kv-cache int8 --cp-quantize mixed]

then drive it from anywhere:

    python -m qwen_tts_tpu_torch.demos.ws_client --port 8766 --clients 3 [--save]
    python -m qwen_tts_tpu_torch.demos.ws_client --port 8766 --barge-in

Prints, per client: first-audio latency over the socket, audio seconds,
wall time; then the aggregate real-time factor across all concurrent
streams. `--barge-in` instead cancels a long utterance after two chunks and
speaks a reply on the same connection.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
import wave

import numpy as np

from ..serving._websocket import connect

TEXTS = [
    "Hello from the first websocket client sharing the batch slots.",
    "The second client is speaking over the very same chip right now.",
    "A third stream joins while the first two are still decoding audio.",
    "Client number four arrives last and is admitted at a chunk boundary.",
]


async def one_client(uri: str, text: str, idx: int):
    t0 = time.perf_counter()
    first_audio = None
    pcm = bytearray()
    async with connect(uri, max_size=None) as ws:
        await ws.send(json.dumps({"type": "synthesize", "text": text, "id": f"c{idx}"}))
        started = json.loads(await ws.recv())
        assert started["type"] == "started", started
        sr = started["sample_rate"]
        while True:
            msg = await ws.recv()
            if isinstance(msg, bytes):
                if first_audio is None:
                    first_audio = time.perf_counter() - t0
                pcm.extend(msg)
                continue
            fin = json.loads(msg)
            if fin.get("type") == "error":
                raise RuntimeError(fin["message"])
            break
    wall = time.perf_counter() - t0
    audio = np.frombuffer(bytes(pcm), np.int16)
    secs = audio.shape[0] / sr
    print(f"client {idx}: first_audio={first_audio * 1e3:7.1f} ms  "
          f"audio={secs:5.2f} s  wall={wall:5.2f} s  "
          f"rtf={wall / max(secs, 1e-9):.3f}")
    return audio, sr, secs, wall, first_audio


async def barge_in(uri: str, cancel_after: int = 2) -> dict:
    """Voice-agent interruption: synthesize a long utterance, cancel after
    `cancel_after` audio chunks, then speak the reply on the same
    connection. Prints cancel → terminal latency and checks that the
    connection is reusable at once."""
    long_text = ("This is a deliberately long agent reply that the user "
                 "is going to talk over almost immediately, so the text "
                 "to speech stream must stop at the very next chunk "
                 "boundary instead of finishing the whole paragraph.")
    async with connect(uri, max_size=None) as ws:
        await ws.send(json.dumps({"type": "synthesize", "text": long_text,
                                  "id": "interrupted"}))
        assert json.loads(await ws.recv())["type"] == "started"
        chunks = 0
        while chunks < cancel_after:
            msg = await ws.recv()
            if isinstance(msg, bytes):
                chunks += 1
        t_cancel = time.perf_counter()
        await ws.send(json.dumps({"type": "cancel"}))
        extra = 0
        while True:
            msg = await ws.recv()
            if isinstance(msg, bytes):
                extra += 1
                continue
            fin = json.loads(msg)
            break
        t_term = time.perf_counter() - t_cancel
        assert fin["type"] == "cancelled", fin
        print(f"barge-in: cancelled after {chunks} chunks heard "
              f"(+{extra} in flight), cancel->terminal {t_term * 1e3:.1f} ms")

        _audio, _sr, secs, wall = await _reuse(ws)
        print(f"barge-in: reply on the same connection: {secs:.2f} s audio "
              f"in {wall:.2f} s wall")
    return {"chunks_heard": chunks, "in_flight": extra, "terminal": fin,
            "cancel_to_terminal_ms": t_term * 1e3, "reply_audio_s": secs}


async def _reuse(ws):
    t0 = time.perf_counter()
    await ws.send(json.dumps({"type": "synthesize", "text": "Sure, go ahead.", "id": "reply"}))
    started = json.loads(await ws.recv())
    assert started["type"] == "started", started
    sr = started["sample_rate"]
    pcm = bytearray()
    while True:
        msg = await ws.recv()
        if isinstance(msg, bytes):
            pcm.extend(msg)
            continue
        fin = json.loads(msg)
        assert fin["type"] == "stopped", fin
        break
    audio = np.frombuffer(bytes(pcm), np.int16)
    return audio, sr, audio.shape[0] / sr, time.perf_counter() - t0


async def run(args) -> dict:
    uri = f"ws://{args.host}:{args.port}"
    if args.barge_in:
        return {"barge_in": await barge_in(uri)}
    t0 = time.perf_counter()
    results = await asyncio.gather(*(one_client(uri, TEXTS[i % len(TEXTS)], i)
                                     for i in range(args.clients)))
    wall = time.perf_counter() - t0
    total_audio = sum(r[2] for r in results)
    print(f"aggregate: {total_audio:.2f} s of audio across {args.clients} concurrent "
          f"clients in {wall:.2f} s wall -> {total_audio / wall:.1f}x realtime")
    if args.save:
        for i, (audio, sr, *_rest) in enumerate(results):
            path = f"ws_client_{i}.wav"
            with wave.open(path, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(sr)
                f.writeframes(audio.tobytes())
            print(f"wrote {path}")
    return {"clients": [{"samples": int(r[0].shape[0]), "audio_s": r[2], "wall_s": r[3],
                         "first_audio_ms": r[4] * 1e3} for r in results],
            "aggregate_rt_x": total_audio / wall, "wall_s": wall}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8766)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--barge-in", action="store_true",
                    help="demo mid-stream cancellation instead of concurrent clients")
    ap.add_argument("--save", action="store_true", help="write ws_client_<i>.wav per client")
    return asyncio.run(run(ap.parse_args(argv)))


if __name__ == "__main__":
    main()

"""The port's TTS demos (`qwen_tts_tpu_torch/demos/{tts,pipeline,ws_client,
voice_agent}.py`), each `main` run once on the CPU at the suite's tiny
config, against what the JAX demo of the same name prints and writes.

`tts` writes the wav the JAX demo's writer would (the port's copy of the
native runtime, `runtime/native.py`) with the samples `synthesize` gave;
`pipeline` streams a 1-frame first chunk and then whole chunks after its
warm-up request; `voice_agent --text-only` speaks the lines read from
standard input (and falls back to that loop, offline, without the API
keys); `ws_client` drives the port's WebSocket server, live on
127.0.0.1 in a thread of its own, with concurrent clients and a barge-in,
on the port's own client. The demos take an engine built here in place of
the one their arguments would build on the card."""

import asyncio
import io
import sys
import threading
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen_tts_tpu.runtime.native import write_wav as jax_write_wav
from qwen_tts_tpu_torch.core.config import tiny_test_config
from qwen_tts_tpu_torch.demos import pipeline, tts, voice_agent, ws_client
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.runtime.continuous import ContinuousBatcher
from qwen_tts_tpu_torch.serving.shared import SharedBatcher
from qwen_tts_tpu_torch.serving.ws_server import TTSWebSocketServer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "demos"))
import demo_ws_client as jclient  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, chunk_frames=4, seed=0,
                              trailing_bucket=16, warmup=False),
                    model_config=tiny_test_config(max_seq_len=256))
    eng.initialize()
    return eng


def test_tts_writes_the_wav_of_synthesize(engine, tmp_path):
    out = tmp_path / "port.wav"
    engine._requests = 4
    res = tts.main(["--text", "hello there", "--output", str(out), "--device", "cpu"],
                   engine=engine)
    engine._requests = 4
    audio, sr = engine.synthesize("hello there")
    assert res["samples"] == len(audio) > 0 and res["sample_rate"] == sr == 24000
    assert res["rtf"] > 0
    ref = tmp_path / "jax.wav"
    jax_write_wav(str(ref), audio, sr)
    assert out.read_bytes() == ref.read_bytes()
    with wave.open(str(out)) as f:
        assert f.getnframes() == len(audio) and f.getframerate() == sr


def test_pipeline_streams_a_one_frame_chunk_then_whole_chunks(engine):
    res = pipeline.main(["--text", "one two three", "--device", "cpu"], engine=engine)
    hop = engine.vocoder_config.hop_length
    assert res["chunks"] >= 3 and res["samples"] > 0 and res["ttfc_ms"] > 0
    assert res["samples"] % hop == 0 and res["rtf"] > 0
    assert len(res["chunk_ms"]) == res["chunks"]


def test_voice_agent_text_only_speaks_each_line(engine, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO("first line here\nsecond one\n\nignored\n"))
    spoken = voice_agent.main(["--text-only", "--device", "cpu"], engine=engine)
    assert [s["text"] for s in spoken] == ["first line here", "second one"]
    assert all(s["chunks"] >= 2 and s["pcm16_bytes"] > 0 for s in spoken)
    # the full pipeline without its API keys: the same loop, offline
    for key in ("DEEPGRAM_API_KEY", "OPENAI_API_KEY"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello\n"))
    spoken = voice_agent.main(["--device", "cpu"], engine=engine)
    assert [s["text"] for s in spoken] == ["hello"]


@pytest.fixture(scope="module")
def server(engine):
    """The port's WebSocket server on a 2-slot batcher of the tiny engine,
    serving from an event loop in a thread of its own."""
    shared = SharedBatcher(batcher=ContinuousBatcher(engine, slots=2, chunk_frames=4))
    srv = TTSWebSocketServer(shared, port=0)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(timeout=60)
    yield srv
    asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(timeout=60)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=60)


def test_ws_client_clients_and_barge_in(server):
    assert ws_client.TEXTS == jclient.TEXTS
    res = ws_client.main(["--port", str(server.port), "--clients", "2"])
    assert len(res["clients"]) == 2
    for c in res["clients"]:
        assert c["samples"] > 0 and c["first_audio_ms"] > 0
        assert c["samples"] % 1920 == 0
    assert res["aggregate_rt_x"] > 0
    b = ws_client.main(["--port", str(server.port), "--barge-in"])["barge_in"]
    assert b["chunks_heard"] == 2 and b["terminal"]["type"] == "cancelled"
    assert b["terminal"]["chunks"] == b["chunks_heard"] + b["in_flight"]
    assert b["reply_audio_s"] > 0

"""Voice-agent pipeline demo: STT → LLM → the port's TTS, wired through Pipecat.

Port of `demos/demo_voice_agent.py`: Silero VAD on the user aggregator, an
LLM context aggregator pair tracking both sides of the conversation,
client connect/disconnect handlers (a greeting through `LLMRunFrame`, a
cancel on disconnect), and a WebSocket or Daily transport, with the port's
`serving/pipecat_tts.py::MegakernelTTSService` speaking.

The full pipeline needs `pipecat-ai[deepgram,openai,silero]` and the STT
and LLM API keys; every import of them is guarded, so without them the
demo falls back to `--text-only`: a loop that reads lines from standard
input (an empty line or its end stops it), speaks each with the engine
and prints its chunks and PCM16 bytes. That path needs no network. The
engine runs on the card unless `--device cpu` is given.

Usage (from the repo root):
    python -m qwen_tts_tpu_torch.demos.voice_agent --text-only [--device cuda]
    python -m qwen_tts_tpu_torch.demos.voice_agent [--transport websocket|daily]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os

from ..engine.tts_engine import TTSConfig, TTSEngine
from ..runtime.native import f32_to_pcm16

logger = logging.getLogger(__name__)

SYSTEM_PROMPT = (
    "You are a helpful voice assistant powered by a GPU-native PyTorch and CUDA "
    "TTS engine running on an NVIDIA H100. Keep your responses concise and "
    "conversational since they will be spoken aloud. Avoid bullet points, "
    "emojis, or special characters that cannot be easily spoken."
)


async def run_text_only(args, engine: TTSEngine | None = None) -> list[dict]:
    """Read lines, speak each; per line its chunks and PCM16 bytes."""
    if engine is None:
        engine = TTSEngine(TTSConfig(model_path=args.model_path, max_seq_len=args.max_seq,
                                     device=args.device))
    engine.initialize()
    print("Ready. Type text (empty line to exit).")
    spoken = []
    while True:
        try:
            text = input("> ").strip()
        except EOFError:
            break
        if not text:
            break
        total = chunks = 0
        async for audio, _sr in engine.synthesize_streaming(text):
            total += len(f32_to_pcm16(audio))
            chunks += 1
        print(f"  → {chunks} chunks, {total} PCM16 bytes @ {engine.sample_rate} Hz")
        spoken.append({"text": text, "chunks": chunks, "pcm16_bytes": total})
    return spoken


def build_transport(args):
    """A WebSocket or Daily transport with 24 kHz audio out."""
    if args.transport == "websocket":
        from pipecat.transports.websocket.fastapi import (
            FastAPIWebsocketParams,
            FastAPIWebsocketTransport,
        )

        return FastAPIWebsocketTransport(
            params=FastAPIWebsocketParams(audio_in_enabled=True, audio_out_enabled=True,
                                          audio_out_sample_rate=24000),
            host=args.host, port=args.port)
    if args.transport == "daily":
        from pipecat.transports.daily.transport import DailyParams, DailyTransport

        return DailyTransport(
            room_url=os.getenv("DAILY_ROOM_URL", ""), token=os.getenv("DAILY_TOKEN", ""),
            bot_name="GPU TTS Bot",
            params=DailyParams(audio_in_enabled=True, audio_out_enabled=True,
                               audio_out_sample_rate=24000))
    raise ValueError(f"unknown transport: {args.transport}")


async def run_pipeline(args, engine: TTSEngine | None = None):
    """The full Pipecat pipeline: transport.input → STT → user aggregator
    (Silero VAD) → LLM → TTS → transport.output → assistant aggregator.
    Without the API keys or `pipecat-ai`, the text-only loop."""
    missing = [k for k in ("DEEPGRAM_API_KEY", "OPENAI_API_KEY") if not os.environ.get(k)]
    if missing:
        print(f"Missing API keys: {missing}; falling back to --text-only mode.")
        return await run_text_only(args, engine)
    try:
        from pipecat.audio.vad.silero import SileroVADAnalyzer
        from pipecat.frames.frames import LLMRunFrame
        from pipecat.pipeline.pipeline import Pipeline
        from pipecat.pipeline.runner import PipelineRunner
        from pipecat.pipeline.task import PipelineParams, PipelineTask
        from pipecat.processors.aggregators.llm_context import LLMContext
        from pipecat.processors.aggregators.llm_response_universal import (
            LLMContextAggregatorPair,
            LLMUserAggregatorParams,
        )
        from pipecat.services.deepgram.stt import DeepgramSTTService
        from pipecat.services.openai.llm import OpenAILLMService
    except ImportError:
        print("pipecat-ai not installed; falling back to --text-only mode.")
        return await run_text_only(args, engine)

    from ..serving.pipecat_tts import MegakernelTTSService

    stt = DeepgramSTTService(api_key=os.environ["DEEPGRAM_API_KEY"])
    llm = OpenAILLMService(api_key=os.environ["OPENAI_API_KEY"], model=args.llm_model)
    tts = MegakernelTTSService(
        config=TTSConfig(model_path=args.model_path, max_seq_len=args.max_seq,
                         device=args.device),
        sample_rate=24000, chunk_frames=args.chunk_frames, engine=engine)

    messages = [{"role": "system", "content": SYSTEM_PROMPT}]
    context = LLMContext(messages)
    user_aggregator, assistant_aggregator = LLMContextAggregatorPair(
        context, user_params=LLMUserAggregatorParams(vad_analyzer=SileroVADAnalyzer()))
    transport = build_transport(args)
    pipeline = Pipeline([transport.input(), stt, user_aggregator, llm, tts,
                         transport.output(), assistant_aggregator])
    task = PipelineTask(pipeline, params=PipelineParams(enable_metrics=True,
                                                        enable_usage_metrics=True))

    @transport.event_handler("on_client_connected")
    async def on_client_connected(transport, client):
        logger.info("Client connected — starting conversation")
        messages.append({"role": "system",
                         "content": "Greet the user briefly and tell them you are ready "
                                    "to chat."})
        await task.queue_frames([LLMRunFrame()])

    @transport.event_handler("on_client_disconnected")
    async def on_client_disconnected(transport, client):
        logger.info("Client disconnected")
        await task.cancel()

    logger.info("Voice agent running (%s transport)", args.transport)
    await PipelineRunner().run(task)


def main(argv=None, engine: TTSEngine | None = None):
    """Run the demo; `engine` (built from the arguments when None) speaks.
    Returns the text-only loop's lines, when it ran."""
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--text-only", action="store_true")
    p.add_argument("--model-path", default=None)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--transport", default="websocket", choices=["websocket", "daily"])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--llm-model", default="gpt-4o-mini")
    p.add_argument("--chunk-frames", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return asyncio.run(run_text_only(args, engine) if args.text_only
                       else run_pipeline(args, engine))


if __name__ == "__main__":
    main()

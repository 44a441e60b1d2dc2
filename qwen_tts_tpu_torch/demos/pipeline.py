"""Streaming TTS demo: per-chunk latency, TTFC and RTF against their targets.

Port of `demos/demo_pipeline.py`: one warm-up request (so a first-use
shape does not pollute the timings), then one streamed request timed on
the host: time to first chunk, the gaps between chunks and the streaming
real-time factor, each beside its target (TTFC < 90 ms, RTF < 0.3). The
engine runs on the card unless `--device cpu` is given.

Usage (from the repo root):
    python -m qwen_tts_tpu_torch.demos.pipeline [--text TEXT] [--model-path DIR]
        [--max-seq 2048] [--chunk-frames 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import asyncio
import time

from ..engine.tts_engine import TTSConfig, TTSEngine


async def run(args, engine: TTSEngine | None = None) -> dict:
    if engine is None:
        engine = TTSEngine(TTSConfig(model_path=args.model_path, max_seq_len=args.max_seq,
                                     chunk_frames=args.chunk_frames, device=args.device))
    t0 = time.perf_counter()
    engine.initialize()
    print(f"Initialized in {time.perf_counter() - t0:.1f}s")

    async for _ in engine.synthesize_streaming(args.text):
        pass

    t_start = time.perf_counter()
    ttfc = None
    total_samples = 0
    chunk_times = []
    prev = t_start
    async for audio, _sr in engine.synthesize_streaming(args.text):
        now = time.perf_counter()
        if ttfc is None:
            ttfc = (now - t_start) * 1000
        chunk_times.append((now - prev) * 1000)
        prev = now
        total_samples += len(audio)

    wall = time.perf_counter() - t_start
    dur = total_samples / engine.sample_rate
    rtf = wall / dur if dur else float("inf")

    print(f"Chunks: {len(chunk_times)}; inter-chunk ms: "
          f"{[f'{t:.0f}' for t in chunk_times[:8]]}")
    print(f"TTFC: {ttfc:.1f} ms ({'PASS' if ttfc < 90 else 'FAIL'} vs 90 ms)")
    print(f"Streaming RTF: {rtf:.3f} ({'PASS' if rtf < 0.3 else 'FAIL'} vs 0.3)")
    return {"chunks": len(chunk_times), "chunk_ms": chunk_times, "ttfc_ms": ttfc,
            "samples": total_samples, "audio_s": dur, "wall_s": wall, "rtf": rtf}


def main(argv=None, engine: TTSEngine | None = None) -> dict:
    """Run the demo; `engine` (built from the arguments when None) speaks."""
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--text", default="Streaming synthesis check with several words "
                                     "to produce a couple of chunks of audio.")
    p.add_argument("--model-path", default=None)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--chunk-frames", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return asyncio.run(run(args, engine))


if __name__ == "__main__":
    main()

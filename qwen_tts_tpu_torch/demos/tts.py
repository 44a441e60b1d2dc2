"""Non-streaming TTS demo: text to a wav file, with the real-time factor.

Port of `demos/demo_tts.py`: the engine synthesizes the text in one call
(`TTSEngine.synthesize`), the port's native audio runtime writes the wav
(`runtime/native.py::write_wav`), and the RTF is printed beside the 0.3
target. The engine runs on the card unless `--device cpu` is given.

Usage (from the repo root):
    python -m qwen_tts_tpu_torch.demos.tts [--text TEXT] [--output output.wav]
        [--model-path DIR] [--max-seq 2048] [--no-sample] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

from ..engine.tts_engine import TTSConfig, TTSEngine
from ..runtime.native import write_wav


def main(argv=None, engine: TTSEngine | None = None) -> dict:
    """Run the demo; `engine` (built from the arguments when None) speaks.
    Returns what it printed, as numbers."""
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--text", default="Hello! This is the GPU native Qwen text to speech engine.")
    p.add_argument("--output", default="output.wav")
    p.add_argument("--model-path", default=None)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--no-sample", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if engine is None:
        engine = TTSEngine(TTSConfig(model_path=args.model_path, max_seq_len=args.max_seq,
                                     subtalker_do_sample=not args.no_sample,
                                     device=args.device))
    t0 = time.perf_counter()
    engine.initialize()
    init_s = time.perf_counter() - t0
    print(f"Initialized in {init_s:.1f}s")

    t0 = time.perf_counter()
    audio, sr = engine.synthesize(args.text)
    dt = time.perf_counter() - t0
    dur = len(audio) / sr if len(audio) else 0.0
    rtf = dt / dur if dur else float("inf")

    write_wav(args.output, audio, sr)
    print(f"Text: {args.text!r}")
    print(f"Audio: {dur:.2f}s @ {sr} Hz → {args.output}")
    print(f"Generation: {dt * 1000:.1f} ms, RTF {rtf:.3f} "
          f"({'PASS' if rtf < 0.3 else 'FAIL'} vs 0.3 target)")
    return {"init_s": init_s, "samples": len(audio), "sample_rate": sr, "audio_s": dur,
            "wall_s": dt, "rtf": rtf, "output": args.output}


if __name__ == "__main__":
    main()

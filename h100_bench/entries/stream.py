"""One listener's stream: a closed loop of `TTSEngine.synthesize_streaming`
requests, each sent when the last one's stream has closed."""

from __future__ import annotations

import asyncio
import time

from .. import traffic
from .common import RecordingEngine, build_engine, frame_cap


def setup(run) -> None:
    cfg, mix = run.cfg, run.mix
    eng = build_engine(run, cfg, mix.get("engine"))
    run.state["eng"] = eng
    cap = lambda t: frame_cap(t, eng.config.max_new_tokens)  # noqa: E731
    run.state["rec"] = RecordingEngine(eng, cap)
    # the mix's longest and shortest sentence: every chunk shape a request uses
    counts = traffic.word_counts(mix["words"])
    vocab = mix["vocabulary"]
    for n in (max(counts), min(counts)):
        text = " ".join(vocab[i % len(vocab)] for i in range(n)) + "."
        asyncio.run(_drain(eng, text))
    run.texts = traffic.texts(mix, run.seed, mix["max_requests"])


async def _drain(eng, text: str) -> None:
    async for _audio, _sr in eng.synthesize_streaming(text):
        pass


def counters(run) -> dict:
    eng = run.state["eng"]
    m = eng.get_metrics()
    out = {"talker_steps": m["talker_steps"], "cp_steps": m["cp_steps"]}
    if eng.device.type == "cuda":
        out["decode_launches"] = eng.decode_launches()
    return out


def window(run) -> None:
    rec = run.state["rec"]

    async def loop():
        i = 0
        while time.perf_counter() < run.end and i < len(run.texts):
            n0 = len(rec.requests)
            try:
                async for _audio, _sr in rec.synthesize_streaming(run.texts[i]):
                    run.tick()
            except Exception:      # recorded as the request's error; the loop goes on
                pass
            run.requests.extend(rec.requests[n0:])
            i += 1

    asyncio.run(loop())


def release(run) -> None:
    run.state.clear()

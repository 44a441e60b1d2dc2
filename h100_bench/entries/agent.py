"""The voice agent's turn: a closed loop of `demos/local_agent.py::agent_turn`
turns (the text LM's reply decoded in a thread, each finished sentence
spoken by the TTS engine as soon as it is ready), one user. The text LM is
the one the configuration's family builds (`families/`)."""

from __future__ import annotations

import asyncio
import sys
import time

from .. import traffic
from .common import RecordingEngine, build_engine, frame_cap


class RecordingLM:
    """The LM as `agent_turn` calls it, recording each reply's ids."""

    def __init__(self, lm):
        self.lm = lm
        self.replies: list[dict] = []

    def generate_stream(self, prompt_ids, max_new_tokens: int = 256, chunk: int = 32,
                        stop_ids: tuple = ()):
        rec = {"prompt": list(prompt_ids), "reply": [], "max": max_new_tokens,
               "stop_ids": tuple(stop_ids), "times": []}
        self.replies.append(rec)
        for ids in self.lm.generate_stream(prompt_ids, max_new_tokens, chunk, stop_ids):
            rec["reply"].extend(ids)
            rec["times"].append((time.perf_counter(), len(ids)))
            yield ids


def setup(run) -> None:
    from qwen_tts_tpu_torch.demos import local_agent
    from qwen_tts_tpu_torch.models.text_lm import chunk_lengths

    cfg, mix = run.cfg, run.mix
    lm = run.lm_family.build(run, run.weights)
    eng = build_engine(run, cfg["tts"], mix.get("engine"))
    words = mix["words_per_sentence"]
    counts = sorted(set(mix["sentences"]))
    lengths = sorted({n for s in counts for n in chunk_lengths(s * words, mix["lm_chunk"])})
    lm.warm(local_agent.PROMPT_BUCKET, lengths)
    rec = RecordingEngine(eng, lambda t: frame_cap(t, eng.config.max_new_tokens))
    rlm = RecordingLM(lm)
    run.state.update(lm=lm, eng=eng, rec=rec, rlm=rlm, turn=local_agent.agent_turn)
    for s in reversed(counts):            # every reply length, every chunk shape
        asyncio.run(_turn(run, mix["user_turns"][0], s))
    rec.requests.clear()
    rlm.replies.clear()
    n = mix["max_turns"]
    run.turn_texts = traffic.choices(mix["user_turns"], run.seed, n)
    run.turn_sentences = traffic.choices(mix["sentences"], run.seed, n, stream=4)


async def _turn(run, text: str, sentences: int):
    mix = run.mix
    return await run.state["turn"](run.state["rlm"], run.state["rec"], text,
                                   sentences=sentences,
                                   words_per_sentence=mix["words_per_sentence"],
                                   lm_chunk=mix["lm_chunk"], verbose=False)


def counters(run) -> dict:
    eng, lm = run.state["eng"], run.state["lm"]
    m = eng.get_metrics()
    out = {"talker_steps": m["talker_steps"], "cp_steps": m["cp_steps"], "lm_steps": lm.steps}
    if eng.device.type == "cuda":
        out["decode_launches"] = eng.decode_launches() + lm.decode_launches()
    return out


def window(run) -> None:
    rec, rlm = run.state["rec"], run.state["rlm"]

    async def loop():
        i = 0
        while time.perf_counter() < run.end and i < len(run.turn_texts):
            t0 = time.perf_counter()
            n0, r0 = len(rec.requests), len(rlm.replies)
            turn = {"start": t0, "error": None, "sentences": run.turn_sentences[i]}
            run.tick()
            try:
                t = await _turn(run, run.turn_texts[i], run.turn_sentences[i])
                turn.update(first_audio_s=t.first_audio_s,
                            first_sentence_s=t.first_sentence_s, wall_s=t.wall_s)
            except Exception as e:
                turn["error"] = repr(e)
            turn["end"] = time.perf_counter()
            turn["requests"] = rec.requests[n0:]
            turn["replies"] = rlm.replies[r0:]
            run.turns.append(turn)
            run.requests.extend(turn["requests"])
            i += 1

    asyncio.run(loop())
    groups: dict = {}
    for t in run.turns:
        if t["error"] is None and t.get("first_audio_s") is not None:
            groups.setdefault(t["sentences"], []).append(t["first_audio_s"] * 1e3)
    print("turns by sentences (count, median first audio ms): " + ", ".join(
        f"{k}: ({len(v)}, {sorted(v)[len(v) // 2]:.1f})" for k, v in sorted(groups.items())),
        file=sys.stderr)


def release(run) -> None:
    run.state.clear()

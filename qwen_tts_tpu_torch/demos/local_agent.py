"""A voice agent's turn on one card: the text LM streams its reply while the
TTS engine speaks the finished sentences.

Port of `demos/demo_local_agent.py`. A Qwen3-0.6B-architecture text LM
(`models/text_lm.py`) produces reply tokens chunk by chunk
(`TextLM.generate_stream`, one host read a chunk) in an executor thread; a
sentence assembler hands each finished sentence to
`TTSEngine.synthesize_streaming`, so speech for sentence k overlaps the
decode of the next ones. Both models are resident on one card. On the
card the LM's steps (decode-step kernel launches on the thread's stream,
its own workspace) and the engine's chunk graphs (on the graphs' stream,
with the workspace they own) are enqueued from two threads.

Random weights give arbitrary token ids, so reply ids are mapped onto a
small pronounceable word list, which times as real text of the same length
would: the engine's byte-level tokenizer sees text of equivalent length.
Prompts are byte ids, padded to one length (no tokenizer files needed).

Per turn it prints the LM's prefill + first-sentence latency, the first
audio after that sentence was ready, user → first audio, and the turn's
real-time factor (wall over the audio produced).

Usage (from the repo root, on the card):
    python -m qwen_tts_tpu_torch.demos.local_agent [--turns 2] [--sentences 3]
        [--words-per-sentence 10] [--lm-chunk 16] [--max-seq 1024] [--device cuda]
"""

from __future__ import annotations

import argparse
import asyncio
import time
from typing import NamedTuple

import numpy as np

# a small pronounceable vocabulary; reply ids index into it
WORDS = ("time flow light sound model stream chip fast audio voice "
         "signal frame token layer cache scale vector tensor phase "
         "wave").split()

USER_TURNS = [
    "What is the weather like today?",
    "Tell me something interesting about TPUs.",
]

PROMPT_BUCKET = 64   # every prompt is this many ids: one prefill shape across turns


def encode_prompt(text: str) -> list[int]:
    """Byte ids of the user's turn, cut or space-padded to PROMPT_BUCKET."""
    ids = [ord(c) % 256 for c in text][:PROMPT_BUCKET]
    return ids + [ord(" ")] * (PROMPT_BUCKET - len(ids))


def ids_to_text(ids: list[int], words_per_sentence: int) -> list[str]:
    """Map token ids onto words; group them into sentences."""
    words = [WORDS[t % len(WORDS)] for t in ids]
    return [" ".join(words[i:i + words_per_sentence]) + "."
            for i in range(0, len(words), words_per_sentence)]


class Turn(NamedTuple):
    first_audio_s: float | None     # user → first audio
    wall_s: float
    audio_s: float
    spoken: int                     # sentences spoken
    first_sentence_s: float | None  # user → the LM's first sentence ready
    sentences: list                 # (text, engine request number, codec frames) each


async def agent_turn(lm, eng, user_text: str, *, sentences: int, words_per_sentence: int,
                     lm_chunk: int, verbose: bool = True) -> Turn:
    """One turn: the LM's reply decoded in an executor thread, each finished
    sentence spoken as soon as it is ready."""
    from ..engine.tokenizer import IM_END

    n_tokens = sentences * words_per_sentence
    prompt_ids = encode_prompt(user_text)
    t0 = time.perf_counter()
    loop = asyncio.get_running_loop()
    queue: asyncio.Queue = asyncio.Queue()

    def produce():
        """LM thread: decode reply chunks, hand over finished sentences."""
        buf: list[int] = []
        flushed = 0
        try:
            for batch in lm.generate_stream(prompt_ids, max_new_tokens=n_tokens,
                                            chunk=lm_chunk, stop_ids=(IM_END,)):
                buf.extend(batch)
                while len(buf) - flushed >= words_per_sentence:
                    sent = ids_to_text(buf[flushed:flushed + words_per_sentence],
                                       words_per_sentence)[0]
                    flushed += words_per_sentence
                    loop.call_soon_threadsafe(queue.put_nowait, (sent, time.perf_counter()))
            if flushed < len(buf):
                sent = ids_to_text(buf[flushed:], words_per_sentence)[0]
                loop.call_soon_threadsafe(queue.put_nowait, (sent, time.perf_counter()))
        finally:
            loop.call_soon_threadsafe(queue.put_nowait, None)   # the speaker never waits forever

    producer = loop.run_in_executor(None, produce)

    first_sentence_t = first_audio_t = None
    audio_samples = 0
    spoken: list = []
    while True:
        item = await queue.get()
        if item is None:
            break
        sent, t_ready = item
        if first_sentence_t is None:
            first_sentence_t = t_ready - t0
        frames: list = []
        async for audio, _sr in eng.synthesize_streaming(sent, frames=frames):
            if first_audio_t is None:
                first_audio_t = time.perf_counter() - t0
            audio_samples += int(np.asarray(audio).shape[0])
        spoken.append((sent, eng.get_metrics()["requests"], frames))
    await producer    # raises what the LM thread raised
    wall = time.perf_counter() - t0
    audio_s = audio_samples / eng.sample_rate
    if verbose:
        print(f"  turn: '{user_text[:40]}...'  sentences={len(spoken)}")
        print(f"    LM first sentence ready  {first_sentence_t * 1e3:8.1f} ms "
              f"({n_tokens} reply tokens total, chunk={lm_chunk})")
        print(f"    user -> first audio      {first_audio_t * 1e3:8.1f} ms")
        print(f"    full reply: {audio_s:.2f} s audio in {wall:.2f} s wall "
              f"(agent-turn RTF {wall / max(audio_s, 1e-9):.3f})")
    return Turn(first_audio_t, wall, audio_s, len(spoken), first_sentence_t, spoken)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--sentences", type=int, default=3)
    ap.add_argument("--words-per-sentence", type=int, default=10)
    ap.add_argument("--lm-chunk", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--quantize", default=None, choices=["int8", "int4", "mixed"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..engine.tts_engine import TTSConfig, TTSEngine
    from ..models.text_lm import TEXT_LM_CONFIG, TextLM, init_text_lm_weights

    print("building text LM (Qwen3-0.6B architecture, random weights)...")
    t0 = time.perf_counter()
    impl = "mega" if args.device.startswith("cuda") else "dense"
    lm = TextLM(init_text_lm_weights(7, TEXT_LM_CONFIG, args.device), TEXT_LM_CONFIG,
                attn_impl=impl, device=args.device)
    # warm what a turn runs: the prefill and every chunk length
    list(lm.generate_stream(encode_prompt("warm"),
                            max_new_tokens=args.sentences * args.words_per_sentence,
                            chunk=args.lm_chunk))
    print(f"  LM ready in {time.perf_counter() - t0:.1f} s")

    print("building TTS engine...")
    t0 = time.perf_counter()
    cfg = TTSConfig(max_seq_len=args.max_seq, device=args.device)
    if args.quantize:
        cfg.quantize = args.quantize
        cfg.kv_cache = "int8"
    eng = TTSEngine(cfg)
    eng.initialize()
    print(f"  engine ready in {time.perf_counter() - t0:.1f} s")

    ok = True
    for i in range(args.turns):
        turn = asyncio.run(agent_turn(
            lm, eng, USER_TURNS[i % len(USER_TURNS)], sentences=args.sentences,
            words_per_sentence=args.words_per_sentence, lm_chunk=args.lm_chunk))
        ok &= (turn.first_audio_s is not None and turn.audio_s > 0
               and turn.spoken >= args.sentences and turn.wall_s < turn.audio_s)
    print(f"one card, two models -> {'PASS' if ok else 'FAIL'}")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()

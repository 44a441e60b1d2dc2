"""The port's on-card agent turn (`qwen_tts_tpu_torch/demos/local_agent.py`)
against the JAX demo (`demos/demo_local_agent.py`), on tiny models on the CPU.

The prompt encoding and the sentence grouping equal JAX's. One tiny turn
streams the LM's chunks from an executor thread into the engine: two
sentences spoken, first audio after the turn starts, and each sentence's
codes equal to the same sentence spoken alone by the engine at the same
request number (its sampling noise is keyed by seed, request and frame).
The full-width turn on the card is `chip_smoke.py` phase 18.
"""

import asyncio
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen_tts_tpu_torch.core.config import DecoderConfig, tiny_test_config
from qwen_tts_tpu_torch.demos import local_agent as agent
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
from qwen_tts_tpu_torch.models.text_lm import TextLM, init_text_lm_weights

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "demos"))
import demo_local_agent as jagent  # noqa: E402

TINY_LM = DecoderConfig(num_layers=2, hidden_size=256, intermediate_size=512, num_q_heads=4,
                        num_kv_heads=2, head_dim=128, vocab_size=1024, max_seq_len=128,
                        rope_theta=10000.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("text", ["hi", "x" * 500, "ünïcode turn", ""])
def test_encode_prompt_equals_jax(text):
    got = agent.encode_prompt(text)
    assert got == jagent.encode_prompt(text)
    assert len(got) == agent.PROMPT_BUCKET == jagent.PROMPT_BUCKET


@pytest.mark.parametrize("n,per", [(25, 10), (30, 10), (7, 4), (0, 3)])
def test_ids_to_text_equals_jax(n, per):
    ids = [(i * 37) % 1500 for i in range(n)]
    got = agent.ids_to_text(ids, words_per_sentence=per)
    assert got == jagent.ids_to_text(ids, words_per_sentence=per)
    assert all(s.endswith(".") for s in got)


def _speak_alone(eng, sentence: str, request: int) -> list:
    eng._requests = request - 1
    frames: list = []

    async def run():
        async for _audio, _sr in eng.synthesize_streaming(sentence, frames=frames):
            pass

    asyncio.run(run())
    assert eng.get_metrics()["requests"] == request
    return frames


@pytest.mark.parametrize("impl", ["dense", "mega"])
def test_agent_turn_tiny_models(impl):
    lm = TextLM(init_text_lm_weights(0, TINY_LM, "cpu"), TINY_LM, attn_impl=impl, device="cpu")
    eng = TTSEngine(TTSConfig(device="cpu", max_seq_len=256, vocoder_mode="random", seed=0,
                              trailing_bucket=16, warmup=False),
                    model_config=tiny_test_config(max_seq_len=256))
    eng.initialize()
    turn = asyncio.run(agent.agent_turn(lm, eng, "hello agent", sentences=2,
                                        words_per_sentence=4, lm_chunk=4, verbose=False))
    assert turn.spoken == 2 and len(turn.sentences) == 2
    assert turn.first_audio_s is not None and turn.first_audio_s > 0
    assert turn.first_sentence_s is not None and turn.first_sentence_s <= turn.first_audio_s
    assert turn.audio_s > 0 and turn.wall_s > 0
    assert lm.steps == 2 * 4 - 1          # the first id comes from the prefill
    reply = lm.generate(agent.encode_prompt("hello agent"), 8)
    assert [s for s, _r, _f in turn.sentences] == agent.ids_to_text(reply, 4)
    requests = [r for _s, r, _f in turn.sentences]
    assert requests == [requests[0], requests[0] + 1]
    for sentence, request, frames in turn.sentences:
        alone = _speak_alone(eng, sentence, request)
        assert len(frames) > 0
        np.testing.assert_array_equal(np.stack(frames), np.stack(alone))

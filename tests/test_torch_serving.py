"""The port's Pipecat services (`qwen_tts_tpu_torch/serving/pipecat_tts.py`)
and its native audio runtime, against `tests/test_serving.py`'s contracts
and the JAX package's `runtime/native.py`.

Without pipecat the services bind to the protocol stand-ins, so the whole
`run_tts` frame sequence is asserted here on tiny engines on the CPU:
Started → N × AudioRaw (PCM16) → Stopped, ErrorFrame then Stopped on a
failure, no Stopped after the client closes the stream mid-utterance (and
the engine serves the next one), and two continuous services sharing one
batcher. The PCM16 conversion equals the JAX package's bit for bit.
"""

import asyncio

import numpy as np
import pytest
import torch

from qwen_tts_tpu.runtime import native as jnative
from qwen_tts_tpu_torch.core.config import tiny_test_config
from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig
from qwen_tts_tpu_torch.runtime import native as tnative
from qwen_tts_tpu_torch.serving import pipecat_tts as svc


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_config(seq: int = 128, **kw) -> TTSConfig:
    return TTSConfig(device="cpu", max_seq_len=seq, vocoder_mode="random", seed=0,
                     trailing_bucket=16, warmup=False, **kw)


def _tiny_service(**kw):
    return svc.MegakernelTTSService(config=_tiny_config(**kw), sample_rate=24000,
                                    chunk_frames=4, model_config=tiny_test_config(128))


def _collect(agen):
    async def run():
        return [f async for f in agen]
    return asyncio.run(run())


def test_module_imports_without_pipecat():
    assert isinstance(svc.PIPECAT_AVAILABLE, bool)
    assert not svc.PIPECAT_AVAILABLE            # the stand-ins: no pipecat here
    from qwen_tts_tpu_torch.serving import _frames

    assert svc.TTSStartedFrame is _frames.TTSStartedFrame
    assert issubclass(svc.MegakernelTTSService, _frames.TTSService)
    assert issubclass(svc.ContinuousTTSService, _frames.TTSService)


def test_run_tts_frame_sequence():
    """Started → N × AudioRaw → Stopped, the first chunk one codec frame of
    PCM16, TTFB metrics stopped at the first audio chunk."""
    service = _tiny_service()
    frames = _collect(service.run_tts("hello protocol test"))
    assert isinstance(frames[0], svc.TTSStartedFrame)
    assert isinstance(frames[-1], svc.TTSStoppedFrame)
    audio = frames[1:-1]
    assert len(audio) >= 2
    hop = service._engine.vocoder_config.hop_length
    for f in audio:
        assert isinstance(f, svc.TTSAudioRawFrame)
        assert f.sample_rate == 24000 and f.num_channels == 1
        assert len(f.audio) > 0 and len(f.audio) % 2 == 0
    assert len(audio[0].audio) == hop * 2
    assert service.metric_calls[:2] == ["start_ttfb", "start_usage"]
    assert service.metric_calls[2] == "stop_ttfb" and service.metric_calls[-1] == "stop_ttfb"


def test_run_tts_error_frame():
    """An engine exception mid-stream yields ErrorFrame, then Stopped."""
    service = _tiny_service()

    async def boom(text, **kw):
        raise RuntimeError("synth exploded")
        yield  # pragma: no cover (makes this an async generator)

    service._engine.synthesize_streaming = boom
    service._engine.initialize = lambda *a, **k: None
    frames = _collect(service.run_tts("will fail"))
    kinds = [type(f).__name__ for f in frames]
    assert kinds == ["TTSStartedFrame", "ErrorFrame", "TTSStoppedFrame"]
    assert "synth exploded" in frames[1].error


def test_float32_to_pcm16_clips_and_scales():
    audio = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0], dtype=np.float32)
    out = np.frombuffer(svc.float32_to_pcm16(audio), dtype=np.int16)
    assert out.shape == audio.shape and out[0] == 0
    assert abs(int(out[1]) - 16383) <= 1 and abs(int(out[2]) + 16383) <= 1
    assert out[5] == out[3] and out[6] == out[4]     # saturates, never wraps
    assert int(out[3]) >= 32700 and int(out[4]) <= -32700


def test_float32_to_pcm16_matches_numpy_reference():
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(4096) * 0.7).astype(np.float32)
    got = np.frombuffer(svc.float32_to_pcm16(audio), dtype=np.int16)
    ref = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    np.testing.assert_allclose(got, ref, atol=1)


@pytest.mark.parametrize("n", [0, 1, 4097])
def test_native_runtime_equals_jax(tmp_path, n):
    """The port's copy of the C runtime (built into its own `_build/`)
    gives the JAX package's bytes: PCM16, the ring and the WAV file."""
    assert tnative.native_available()
    assert tnative._build_lib()._name.startswith(str(tnative._SRC.parent.parent / "_build"))
    audio = (np.random.default_rng(n).standard_normal(n) * 1.5).astype(np.float32)
    assert tnative.f32_to_pcm16(audio) == jnative.f32_to_pcm16(audio)
    ring = tnative.PCMRing(1 << 12)
    data = bytes(range(256)) * 3
    assert ring.write(data) == len(data) and ring.size == len(data)
    assert ring.read(100) + ring.read(10_000) == data
    tnative.write_wav(str(tmp_path / "a.wav"), audio, 24000)
    jnative.write_wav(str(tmp_path / "b.wav"), audio, 24000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def test_run_tts_midstream_cancellation_engine_reusable():
    """A client that hangs up after the first audio chunk closes `run_tts`:
    no Stopped frame, the engine's stream ends, and the next utterance is
    served normally."""
    service = _tiny_service()

    async def drive_cancel():
        agen = service.run_tts("a longer first utterance that makes several chunks of audio")
        frames = []
        async for f in agen:
            frames.append(f)
            if isinstance(f, svc.TTSAudioRawFrame):
                break
        await agen.aclose()
        return frames

    frames = asyncio.run(drive_cancel())
    assert isinstance(frames[0], svc.TTSStartedFrame)
    assert isinstance(frames[-1], svc.TTSAudioRawFrame)
    assert not any(isinstance(f, (svc.TTSStoppedFrame, svc.ErrorFrame)) for f in frames)
    assert service.metric_calls[-1] == "stop_ttfb"   # the cleanup ran
    assert service._engine._owner is None            # no stream holds the engine

    frames2 = _collect(service.run_tts("second utterance"))
    assert isinstance(frames2[0], svc.TTSStartedFrame)
    assert isinstance(frames2[-1], svc.TTSStoppedFrame)
    assert not any(isinstance(f, svc.ErrorFrame) for f in frames2)
    assert sum(isinstance(f, svc.TTSAudioRawFrame) for f in frames2) >= 2
    assert service._engine.get_metrics()["frames_generated"] > 0


def test_continuous_service_shared_batcher_multi_client():
    """Two continuous services share one engine and batcher; concurrent
    `run_tts` calls both complete the frame protocol on its slots."""
    s1 = svc.ContinuousTTSService(config=_tiny_config(256), sample_rate=24000,
                                  chunk_frames=4, slots=2,
                                  model_config=tiny_test_config(256), warm=False)
    s2 = svc.ContinuousTTSService(share=s1)
    assert s2._shared is s1._shared

    async def drive():
        async def one(service, text):
            return [f async for f in service.run_tts(text)]
        return await asyncio.gather(one(s1, "first concurrent client"),
                                    one(s2, "the second client speaks at the same time"))

    frames1, frames2 = asyncio.run(drive())
    b = s1._shared.batcher
    assert b is not None and b is s2._shared.batcher and b.slots == 2
    for frames in (frames1, frames2):
        assert isinstance(frames[0], svc.TTSStartedFrame)
        assert isinstance(frames[-1], svc.TTSStoppedFrame)
        assert not any(isinstance(f, svc.ErrorFrame) for f in frames)
        audio = [f for f in frames if isinstance(f, svc.TTSAudioRawFrame)]
        assert len(audio) >= 1
        assert all(f.sample_rate == 24000 and len(f.audio) % 2 == 0 for f in audio)
    assert b.active == 0


def test_services_default_to_the_gpu():
    """Both services build their engine on "cuda" unless asked for the CPU;
    without a card the engine's start fails inside the frame protocol."""
    single = svc.MegakernelTTSService(model_config=tiny_test_config(128))
    assert single._engine.config.device == "cuda"
    cont = svc.ContinuousTTSService(model_config=tiny_test_config(128), warm=False)
    assert cont._shared._config.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default services run on it")
    frames = _collect(single.run_tts("no card here"))
    assert [type(f).__name__ for f in frames] == ["TTSStartedFrame", "ErrorFrame",
                                                  "TTSStoppedFrame"]
    assert "no CUDA device" in frames[1].error


def test_single_service_speaks_with_a_given_engine():
    """`engine=`: the service speaks with that engine (its own config holds)
    instead of building one."""
    from qwen_tts_tpu_torch.engine.tts_engine import TTSEngine

    eng = TTSEngine(_tiny_config(chunk_frames=4), model_config=tiny_test_config(128))
    service = svc.MegakernelTTSService(engine=eng, config=_tiny_config(chunk_frames=2))
    assert service._engine is eng and eng.config.chunk_frames == 4
    kinds = [type(f).__name__ for f in _collect(service.run_tts("a given engine"))]
    assert kinds[0] == "TTSStartedFrame" and kinds[-1] == "TTSStoppedFrame"
    assert kinds.count("TTSAudioRawFrame") >= 2 and eng.get_metrics()["requests"] == 1

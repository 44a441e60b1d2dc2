"""What the entry modules share: request records, the TTS engine of a
configuration, the frame cap, and a recording wrapper for the engine's
streaming entry."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    """One request as the client saw it, on the host clock."""

    text: str
    due: float                                  # due (open loop) or started (closed loop)
    cap: int                                    # frames it may have before EOS
    start: float = 0.0
    first: float | None = None                  # first audio chunk received
    end: float | None = None                    # last chunk received, stream closed
    chunks: list = field(default_factory=list)  # (time received, samples)
    audio: list = field(default_factory=list)   # the chunks' f32 samples
    codes: list = field(default_factory=list)   # served codec frames, [16] each
    error: str | None = None

    def add(self, audio) -> None:
        t = time.perf_counter()
        a = np.asarray(audio, dtype=np.float32)
        if self.first is None:
            self.first = t
        self.chunks.append((t, int(a.shape[0])))
        self.audio.append(a)

    @property
    def ok(self) -> bool:
        """Finished, with audio, all of it finite."""
        return (self.error is None and self.end is not None and bool(self.audio)
                and all(np.isfinite(a).all() for a in self.audio)
                and sum(a.shape[0] for a in self.audio) > 0)


def frame_cap(text: str, max_new_tokens: int, seq_bound: int | None = None) -> int:
    """The published rule the engine stops by when no EOS comes: ~2.5 words
    a second at 12.5 frames a second, twice over, at least 25 frames, at
    most `max_new_tokens` (and, in the batcher, what its cache leaves)."""
    words = max(len(text.split()), 1)
    cap = min(max(int(words / 2.5 * 12.5 * 2.0), 25), max_new_tokens)
    return cap if seq_bound is None else min(cap, seq_bound)


def model_config(cfg: dict):
    """The port's `TTSModelConfig` for a configuration file's sizes."""
    from qwen_tts_tpu_torch.core.config import DecoderConfig, TextProjectionConfig, TTSModelConfig

    def dec(c, seq):
        return DecoderConfig(num_layers=c["num_layers"], hidden_size=c["hidden_size"],
                             intermediate_size=c["intermediate_size"],
                             num_q_heads=c["num_q_heads"], num_kv_heads=c["num_kv_heads"],
                             head_dim=c["head_dim"], vocab_size=c["vocab_size"],
                             max_seq_len=seq, rope_theta=c["rope_theta"], rms_eps=c["rms_eps"])

    tp = cfg["text_projection"]
    return TTSModelConfig(
        talker=dec(cfg["talker"], cfg["talker"]["max_seq_len"]),
        code_predictor=dec(cfg["code_predictor"], cfg["code_predictor"]["max_seq_len"]),
        text_projection=TextProjectionConfig(text_vocab_size=tp["text_vocab_size"],
                                             text_hidden_size=tp["text_hidden_size"],
                                             hidden_size=tp["hidden_size"]),
        num_code_groups=cfg["num_code_groups"])


def build_engine(run, cfg: dict, overrides: dict | None = None):
    """A `TTSEngine` of the configuration on the run's weights: the engine
    settings of the configuration, then the mix's (`overrides`), then, for
    the control, the configuration's lower-precision path."""
    from qwen_tts_tpu_torch.engine.tts_engine import TTSConfig, TTSEngine
    from qwen_tts_tpu_torch.vocoder.code2wav import Code2WavConfig

    from ..weights import program_code2wav, program_tts

    settings = dict(cfg["engine"])
    settings.update(overrides or {})
    settings["max_seq_len"] = settings.get("max_seq_len", cfg["talker"]["max_seq_len"])
    if run.control:
        settings.update(cfg["control"]["engine"])
    c2w = Code2WavConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in cfg["code2wav"].items()})
    tcfg = TTSConfig(device=run.device, code2wav_config=c2w, **settings)
    eng = TTSEngine(tcfg, model_config(cfg))
    eng.initialize(weights=program_tts(run.weights, eng.model_config, run.device),
                   vocoder_weights=program_code2wav(run.weights, c2w))
    return eng


class RecordingEngine:
    """The engine as `agent_turn` calls it, recording what each streamed
    request yields (its audio chunks and codec frames)."""

    def __init__(self, eng, cap_of):
        self.eng, self.cap_of = eng, cap_of
        self.sample_rate = eng.sample_rate
        self.requests: list[Request] = []

    def get_metrics(self) -> dict:
        return self.eng.get_metrics()

    async def synthesize_streaming(self, text, chunk_frames=None, frames=None):
        rec = Request(text=text, due=time.perf_counter(), cap=self.cap_of(text))
        rec.start = rec.due
        self.requests.append(rec)
        got: list = []
        try:
            async for audio, sr in self.eng.synthesize_streaming(text, chunk_frames, frames=got):
                rec.add(audio)
                yield audio, sr
        except Exception as e:          # the turn raises it; the record keeps it too
            rec.error = repr(e)
            raise
        finally:
            rec.codes = list(got)
            if frames is not None:
                frames.extend(got)
        rec.end = time.perf_counter()

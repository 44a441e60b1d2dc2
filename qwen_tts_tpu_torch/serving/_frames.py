"""Protocol-level stand-ins for the Pipecat TTS frame types + service base.

`pipecat-ai` is not installable in every environment (it is absent from this
image), but the service's FRAME PROTOCOL — `TTSStartedFrame` → N ×
`TTSAudioRawFrame`(PCM16 @ 24 kHz) → `TTSStoppedFrame`, `ErrorFrame` on
exception (reference: pipecat_tts.py:87-132) — is the contract worth
testing. These minimal classes mirror the Pipecat types' constructor
surface exactly as the service uses them, so `run_tts` runs (and is
asserted) identically with or without the real package; with pipecat
installed the real types are used instead (serving/pipecat_tts.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class Frame:
    """Base frame (pipecat.frames.frames.Frame stand-in)."""


@dataclass
class TTSStartedFrame(Frame):
    pass


@dataclass
class TTSStoppedFrame(Frame):
    pass


@dataclass
class TTSAudioRawFrame(Frame):
    audio: bytes = b""
    sample_rate: int = 24000
    num_channels: int = 1


@dataclass
class ErrorFrame(Frame):
    error: str = ""


class TTSService:
    """Minimal pipecat.services.tts_service.TTSService stand-in: the
    constructor keywords and async metric hooks `run_tts` touches, with the
    hook calls RECORDED so tests can assert the metrics discipline
    (reference: pipecat_tts.py:78-79,96-97,123,131)."""

    def __init__(self, sample_rate: int = 24000, **kwargs):
        self.sample_rate = sample_rate
        self.metric_calls: list[str] = []

    def can_generate_metrics(self) -> bool:
        return True

    async def start_ttfb_metrics(self):
        self.metric_calls.append("start_ttfb")

    async def stop_ttfb_metrics(self):
        self.metric_calls.append("stop_ttfb")

    async def start_tts_usage_metrics(self, text: str):
        self.metric_calls.append("start_usage")

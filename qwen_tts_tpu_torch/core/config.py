"""Model configuration and special-token constants of Qwen3-TTS-12Hz-0.6B.

The port's own copy of what it uses from `qwen_tts_tpu/core/config.py`: the
decoder and model configs, the special-token ids and `tiny_test_config`.
The TPU tuning knobs of that module (attention chunk, prefetch depth, VMEM
budget) have no meaning here and are left out. `tests/test_torch_isolation.py`
holds the two copies equal field for field.

One `DecoderConfig` serves both the 28-layer talker and the 5-layer code
predictor.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Architecture of a Qwen3-style decoder (talker or code predictor)."""

    num_layers: int = 28
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_q_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    vocab_size: int = 3072          # codec vocab (talker); 2048 for CP heads
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    # M-RoPE: splits the D//2 rotary frequency indices into sections with
    # their own position counters ((24, 20, 20) in the released talker).
    # None = standard RoPE. Equal section positions reproduce standard RoPE.
    mrope_section: tuple[int, ...] | None = None
    # Frequency-index -> section layout. False: contiguous runs. True:
    # interleaved (Qwen3-Omni): index j belongs to section s >= 1 iff
    # j % n == s and j < n * sec[s], else to section 0.
    mrope_interleaved: bool = False

    @property
    def q_size(self) -> int:
        return self.num_q_heads * self.head_dim      # 2048

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim     # 1024

    @property
    def gqa_groups(self) -> int:
        return self.num_q_heads // self.num_kv_heads


TALKER_CONFIG = DecoderConfig()

CODE_PREDICTOR_CONFIG = DecoderConfig(
    num_layers=5,
    vocab_size=2048,
    max_seq_len=64,
)


@dataclasses.dataclass(frozen=True)
class TextProjectionConfig:
    """Text embedding + projection MLP."""

    text_vocab_size: int = 151936
    text_hidden_size: int = 2048
    hidden_size: int = 1024


@dataclasses.dataclass(frozen=True)
class TTSModelConfig:
    """The Qwen3-TTS-12Hz-0.6B-Base model bundle."""

    talker: DecoderConfig = TALKER_CONFIG
    code_predictor: DecoderConfig = CODE_PREDICTOR_CONFIG
    text_projection: TextProjectionConfig = TextProjectionConfig()
    num_code_groups: int = 16       # 1 talker codebook + 15 predicted
    frame_rate_hz: float = 12.5
    sample_rate: int = 24000


# ── Special token ids ────────────────────────────────────────────────────────

CODEC_BOS = 2149
CODEC_EOS = 2150
CODEC_PAD = 2148

CODEC_NOTHINK = 2155
CODEC_THINK_BOS = 2156
CODEC_THINK_EOS = 2157

TTS_BOS = 151672
TTS_EOS = 151673
TTS_PAD = 151671

NUM_CODE_GROUPS = 16
CODE_PREDICTOR_LAYERS = 5
CODE_PREDICTOR_VOCAB = 2048


def tiny_test_config(max_seq_len: int = 64) -> TTSModelConfig:
    """A scaled-down config for CPU tests (head_dim stays 128)."""
    talker = DecoderConfig(
        num_layers=2,
        hidden_size=256,
        intermediate_size=512,
        num_q_heads=4,
        num_kv_heads=2,
        head_dim=128,
        vocab_size=3072,
        max_seq_len=max_seq_len,
    )
    cp = DecoderConfig(
        num_layers=2,
        hidden_size=256,
        intermediate_size=512,
        num_q_heads=4,
        num_kv_heads=2,
        head_dim=128,
        vocab_size=2048,
        max_seq_len=64,
    )
    tp = TextProjectionConfig(
        text_vocab_size=512,
        text_hidden_size=512,
        hidden_size=256,
    )
    return TTSModelConfig(talker=talker, code_predictor=cp, text_projection=tp)

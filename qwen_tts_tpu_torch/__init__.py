"""qwen_tts_tpu_torch — the PyTorch + CUDA port of `qwen_tts_tpu`.

Runs the streaming TTS main path (`TTSEngine.synthesize_streaming` with the
default config) on one NVIDIA Hopper GPU. Plain tensor code is PyTorch; the
single-token decode step of the talker and the code predictor is a CUDA
kernel written for sm_90a (`csrc/decode_step.cu`). The JAX package
`qwen_tts_tpu` stays the reference every module here is tested against.

The two host-only modules the JAX package keeps free of JAX — the model
config (`qwen_tts_tpu.core.config`) and the tokenizer
(`qwen_tts_tpu.engine.tokenizer`) — are imported, not copied. This package
never imports `jax`.
"""

__version__ = "0.1.0"

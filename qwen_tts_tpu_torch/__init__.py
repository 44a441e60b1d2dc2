"""qwen_tts_tpu_torch — the PyTorch + CUDA port of `qwen_tts_tpu`.

Runs the streaming TTS path (`TTSEngine.synthesize_streaming`, bf16
weights and KV cache) and N-step greedy talker generation
(`ops/generate_kernel.py::generate_megakernel`, `runtime/decoder.py::TTSDecoder`)
on one NVIDIA Hopper GPU. Plain tensor code is PyTorch; the three TPU
kernels of the JAX package are CUDA kernels written for sm_90a under
`csrc/`: the single-token decode step, N greedy steps with on-device token
feedback, and single-token decode attention. The JAX package `qwen_tts_tpu`
stays the reference every module here is tested against.

The package imports neither `jax` nor anything of `qwen_tts_tpu`: it keeps
its own copies of the host-only modules it needs (`core/config.py`,
`engine/tokenizer.py`). Entry points run on the GPU unless the caller
passes `device="cpu"`, where every kernel runs its plain version.
"""

__version__ = "0.2.0"

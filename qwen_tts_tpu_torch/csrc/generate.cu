// N greedy decode steps of the talker in one persistent launch, with the
// next token fed back on the device, for sm_90a.
//
// Replaces the Pallas TPU kernel qwen_tts_tpu/ops/generate_kernel.py
// ::_gen_kernel (:52; pallas_call :709 in _generate_impl :514, wrapper
// generate_megakernel :769) in all its forms: bf16, int8, int4-g128 and
// mixed weights, a bf16 or int8 KV cache, standard RoPE or M-RoPE with any
// number of sections (up to 8) in the interleaved or the chunked layout.
// Per step n, at cache row pos0 + n, the launch runs (decode_layer.cuh):
//   1. the decode step: L layers, the cos/sin row gathered from the tables
//      by section (section s reads row positions[1 + s] + n), the new K/V
//      column (and, for an int8 cache, its row scales) written into the
//      cache at its row, final RMSNorm, LM head (scaled logits for an int8
//      head);
//   2. the argmax of the V logits: each block's candidate over its slice,
//      a grid barrier, then every block reduces the candidates in the same
//      way (lowest index wins a tie, as torch.argmax and jnp.argmax do);
//      block 0 writes tokens[n];
//   3. the token's embedding row, read by every block as the f32 input of
//      step n + 1.
// It is the kernel of qtts_decode_step with a step loop inside, so a step
// equals a decode-step launch bit for bit. The Pallas kernel's VMEM tail
// ring, aligned flushes and one-hot embedding gather are TPU lowering rules
// and are not carried over: the cache row is written at its position
// directly, and the next step reads it through TMA after the writer's
// async-proxy fence. The in-flight token therefore joins its own attention
// as the f32 column of the decode step, where the Pallas kernel reads it
// back from its ring in the cache's dtype (generate_kernel.py:278-297,
// 389-421): under an int8 cache the two differ by one int8 rounding of
// that column.
//
// What bounds it on an H100: weight bytes, N x 0.887 GB for the bf16
// talker (int8 ~0.445 GB, int4 ~0.237 GB). Step n + 1 needs step n's
// token, and the weights do not fit the 50 MB L2, so every step streams
// them again: N x 0.265 ms at 3.35 TB/s for bf16 (~3,770 tokens/s at
// most), N x 0.133 ms for int8. It replaces a first design that enqueued
// ~230 small launches a step from the host.

#include "decode_layer.cuh"

extern "C" {

// num_steps greedy steps of the decoder `dec` (which must have an LM head)
// from first_token (int32 [1], device) with the bf16 embedding table [V', H]
// (V' >= V) and the f32 rope tables [rows, D/2], in a workspace of
// qtts_workspace_bytes(...) bytes; positions, n_sec,
// interleaved and sec as for qtts_decode_step (the launch advances the
// positions by num_steps). tokens: int32 [num_steps], device. The caller
// checks that every row read lies in the cache and the tables. Returns 0
// or the first CUDA error; launches on `stream` and does not synchronise.
int qtts_generate(const QttsDecoder* dec, const void* first_token, const void* embed,
                  const void* cos_tab, const void* sin_tab, void* positions, int n_sec,
                  int interleaved, const int* sec, void* tokens, void* workspace, int num_steps,
                  void* stream) {
  if (dec->lm_head.w == nullptr || first_token == nullptr || embed == nullptr ||
      tokens == nullptr || n_sec < 0 || n_sec > kQttsMaxSections)
    return (int)cudaErrorInvalidValue;
  QttsStepIO io{};
  io.embed = embed;
  io.first_token = static_cast<const int*>(first_token);
  io.tokens = static_cast<int*>(tokens);
  io.num_steps = num_steps;
  io.cos_tab = static_cast<const float*>(cos_tab);
  io.sin_tab = static_cast<const float*>(sin_tab);
  io.positions = static_cast<int*>(positions);
  io.n_sec = n_sec;
  io.interleaved = interleaved;
  for (int s = 0; s < n_sec; ++s) io.sec[s] = sec[s];
  io.workspace = workspace;
  return qtts_run_steps(*dec, io, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"

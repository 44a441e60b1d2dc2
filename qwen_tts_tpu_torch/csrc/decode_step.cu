// One bf16 decode step of one token through all L layers of a Qwen3 decoder
// (the 28-layer talker or the 5-layer code predictor), for sm_90a.
//
// Replaces the Pallas TPU kernel qwen_tts_tpu/ops/decode_step.py::_megakernel
// (body :98, pallas_call :607, wrapper megakernel_forward :453) for bf16
// weights and a bf16 KV cache. The layer kernels, what bounds them (weight
// bytes: 0.887 GB a talker step, 0.265 ms at 3.35 TB/s) and the design that
// answers it are in decode_layer.cuh, which generate.cu shares.
//
// This first version launches eight small kernels per layer from a host
// loop; a persistent single launch, wgmma, TMA and L2 prefetch are later
// work. The entry point qtts_decode_step is a plain C function (bound with
// ctypes): it launches on the caller's stream, does not synchronise,
// allocates nothing (the caller passes a workspace of
// qtts_workspace_bytes(...) bytes), writes the new K/V column into the
// cache in place at `pos`, and returns the first CUDA error it sees.

#include "decode_layer.cuh"

extern "C" {

// Bytes of scratch qtts_decode_step needs for these widths.
long long qtts_workspace_bytes(int H, int I, int HQ, int KVH, int D, int V) {
  return (long long)workspace_bytes(H, I, HQ, KVH, D, V, nullptr, nullptr);
}

// One decode step. Pointers are device pointers into the layer-stacked
// weights ([L, in, out] bf16 matrices, [L, H] / [L, D] bf16 norms), the
// f32 embedding [H], the f32 cos/sin row [D/2], the bf16 caches
// [L, KVH, S, D] (column `pos` is written in place), and the f32 outputs
// normed [H] and logits [V]. lm_head and logits may both be null: the head
// is then skipped. Returns 0 or the first CUDA error.
int qtts_decode_step(const void* embed, const void* input_norm, const void* wqkv,
                     const void* q_norm, const void* k_norm, const void* wo,
                     const void* post_norm, const void* w_gate_up,
                     const void* w_down, const void* final_norm,
                     const void* lm_head, const void* cos_row,
                     const void* sin_row, void* k_cache, void* v_cache,
                     void* normed, void* logits, void* workspace, int L, int H,
                     int I, int HQ, int KVH, int D, int S, int V, int pos,
                     float eps, void* stream) {
  const StepDims dims{L, H, I, HQ, KVH, D, S, V, eps};
  if (!dims_ok(dims, pos) || (lm_head == nullptr) != (logits == nullptr))
    return (int)cudaErrorInvalidValue;
  Workspace ws;
  workspace_bytes(H, I, HQ, KVH, D, V, &ws, reinterpret_cast<char*>(workspace));
  const StepWeights w{
      reinterpret_cast<const bf16*>(input_norm), reinterpret_cast<const bf16*>(wqkv),
      reinterpret_cast<const bf16*>(q_norm),     reinterpret_cast<const bf16*>(k_norm),
      reinterpret_cast<const bf16*>(wo),         reinterpret_cast<const bf16*>(post_norm),
      reinterpret_cast<const bf16*>(w_gate_up),  reinterpret_cast<const bf16*>(w_down),
      reinterpret_cast<const bf16*>(final_norm), reinterpret_cast<const bf16*>(lm_head)};
  return enqueue_step(w, dims, reinterpret_cast<const float*>(embed),
                      reinterpret_cast<const float*>(cos_row),
                      reinterpret_cast<const float*>(sin_row),
                      reinterpret_cast<bf16*>(k_cache), reinterpret_cast<bf16*>(v_cache),
                      reinterpret_cast<float*>(normed), reinterpret_cast<float*>(logits),
                      ws, pos, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"

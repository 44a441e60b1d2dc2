// One decode step of one token through all L layers of a Qwen3 decoder
// (the 28-layer talker or the 5-layer code predictor), for sm_90a.
//
// Replaces the Pallas TPU kernel qwen_tts_tpu/ops/decode_step.py::_megakernel
// (body :98, pallas_call :607, wrapper megakernel_forward :453) in all its
// forms: bf16, int8 (per channel or per 128-row group), int4-g128 and mixed
// weights, an int8 or bf16 LM head, and a bf16 or int8 KV cache. The layer
// kernels, what bounds them (weight bytes: 0.887 GB a bf16 talker step,
// 0.265 ms at 3.35 TB/s; ~0.445 GB for int8, ~0.237 GB for int4) and the
// design that answers it are in decode_layer.cuh, which generate.cu shares.
//
// This first version launches eight small kernels per layer from a host
// loop; a persistent single launch, wgmma, TMA and L2 prefetch are later
// work. The entry point qtts_decode_step is a plain C function (bound with
// ctypes): it launches on the caller's stream, does not synchronise,
// allocates nothing (the caller passes a workspace of
// qtts_workspace_bytes(...) bytes), writes the new K/V column (and its
// scales) into the cache in place at `pos`, and returns the first CUDA
// error it sees.

#include "decode_layer.cuh"

extern "C" {

// Bytes of scratch qtts_decode_step needs for these widths.
long long qtts_workspace_bytes(int H, int I, int HQ, int KVH, int D, int V) {
  return (long long)workspace_bytes(H, I, HQ, KVH, D, V, nullptr, nullptr);
}

// One decode step of the decoder `dec` (device pointers, see QttsDecoder)
// from the f32 embedding [H] and the f32 cos/sin row [D/2]: writes the
// cache row `pos`, the f32 outputs normed [H] and, when dec->lm_head.w is
// set, logits [V] (logits must then be set, and null otherwise). Returns 0
// or the first CUDA error.
int qtts_decode_step(const QttsDecoder* dec, const void* embed, const void* cos_row,
                     const void* sin_row, void* normed, void* logits, void* workspace,
                     int pos, void* stream) {
  if (!decoder_ok(*dec, pos) || (dec->lm_head.w == nullptr) != (logits == nullptr))
    return (int)cudaErrorInvalidValue;
  Workspace ws;
  workspace_bytes(dec->H, dec->I, dec->HQ, dec->KVH, dec->D, dec->V, &ws,
                  reinterpret_cast<char*>(workspace));
  return enqueue_step(*dec, reinterpret_cast<const float*>(embed),
                      reinterpret_cast<const float*>(cos_row),
                      reinterpret_cast<const float*>(sin_row),
                      reinterpret_cast<float*>(normed), reinterpret_cast<float*>(logits),
                      ws, pos, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Single-token GQA decode attention over one layer's bf16 KV-cache prefix
// plus the in-flight token's f32 K/V column, for sm_90a.
//
// Replaces the Pallas TPU kernel qwen_tts_tpu/ops/attention.py
// ::_decode_attn_kernel (:29; pallas_call in _build_call :146, wrapper
// decode_attention :167). Same function: out[qh] = softmax over the rows
// [0, position) of cache[layer, qh / G] and the in-flight column of
// (q[qh] . k) / sqrt(D), times V, all in f32. The cache is only read.
//
// What bounds it on an H100: the bytes of the valid cache prefix, K and V,
// position x KVH x D x 2 B x 2 = position x 4 KiB at KVH = 8, D = 128:
// 1.2 MB at position 300 (0.37 us at 3.35 TB/s), 33.5 MB at 8191 (10 us).
// The arithmetic is ~1 FLOP per byte per q head sharing the kv head.
//
// Design: one launch of the decode-attention core of attention_core.cuh,
// which the decode step's attention stage shares: a thread-block cluster
// per kv head, its blocks streaming contiguous 64-row tile ranges through
// a TMA bulk-copy ring, the partials merged by rank 0 through distributed
// shared memory in rank order, the in-flight column last. No workspace, no
// atomics. It replaces a two-launch flash-decode (256-row chunk blocks,
// partials to a workspace, then a merge) that took 15.12 / 17.16 / 22.74 us
// of device time at positions 300 / 4095 / 8191 on an H100 80GB HBM3 at
// 700 W (chip_smoke.py, PERF.md).
//
// Constraints (those of the decode step): D = 128, G = HQ / KVH <= 8.

#include "attention_core.cuh"

namespace {

// Cluster of blocks `blockIdx.x / nb` = kv head h: q [HQ, D], k_new / v_new
// [KVH, D] f32, this layer's caches [KVH, S, D] bf16, out [HQ, D] f32;
// KG as in attend_cluster.
template <int KG>
__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                        const float* __restrict__ v_new, const bf16* __restrict__ k_layer,
                        const bf16* __restrict__ v_layer, int S, int G, int pos, int tpb,
                        float* __restrict__ out) {
  __shared__ AttnShared sh;
  extern __shared__ __align__(16) char attn_stages[];
  const int nb = (int)cg::this_cluster().num_blocks();
  const int h = blockIdx.x / nb, rank = (int)cg::this_cluster().block_rank();
  const bf16* kh = k_layer + (size_t)h * S * kAttnD;
  const bf16* vh = v_layer + (size_t)h * S * kAttnD;
  attn_start(sh, attn_stages, kh, vh, nullptr, nullptr, pos, tpb, rank);
  for (int i = threadIdx.x; i < (G + 2) * kAttnD; i += kAttnThreads) {
    const int r = i / kAttnD, d = i % kAttnD;
    sh.vecs[r][d] = r < G ? q[(size_t)(h * G + r) * kAttnD + d]
                          : (r == G ? k_new : v_new)[(size_t)h * kAttnD + d];
  }
  __syncthreads();
  attend_cluster<bf16, KG>(sh, attn_stages, kh, vh, nullptr, nullptr, G, pos, tpb,
                           out + (size_t)h * G * kAttnD, rank, nb);
}

template <int KG>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* k_cache,
                   const void* v_cache, void* out, int KVH, int S, int G, int layer,
                   int position, void* stream) {
  constexpr int kSmem = attn_dyn_smem<bf16>();
  static const cudaError_t prep =
      attn_prepare((const void*)decode_attention_kernel<KG>, kSmem);
  if (prep != cudaSuccess) return prep;
  int tpb = 0;
  const int nb = attn_blocks_per_head(position, &tpb);
  const size_t layer_off = (size_t)layer * KVH * S * kAttnD;
  return attn_launch(
      decode_attention_kernel<KG>, KVH, nb, kSmem, reinterpret_cast<cudaStream_t>(stream),
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k_new),
      reinterpret_cast<const float*>(v_new),
      reinterpret_cast<const bf16*>(k_cache) + layer_off,
      reinterpret_cast<const bf16*>(v_cache) + layer_off, S, G, position, tpb,
      reinterpret_cast<float*>(out));
}

}  // namespace

extern "C" {

// out [HQ, D] f32 = attention of q [HQ, D] f32 over rows [0, position) of
// layer `layer` of the bf16 caches [L, KVH, S, D] plus the column
// k_new / v_new [KVH, D] f32. All pointers are device pointers. One launch
// on `stream`; does not synchronise; returns 0 or the first CUDA error.
int qtts_decode_attention(const void* q, const void* k_new, const void* v_new,
                          const void* k_cache, const void* v_cache, void* out, int L, int HQ,
                          int KVH, int S, int D, int layer, int position, void* stream) {
  if (D != kAttnD || KVH <= 0 || HQ % KVH != 0 || HQ / KVH > kAttnMaxG || layer < 0 ||
      layer >= L || position < 0 || position > S)
    return (int)cudaErrorInvalidValue;
  const int G = HQ / KVH;
  decltype(&launch<2>) fn = &launch<kAttnMaxG>;
  if (G == 1) fn = &launch<1>;
  if (G == 2) fn = &launch<2>;
  const cudaError_t e =
      fn(q, k_new, v_new, k_cache, v_cache, out, KVH, S, G, layer, position, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

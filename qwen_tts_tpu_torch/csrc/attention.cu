// Single-token GQA decode attention over one layer's bf16 KV-cache prefix
// plus the in-flight token's f32 K/V column, for B slots at once, each at its
// own position read from device memory, for sm_90a.
//
// Replaces the Pallas TPU kernel qwen_tts_tpu/ops/attention.py
// ::_decode_attn_kernel (:29; pallas_call in _build_call :146, wrapper
// decode_attention :167). Same function, per slot b: out[b, qh] = softmax
// over the rows [0, pos[b]) of cache[b, layer, qh / G] and the in-flight
// column of (q[b, qh] . k) / sqrt(D), times V, all in f32. The cache is only
// read. As in the JAX kernel (which reads its position from SMEM), the
// position is a device value: the launch does not depend on it, so a CUDA
// graph that captured the launch replays it at whatever positions the array
// holds then.
//
// What bounds it on an H100: the bytes of the valid cache prefixes, K and V,
// sum_b pos[b] x KVH x D x 2 B x 2 = pos x 4 KiB a slot at KVH = 8, D = 128:
// 1.2 MB at position 300 (0.37 us at 3.35 TB/s), 33.5 MB at 8191 (10 us).
// The arithmetic is ~1 FLOP per byte per q head sharing the kv head.
//
// Design: one launch of the decode-attention core of attention_core.cuh,
// which the decode step's attention stage shares: a thread-block cluster
// per (slot, kv head), its blocks streaming contiguous 64-row tile ranges
// through a TMA bulk-copy ring, the partials merged by rank 0 through
// distributed shared memory in rank order, the in-flight column last. The
// grid is fixed by the cache's length (attn_blocks_for_cache: 16 blocks a
// kv head from 1,024 rows on, one up to 64): each block reads its slot's
// position and takes its share of that prefix's tiles; blocks past the
// prefix take none and merge as empty partials. No workspace, and no
// atomics but the launch count.
//
// Constraints (those of the decode step): D = 128, G = HQ / KVH <= 8.

#include "attention_core.cuh"

namespace {

// Cluster `blockIdx.x / nb` = slot b x KVH + kv head h. Slot b's q [HQ, D],
// k_new / v_new [KVH, D] f32 and out [HQ, D] f32 start at b times their slot
// strides, its caches [L, KVH, S, D] bf16 at b x cache_stride + layer_off;
// positions [B] int32 (clamped to [0, S]); KG as in attend_cluster. The
// launch's first block adds one to *count (when set): the kernel's own
// count of its launches, which CUDA-graph replays reach too.
template <int KG>
__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                        const float* __restrict__ v_new, const bf16* __restrict__ k_cache,
                        const bf16* __restrict__ v_cache, const int* __restrict__ positions,
                        int KVH, int S, int G, int nb, long long q_stride, long long col_stride,
                        long long cache_stride, long long layer_off, long long out_stride,
                        float* __restrict__ out, unsigned long long* __restrict__ count) {
  __shared__ AttnShared sh;
  extern __shared__ __align__(16) char attn_stages[];
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(count, 1ull);
  const int cl = blockIdx.x / nb, b = cl / KVH, h = cl % KVH;
  const int rank = nb == 1 ? 0 : (int)cg::this_cluster().block_rank();
  const int pos = min(max(__ldg(positions + b), 0), S);
  const int tpb = attn_tiles_per_block(pos, nb);
  const size_t head = (size_t)b * cache_stride + layer_off + (size_t)h * S * kAttnD;
  const bf16* kh = k_cache + head;
  const bf16* vh = v_cache + head;
  attn_start(sh, attn_stages, kh, vh, nullptr, nullptr, pos, tpb, rank);
  const float* qb = q + (size_t)b * q_stride;
  const float* kb = k_new + (size_t)b * col_stride;
  const float* vb = v_new + (size_t)b * col_stride;
  for (int i = threadIdx.x; i < (G + 2) * kAttnD; i += kAttnThreads) {
    const int r = i / kAttnD, d = i % kAttnD;
    sh.vecs[r][d] = r < G ? qb[(size_t)(h * G + r) * kAttnD + d]
                          : (r == G ? kb : vb)[(size_t)h * kAttnD + d];
  }
  __syncthreads();
  attend_cluster<bf16, KG>(sh, attn_stages, kh, vh, nullptr, nullptr, G, pos, tpb,
                           out + (size_t)b * out_stride + (size_t)h * G * kAttnD, rank, nb);
}

template <int KG>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* k_cache,
                   const void* v_cache, void* out, const void* positions, int B, int KVH, int S,
                   int G, int layer, long long q_stride, long long col_stride,
                   long long cache_stride, long long out_stride, void* count,
                   void* stream) {
  constexpr int kSmem = attn_dyn_smem<bf16>();
  static const cudaError_t prep =
      attn_prepare((const void*)decode_attention_kernel<KG>, kSmem);
  if (prep != cudaSuccess) return prep;
  const int nb = attn_blocks_for_cache(S);
  return attn_launch(
      decode_attention_kernel<KG>, B * KVH, nb, kSmem, reinterpret_cast<cudaStream_t>(stream),
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k_new),
      reinterpret_cast<const float*>(v_new), reinterpret_cast<const bf16*>(k_cache),
      reinterpret_cast<const bf16*>(v_cache), reinterpret_cast<const int*>(positions), KVH, S,
      G, nb, q_stride, col_stride, cache_stride, (long long)layer * KVH * S * kAttnD,
      out_stride, reinterpret_cast<float*>(out), reinterpret_cast<unsigned long long*>(count));
}

}  // namespace

extern "C" {

// For each of B slots b: out[b] [HQ, D] f32 = attention of q[b] [HQ, D] f32
// over rows [0, positions[b]) of layer `layer` of slot b's bf16 caches
// [L, KVH, S, D] plus the column k_new[b] / v_new[b] [KVH, D] f32. Slot b's
// tensors start b x their stride (in elements) after the first's; positions
// is a device int32 array [B]; count, if not null, a device uint64 the
// launch adds one to. All pointers are device pointers. One launch on
// `stream`, whose grid does not depend on the positions; does not
// synchronise; returns 0 or the first CUDA error.
int qtts_decode_attention(const void* q, const void* k_new, const void* v_new,
                          const void* k_cache, const void* v_cache, void* out,
                          const void* positions, int B, int L, int HQ, int KVH, int S, int D,
                          int layer, long long q_stride, long long col_stride,
                          long long cache_stride, long long out_stride, void* count,
                          void* stream) {
  if (D != kAttnD || B <= 0 || KVH <= 0 || HQ % KVH != 0 || HQ / KVH > kAttnMaxG ||
      layer < 0 || layer >= L || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = HQ / KVH;
  decltype(&launch<2>) fn = &launch<kAttnMaxG>;
  if (G == 1) fn = &launch<1>;
  if (G == 2) fn = &launch<2>;
  const cudaError_t e = fn(q, k_new, v_new, k_cache, v_cache, out, positions, B, KVH, S, G,
                           layer, q_stride, col_stride, cache_stride, out_stride, count,
                           stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

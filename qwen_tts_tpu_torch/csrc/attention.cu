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
// Design. The Pallas kernel walks 256-row chunks in sequence with an online
// softmax; here the chunks are parallel blocks (flash-decoding), so a long
// prefix spreads over the SMs: grid (KVH, ceil(position / 256)), 256 threads.
// In a block 16 threads share a cache row, each loading 16 bytes (8 bf16
// dims), so a half-warp reads one 256-byte row and a block 16 rows a pass.
// Each K row is loaded once and scored against all G q heads of its kv head
// (q kept in registers); the block then takes its chunk's max and sum per q
// head and accumulates p x V the same way. A block writes a partial
// (m, l, acc[D]) per q head into a workspace the caller allocates; a second
// kernel, one block per q head, merges the partials in chunk order and
// then the in-flight column, and divides. No atomics: the result is the
// same from run to run. position == 0 launches only the merge.
//
// Constraints (those of decode_step.cu): D = 128, G = HQ / KVH <= 8.
// Staging chunks through cp.async/TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kD = 128;
constexpr int kMaxG = 8;
constexpr int kChunk = 256;                 // cache rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = kD / 8;          // 16 threads x 8 dims = one row
constexpr int kRowsPerPass = kThreads / kRowThreads;  // 16

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// Block (h, c): rows [c*256, min(c*256+256, position)) of kv head h.
// part_ml[((h * nc + c) * G + g) * 2 + {0,1}] = chunk max m, sum l of
// exp(s - m); part_acc[((h * nc + c) * G + g) * D + d] = sum exp(s - m) v[d].
__global__ void __launch_bounds__(kThreads)
attn_chunk(const float* __restrict__ q, const bf16* __restrict__ k_layer,
           const bf16* __restrict__ v_layer, int S, int G, int position,
           float* __restrict__ part_ml, float* __restrict__ part_acc) {
  const int h = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = tid / kRowThreads;            // row lane 0..15
  const int dl = tid % kRowThreads;            // dims dl*8 .. dl*8+7
  const int t0 = c * kChunk;
  const int nrows = min(kChunk, position - t0);
  const float scale = rsqrtf((float)kD);
  const bf16* kh = k_layer + ((size_t)h * S + t0) * kD + dl * 8;
  const bf16* vh = v_layer + ((size_t)h * S + t0) * kD + dl * 8;

  __shared__ float s_p[kMaxG][kChunk];          // scores, then probabilities
  __shared__ float s_m[kMaxG], s_l[kMaxG];
  __shared__ float red[kWarps][kMaxG][kD];

  float qr[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[g][e] = g < G ? q[(size_t)(h * G + g) * kD + dl * 8 + e] : 0.f;

  for (int base = 0; base < nrows; base += kRowsPerPass) {  // scores
    const int r = base + rl;
    const bool ok = r < nrows;
    float kf[8];
    unpack8(ok ? __ldg(reinterpret_cast<const uint4*>(kh + (size_t)r * kD))
               : make_uint4(0u, 0u, 0u, 0u), kf);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float s = qr[g][0] * kf[0];
#pragma unroll
      for (int e = 1; e < 8; ++e) s = fmaf(qr[g][e], kf[e], s);
#pragma unroll
      for (int o = kRowThreads / 2; o > 0; o >>= 1)   // the row's 16 lanes
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (ok && dl == 0) s_p[g][r] = s * scale;
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += kWarps) {  // chunk max and sum per q head
    float m = -INFINITY;
    for (int r = lane; r < nrows; r += 32) m = fmaxf(m, s_p[g][r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int r = lane; r < nrows; r += 32) {
      const float p = expf(s_p[g][r] - m);
      s_p[g][r] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      s_m[g] = m;
      s_l[g] = l;
    }
  }
  __syncthreads();

  float acc[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int base = 0; base < nrows; base += kRowsPerPass) {  // p x V
    const int r = base + rl;
    if (r < nrows) {
      float vf[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(vh + (size_t)r * kD)), vf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float p = s_p[g][r];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  // the warp's two rows (lanes l and l + 16 hold the same dims), then warps
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
      if (lane < 16) red[warp][g][dl * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();
  const size_t slot = (size_t)(h * nc + c) * G;
  for (int i = tid; i < G * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][g][d];
    part_acc[(slot + g) * kD + d] = s;
  }
  if (tid < G) {
    part_ml[(slot + tid) * 2] = s_m[tid];
    part_ml[(slot + tid) * 2 + 1] = s_l[tid];
  }
}

// One block of D threads per q head qh = h * G + g: merge the nc chunk
// partials in order, then the in-flight column, and divide.
__global__ void __launch_bounds__(kD)
attn_merge(const float* __restrict__ q, const float* __restrict__ k_new,
           const float* __restrict__ v_new, const float* __restrict__ part_ml,
           const float* __restrict__ part_acc, int G, int nc,
           float* __restrict__ out) {
  const int qh = blockIdx.x, h = qh / G, g = qh % G;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  __shared__ float w_s[kD / 32];

  float s = q[(size_t)qh * kD + d] * k_new[(size_t)h * kD + d];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) w_s[warp] = s;
  __syncthreads();
  float dot = 0.f;
#pragma unroll
  for (int w = 0; w < kD / 32; ++w) dot += w_s[w];
  const float s_new = dot * rsqrtf((float)kD);

  float mx = s_new;
  for (int c = 0; c < nc; ++c)
    mx = fmaxf(mx, part_ml[((size_t)(h * nc + c) * G + g) * 2]);
  const float p_new = expf(s_new - mx);
  float den = p_new;
  float num = p_new * v_new[(size_t)h * kD + d];
  for (int c = 0; c < nc; ++c) {
    const size_t slot = (size_t)(h * nc + c) * G + g;
    const float w = expf(part_ml[slot * 2] - mx);
    den = fmaf(part_ml[slot * 2 + 1], w, den);
    num = fmaf(part_acc[slot * kD + d], w, num);
  }
  out[(size_t)qh * kD + d] = num / den;
}

int num_chunks(int position) { return (position + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

// Bytes of scratch qtts_decode_attention needs at this position.
long long qtts_attention_workspace_bytes(int HQ, int KVH, int D, int position) {
  (void)KVH;
  if (position <= 0) return 0;
  return (long long)num_chunks(position) * HQ * (2 + D) * (long long)sizeof(float);
}

// out [HQ, D] f32 = attention of q [HQ, D] f32 over rows [0, position) of
// layer `layer` of the bf16 caches [L, KVH, S, D] plus the column
// k_new / v_new [KVH, D] f32. All pointers are device pointers; workspace
// holds qtts_attention_workspace_bytes(...) bytes. Launches on `stream`,
// does not synchronise, returns 0 or the first CUDA error.
int qtts_decode_attention(const void* q, const void* k_new, const void* v_new,
                          const void* k_cache, const void* v_cache, void* out,
                          void* workspace, int L, int HQ, int KVH, int S, int D,
                          int layer, int position, void* stream) {
  if (D != kD || KVH <= 0 || HQ % KVH != 0 || HQ / KVH > kMaxG || layer < 0 ||
      layer >= L || position < 0 || position > S)
    return (int)cudaErrorInvalidValue;
  const int G = HQ / KVH, nc = num_chunks(position);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* part_ml = reinterpret_cast<float*>(workspace);
  float* part_acc = part_ml + (size_t)nc * HQ * 2;
  const size_t layer_off = (size_t)layer * KVH * S * kD;
  if (nc > 0)
    attn_chunk<<<dim3(KVH, nc), kThreads, 0, st>>>(
        reinterpret_cast<const float*>(q),
        reinterpret_cast<const bf16*>(k_cache) + layer_off,
        reinterpret_cast<const bf16*>(v_cache) + layer_off, S, G, position,
        part_ml, part_acc);
  attn_merge<<<HQ, kD, 0, st>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k_new),
      reinterpret_cast<const float*>(v_new), part_ml, part_acc, G, nc,
      reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"

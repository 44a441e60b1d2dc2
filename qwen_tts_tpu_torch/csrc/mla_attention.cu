// Single-token multi-head latent attention (MLA) of DeepSeek-V2 over one
// layer's latent cache, the position read from device memory, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no latent attention. Added for
// qwen_tts_tpu_torch/models/deepseek_v2.py's decode step in the absorbed
// form (ops/mla_attention.py wraps it). Function: each cache row t holds a
// token's normed latent c[t] (C = 512) and its roped k_pe[t] (R = 64), bf16;
// for each of the 16 heads h,
//     o[h] = sum_t p[h][t] c[t],  p[h] = softmax_t(scale * (q_lat[h] . c[t] + q_pe[h] . k_pe[t]))
// over t in [0, pos], the new token's row (written before the launch)
// included, in float32. W_UK and W_UV are folded into q_lat and out by the
// caller. As in the decode-attention kernel (attention.cu), the position is
// a device value: the launch does not depend on it, so a CUDA graph that
// captured it replays it at whatever position the array holds then.
//
// What bounds it on an H100: the rows' bytes, (pos + 1) x 576 x 2 B, and the
// queries and output in float32 (69.6 KB): 0.19 MB at position 100
// (0.06 us at 3.35 TB/s), 2.4 MB at 2,047 (0.7 us). At the agent's
// positions (64-104) a launch is latency, not bytes.
//
// Design: a grid fixed by the cache's length (`splits` blocks, at most 32);
// block s takes the s-th equal share of the rows [0, pos] (a multiple of
// 16), for all 16 heads at once, so each row is read once; blocks past the
// rows (7 of 32 are active at position 100) return at once. A block walks
// its share in 16-row tiles staged in shared memory: thread (h, r) scores
// head h on row r (a 576-long float32 dot product from shared memory, the
// tile's rows at an odd word stride so the 16 rows fall in 16 banks), one
// thread a head
// updates the head's running max and sum, then thread d rescales and adds
// p x c for latent dims d and d + 256 of every head. The queries and each
// tile are staged with 16-byte loads, a thread's loads all issued before its
// first store, so a block waits on memory once a tile. Each block leaves its
// unnormalised output, max and sum in the workspace; the last active block
// to take a ticket merges the partials in split order (one thread a split
// and head for the weights, then every dim's sum with its loads in flight
// together) and resets the ticket for the next launch. The launch's first
// block adds one to *count (when set).
//
// Constraints: 16 heads, C = 512, R = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;
constexpr int kHeads = 16;
constexpr int kC = 512;
constexpr int kR = 64;
constexpr int kD = kC + kR;          // 576 values a cache row
constexpr int kRows = 16;            // rows a tile
constexpr int kQStride = kD + 4;     // floats a query row in shared memory
constexpr int kCStride = kD + 2;     // bf16 a tile row: 289 words, an odd stride
constexpr int kMaxSplits = 32;
constexpr int kQLoads = kHeads * kD / 4 / kThreads;           // 9 float4 a thread
constexpr int kVecs = kD / 8;                                 // 72 uint4 a cache row
constexpr int kTileLoads = (kRows * kVecs + kThreads - 1) / kThreads;   // 5
constexpr size_t kSmem = (size_t)kHeads * kQStride * sizeof(float) +
                         (size_t)kRows * kCStride * sizeof(bf16) +
                         (size_t)(kHeads * kRows + 3 * kHeads + kMaxSplits * kHeads) *
                             sizeof(float);

__global__ void __launch_bounds__(kThreads)
mla_decode_attn(const float* __restrict__ q_lat, const float* __restrict__ q_pe,
                const bf16* __restrict__ cache, const int* __restrict__ positions, int S,
                float scale_log2, int splits, float* __restrict__ out,
                float* __restrict__ work, unsigned int* __restrict__ ticket,
                unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                                 // [16][580]
  bf16* ct = reinterpret_cast<bf16*>(qs + kHeads * kQStride);                 // [16][578]
  float* sc = reinterpret_cast<float*>(ct + kRows * kCStride);                // [16][16]
  float* mrow = sc + kHeads * kRows;
  float* lrow = mrow + kHeads;
  float* alpha = lrow + kHeads;
  float* factor = alpha + kHeads;                                             // [splits][16]
  __shared__ bool last;
  const int tid = threadIdx.x;
  if (count != nullptr && blockIdx.x == 0 && tid == 0) atomicAdd(count, 1ull);

  const int n = min(max(__ldg(positions), 0), S - 1) + 1;       // rows [0, pos]
  const int share = ((n + splits - 1) / splits + kRows - 1) / kRows * kRows;
  const int active = (n + share - 1) / share;                   // blocks with rows
  if ((int)blockIdx.x >= active) return;
  const int beg = blockIdx.x * share, end = min(n, beg + share);

  {                                   // the queries: all of a thread's loads in flight at once
    constexpr int kLat = kHeads * kC / 4;        // q_lat's float4s, then q_pe's
    float4 v[kQLoads];
#pragma unroll
    for (int k = 0; k < kQLoads; ++k) {
      const int i = tid + k * kThreads;
      v[k] = i < kLat ? __ldg(reinterpret_cast<const float4*>(q_lat) + i)
                      : __ldg(reinterpret_cast<const float4*>(q_pe) + i - kLat);
    }
#pragma unroll
    for (int k = 0; k < kQLoads; ++k) {
      const int i = tid + k * kThreads;
      const int h = i < kLat ? i / (kC / 4) : (i - kLat) / (kR / 4);
      const int d = i < kLat ? i % (kC / 4) * 4 : kC + (i - kLat) % (kR / 4) * 4;
      *reinterpret_cast<float4*>(qs + h * kQStride + d) = v[k];
    }
  }
  if (tid < kHeads) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  float acc[kHeads][2];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) acc[h][0] = acc[h][1] = 0.f;
  __syncthreads();

  for (int t0 = beg; t0 < end; t0 += kRows) {
    constexpr int kWords = kD / 2;                // 288 bf16 pairs a row
    {                                 // the tile: 16-byte loads, all in flight at once
      uint4 v[kTileLoads];
#pragma unroll
      for (int k = 0; k < kTileLoads; ++k) {
        const int i = tid + k * kThreads, r = i / kVecs;
        v[k] = i < kRows * kVecs && t0 + r < end
            ? __ldg(reinterpret_cast<const uint4*>(cache + (size_t)(t0 + r) * kD) + i % kVecs)
            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kTileLoads; ++k) {
        const int i = tid + k * kThreads;
        if (i < kRows * kVecs) {
          uint32_t* w = reinterpret_cast<uint32_t*>(ct + (i / kVecs) * kCStride) + i % kVecs * 4;
          w[0] = v[k].x;
          w[1] = v[k].y;
          w[2] = v[k].z;
          w[3] = v[k].w;
        }
      }
    }
    __syncthreads();
    {
      const int h = tid / kRows, r = tid % kRows;
      const float* qh = qs + h * kQStride;
      const __nv_bfloat162* cr = reinterpret_cast<const __nv_bfloat162*>(ct + r * kCStride);
      float s = 0.f;
#pragma unroll 8
      for (int k2 = 0; k2 < kWords; ++k2) {
        const float2 c = __bfloat1622float2(cr[k2]);
        const float2 q = *reinterpret_cast<const float2*>(qh + 2 * k2);
        s = fmaf(q.x, c.x, s);
        s = fmaf(q.y, c.y, s);
      }
      sc[h * kRows + r] = t0 + r < end ? s * scale_log2 : -INFINITY;
    }
    __syncthreads();
    if (tid < kHeads) {
      const float m_old = mrow[tid];
      float m = m_old;
#pragma unroll
      for (int r = 0; r < kRows; ++r) m = fmaxf(m, sc[tid * kRows + r]);
      const float a = exp2f(m_old - m);
      float l = lrow[tid] * a;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = exp2f(sc[tid * kRows + r] - m);
        sc[tid * kRows + r] = p;
        l += p;
      }
      mrow[tid] = m;
      lrow[tid] = l;
      alpha[tid] = a;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      float a0 = acc[h][0] * alpha[h], a1 = acc[h][1] * alpha[h];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sc[h * kRows + r];
        a0 = fmaf(p, __bfloat162float(ct[r * kCStride + tid]), a0);
        a1 = fmaf(p, __bfloat162float(ct[r * kCStride + tid + kThreads]), a1);
      }
      acc[h][0] = a0;
      acc[h][1] = a1;
    }
    __syncthreads();                          // before the next tile is staged
  }

  float* opart = work;                                      // [splits][16][512]
  float* mpart = work + (size_t)splits * kHeads * kC;       // [splits][16]
  float* lpart = mpart + splits * kHeads;                   // [splits][16]
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    float* o = opart + ((size_t)blockIdx.x * kHeads + h) * kC;
    o[tid] = acc[h][0];
    o[tid + kThreads] = acc[h][1];
  }
  if (tid < kHeads) {
    mpart[blockIdx.x * kHeads + tid] = mrow[tid];
    lpart[blockIdx.x * kHeads + tid] = lrow[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned)active - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the merge, in split order: each partial's weight exp2(m_s - M) / L a
  // head, one thread a (split, head), then every output dim's sum over the
  // active splits, their loads independent
  for (int i = tid; i < active * kHeads; i += kThreads) factor[i] = __ldcg(mpart + i);
  __syncthreads();
  if (tid < kHeads) {
    float m = -INFINITY;
    for (int s = 0; s < active; ++s) m = fmaxf(m, factor[s * kHeads + tid]);
    mrow[tid] = m;
  }
  __syncthreads();
  for (int i = tid; i < active * kHeads; i += kThreads)
    factor[i] = exp2f(factor[i] - mrow[i % kHeads]);
  __syncthreads();
  if (tid < kHeads) {
    float l = 0.f;
    for (int s = 0; s < active; ++s)
      l += __ldcg(lpart + s * kHeads + tid) * factor[s * kHeads + tid];
    lrow[tid] = 1.f / l;
  }
  __syncthreads();
  for (int h = 0; h < kHeads; ++h) {
    float o0 = 0.f, o1 = 0.f;
#pragma unroll 8
    for (int s = 0; s < active; ++s) {
      const float f = factor[s * kHeads + h];
      const float* o = opart + ((size_t)s * kHeads + h) * kC;
      o0 = fmaf(__ldcg(o + tid), f, o0);
      o1 = fmaf(__ldcg(o + tid + kThreads), f, o1);
    }
    out[h * kC + tid] = o0 * lrow[h];
    out[h * kC + tid + kThreads] = o1 * lrow[h];
  }
  if (tid == 0) *ticket = 0u;
}

}  // namespace

extern "C" {

// out [16, 512] f32 = the latent attention of q_lat [16, 512] and q_pe
// [16, 64] f32 over rows [0, positions[0]] of one layer's cache [S, 576]
// bf16 (positions a device int32; clamped to [0, S - 1]), with the softmax's
// scale given in base 2 (scale x log2 e). work holds splits x 16 x 514
// floats; ticket a device uint32, zero between launches; count, if not
// null, a device uint64 the launch adds one to. One launch on `stream`;
// does not synchronise; returns 0 or the first CUDA error.
int qtts_mla_decode_attention(const void* q_lat, const void* q_pe, const void* cache,
                              const void* positions, int S, int NH, int C, int R,
                              float scale_log2, void* out, void* work, void* ticket, int splits,
                              void* count, void* stream) {
  if (NH != kHeads || C != kC || R != kR || S <= 0 || splits <= 0 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t prep = cudaFuncSetAttribute(
      mla_decode_attn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (prep != cudaSuccess) return (int)prep;
  mla_decode_attn<<<splits, kThreads, kSmem, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(q_lat), reinterpret_cast<const float*>(q_pe),
      reinterpret_cast<const bf16*>(cache), reinterpret_cast<const int*>(positions), S,
      scale_log2, splits, reinterpret_cast<float*>(out), reinterpret_cast<float*>(work),
      reinterpret_cast<unsigned int*>(ticket), reinterpret_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

}  // extern "C"

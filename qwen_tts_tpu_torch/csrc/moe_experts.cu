// Routed plus shared SwiGLU experts of a DeepSeek-V2 MoE layer, added into
// the float32 residual rows, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no mixture-of-experts model.
// Added for qwen_tts_tpu_torch/models/deepseek_v2.py (ops/moe.py wraps it).
// Function: for each row t of h [T, H] bf16, each expert e that the router
// chose for it with weight w (device arrays), and the shared expert with
// weight 1,
//     x[t] += w * W_down[e] (silu(W_gate[e] h[t]) * (W_up[e] h[t]))
// in float32, the weights bf16 in the [out, in] layout: gate|up [E, 2I, H]
// (rows j and I + j are column j's gate and up), down [E, H, I]; the shared
// expert [2Is, H] and [H, Is].
//
// What bounds it on an H100: the chosen experts' bytes. A decode step (one
// row, top-6 of 64 experts of width 1,408, shared width 2,816, H 2,048)
// reads (6 x 3 x 2,048 x 1,408 + 3 x 2,048 x 2,816) x 2 B = 138.4 MB, 41.3 us
// at 3.35 TB/s, at 1 FLOP a byte: a GEMV, far below the ridge point, so the
// products run on the CUDA cores in float32 and the design is about bytes
// in flight.
//
// Design:
//  - One block a 64-column tile of one expert's intermediate width (22
//    tiles of 1,408, 44 of the shared 2,816), so a decode step is 6 x 22 +
//    44 = 176 blocks of 256 threads, several resident an SM, each with its
//    whole tile's loads in flight.
//  - Phase A, gate and up: warp w owns columns 8w..8w+7 of the tile; for
//    each it loads the column's gate row and up row whole (H = 2,048 bf16:
//    eight 16-byte loads a lane each, 16 loads in flight), dots them with the
//    block's rows of h held in shared memory and reduces across the warp.
//    The activation silu(g) * u times the row's routing weight goes to
//    shared memory.
//  - Phase B, down: each 8-lane group reads one output n's 64 tile columns
//    of W_down (128 contiguous bytes), four n's a warp and four rounds of
//    loads in flight, dots them with the activations and adds its share of
//    x[t][n] with a float32 atomic: the tile is a split of the down
//    product's inner dimension, so no second pass and no workspace, at the
//    price of a sum whose order varies between runs.
//  - Two forms, two kernels by name in the device trace:
//    moe_experts_decode (one row: the block's expert is ids[slot]) and
//    moe_experts_prefill (T rows: the (row, expert) pairs sorted by expert
//    on the device; block (e, tile) takes the rows of expert e, 8 at a
//    time, and an expert no row chose returns at once, its weights unread).
//    Neither computes an expert that no row chose.
//  - The launch's first block adds one to *count (when set): the kernel's
//    own count of its launches, which CUDA-graph replays reach too.
//
// Constraints: H a multiple of 256 up to 2,048; I and Is multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // intermediate columns a block owns
constexpr int kColsPerWarp = kTile / kWarps;
constexpr int kMaxPasses = 8;              // 16-byte loads a lane over a row of H <= 2,048
constexpr int kPrefillRows = 8;            // rows of h a prefill block holds at once
constexpr int kDownUnroll = 4;             // W_down rounds in flight

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

// acc += the dot product of 8 bf16 weights and 8 bf16 activations.
__device__ __forceinline__ void dot8(const uint4& w, const uint4& a, float& acc) {
  const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(wp[i]);
    const float2 y = __bfloat1622float2(ap[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
}

// acc += the dot product of 8 bf16 weights and 8 f32 activations.
__device__ __forceinline__ void dot8f(const uint4& w, const float* a, float& acc) {
  const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(wp[i]);
    acc = fmaf(x.x, a[2 * i], acc);
    acc = fmaf(x.y, a[2 * i + 1], acc);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One expert's tile of kTile intermediate columns [j0, j0 + kTile) over the
// block's `nrows` (<= R) rows: hs [R][H] bf16, wts[R] and xrow[R] in shared
// memory (the routing weight and the row of x of each), act [R][kTile] f32
// shared scratch. gu: the expert's gate|up [2I, H]; dn: its down [H, I].
template <int R>
__device__ __forceinline__ void expert_tile(const bf16* __restrict__ gu,
                                            const bf16* __restrict__ dn, int H, int I, int j0,
                                            int nrows, const bf16* hs, const float* wts,
                                            const int* xrow, float* act,
                                            float* __restrict__ x) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int passes = H / 256;
  // Phase A: act[r][j] = silu(gate_j . h_r) * (up_j . h_r) * w_r
  for (int jj = 0; jj < kColsPerWarp; ++jj) {
    const int j = warp * kColsPerWarp + jj;
    const uint4* g = reinterpret_cast<const uint4*>(gu + (size_t)(j0 + j) * H) + lane;
    const uint4* u = reinterpret_cast<const uint4*>(gu + (size_t)(I + j0 + j) * H) + lane;
    uint4 gw[kMaxPasses], uw[kMaxPasses];
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < passes) {
        gw[p] = __ldg(g + p * 32);
        uw[p] = __ldg(u + p * 32);
      }
    }
    float gs[R], us[R];
#pragma unroll
    for (int r = 0; r < R; ++r) gs[r] = us[r] = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < passes) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nrows) {
            const uint4 hv = reinterpret_cast<const uint4*>(hs + (size_t)r * H)[p * 32 + lane];
            dot8(gw[p], hv, gs[r]);
            dot8(uw[p], hv, us[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
        const float gsum = warp_sum(gs[r]), usum = warp_sum(us[r]);
        if (lane == 0) act[r * kTile + j] = silu(gsum) * usum * wts[r];
      }
    }
  }
  __syncthreads();
  // Phase B: x[row_r][n] += act[r][:] . W_down[n][j0 : j0 + kTile]
  const int sub = lane / 8, part = lane % 8;
  float a[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) a[r][i] = r < nrows ? act[r * kTile + part * 8 + i] : 0.f;
  }
  const int step = kWarps * 4;                 // n's a round of the block
  for (int n0 = warp * 4 + sub; n0 < H; n0 += step * kDownUnroll) {
    uint4 wv[kDownUnroll];
#pragma unroll
    for (int q = 0; q < kDownUnroll; ++q) {
      const int n = n0 + q * step;
      if (n < H) wv[q] = __ldg(reinterpret_cast<const uint4*>(dn + (size_t)n * I + j0) + part);
    }
#pragma unroll
    for (int q = 0; q < kDownUnroll; ++q) {
      const int n = n0 + q * step;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nrows) {
          float s = 0.f;
          if (n < H) dot8f(wv[q], a[r], s);
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          if (part == 0 && n < H) atomicAdd(x + (size_t)xrow[r] * H + n, s);
        }
      }
    }
  }
}

// Rows of h into shared memory, 16 bytes a thread at a time.
__device__ __forceinline__ void load_rows(const bf16* __restrict__ h, int H, int nrows,
                                          const int* xrow, bf16* hs) {
  const int per_row = H / 8;
  for (int i = threadIdx.x; i < nrows * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row;
    reinterpret_cast<uint4*>(hs + (size_t)r * H)[c] =
        __ldg(reinterpret_cast<const uint4*>(h + (size_t)xrow[r] * H) + c);
  }
}

// One row: block b < k x tiles is tile b % tiles of the expert ids[b / tiles]
// (weight weights[b / tiles]); the rest are the shared expert's tiles.
__global__ void __launch_bounds__(kThreads)
moe_experts_decode(const bf16* __restrict__ h, const long long* __restrict__ ids,
                   const float* __restrict__ weights, int k, const bf16* __restrict__ w_gu,
                   const bf16* __restrict__ w_down, const bf16* __restrict__ s_gu,
                   const bf16* __restrict__ s_down, int E, int H, int I, int Is,
                   float* __restrict__ x, unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* act = reinterpret_cast<float*>(smem + (size_t)H * sizeof(bf16));
  __shared__ float wts[1];
  __shared__ int xrow[1];
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(count, 1ull);
  const int tiles = I / kTile, b = blockIdx.x;
  const bf16 *gu, *dn;
  int width, j0;
  float w = 1.f;
  if (b < k * tiles) {
    const int slot = b / tiles;
    const long long e = min(max(__ldg(ids + slot), 0ll), (long long)E - 1);
    gu = w_gu + (size_t)e * 2 * I * H;
    dn = w_down + (size_t)e * H * I;
    width = I;
    j0 = (b % tiles) * kTile;
    w = __ldg(weights + slot);
  } else {
    gu = s_gu;
    dn = s_down;
    width = Is;
    j0 = (b - k * tiles) * kTile;
  }
  if (threadIdx.x == 0) {
    wts[0] = w;
    xrow[0] = 0;
  }
  __syncthreads();
  load_rows(h, H, 1, xrow, hs);
  __syncthreads();
  expert_tile<1>(gu, dn, H, width, j0, 1, hs, wts, xrow, act, x);
}

// T rows: block b < E x tiles is tile b % tiles of expert e = b / tiles over
// the pairs [offsets[e], offsets[e + 1]) of rows / weights (sorted by
// expert); the rest are the shared expert's tiles over rows 0..T-1.
__global__ void __launch_bounds__(kThreads)
moe_experts_prefill(const bf16* __restrict__ h, int T, const int* __restrict__ rows,
                    const float* __restrict__ weights, const int* __restrict__ offsets,
                    const bf16* __restrict__ w_gu, const bf16* __restrict__ w_down,
                    const bf16* __restrict__ s_gu, const bf16* __restrict__ s_down, int E,
                    int H, int I, int Is, float* __restrict__ x,
                    unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* act = reinterpret_cast<float*>(smem + (size_t)kPrefillRows * H * sizeof(bf16));
  __shared__ float wts[kPrefillRows];
  __shared__ int xrow[kPrefillRows];
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(count, 1ull);
  const int tiles = I / kTile, b = blockIdx.x;
  const bool routed = b < E * tiles;
  const bf16 *gu, *dn;
  int width, j0, beg, end;
  if (routed) {
    const int e = b / tiles;
    gu = w_gu + (size_t)e * 2 * I * H;
    dn = w_down + (size_t)e * H * I;
    width = I;
    j0 = (b % tiles) * kTile;
    beg = __ldg(offsets + e);
    end = __ldg(offsets + e + 1);
  } else {
    gu = s_gu;
    dn = s_down;
    width = Is;
    j0 = (b - E * tiles) * kTile;
    beg = 0;
    end = T;
  }
  for (int c = beg; c < end; c += kPrefillRows) {
    const int nrows = min(kPrefillRows, end - c);
    __syncthreads();                           // the previous rows' readers are done
    if (threadIdx.x < nrows) {
      xrow[threadIdx.x] = routed ? __ldg(rows + c + threadIdx.x) : c + threadIdx.x;
      wts[threadIdx.x] = routed ? __ldg(weights + c + threadIdx.x) : 1.f;
    }
    __syncthreads();
    load_rows(h, H, nrows, xrow, hs);
    __syncthreads();
    expert_tile<kPrefillRows>(gu, dn, H, width, j0, nrows, hs, wts, xrow, act, x);
  }
}

}  // namespace

extern "C" {

// The one-row form: x [1, H] f32 += the experts ids [1, k] (int64) with
// weights [1, k] f32 chose for h [1, H] bf16, and the shared expert. All
// pointers are device pointers; count, if not null, a device uint64 the
// launch adds one to. One launch on `stream`; does not synchronise; returns
// 0 or the first CUDA error.
int qtts_moe_experts_decode(const void* h, const void* ids, const void* weights, int k,
                            const void* w_gu, const void* w_down, const void* s_gu,
                            const void* s_down, int E, int H, int I, int Is, void* x,
                            void* count, void* stream) {
  if (H % 256 != 0 || H > 256 * kMaxPasses || I % kTile != 0 || Is % kTile != 0 || k <= 0 ||
      E <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = k * (I / kTile) + Is / kTile;
  const size_t smem = (size_t)H * sizeof(bf16) + kTile * sizeof(float);
  moe_experts_decode<<<blocks, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const bf16*>(h), reinterpret_cast<const long long*>(ids),
      reinterpret_cast<const float*>(weights), k, reinterpret_cast<const bf16*>(w_gu),
      reinterpret_cast<const bf16*>(w_down), reinterpret_cast<const bf16*>(s_gu),
      reinterpret_cast<const bf16*>(s_down), E, H, I, Is, reinterpret_cast<float*>(x),
      reinterpret_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

// The multi-row form: x [T, H] f32 += for each (row, expert) pair sorted by
// expert (rows [P] int32, weights [P] f32, offsets [E + 1] int32 of each
// expert's first pair) that expert of h[row] times its weight, and the
// shared expert of every row. As above otherwise.
int qtts_moe_experts_prefill(const void* h, int T, const void* rows, const void* weights,
                             const void* offsets, const void* w_gu, const void* w_down,
                             const void* s_gu, const void* s_down, int E, int H, int I, int Is,
                             void* x, void* count, void* stream) {
  if (H % 256 != 0 || H > 256 * kMaxPasses || I % kTile != 0 || Is % kTile != 0 || T <= 0 ||
      E <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = E * (I / kTile) + Is / kTile;
  const size_t smem = (size_t)kPrefillRows * (H * sizeof(bf16) + kTile * sizeof(float));
  moe_experts_prefill<<<blocks, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const bf16*>(h), T, reinterpret_cast<const int*>(rows),
      reinterpret_cast<const float*>(weights), reinterpret_cast<const int*>(offsets),
      reinterpret_cast<const bf16*>(w_gu), reinterpret_cast<const bf16*>(w_down),
      reinterpret_cast<const bf16*>(s_gu), reinterpret_cast<const bf16*>(s_down), E, H, I, Is,
      reinterpret_cast<float*>(x), reinterpret_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

}  // extern "C"

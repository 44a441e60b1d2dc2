// The device code of one decode step of a Qwen3 decoder, for sm_90a: the
// layer kernels and the host function that enqueues them for one token
// through all L layers, the final RMSNorm and the LM head.
//
// Shared by decode_step.cu (one step a call, qtts_decode_step) and
// generate.cu (N greedy steps a call, qtts_generate), so the two compute
// bit-identical steps. It computes what the Pallas TPU kernel
// qwen_tts_tpu/ops/decode_step.py::_megakernel computes, with the same bf16
// rounding points: the residual stream stays f32 and is rounded to bf16
// only where it enters a matrix product (normed input before QKV,
// attention output before O-proj, post-norm before gate|up, SwiGLU output
// before down, final norm before the head). q, k and v stay f32 through
// QK-RMSNorm and RoPE; only the cache stores bf16 (or int8), and the
// in-flight token joins the attention as an f32 column.
//
// Weight forms, per matrix (QttsMat::form; the Pallas kernel's
// make_mms().mm_scaled, decode_step.py:45-95, picks them by shape the same
// way, which is how the mixed int8-attention/int4-MLP tier runs):
//   bf16  gemv_bf16: bf16 x bf16, f32 sums;
//   int8  gemv_int8: int8 [K, N] with f32 scales [ng, N]; ng == 1 scales
//         the column's summed product (per output channel, also the int8
//         LM head's [1, V]); ng > 1 (groups of 128 rows) scales each
//         group's partial product;
//   int4  gemv_int4: int4-g128 nibble-packed in the halves layout, byte
//         row r of [K/2, N] holding input row r (low nibble) and row
//         r + K/2 (high nibble); low half takes scale rows [0, ng/2), the
//         high half [ng/2, ng).
// The weights are upcast in registers (an int8 or int4 value times a bf16
// activation is exact in f32); no kernel writes a dequantized matrix.
// An int8 KV cache (QttsDecoder::k_scale set) stores each new head row as
// rint(row / s), s = max(absmax, 1e-8) / 127 from the f32 row, and applies
// the per-row scales on the score and probability side, as the Pallas
// kernel does (decode_step.py:259-315).
//
// What bounds a step on an H100: weight bytes. One bf16 talker step reads
// ~0.887 GB of layer weights (int8 ~0.445 GB, mixed ~0.32 GB, int4 ~0.237
// GB with its group scales) and does ~2 FLOP per weight, two orders of
// magnitude below the card's ridge point, so every matrix product is a
// matrix-vector product limited by HBM bandwidth. The GEMV's threads each
// own 8 adjacent output columns (16 bytes of a bf16 row, 8 of an int8 or
// packed int4 row), 8 threads a 64-column tile, 32 row lanes, four rows in
// flight per thread, and split-K across blocks so that even the narrow
// O-proj and down-proj (1024 outputs) put ~256 blocks on 132 SMs. One
// unrolled pass of a block's 32 row lanes covers 4 x 32 = 128 rows, so for
// the grouped forms the split-K boundaries follow the 128-row groups: every
// pass of a thread lies in one group, and its 8 partial sums are scaled
// once per pass from 8 scale loads (32 bytes a thread per 128 rows, ~3% of
// the int8 weight bytes), not per row. (Folding the scale into each row
// instead would cost a multiply per weight.) Split-K partial sums go to a
// workspace and are summed, in a fixed order, by the kernel that consumes
// them (no atomics: results are deterministic).
//
// The attention stage, one launch a layer (attention_step), is the
// decode-attention core of attention_core.cuh, which the standalone
// decode-attention kernel shares: a cluster of blocks per kv head, each
// streaming a contiguous range of 64-row cache tiles through a TMA
// bulk-copy ring, merged by rank 0 through distributed shared memory in a
// fixed order. Its bytes grow with the position: at 8191 the 28 talker layers
// read 0.94 GB of bf16 cache a step, more than the weights (0.28 ms at
// 3.35 TB/s). Before, one block per kv head walked the prefix a row per
// warp, ~30 us a layer at position 300 and 21.3 ms a step at 8191.
//
// Constraints: head_dim D = 128, at most 8 q heads per kv head, every
// matrix width (H, Q + 2*KV, 2*I, V) a multiple of 64, grouped scales
// over groups of exactly 128 rows, and a cache length S that is a multiple
// of 8 (the attention core copies int8 row scales 4 at a time).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_core.cuh"

// One weight matrix, layer-stacked: w is [L, K, N] bf16 or int8, or
// [L, K/2, N] packed int4; s is [L, ng, N] f32 (null for bf16).
struct QttsMat {
  const void* w;
  const float* s;
  int form;  // kFormBf16, kFormInt8, kFormInt4
  int ng;    // scale rows per layer
};

// A decoder and its KV cache, as the C entry points take it. Norms are
// bf16 ([L, H], [L, D], [H]); lm_head.w may be null (no head). The caches
// are [L, KVH, S, D] bf16, or int8 when k_scale / v_scale ([L, KVH, S] f32)
// are set.
struct QttsDecoder {
  const void* input_norm;
  const void* q_norm;
  const void* k_norm;
  const void* post_norm;
  const void* final_norm;
  QttsMat wqkv, wo, w_gate_up, w_down, lm_head;
  void* k_cache;
  void* v_cache;
  float* k_scale;
  float* v_scale;
  int L, H, I, HQ, KVH, D, S, V;
  float eps;
};

namespace {

enum : int { kFormBf16 = 0, kFormInt8 = 1, kFormInt4 = 2 };

constexpr int kGemvCols = 64;     // output columns per block
constexpr int kGemvThreads = 256;  // 8 threads per row x 32 rows
constexpr int kGemvRows = 32;     // rows per block per pass
constexpr int kGemvUnroll = 4;    // passes whose loads are issued together
constexpr int kGroup = kGemvRows * kGemvUnroll;  // 128: one pass, one scale group
constexpr int kMaxSplit = 32;     // split-K factor bound (sizes the workspace)
constexpr int kNormThreads = 1024;

// Sum the block's 32 row lanes and write the split's partial of its 64
// columns, times the column's scale when col_scale is set.
__device__ __forceinline__ void store_split(const float (&acc)[8], float* __restrict__ part,
                                            int N, const float* __restrict__ col_scale) {
  __shared__ float red[kGemvRows][kGemvCols + 1];
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) red[rg][cg * 8 + j] = acc[j];
  __syncthreads();
  if (tid < kGemvCols) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < kGemvRows; ++r) s += red[r][tid];
    const int n = blockIdx.x * kGemvCols + tid;
    if (col_scale != nullptr) s *= col_scale[n];
    part[(size_t)blockIdx.y * N + n] = s;
  }
}

__device__ __forceinline__ void load_scales8(const float* __restrict__ p, float (&s)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

// part[split][n] = sum over this split's rows k of x[k] * W[k][n].
// W is row-major [K, N] bf16 (in -> out), x is bf16 [K].
__global__ void __launch_bounds__(kGemvThreads)
gemv_bf16(const bf16* __restrict__ x, const bf16* __restrict__ W,
          float* __restrict__ part, int K, int N, int rows_per_split) {
  const int tid = threadIdx.x;
  const int cg = tid & 7;   // 8-column group inside the tile
  const int rg = tid >> 3;  // row lane, 0..31
  const int col = blockIdx.x * kGemvCols + cg * 8;
  const int k0 = blockIdx.y * rows_per_split;
  const int k1 = min(K, k0 + rows_per_split);

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int k = k0 + rg; k < k1; k += kGemvRows * kGemvUnroll) {
    uint4 w[kGemvUnroll];
    float xv[kGemvUnroll];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int r = k + u * kGemvRows;
      if (r < k1) {
        w[u] = __ldg(reinterpret_cast<const uint4*>(W + (size_t)r * N + col));
        xv[u] = __bfloat162float(x[r]);
      } else {
        w[u] = make_uint4(0u, 0u, 0u, 0u);
        xv[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w[u]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        acc[2 * j] = fmaf(xv[u], f.x, acc[2 * j]);
        acc[2 * j + 1] = fmaf(xv[u], f.y, acc[2 * j + 1]);
      }
    }
  }
  store_split(acc, part, N, nullptr);
}

// Exact int8 / int4 -> f32 without the conversion instruction (I2F runs at
// a quarter of the FMA rate on sm_90; with one conversion per weight the
// int8 GEMVs of a talker step moved 0.99 TB/s on an H100, with this 1.05
// TB/s, tools/profile_port.py forms, PERF.md). A value v in
// [0, 255] placed in the low byte of 0x4B000000 is the float 2^23 + v, so
// one byte permute and one subtraction give it. Signed values are offset
// first: int8 b as b ^ 0x80 = b + 128; an int4 nibble n as n ^ 8 = n + 8,
// which equals the Pallas kernel's sign extension ((int)b << 28) >> 28
// (low nibble) and (int)b >> 4 (high nibble) minus the offset.
__device__ __forceinline__ float biased_byte(uint32_t word, int j, float bias) {
  return __int_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | j)) - bias;
}

// Eight int8 values (8 bytes, columns 0..7) as floats.
__device__ __forceinline__ void int8x8(const uint2& w, float (&f)[8]) {
  const uint32_t a = w.x ^ 0x80808080u, b = w.y ^ 0x80808080u;
  constexpr float kBias = 8388608.f + 128.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = biased_byte(a, j, kBias);
    f[4 + j] = biased_byte(b, j, kBias);
  }
}

// Eight packed bytes as the low-nibble and high-nibble int4 values.
__device__ __forceinline__ void int4x8(const uint2& w, float (&lo)[8], float (&hi)[8]) {
  constexpr float kBias = 8388608.f + 8.f;
  const uint32_t words[2] = {w.x, w.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t l = (words[i] & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t h = ((words[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[4 * i + j] = biased_byte(l, j, kBias);
      hi[4 * i + j] = biased_byte(h, j, kBias);
    }
  }
}

// The int8 form: W int8 [K, N], scale f32 [ng, N]. kGrouped (ng > 1,
// groups of kGroup rows; the split starts on a group boundary): each pass
// lies in group (k - rg) / kGroup and its partials are scaled there.
// Otherwise (ng == 1) the split's column sum is scaled in store_split.
template <bool kGrouped>
__global__ void __launch_bounds__(kGemvThreads)
gemv_int8(const bf16* __restrict__ x, const int8_t* __restrict__ W,
          const float* __restrict__ scale, float* __restrict__ part, int K, int N,
          int rows_per_split) {
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  const int col = blockIdx.x * kGemvCols + cg * 8;
  const int k0 = blockIdx.y * rows_per_split;
  const int k1 = min(K, k0 + rows_per_split);

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int k = k0 + rg; k < k1; k += kGroup) {
    uint2 w[kGemvUnroll];
    float xv[kGemvUnroll];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int r = k + u * kGemvRows;
      if (r < k1) {
        w[u] = __ldg(reinterpret_cast<const uint2*>(W + (size_t)r * N + col));
        xv[u] = __bfloat162float(x[r]);
      } else {
        w[u] = make_uint2(0u, 0u);
        xv[u] = 0.f;
      }
    }
    float p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = 0.f;
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      float f[8];
      int8x8(w[u], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = fmaf(xv[u], f[j], p[j]);
    }
    if constexpr (kGrouped) {
      float s[8];
      load_scales8(scale + (size_t)((k - rg) / kGroup) * N + col, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(p[j], s[j], acc[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += p[j];
    }
  }
  store_split(acc, part, N, kGrouped ? nullptr : scale);
}

// The packed int4-g128 form: W int8 [K/2, N] (halves layout), scale f32
// [K/128, N]. Packed row r pairs input rows r and r + K/2, whose groups
// are g = r / 128 and g + K/256.
__global__ void __launch_bounds__(kGemvThreads)
gemv_int4(const bf16* __restrict__ x, const int8_t* __restrict__ W,
          const float* __restrict__ scale, float* __restrict__ part, int K, int N,
          int rows_per_split) {
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  const int col = blockIdx.x * kGemvCols + cg * 8;
  const int Kh = K / 2;
  const int hi_groups = Kh / kGroup;
  const int k0 = blockIdx.y * rows_per_split;
  const int k1 = min(Kh, k0 + rows_per_split);

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int k = k0 + rg; k < k1; k += kGroup) {
    uint2 w[kGemvUnroll];
    float xl[kGemvUnroll], xh[kGemvUnroll];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int r = k + u * kGemvRows;
      if (r < k1) {
        w[u] = __ldg(reinterpret_cast<const uint2*>(W + (size_t)r * N + col));
        xl[u] = __bfloat162float(x[r]);
        xh[u] = __bfloat162float(x[r + Kh]);
      } else {
        w[u] = make_uint2(0u, 0u);
        xl[u] = xh[u] = 0.f;
      }
    }
    float pl[8], ph[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pl[j] = ph[j] = 0.f;
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      float lo[8], hi[8];
      int4x8(w[u], lo, hi);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pl[j] = fmaf(xl[u], lo[j], pl[j]);
        ph[j] = fmaf(xh[u], hi[j], ph[j]);
      }
    }
    const int g = (k - rg) / kGroup;
    float sl[8], sh[8];
    load_scales8(scale + (size_t)g * N + col, sl);
    load_scales8(scale + (size_t)(g + hi_groups) * N + col, sh);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(ph[j], sh[j], fmaf(pl[j], sl[j], acc[j]));
  }
  store_split(acc, part, N, nullptr);
}

// x_out = x_in + sum_s part[s] (part may be null), then
// y = rms_norm(x_out) * w  ->  out_bf (bf16) and, if out_f is set, out_f (f32).
// One block; x_in may alias x_out (each element is read and written by one
// thread).
__global__ void __launch_bounds__(kNormThreads)
residual_rmsnorm(const float* x_in, const float* __restrict__ part, int nsplit,
                 float* x_out, const bf16* __restrict__ w,
                 bf16* __restrict__ out_bf, float* __restrict__ out_f, int H,
                 float eps) {
  __shared__ float warp_ss[32];
  __shared__ float inv_rms;
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float p = 0.f;
    for (int s = 0; s < nsplit; ++s) p += part[(size_t)s * H + i];
    const float v = x_in[i] + p;
    x_out[i] = v;
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float t = lane < nwarps ? warp_ss[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / (float)H + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float y = x_out[i] * r * __bfloat162float(w[i]);
    out_bf[i] = __float2bfloat16(y);
    if (out_f != nullptr) out_f[i] = y;
  }
}

// The attention stage of one layer, a cluster of blocks per kv head h (the
// core of attention_core.cuh). Every block sums the split-K partials of
// h's G q heads and of its k and v head, applies per-head QK-RMSNorm and
// half-split RoPE (cheap: (G + 2) x 128 values, so each block redoes it
// rather than wait for one). Rank 0 writes the K/V column at `pos` (bf16;
// or, for an int8 cache, rint(row / s) clipped to +-127 and the row scale
// s = max(absmax, 1e-8) / 127 into ks / vs). The blocks read only the rows
// [0, pos), so that write and their reads never meet. Then the G q heads
// attend over those rows plus the in-flight (f32) column; an int8 row's
// scale multiplies its score and its probability's weight on V. Output
// bf16 [HQ*D]. The caches and scales are this layer's: [KVH, S, D] and
// [KVH, S]. KG as in attend_cluster.
template <typename CacheT, int KG>
__global__ void __launch_bounds__(kAttnThreads)
attention_step(const float* __restrict__ part, int nsplit, int qkv_n,
               const bf16* __restrict__ q_norm, const bf16* __restrict__ k_norm,
               const float* __restrict__ cos_row, const float* __restrict__ sin_row,
               CacheT* __restrict__ k_cache, CacheT* __restrict__ v_cache,
               float* __restrict__ k_scale, float* __restrict__ v_scale,
               bf16* __restrict__ attn_out, int HQ, int KVH, int S, int pos,
               float eps, int tpb) {
  constexpr bool kKv8 = sizeof(CacheT) == 1;
  constexpr int D = kAttnD;
  constexpr int D2 = kAttnD / 2;
  __shared__ AttnShared sh;
  extern __shared__ __align__(16) char attn_stages[];
  const bool rank0 = cg::this_cluster().block_rank() == 0;
  const int h = blockIdx.x / cg::this_cluster().num_blocks();
  const int G = HQ / KVH;
  const int Q = HQ * D, KV = KVH * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  CacheT* kh = k_cache + (size_t)h * S * D;
  CacheT* vh = v_cache + (size_t)h * S * D;
  const float* ksh = kKv8 ? k_scale + (size_t)h * S : nullptr;
  const float* vsh = kKv8 ? v_scale + (size_t)h * S : nullptr;
  attn_start(sh, attn_stages, kh, vh, ksh, vsh, pos, tpb);  // the prefix streams in meanwhile

  for (int i = tid; i < (G + 2) * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int col = r < G ? (h * G + r) * D + d
                          : (r == G ? Q + h * D + d : Q + KV + h * D + d);
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) s += part[(size_t)sp * qkv_n + col];
    sh.vecs[r][d] = s;
  }
  __syncthreads();

  for (int r = warp; r < G + 1; r += kAttnWarps) {  // QK-RMSNorm
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) ss = fmaf(sh.vecs[r][d], sh.vecs[r][d], ss);
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)D + eps);
    const bf16* nw = r < G ? q_norm : k_norm;
    for (int d = lane; d < D; d += 32)
      sh.vecs[r][d] = sh.vecs[r][d] * inv * __bfloat162float(nw[d]);
  }
  __syncthreads();

  for (int i = tid; i < (G + 1) * D2; i += blockDim.x) {  // RoPE
    const int r = i / D2, j = i % D2;
    const float x1 = sh.vecs[r][j], x2 = sh.vecs[r][j + D2];
    const float c = cos_row[j], s = sin_row[j];
    sh.vecs[r][j] = x1 * c - x2 * s;
    sh.vecs[r][j + D2] = x2 * c + x1 * s;
  }
  __syncthreads();

  if (rank0) {
    if constexpr (kKv8) {
      if (warp < 2) {  // warp 0 quantizes the k row, warp 1 the v row
        const float* row = sh.vecs[G + warp];
        float am = 0.f;
        for (int d = lane; d < D; d += 32) am = fmaxf(am, fabsf(row[d]));
        const float sc = fmaxf(warp_max(am), 1e-8f) / 127.f;
        CacheT* dst = (warp == 0 ? kh : vh) + (size_t)pos * D;
        for (int d = lane; d < D; d += 32)
          dst[d] = (CacheT)fminf(fmaxf(rintf(row[d] / sc), -127.f), 127.f);
        if (lane == 0) (warp == 0 ? k_scale : v_scale)[(size_t)h * S + pos] = sc;
      }
    } else {
      for (int d = tid; d < D; d += blockDim.x) {
        kh[(size_t)pos * D + d] = __float2bfloat16(sh.vecs[G][d]);
        vh[(size_t)pos * D + d] = __float2bfloat16(sh.vecs[G + 1][d]);
      }
    }
  }
  attend_cluster<CacheT, KG>(sh, attn_stages, kh, vh, ksh, vsh, G, pos, tpb,
                             attn_out + (size_t)h * G * D);
}

// act[i] = bf16(silu(gate[i]) * up[i]), gate|up summed over the splits.
__global__ void swiglu(const float* __restrict__ part, int nsplit, int I,
                       bf16* __restrict__ act) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I) return;
  float g = 0.f, u = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    g += part[(size_t)s * 2 * I + i];
    u += part[(size_t)s * 2 * I + I + i];
  }
  act[i] = __float2bfloat16(g / (1.f + expf(-g)) * u);
}

__global__ void sum_splits(const float* __restrict__ part, int nsplit, int N,
                           float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += part[(size_t)sp * N + n];
  out[n] = s;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Split-K factor: double it while the grid has fewer than two blocks per SM
// and each split keeps at least one full unrolled pass of rows.
int choose_split(int K, int N) {
  const int tiles = N / kGemvCols;
  int s = 1;
  while (s < kMaxSplit && tiles * s < 2 * sm_count() &&
         K / (2 * s) >= kGemvRows * kGemvUnroll)
    s *= 2;
  return s;
}

size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

struct Workspace {
  float* x;
  float* part;
  bf16* xb;
  bf16* attn;
  bf16* act;
};

size_t workspace_bytes(int H, int I, int HQ, int KVH, int D, int V, Workspace* ws,
                       char* base) {
  const int Q = HQ * D, QKV = Q + 2 * KVH * D;
  int max_n = QKV;
  if (H > max_n) max_n = H;
  if (2 * I > max_n) max_n = 2 * I;
  if (V > max_n) max_n = V;
  int max_in = H;
  if (Q > max_in) max_in = Q;
  if (I > max_in) max_in = I;
  size_t off = 0;
  const size_t x_off = off;    off += align_up((size_t)H * sizeof(float));
  const size_t p_off = off;    off += align_up((size_t)kMaxSplit * max_n * sizeof(float));
  const size_t xb_off = off;   off += align_up((size_t)max_in * sizeof(bf16));
  const size_t at_off = off;   off += align_up((size_t)Q * sizeof(bf16));
  const size_t ac_off = off;   off += align_up((size_t)I * sizeof(bf16));
  if (ws != nullptr) {
    ws->x = reinterpret_cast<float*>(base + x_off);
    ws->part = reinterpret_cast<float*>(base + p_off);
    ws->xb = reinterpret_cast<bf16*>(base + xb_off);
    ws->attn = reinterpret_cast<bf16*>(base + at_off);
    ws->act = reinterpret_cast<bf16*>(base + ac_off);
  }
  return off;
}

// x [K] bf16 times layer `li` of matrix m ([K, N] in its form) into the
// split-K partials; returns the number of splits.
int launch_mat(const QttsMat& m, size_t li, const bf16* x, float* part, int K, int N,
               cudaStream_t st) {
  const int tiles = N / kGemvCols;
  if (m.form == kFormBf16) {
    const int s = choose_split(K, N);
    const int rows = (K + s - 1) / s;
    gemv_bf16<<<dim3(tiles, s), kGemvThreads, 0, st>>>(
        x, static_cast<const bf16*>(m.w) + li * K * N, part, K, N, rows);
    return s;
  }
  const bool int4 = m.form == kFormInt4, grouped = int4 || m.ng > 1;
  const int Kp = int4 ? K / 2 : K;  // stored rows
  const int8_t* w = static_cast<const int8_t*>(m.w) + li * Kp * N;
  const float* sc = m.s + li * m.ng * N;
  const int s = choose_split(Kp, N);
  int rows = (Kp + s - 1) / s;
  if (grouped) rows = (rows + kGroup - 1) / kGroup * kGroup;  // splits on group bounds
  const int ns = (Kp + rows - 1) / rows;
  const dim3 grid(tiles, ns);
  if (int4)
    gemv_int4<<<grid, kGemvThreads, 0, st>>>(x, w, sc, part, K, N, rows);
  else if (grouped)
    gemv_int8<true><<<grid, kGemvThreads, 0, st>>>(x, w, sc, part, K, N, rows);
  else
    gemv_int8<false><<<grid, kGemvThreads, 0, st>>>(x, w, sc, part, K, N, rows);
  return ns;
}

// True when matrix m ([K, N]) is a form the GEMVs take.
bool mat_ok(const QttsMat& m, int K) {
  if (m.w == nullptr) return false;
  switch (m.form) {
    case kFormBf16:
      return true;
    case kFormInt8:
      return m.s != nullptr && (m.ng == 1 || m.ng * kGroup == K);
    case kFormInt4:
      return m.s != nullptr && m.ng * kGroup == K && m.ng % 2 == 0;
    default:
      return false;
  }
}

// True when the kernels take this decoder and `pos` is a cache row.
bool decoder_ok(const QttsDecoder& d, int pos) {
  const int Q = d.HQ * d.D, QKV = Q + 2 * d.KVH * d.D;
  return d.D == kAttnD && d.KVH > 0 && d.HQ % d.KVH == 0 &&
         d.HQ / d.KVH <= kAttnMaxG && d.H % kGemvCols == 0 &&
         QKV % kGemvCols == 0 && (2 * d.I) % kGemvCols == 0 &&
         d.V % kGemvCols == 0 && d.S % 8 == 0 && pos >= 0 && pos < d.S && d.L > 0 &&
         mat_ok(d.wqkv, d.H) && mat_ok(d.wo, Q) && mat_ok(d.w_gate_up, d.H) &&
         mat_ok(d.w_down, d.I) && (d.lm_head.w == nullptr || mat_ok(d.lm_head, d.H)) &&
         (d.k_scale == nullptr) == (d.v_scale == nullptr);
}

// One clustered launch of layer li's attention stage: KVH clusters of
// attn_blocks_per_head(pos) blocks. Returns the launch's error.
template <typename CacheT, int KG>
cudaError_t launch_attention(const QttsDecoder& d, int li, const float* part, int nsplit,
                             const float* cos_row, const float* sin_row, bf16* out, int pos,
                             cudaStream_t st) {
  constexpr int kSmem = attn_dyn_smem<CacheT>();
  static const cudaError_t prep =
      attn_prepare((const void*)attention_step<CacheT, KG>, kSmem);
  if (prep != cudaSuccess) return prep;
  int tpb = 0;
  const int nb = attn_blocks_per_head(pos, &tpb);
  const size_t rows = (size_t)d.KVH * d.S;
  return attn_launch(
      attention_step<CacheT, KG>, d.KVH, nb, kSmem, st, part, nsplit,
      d.HQ * d.D + 2 * d.KVH * d.D, static_cast<const bf16*>(d.q_norm) + (size_t)li * d.D,
      static_cast<const bf16*>(d.k_norm) + (size_t)li * d.D, cos_row, sin_row,
      static_cast<CacheT*>(d.k_cache) + li * rows * d.D,
      static_cast<CacheT*>(d.v_cache) + li * rows * d.D,
      d.k_scale ? d.k_scale + li * rows : nullptr, d.v_scale ? d.v_scale + li * rows : nullptr,
      out, d.HQ, d.KVH, d.S, pos, d.eps, tpb);
}

using AttentionLauncher = cudaError_t (*)(const QttsDecoder&, int, const float*, int,
                                          const float*, const float*, bf16*, int, cudaStream_t);

// The attention stage for this decoder's cache type and q heads per kv head.
AttentionLauncher attention_launcher(const QttsDecoder& d) {
  const int G = d.HQ / d.KVH;
  if (d.k_scale != nullptr) {
    if (G == 1) return &launch_attention<int8_t, 1>;
    if (G == 2) return &launch_attention<int8_t, 2>;
    return &launch_attention<int8_t, kAttnMaxG>;
  }
  if (G == 1) return &launch_attention<bf16, 1>;
  if (G == 2) return &launch_attention<bf16, 2>;
  return &launch_attention<bf16, kAttnMaxG>;
}

// Enqueue one token through all L layers at cache row `pos`, from the f32
// residual input x_in [H] and the f32 cos/sin row [D/2]: writes the new
// K/V column (and, for an int8 cache, its scales) into the caches, normed
// [H] f32 and, when d.lm_head.w is set, logits [V] f32. Each matrix goes
// to the GEMV of its form. Returns 0 or the first CUDA error.
int enqueue_step(const QttsDecoder& d, const float* x_in, const float* cos_row,
                 const float* sin_row, float* normed, float* logits, const Workspace& ws,
                 int pos, cudaStream_t st) {
  const int H = d.H, I = d.I, Q = d.HQ * d.D, QKV = Q + 2 * d.KVH * d.D;
  const bf16* input_norm = static_cast<const bf16*>(d.input_norm);
  const bf16* post_norm = static_cast<const bf16*>(d.post_norm);
  cudaError_t err;
  int prev_split = 0;  // layer 0 starts from x_in, no partials
  for (int li = 0; li < d.L; ++li) {
    residual_rmsnorm<<<1, kNormThreads, 0, st>>>(
        x_in, prev_split ? ws.part : nullptr, prev_split, ws.x,
        input_norm + (size_t)li * H, ws.xb, nullptr, H, d.eps);
    const int s_qkv = launch_mat(d.wqkv, li, ws.xb, ws.part, H, QKV, st);
    err = attention_launcher(d)(d, li, ws.part, s_qkv, cos_row, sin_row, ws.attn, pos, st);
    if (err != cudaSuccess) return (int)err;
    const int s_o = launch_mat(d.wo, li, ws.attn, ws.part, Q, H, st);
    residual_rmsnorm<<<1, kNormThreads, 0, st>>>(
        ws.x, ws.part, s_o, ws.x, post_norm + (size_t)li * H, ws.xb, nullptr, H, d.eps);
    const int s_gu = launch_mat(d.w_gate_up, li, ws.xb, ws.part, H, 2 * I, st);
    swiglu<<<(I + 255) / 256, 256, 0, st>>>(ws.part, s_gu, I, ws.act);
    prev_split = launch_mat(d.w_down, li, ws.act, ws.part, I, H, st);
    x_in = ws.x;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  residual_rmsnorm<<<1, kNormThreads, 0, st>>>(
      ws.x, ws.part, prev_split, ws.x, static_cast<const bf16*>(d.final_norm), ws.xb,
      normed, H, d.eps);
  if (d.lm_head.w != nullptr) {
    const int s_h = launch_mat(d.lm_head, 0, ws.xb, ws.part, H, d.V, st);
    sum_splits<<<(d.V + 255) / 256, 256, 0, st>>>(ws.part, s_h, d.V, logits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The device code of one bf16 decode step of a Qwen3 decoder, for sm_90a:
// the layer kernels and the host function that enqueues them for one token
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
// QK-RMSNorm and RoPE; only the cache stores bf16, and the in-flight token
// joins the attention as an f32 column.
//
// What bounds a step on an H100: weight bytes. One talker step reads ~881
// MB of bf16 layer weights and does ~2 FLOP per weight byte, two orders of
// magnitude below the card's ridge point, so every matrix product is a
// matrix-vector product limited by HBM bandwidth. The GEMV's loads are 16
// bytes a thread, adjacent threads on adjacent output columns (one 128-byte
// line per row per 8 threads), four rows in flight per thread, and split-K
// across blocks so that even the narrow O-proj and down-proj (1024 outputs)
// put ~256 blocks on 132 SMs. Split-K partial sums go to a workspace and are
// summed, in a fixed order, by the kernel that consumes them (no atomics:
// results are deterministic).
//
// Constraints: head_dim D = 128, at most 8 q heads per kv head, and every
// matrix width (H, Q + 2*KV, 2*I, V) a multiple of 64.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kGemvCols = 64;     // output columns per block
constexpr int kGemvThreads = 256;  // 8 threads per row x 32 rows
constexpr int kGemvRows = 32;     // rows per block per pass
constexpr int kGemvUnroll = 4;    // passes whose loads are issued together
constexpr int kMaxSplit = 32;     // split-K factor bound (sizes the workspace)
constexpr int kHeadDim = 128;
constexpr int kMaxGroups = 8;     // q heads per kv head
constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kNormThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

  __shared__ float red[kGemvRows][kGemvCols + 1];
#pragma unroll
  for (int j = 0; j < 8; ++j) red[rg][cg * 8 + j] = acc[j];
  __syncthreads();
  if (tid < kGemvCols) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < kGemvRows; ++r) s += red[r][tid];
    part[(size_t)blockIdx.y * N + blockIdx.x * kGemvCols + tid] = s;
  }
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

// One block per kv head h: sum the split-K partials of its G q heads and of
// its k and v head, per-head QK-RMSNorm, half-split RoPE, write the bf16 K/V
// column at `pos`, then online-softmax attention of the G q heads over the
// cache rows [0, pos) plus the in-flight (f32) column. Output bf16 [HQ*D].
__global__ void __launch_bounds__(kAttnThreads)
attention_step(const float* __restrict__ part, int nsplit, int qkv_n,
               const bf16* __restrict__ q_norm, const bf16* __restrict__ k_norm,
               const float* __restrict__ cos_row, const float* __restrict__ sin_row,
               bf16* __restrict__ k_cache, bf16* __restrict__ v_cache,
               bf16* __restrict__ attn_out, int HQ, int KVH, int S, int pos,
               float eps) {
  constexpr int D = kHeadDim;
  constexpr int D2 = kHeadDim / 2;
  const int h = blockIdx.x;
  const int G = HQ / KVH;
  const int Q = HQ * D, KV = KVH * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float scale = rsqrtf((float)D);

  __shared__ float vecs[kMaxGroups + 2][D];  // q_0..q_{G-1}, k, v
  __shared__ float s_new[kMaxGroups];
  __shared__ float w_m[kAttnWarps][kMaxGroups];
  __shared__ float w_l[kAttnWarps][kMaxGroups];
  __shared__ float w_acc[kAttnWarps][kMaxGroups][D];

  for (int i = tid; i < (G + 2) * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int col = r < G ? (h * G + r) * D + d
                          : (r == G ? Q + h * D + d : Q + KV + h * D + d);
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) s += part[(size_t)sp * qkv_n + col];
    vecs[r][d] = s;
  }
  __syncthreads();

  for (int r = warp; r < G + 1; r += kAttnWarps) {  // QK-RMSNorm
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) ss = fmaf(vecs[r][d], vecs[r][d], ss);
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)D + eps);
    const bf16* nw = r < G ? q_norm : k_norm;
    for (int d = lane; d < D; d += 32)
      vecs[r][d] = vecs[r][d] * inv * __bfloat162float(nw[d]);
  }
  __syncthreads();

  for (int i = tid; i < (G + 1) * D2; i += blockDim.x) {  // RoPE
    const int r = i / D2, j = i % D2;
    const float x1 = vecs[r][j], x2 = vecs[r][j + D2];
    const float c = cos_row[j], s = sin_row[j];
    vecs[r][j] = x1 * c - x2 * s;
    vecs[r][j + D2] = x2 * c + x1 * s;
  }
  __syncthreads();

  bf16* kh = k_cache + (size_t)h * S * D;
  bf16* vh = v_cache + (size_t)h * S * D;
  for (int d = tid; d < D; d += blockDim.x) {
    kh[(size_t)pos * D + d] = __float2bfloat16(vecs[G][d]);
    vh[(size_t)pos * D + d] = __float2bfloat16(vecs[G + 1][d]);
  }
  for (int g = warp; g < G; g += kAttnWarps) {  // in-flight column's score
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(vecs[g][d], vecs[G][d], s);
    s = warp_sum(s);
    if (lane == 0) s_new[g] = s * scale;
  }

  // Each warp walks rows t = warp, warp + 8, ...; lane owns dims 4l..4l+3.
  float q[kMaxGroups][4], m[kMaxGroups], l[kMaxGroups], acc[kMaxGroups][4];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q[g][e] = g < G ? vecs[g][lane * 4 + e] : 0.f;
      acc[g][e] = 0.f;
    }
  }
  for (int t = warp; t < pos; t += kAttnWarps) {
    const uint2 kr = *reinterpret_cast<const uint2*>(kh + (size_t)t * D + lane * 4);
    const uint2 vr = *reinterpret_cast<const uint2*>(vh + (size_t)t * D + lane * 4);
    const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kr.x));
    const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kr.y));
    const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vr.x));
    const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vr.y));
    const float kv[4] = {k01.x, k01.y, k23.x, k23.y};
    const float vv[4] = {v01.x, v01.y, v23.x, v23.y};
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= G) break;
      float s = q[g][0] * kv[0];
      s = fmaf(q[g][1], kv[1], s);
      s = fmaf(q[g][2], kv[2], s);
      s = fmaf(q[g][3], kv[3], s);
      s = warp_sum(s) * scale;
      const float m_new = fmaxf(m[g], s);
      const float corr = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = acc[g][e] * corr + p * vv[e];
      m[g] = m_new;
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      w_m[warp][g] = m[g];
      w_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) w_acc[warp][g][lane * 4 + e] = acc[g][e];
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += blockDim.x) {  // merge warps + column
    const int g = i / D, d = i % D;
    float mx = s_new[g];
    for (int w = 0; w < kAttnWarps; ++w) mx = fmaxf(mx, w_m[w][g]);
    const float p_new = expf(s_new[g] - mx);
    float den = p_new;
    float num = p_new * vecs[G + 1][d];
    for (int w = 0; w < kAttnWarps; ++w) {
      const float c = expf(w_m[w][g] - mx);  // 0 for a warp that saw no row
      den += w_l[w][g] * c;
      num += w_acc[w][g][d] * c;
    }
    attn_out[(size_t)(h * G + g) * D + d] = __float2bfloat16(num / den);
  }
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

int launch_gemv(const bf16* x, const bf16* W, float* part, int K, int N,
                cudaStream_t st) {
  const int s = choose_split(K, N);
  const int rows = (K + s - 1) / s;
  gemv_bf16<<<dim3(N / kGemvCols, s), kGemvThreads, 0, st>>>(x, W, part, K, N, rows);
  return s;
}

// Layer-stacked bf16 weights of one decoder ([L, in, out] matrices, [L, H]
// and [L, D] norms); lm_head may be null (no head).
struct StepWeights {
  const bf16* input_norm;
  const bf16* wqkv;
  const bf16* q_norm;
  const bf16* k_norm;
  const bf16* wo;
  const bf16* post_norm;
  const bf16* w_gate_up;
  const bf16* w_down;
  const bf16* final_norm;
  const bf16* lm_head;
};

struct StepDims {
  int L, H, I, HQ, KVH, D, S, V;
  float eps;
};

// True when the kernels take these widths and `pos` is a cache row.
bool dims_ok(const StepDims& d, int pos) {
  const int Q = d.HQ * d.D, QKV = Q + 2 * d.KVH * d.D;
  return d.D == kHeadDim && d.KVH > 0 && d.HQ % d.KVH == 0 &&
         d.HQ / d.KVH <= kMaxGroups && d.H % kGemvCols == 0 &&
         QKV % kGemvCols == 0 && (2 * d.I) % kGemvCols == 0 &&
         d.V % kGemvCols == 0 && pos >= 0 && pos < d.S && d.L > 0;
}

// Enqueue one token through all L layers at cache row `pos`, from the f32
// residual input x_in [H] and the f32 cos/sin row [D/2]: writes the new
// K/V column into the caches, normed [H] f32 and, when w.lm_head is set,
// logits [V] f32. Returns 0 or the first CUDA error.
int enqueue_step(const StepWeights& w, const StepDims& d, const float* x_in,
                 const float* cos_row, const float* sin_row, bf16* kc, bf16* vc,
                 float* normed, float* logits, const Workspace& ws, int pos,
                 cudaStream_t st) {
  const int L = d.L, H = d.H, I = d.I, HQ = d.HQ, KVH = d.KVH, D = d.D, S = d.S;
  const int Q = HQ * D, KV = KVH * D, QKV = Q + 2 * KV;
  cudaError_t err;
  int prev_split = 0;  // layer 0 starts from x_in, no partials
  for (int li = 0; li < L; ++li) {
    residual_rmsnorm<<<1, kNormThreads, 0, st>>>(
        x_in, prev_split ? ws.part : nullptr, prev_split, ws.x,
        w.input_norm + (size_t)li * H, ws.xb, nullptr, H, d.eps);
    const int s_qkv = launch_gemv(ws.xb, w.wqkv + (size_t)li * H * QKV, ws.part, H, QKV, st);
    attention_step<<<KVH, kAttnThreads, 0, st>>>(
        ws.part, s_qkv, QKV, w.q_norm + (size_t)li * D, w.k_norm + (size_t)li * D,
        cos_row, sin_row, kc + (size_t)li * KVH * S * D, vc + (size_t)li * KVH * S * D,
        ws.attn, HQ, KVH, S, pos, d.eps);
    const int s_o = launch_gemv(ws.attn, w.wo + (size_t)li * Q * H, ws.part, Q, H, st);
    residual_rmsnorm<<<1, kNormThreads, 0, st>>>(
        ws.x, ws.part, s_o, ws.x, w.post_norm + (size_t)li * H, ws.xb, nullptr, H, d.eps);
    const int s_gu = launch_gemv(ws.xb, w.w_gate_up + (size_t)li * H * 2 * I, ws.part, H,
                                 2 * I, st);
    swiglu<<<(I + 255) / 256, 256, 0, st>>>(ws.part, s_gu, I, ws.act);
    prev_split = launch_gemv(ws.act, w.w_down + (size_t)li * I * H, ws.part, I, H, st);
    x_in = ws.x;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  residual_rmsnorm<<<1, kNormThreads, 0, st>>>(
      ws.x, ws.part, prev_split, ws.x, w.final_norm, ws.xb, normed, H, d.eps);
  if (w.lm_head != nullptr) {
    const int s_h = launch_gemv(ws.xb, w.lm_head, ws.part, H, d.V, st);
    sum_splits<<<(d.V + 255) / 256, 256, 0, st>>>(ws.part, s_h, d.V, logits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

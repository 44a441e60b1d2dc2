// The decode-attention core shared by the standalone decode-attention
// kernel (attention.cu) and the attention stage of the decode step
// (decode_layer.cuh), for sm_90a.
//
// Function: one kv head h's GQA attention of its G q heads (G <= 8,
// D = 128) over the cache rows [0, pos) of one layer, bf16 or int8 (an int8
// row's f32 scale multiplies its score and its probability's weight on V),
// plus the in-flight token's f32 K/V column, merged last. out[g][d] =
// sum_t p[g][t] v[t][d] / sum_t p[g][t] with p = exp((q[g] . k[t]) / sqrt(D)
// - max), all in f32.
//
// What bounds it on an H100: the bytes of the prefix, pos x 256 B a kv head
// and K or V for bf16 (pos x 132 B for int8 with its scale), and then the
// instructions that each of those bytes costs. G = 2 (the talker and the
// code predictor) is ~2 FLOP a byte, two orders of magnitude below the
// card's ridge point (~295 FLOP a byte in bf16), so the products run on the
// CUDA cores in f32, as the rounding points of the decode step ask (q, k
// and v stay f32; the cache is bf16 or int8): a wgmma tile has 64 rows of
// which G = 2 would be used, and q and p would have to be rounded to bf16
// (or split into several bf16 terms) to enter it. The price is issue rate:
// a 64-row tile costs each of a block's 8 warps ~400 instructions (2 FMA
// and one conversion a value, the shuffles of the reductions), which 8
// warps an SM issue in ~1 us (tools/attention_variants.py, PERF.md), so at
// long prefixes the core is bound by instruction issue at ~2-3 TB/s rather
// than by the 3.35 TB/s of memory.
//
// Design, for a card of 132 SMs:
//  - Fill the card: the prefix is cut into 64-row tiles, and a kv head's
//    tiles into contiguous ranges, one per block of a thread-block cluster
//    of nb blocks, one cluster per kv head (grid KVH x nb, cluster nb; the
//    standalone kernel: one per slot and kv head). In the standalone kernel
//    nb is fixed by the cache's length, one block per tile of it up to
//    kAttnMaxBlocks (16: 8 x 16 = 128 blocks on 132 SMs; a cluster above 8
//    blocks is non-portable and is allowed on the kernel; 16 beat 8 from
//    position ~8191 and tied below), and each block reads the position
//    from device memory and takes its share of the prefix's tiles (ranks
//    past the prefix take none); in the decode step nb follows the
//    position. A cache of up to 64 rows (the code predictor's) is one
//    block a kv head, launched without the cluster attribute (an implicit
//    cluster of one).
//  - Keep bytes in flight: one thread streams the block's tiles through a
//    ring of kAttnStages shared-memory stages with TMA bulk copies (a
//    tile's K rows and V rows are two contiguous ranges, so two copies, plus
//    two for int8 row scales), each stage's copies reported to its own
//    mbarrier. The first copies start before the caller prepares q
//    (attn_start), so the prefix streams in under the decode step's
//    QK-norm and RoPE. Only rows below pos are copied; a stage's rows past
//    pos keep stale bytes, which the core masks and never multiplies.
//  - No block barrier in the softmax: warp w owns rows 4w..4w+3 and
//    32+4w..32+4w+3 of every tile (so a short prefix, as the code
//    predictor's, spreads over the warps). It scores them 4 at a time (8
//    lanes a row, each holding 16 dims: two 16-byte runs, so 8 neighbouring
//    lanes read 128 contiguous bytes of shared memory without bank
//    conflicts; q stays in registers for the whole prefix), takes their max
//    and sum with two shuffles, rescales its own running (m, l, acc) once a
//    tile, and adds p x V with lane l owning dims [4l, 4l+4). One
//    __syncthreads a tile frees the stage for refill; the warps' partials
//    are merged in warp order at the end, and a kv head of one block
//    finishes there, without the cluster's merge.
//  - Merge in the cluster, in a fixed order: each block leaves (m, l,
//    acc[G][D]) in its shared memory; after cluster.sync() rank 0 reads the
//    other blocks' partials through distributed shared memory in rank
//    order, adds the in-flight column last and divides; a second
//    cluster.sync() keeps the partials alive until it is done. No second
//    launch, no workspace, no atomics: the same bits on every run. The
//    decode step's persistent kernel, whose kv heads' blocks are not
//    clusters, merges the same way through device memory instead: each
//    block stores its partials (rank 0 also the in-flight column) and
//    counts itself in with an integer atomic, and each block of the next
//    stage that needs the head's output waits for the count and merges the
//    partials itself (merge_global), in rank order: one hop through L2
//    instead of a merging block's two.
//
// Replaces the earlier designs: a standalone kernel of two launches (256-row
// chunk blocks writing partials to a workspace, then a merge), and a decode
// step attention stage of one block per kv head walking the prefix a row
// per warp behind a dependent online-softmax chain.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

namespace cg = cooperative_groups;

constexpr int kAttnD = 128;          // head dim
constexpr int kAttnMaxG = 8;         // q heads per kv head
// Ring depth, block size and the most blocks a kv head gets;
// tools/attention_variants.py builds other values to compare them on the
// card.
#ifndef QTTS_ATTN_STAGES
#define QTTS_ATTN_STAGES 3
#endif
#ifndef QTTS_ATTN_THREADS
#define QTTS_ATTN_THREADS 256
#endif
#ifndef QTTS_ATTN_MAX_BLOCKS
#define QTTS_ATTN_MAX_BLOCKS 16
#endif
constexpr int kAttnTile = 64;                  // cache rows per tile
constexpr int kAttnStages = QTTS_ATTN_STAGES;  // tiles in the shared-memory ring
constexpr int kAttnThreads = QTTS_ATTN_THREADS;  // 256 or 512
constexpr int kAttnMaxCluster = 16;              // the hardware's most (non-portable)
constexpr int kAttnMaxBlocks = QTTS_ATTN_MAX_BLOCKS;
static_assert(kAttnMaxBlocks >= 1 && kAttnMaxBlocks <= kAttnMaxCluster,
              "1 to 16 blocks a kv head");
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kAttnRowLanes = 8;                        // lanes sharing a row when scoring
constexpr int kAttnPassRows = 32 / kAttnRowLanes;       // 4 rows a warp scores at once
constexpr int kAttnPassStride = kAttnWarps * kAttnPassRows;  // rows the warps score at once
constexpr int kAttnPasses = kAttnTile / kAttnPassStride;

// Static shared memory of an attention block. vecs holds q_0..q_{G-1}, the
// in-flight k and v (f32); part_* are the block's partials that rank 0
// reads through distributed shared memory.
struct __align__(16) AttnShared {
  uint64_t bar[kAttnStages];  // the ring's mbarriers, one a stage
  float vecs[kAttnMaxG + 2][kAttnD];
  float s_new[kAttnMaxG];
  float warp_w[kAttnWarps][kAttnMaxG];  // the warps' maxima, then weights
  float warp_l[kAttnWarps][kAttnMaxG];
  float part_m[kAttnMaxG];
  float part_l[kAttnMaxG];
  float part_acc[kAttnMaxG][kAttnD];
  float blk_w[kAttnMaxCluster][kAttnMaxG];  // rank 0: block maxima, then weights
  float blk_l[kAttnMaxCluster][kAttnMaxG];
  float col_p[kAttnMaxG];
  float den[kAttnMaxG];
};

// The partials of one kv head's blocks in device memory, for a merge
// through global memory (the decode step's attention stage, whose blocks
// are not one cluster): m, l [nb][G], acc [nb][G][D], the in-flight
// column's scores col_s [G] and values col_v [D], and the count of block
// partials written, which only grows.
struct AttnGlobal {
  float* m;
  float* l;
  float* acc;
  float* col_s;
  float* col_v;
  unsigned* count;
};

template <typename CacheT>
__host__ __device__ constexpr int attn_stage_bytes() {
  return 2 * kAttnTile * kAttnD * (int)sizeof(CacheT) +
         (sizeof(CacheT) == 1 ? 2 * kAttnTile * (int)sizeof(float) : 0);
}

template <typename CacheT>
__host__ __device__ constexpr int attn_dyn_smem() {
  return kAttnStages * attn_stage_bytes<CacheT>();
}

static_assert(kAttnPasses >= 1 && kAttnTile % kAttnPassStride == 0,
              "a tile is whole scoring passes");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// The barrier's phase completes when `bytes` of bulk copies have landed.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, reported to `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Cache values from shared memory as floats. A bf16 pair's low half is
// its bits shifted up, the high half its bits masked (one instruction a
// value). An int8 value v is read as the float 2^23 + (v + 128) by one byte
// permute into 0x4B000000 and then offset back by one subtraction, at the
// FMA rate (I2F runs at a quarter of it on sm_90).
__device__ __forceinline__ void bf16x2_to_float(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  constexpr float kBias = 8388608.f + 128.f;
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) - kBias;
}

// Eight values: 16 bytes of bf16 or 8 bytes of int8.
__device__ __forceinline__ void attn_load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  bf16x2_to_float(u.x, f);
  bf16x2_to_float(u.y, f + 2);
  bf16x2_to_float(u.z, f + 4);
  bf16x2_to_float(u.w, f + 6);
}

__device__ __forceinline__ void attn_load8(const int8_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  int8x4_to_float(u.x, f);
  int8x4_to_float(u.y, f + 4);
}

// Four values: 8 bytes of bf16 or 4 bytes of int8.
__device__ __forceinline__ void attn_load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  bf16x2_to_float(u.x, f);
  bf16x2_to_float(u.y, f + 2);
}

__device__ __forceinline__ void attn_load4(const int8_t* p, float* f) {
  int8x4_to_float(*reinterpret_cast<const uint32_t*>(p), f);
}

__device__ __forceinline__ void attn_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void attn_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One thread: copy tile `tile` (its rows below pos) of one kv head into
// stage `st` with TMA bulk copies reported to `bar`: the K rows, the V rows
// and, for an int8 cache, their scales (rounded up to 4 rows, 16 bytes: the
// cache length is a multiple of 8). Rows of the stage at or past pos keep
// what they held; the core masks them.
template <typename CacheT>
__device__ __forceinline__ void attn_load_tile(char* st, uint64_t* bar, const CacheT* kh,
                                               const CacheT* vh, const float* ksh,
                                               const float* vsh, int tile, int pos) {
  constexpr int kRowBytes = kAttnD * (int)sizeof(CacheT);
  constexpr int kTileBytes = kAttnTile * kRowBytes;
  const int t0 = tile * kAttnTile, rows = min(kAttnTile, pos - t0);
  const unsigned bytes = rows * kRowBytes;
  const unsigned sbytes = sizeof(CacheT) == 1 ? (rows + 3) / 4 * 16 : 0;
  mbar_expect_tx(bar, 2 * bytes + 2 * sbytes);
  bulk_copy(st, kh + (size_t)t0 * kAttnD, bytes, bar);
  bulk_copy(st + kTileBytes, vh + (size_t)t0 * kAttnD, bytes, bar);
  if constexpr (sizeof(CacheT) == 1) {
    bulk_copy(st + 2 * kTileBytes, ksh + t0, sbytes, bar);
    bulk_copy(st + 2 * kTileBytes + kAttnTile * sizeof(float), vsh + t0, sbytes, bar);
  }
}

// The 64-row tiles of the prefix that block `rank` of a kv head takes:
// [*b0, *b0 + *n).
__device__ __forceinline__ void attn_tiles(int pos, int tpb, int rank, int* b0, int* n) {
  const int nt = (pos + kAttnTile - 1) / kAttnTile;
  *b0 = min(nt, rank * tpb);
  *n = min(nt, *b0 + tpb) - *b0;
}

// The first half of the core, to call first thing in the kernel: thread 0
// initialises the ring's barriers and starts the copies of the block's
// first kAttnStages tiles, so that they land while the caller prepares q
// (the rows read are [0, pos), which nothing in the launch writes). The
// caller then passes a __syncthreads() before attend_cluster.
template <typename CacheT>
__device__ __forceinline__ void attn_start(AttnShared& sh, char* stages, const CacheT* kh,
                                           const CacheT* vh, const float* ksh,
                                           const float* vsh, int pos, int tpb, int rank) {
  if (threadIdx.x != 0) return;
  int b0, n;
  attn_tiles(pos, tpb, rank, &b0, &n);
#pragma unroll
  for (int i = 0; i < kAttnStages; ++i) mbar_init(&sh.bar[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = 0; i < kAttnStages && i < n; ++i)
    attn_load_tile(stages + i * attn_stage_bytes<CacheT>(), &sh.bar[i], kh, vh, ksh, vsh,
                   b0 + i, pos);
}

// Rank 0's merge of a kv head's nb block partials (max m, sum l and the
// p x V sums acc of each of its G q heads, read through the loaders), in
// rank order, then the in-flight column (its score s_new and v in
// sh.vecs[G + 1]); writes out[g * D + d].
template <typename LoadM, typename LoadL, typename LoadAcc, typename OutT>
__device__ __forceinline__ void merge_blocks(AttnShared& sh, int nb, int G, const LoadM& load_m,
                                             const LoadL& load_l, const LoadAcc& load_acc,
                                             OutT* __restrict__ out) {
  constexpr int D = kAttnD;
  const int tid = threadIdx.x;
  for (int i = tid; i < nb * G; i += kAttnThreads) {  // every block's (m, l)
    const int b = i / G, g = i % G;
    sh.blk_w[b][g] = load_m(b, g);
    sh.blk_l[b][g] = load_l(b, g);
  }
  __syncthreads();
  if (tid < G) {  // q head g's block weights, the column's and the sum
    const int g = tid;
    float mx = sh.s_new[g];
    for (int b = 0; b < nb; ++b) mx = fmaxf(mx, sh.blk_w[b][g]);
    float den = 0.f;
    for (int b = 0; b < nb; ++b) {
      const float w = expf(sh.blk_w[b][g] - mx);  // 0 for a block with no rows
      sh.blk_w[b][g] = w;
      den = fmaf(sh.blk_l[b][g], w, den);
    }
    const float p_new = expf(sh.s_new[g] - mx);
    sh.col_p[g] = p_new;
    sh.den[g] = den + p_new;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kAttnThreads) {
    const int g = i / D, d = i % D;
    float a[kAttnMaxCluster];  // every block's loads in flight at once
#pragma unroll
    for (int b = 0; b < kAttnMaxCluster; ++b) a[b] = b < nb ? load_acc(b, i) : 0.f;
    float num = 0.f;
#pragma unroll
    for (int b = 0; b < kAttnMaxCluster; ++b)
      if (b < nb) num = fmaf(a[b], sh.blk_w[b][g], num);
    num = fmaf(sh.col_p[g], sh.vecs[G + 1][d], num);
    attn_store(out + i, num / sh.den[g]);
  }
}

// The merge of merge_blocks from device memory: kv head gm's nb block
// partials and its in-flight column, which the head's blocks have all
// written (the caller waited for their count), with every load in flight
// at once; writes out[g * D + d] rounded to bf16, as f32. The same
// arithmetic as merge_blocks. Every thread of the block calls it.
__device__ __forceinline__ void merge_global(AttnShared& sh, int nb, int G, const AttnGlobal& gm,
                                             float* out) {
  constexpr int D = kAttnD;
  const int tid = threadIdx.x;
  float a[kAttnMaxCluster];  // this thread's first output's block sums
#pragma unroll
  for (int b = 0; b < kAttnMaxCluster; ++b)
    a[b] = b < nb && tid < G * D ? __ldcg(gm.acc + b * G * D + tid) : 0.f;
  for (int i = tid; i < nb * G; i += kAttnThreads) {
    sh.blk_w[i / G][i % G] = __ldcg(gm.m + i);
    sh.blk_l[i / G][i % G] = __ldcg(gm.l + i);
  }
  if (tid < G) sh.s_new[tid] = __ldcg(gm.col_s + tid);
  for (int d = tid; d < D; d += kAttnThreads) sh.vecs[G + 1][d] = __ldcg(gm.col_v + d);
  __syncthreads();
  if (tid < G) {  // q head g's block weights, the column's and the sum
    const int g = tid;
    float mx = sh.s_new[g];
    for (int b = 0; b < nb; ++b) mx = fmaxf(mx, sh.blk_w[b][g]);
    float den = 0.f;
    for (int b = 0; b < nb; ++b) {
      const float w = expf(sh.blk_w[b][g] - mx);  // 0 for a block with no rows
      sh.blk_w[b][g] = w;
      den = fmaf(sh.blk_l[b][g], w, den);
    }
    const float p_new = expf(sh.s_new[g] - mx);
    sh.col_p[g] = p_new;
    sh.den[g] = den + p_new;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kAttnThreads) {
    const int g = i / D, d = i % D;
    if (i != tid) {
#pragma unroll
      for (int b = 0; b < kAttnMaxCluster; ++b) a[b] = b < nb ? __ldcg(gm.acc + b * G * D + i) : 0.f;
    }
    float num = 0.f;
#pragma unroll
    for (int b = 0; b < kAttnMaxCluster; ++b)
      if (b < nb) num = fmaf(a[b], sh.blk_w[b][g], num);
    num = fmaf(sh.col_p[g], sh.vecs[G + 1][d], num);
    out[i] = __bfloat162float(__float2bfloat16(num / sh.den[g]));
  }
}

// The core. On entry attn_start has run, sh.vecs holds q_0..q_{G-1},
// k_new, v_new of kv head h (f32) and every thread of the block has passed
// a __syncthreads() since both. kh / vh are kv head h's cache rows [S, D] of this
// layer, ksh / vsh its row scales [S] (int8 cache) or null. The block is
// rank `rank` of the nb blocks of its kv head, a cluster (gm null) or any
// nb blocks of the grid that merge through device memory (gm set: the
// head's AttnGlobal); it takes the 64-row tiles [rank * tpb, (rank + 1) *
// tpb) of the prefix. Rank 0 writes out[g * D + d] for the G q heads and
// returns true (the others false); with gm, every block stores its
// partials there and counts itself in, and none writes out (the readers
// merge with merge_global). KG is G when G is 1 or 2 (the talker's and the
// code predictor's), known at compile time, and 8 for any other G (q and
// the p x V sums live in registers, KG of each). Every thread of every
// block of the cluster must call it.
template <typename CacheT, int KG, typename OutT>
__device__ bool attend_cluster(AttnShared& sh, char* stages, const CacheT* __restrict__ kh,
                               const CacheT* __restrict__ vh, const float* __restrict__ ksh,
                               const float* __restrict__ vsh, int g_in, int pos, int tpb,
                               OutT* __restrict__ out, int rank, int nb,
                               const AttnGlobal* gm = nullptr) {
  constexpr bool kKv8 = sizeof(CacheT) == 1;
  constexpr int D = kAttnD;
  constexpr int kTileBytes = kAttnTile * D * (int)sizeof(CacheT);
  constexpr int kStageBytes = attn_stage_bytes<CacheT>();
  static_assert(kAttnWarps * KG * D * (int)sizeof(float) <= kAttnStages * kStageBytes,
                "after the tile loop the ring holds the warps' p x V sums");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float scale = rsqrtf((float)D);
  const int G = KG <= 2 ? KG : g_in;

  if (rank == 0 && warp < G) {  // the in-flight column's score
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(sh.vecs[warp][d], sh.vecs[G][d], s);
    s = warp_sum(s);
    if (lane == 0) sh.s_new[warp] = s * scale;
  }

  int b0, n;
  attn_tiles(pos, tpb, rank, &b0, &n);

  // Warp w takes rows 4w..4w+3 and 32+4w..32+4w+3 of every tile (so that a
  // short prefix spreads over the warps): it scores them in two passes of
  // 4 rows (8 lanes a row, lane dl holding dims [dl*8, dl*8+8) and
  // [64+dl*8, 64+dl*8+8), whose q values stay in registers for the whole
  // prefix), skipping a pass with no row below pos, keeps its own running
  // max and sum per q head, and adds p x V with lane l owning dims
  // [4l, 4l+4). One block barrier a tile, before its stage is refilled;
  // the warps' partials are merged at the end.
  const int rl = lane / kAttnRowLanes, dl = lane % kAttnRowLanes;
  float qr[KG][16];
#pragma unroll
  for (int g = 0; g < KG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[g][e] = g < G ? sh.vecs[g][dl * 8 + e] : 0.f;
      qr[g][8 + e] = g < G ? sh.vecs[g][D / 2 + dl * 8 + e] : 0.f;
    }
  float m[KG], l[KG], acc[KG][4];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    mbar_wait(&sh.bar[i % kAttnStages], (i / kAttnStages) & 1);  // tile i landed
    const char* st = stages + (i % kAttnStages) * kStageBytes;
    const CacheT* kt = reinterpret_cast<const CacheT*>(st);
    const CacheT* vt = reinterpret_cast<const CacheT*>(st + kTileBytes);
    const float* kst = reinterpret_cast<const float*>(st + 2 * kTileBytes);
    const float* vst = kst + kAttnTile;
    const int t0 = (b0 + i) * kAttnTile, r0 = warp * kAttnPassRows;

    float s[kAttnPasses][KG];  // row r0 + pass*32 + rl, every lane of the row
#pragma unroll
    for (int pass = 0; pass < kAttnPasses; ++pass) {
      const int r = r0 + pass * kAttnPassStride + rl;
      if (t0 + r0 + pass * kAttnPassStride >= pos) {  // none of the pass's rows
#pragma unroll
        for (int g = 0; g < KG; ++g) s[pass][g] = -INFINITY;
        continue;
      }
      float kf[16];
      attn_load8(kt + r * D + dl * 8, kf);
      attn_load8(kt + r * D + D / 2 + dl * 8, kf + 8);
      const float rs = (kKv8 ? kst[r] : 1.f) * scale;
      const bool ok = t0 + r < pos;
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        float a = qr[g][0] * kf[0], b = qr[g][1] * kf[1];  // two chains
#pragma unroll
        for (int e = 2; e < 16; e += 2) {
          a = fmaf(qr[g][e], kf[e], a);
          b = fmaf(qr[g][e + 1], kf[e + 1], b);
        }
        a += b;
#pragma unroll
        for (int o = kAttnRowLanes / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        s[pass][g] = ok ? a * rs : -INFINITY;
      }
    }

    float p[kAttnPasses][KG];
#pragma unroll
    for (int g = 0; g < KG; ++g) {  // the warp's 8 rows: max, rescale, sum
      if (g < G) {
        float t = s[0][g];
#pragma unroll
        for (int pass = 1; pass < kAttnPasses; ++pass) t = fmaxf(t, s[pass][g]);
#pragma unroll
        for (int o = kAttnRowLanes; o < 32; o <<= 1)
          t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
        const float m_new = fmaxf(m[g], t);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no row of this warp yet
        const float corr = expf(m[g] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int pass = 0; pass < kAttnPasses; ++pass) {
          const int r = r0 + pass * kAttnPassStride + rl;
          p[pass][g] = expf(s[pass][g] - m_use);  // 0 past pos
          sum += p[pass][g];
          if (kKv8) p[pass][g] = t0 + r < pos ? p[pass][g] * vst[r] : 0.f;
        }
#pragma unroll
        for (int o = kAttnRowLanes; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[g] = fmaf(l[g], corr, sum);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] *= corr;
      }
    }

#pragma unroll
    for (int pass = 0; pass < kAttnPasses; ++pass) {  // p x V
#pragma unroll
      for (int k = 0; k < kAttnPassRows; ++k) {
        const int r = r0 + pass * kAttnPassStride + k;
        if (t0 + r >= pos) break;  // the stage's rows past pos hold stale bytes
        float vf[4];
        attn_load4(vt + r * D + lane * 4, vf);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
            const float pk = __shfl_sync(0xffffffffu, p[pass][g], k * kAttnRowLanes);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pk, vf[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with tile i's stage
    if (tid == 0 && i + kAttnStages < n)
      attn_load_tile(stages + (i % kAttnStages) * kStageBytes, &sh.bar[i % kAttnStages], kh,
                     vh, ksh, vsh, b0 + i + kAttnStages, pos);
  }
  // Every tile issued has landed and been read: the ring takes the warps' sums.

  float* red = reinterpret_cast<float*>(stages);  // [kAttnWarps][G][D]
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(warp * G + g) * D + lane * 4 + e] = acc[g][e];
      if (lane == 0) {
        sh.warp_w[warp][g] = m[g];
        sh.warp_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  if (nb == 1 && gm == nullptr) {  // one block a kv head: finish here, the column last
    if (tid < G) {
      const int g = tid;
      float mx = sh.s_new[g];
      for (int w = 0; w < kAttnWarps; ++w) mx = fmaxf(mx, sh.warp_w[w][g]);
      float den = 0.f;
      for (int w = 0; w < kAttnWarps; ++w) {
        const float wt = expf(sh.warp_w[w][g] - mx);  // 0 for a warp with no rows
        sh.warp_w[w][g] = wt;
        den = fmaf(sh.warp_l[w][g], wt, den);
      }
      const float p_new = expf(sh.s_new[g] - mx);
      sh.col_p[g] = p_new;
      sh.den[g] = den + p_new;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kAttnThreads) {
      const int g = i / D;
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < kAttnWarps; ++w) num = fmaf(red[w * G * D + i], sh.warp_w[w][g], num);
      num = fmaf(sh.col_p[g], sh.vecs[G + 1][i % D], num);
      attn_store(out + i, num / sh.den[g]);
    }
    return true;
  }
  if (tid < G) {  // the block's max and sum of q head g, and each warp's weight
    const int g = tid;
    float mx = -INFINITY;
    for (int w = 0; w < kAttnWarps; ++w) mx = fmaxf(mx, sh.warp_w[w][g]);
    const float m_use = mx == -INFINITY ? 0.f : mx;  // a block with no rows
    float sum = 0.f;
    for (int w = 0; w < kAttnWarps; ++w) {
      const float wt = expf(sh.warp_w[w][g] - m_use);
      sh.warp_w[w][g] = wt;
      sum = fmaf(sh.warp_l[w][g], wt, sum);
    }
    sh.part_m[g] = mx;
    sh.part_l[g] = sum;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kAttnThreads) {
    const int g = i / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) a = fmaf(red[w * G * D + i], sh.warp_w[w][g], a);
    if (gm != nullptr)
      gm->acc[rank * G * D + i] = a;
    else
      sh.part_acc[g][i % D] = a;
  }
  if (gm != nullptr) {  // through device memory: the readers merge
    if (tid < G) {
      gm->m[rank * G + tid] = sh.part_m[tid];
      gm->l[rank * G + tid] = sh.part_l[tid];
    }
    if (rank == 0) {
      if (tid < G) gm->col_s[tid] = sh.s_new[tid];
      for (int d = tid; d < D; d += kAttnThreads) gm->col_v[d] = sh.vecs[G + 1][d];
    }
    __syncthreads();  // the block's stores, then thread 0's release
    if (tid == 0)
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(gm->count) : "memory");
    return false;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0)
    merge_blocks(
        sh, nb, G, [&](int b, int g) { return cluster.map_shared_rank(sh.part_m, b)[g]; },
        [&](int b, int g) { return cluster.map_shared_rank(sh.part_l, b)[g]; },
        [&](int b, int i) { return cluster.map_shared_rank(&sh.part_acc[0][0], b)[i]; }, out);
  cluster.sync();  // the partials stay in shared memory until rank 0 has read them
  return rank == 0;
}

// Blocks a kv head gets in a launch over a cache of S rows: one per 64-row
// tile of S, at most kAttnMaxBlocks. It depends on the cache's length, not
// on a position, so a launch's grid is the same at every step.
int attn_blocks_for_cache(int S) {
  const int nt = (S + kAttnTile - 1) / kAttnTile;
  return nt < 1 ? 1 : (nt < kAttnMaxBlocks ? nt : kAttnMaxBlocks);
}

// The 64-row tiles each of a kv head's nb blocks takes at a prefix of pos
// rows (0 when the prefix is empty): as few blocks as take the tiles evenly,
// the ranks past them take none and leave an empty partial (m = -inf,
// l = 0) to the merge.
__device__ __forceinline__ int attn_tiles_per_block(int pos, int nb) {
  const int nt = (pos + kAttnTile - 1) / kAttnTile;
  const int used = nt < nb ? nt : nb;
  return nt > 0 ? (nt + used - 1) / used : 0;
}

// Shared-memory and cluster attributes of an attention kernel; call once.
cudaError_t attn_prepare(const void* kernel, int dyn_smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       dyn_smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Launch `kernel` over KVH clusters of nb blocks each; with nb == 1 a plain
// launch, whose blocks are implicit clusters of one.
template <typename... KArgs, typename... Args>
cudaError_t attn_launch(void (*kernel)(KArgs...), int KVH, int nb, int dyn_smem,
                        cudaStream_t st, Args... args) {
  if (nb == 1) {
    kernel<<<KVH, kAttnThreads, dyn_smem, st>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KVH * nb);
  cfg.blockDim = dim3(kAttnThreads);
  cfg.dynamicSmemBytes = dyn_smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// The device code of the decode step of a Qwen3 decoder, for sm_90a: one
// persistent kernel that runs a token through all L layers, the final
// RMSNorm and the LM head, and, for N-step generation, the argmax and the
// next token's embedding, N times, in one launch.
//
// Shared by decode_step.cu (which instantiates and launches the kernel:
// qtts_decode_step, one step a call) and generate.cu (qtts_generate, N
// greedy steps a call), so the two compute bit-identical steps. It computes
// what the Pallas TPU kernel qwen_tts_tpu/ops/decode_step.py::_megakernel
// computes, with the same bf16 rounding points: the residual stream stays
// f32 and is rounded to bf16 only where it enters a matrix product (normed
// input before QKV, attention output before O-proj, post-norm before
// gate|up, SwiGLU output before down, final norm before the head). q, k and
// v stay f32 through QK-RMSNorm and RoPE; only the cache stores bf16 (or
// int8), and the in-flight token joins the attention as an f32 column.
//
// Weight forms, per matrix (QttsMat::form; the Pallas kernel's
// make_mms().mm_scaled, decode_step.py:45-95, picks them by shape the same
// way, which is how the mixed int8-attention/int4-MLP tier runs):
//   bf16  bf16 x bf16, f32 sums;
//   int8  int8 [K, N] with f32 scales [ng, N]; ng == 1 scales the column's
//         summed product (per output channel, also the int8 LM head's
//         [1, V]); ng > 1 (groups of 128 rows) scales each group's partial
//         product;
//   int4  int4-g128 nibble-packed in the halves layout, byte row r of
//         [K/2, N] holding input row r (low nibble) and row r + K/2 (high
//         nibble); low half takes scale rows [0, ng/2), the high half
//         [ng/2, ng).
// The weights are upcast in registers (an int8 or int4 value times a bf16
// activation is exact in f32); nothing writes a dequantized matrix. An
// int8 KV cache (QttsDecoder::k_scale set) stores each new head row as
// rint(row / s), s = max(absmax, 1e-8) / 127 from the f32 row, and applies
// the per-row scales on the score and probability side, as the Pallas
// kernel does (decode_step.py:259-315).
//
// What bounds a step on an H100: weight bytes. One bf16 talker step reads
// ~0.887 GB of layer weights (int8 ~0.445 GB, mixed ~0.32 GB, int4 ~0.237
// GB with its group scales) and does ~2 FLOP per weight, two orders of
// magnitude below the card's ridge point: every product is a
// matrix-vector product limited by HBM bandwidth (0.265 ms a bf16 talker
// step at 3.35 TB/s). A step is a chain of ~115 dependent stages, so the
// design is about not paying a launch, a host enqueue or an idle gap for
// each of them.
//
// Design: one persistent launch a step (B2: for all N steps), one block of
// 256 threads an SM, as many blocks as the card holds at once rounded down
// to a multiple of KVH (128 on an H100 SXM: 16 a kv head), launched
// cooperatively so that a grid that could not be all resident fails to
// launch (a persistent kernel whose blocks are not all resident deadlocks
// at its first barrier). Stages are separated by a grid barrier of integer
// atomics (an arrival count in the workspace that only grows, one atomic a
// block; a spin that outlasts a second traps, so a bug fails with a CUDA
// error instead of hanging). Per layer, four stages:
//   1. norm + QKV: every block sums the previous down-proj's split-K
//      partials in a fixed order, adds the residual and takes the RMSNorm
//      of the H-vector itself (cheap, and every block gets the same bits;
//      block 0 stores the new residual), then runs its work items of the
//      QKV GEMV;
//   2. attention + O-proj: the decode-attention core of attention_core.cuh
//      on up to 16 of a kv head's blocks (as many as the prefix has 64-row
//      tiles): QK-norm, RoPE (the cos/sin row gathered from the tables at
//      the positions read from device memory), the cache row written by
//      rank 0, the prefix streamed by TMA through a ring of three 64-row
//      tiles (the first tiles' copies start at the barrier that ends stage
//      1, after the block's arrival); each block leaves its partials in
//      device memory and adds one to the head's count (an integer counter
//      that only grows). Then the O-proj, split-K a kv head's G x D rows a
//      split: a block waits for the count of the head its rows hold, not
//      for a grid barrier, and merges the head's partials in rank order
//      itself;
//   3. residual + post-norm + gate|up, with stage 1's prologue;
//   4. SwiGLU + down: each work item's row range of w_down needs only the
//      matching rows of the activation, so the block takes their SwiGLU
//      from the gate|up partials itself.
// Then the final norm and the head, and the logits summed over the head's
// splits; for generation, each block's argmax candidate, a barrier, and
// every block reduces the candidates to the same token (lowest index on a
// tie) and reads its embedding row as the next step's input.
// GEMV work items are 64-column tiles x split-K row ranges, the split
// chosen so that the items spread evenly over the grid; the grouped forms
// keep their splits on 128-row groups, one scale load a pass. Weights
// stream into shared memory through TMA across the barriers (see "Weight
// streaming" below). What other blocks wrote (partials, the residual)
// comes into shared memory with cp.async, all of a block's loads in flight
// at once. Split-K partials and the residual ping-pong between two
// buffers, so that a stage never writes what the previous one still reads;
// no float atomics: the same bits on every run.
//
// What holds it back on an H100 (stage timers of tools/profile_port.py,
// tools/grid_barrier.py, PERF.md): each stage is a chain of dependent
// latencies, the barrier (~1 us), the loads of the partials and the norm
// (~2.5-3 us), the GEMV and its reduction, at ~37 us a layer against the
// ~10 us its bytes need at 3.35 TB/s; at long prefixes the attention's
// 64-row tiles (~2 us each on a block).
//
// Coherence: data another block wrote in the same launch (partials, the
// residual, the attention partials, the token candidates, the positions) is
// read with ld.global.cg or cp.async.cg, never through the non-coherent
// path; only weights, scales and norms go through __ldg. The cache rows a
// step writes with generic stores are read by later steps' TMA copies (the
// async proxy), so each writer fences with fence.proxy.async.global before
// the grid barrier.
//
// Constraints: head_dim D = 128, at most 8 q heads per kv head, every
// matrix width (H, Q + 2*KV, 2*I, V) a multiple of 64, H, Q and I at most
// 4096, grouped scales over groups of exactly 128 rows, a cache length S
// that is a multiple of 8 (the attention core copies int8 row scales 4 at
// a time), at most 8 M-RoPE sections.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// The attention ring of the decode kernel has three stages (96 KB for a
// bf16 cache: weight region 0, which it shares, exactly), as the
// standalone decode-attention kernel (attention.cu) has: with two, each
// 64-row tile's copy from HBM outlasted the previous tile's arithmetic at
// long prefixes (PERF.md).
#define QTTS_ATTN_STAGES 3
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

constexpr int kQttsMaxSections = 8;

// What a launch computes beside the decoder. One step (qtts_decode_step):
// x_in is the f32 input row [H]; normed [H] and, with a head, logits [V]
// are written. N steps (qtts_generate): embed [*, H] bf16 and first_token
// (device int32 [1]) give step 0's input, tokens [N] int32 receive the
// argmaxes. positions (device int32 [1 + n_sec]): the cache row of the
// first step, then the first step's M-RoPE section positions (n_sec == 0:
// standard RoPE at the cache row); the launch adds num_steps to each.
// Section s of the rotary frequencies reads row positions[1 + s] + n of
// the f32 tables cos_tab / sin_tab [rope_rows, D/2] at step n: index j is
// in section s >= 1 iff (interleaved) j % n_sec == s and j < n_sec *
// sec[s], or (chunked) j >= sec[0] + ... + sec[s - 1], the last such s
// winning; else in section 0.
struct QttsStepIO {
  const float* x_in;
  const void* embed;
  const int* first_token;
  int* tokens;
  int num_steps;
  const float* cos_tab;
  const float* sin_tab;
  int* positions;
  int n_sec;
  int interleaved;
  int sec[kQttsMaxSections];
  float* normed;
  float* logits;
  void* workspace;
};

// Launches the persistent decode kernel (defined in decode_step.cu).
// Returns 0 or a CUDA error.
int qtts_run_steps(const QttsDecoder& d, const QttsStepIO& io, cudaStream_t st);

namespace {

enum : int { kFormBf16 = 0, kFormInt8 = 1, kFormInt4 = 2 };

constexpr int kThreads = kAttnThreads;  // one block an SM, 256 threads
constexpr int kGemvCols = 64;           // output columns per work item
constexpr int kGemvRows = 32;           // row lanes per pass
constexpr int kGemvUnroll = 4;          // passes whose loads are issued together
constexpr int kGroup = kGemvRows * kGemvUnroll;  // 128: one pass, one scale group
constexpr int kMaxSplit = 32;           // split-K factor bound (sizes the workspace)
constexpr int kMaxK = 4096;             // longest GEMV input (H, Q, I)
constexpr int kMaxGrid = 1024;          // most blocks a launch (sizes the candidates)
constexpr int kMaxKvHeads = 32;
static_assert(kThreads == 8 * kGemvRows, "8 threads a 64-column tile x 32 row lanes");

// Stages, for the stage timers (-DQTTS_STAGE_TIMERS).
enum : int {
  kStageQkv = 0,   // residual + input norm + QKV
  kStageAttn,      // attention + O-proj
  kStageGateUp,    // residual + post norm + gate|up
  kStageDown,      // SwiGLU + down
  kStageHead,      // final norm + LM head
  kStageLogits,    // logits (+ argmax candidates)
  kStageArgmax,    // argmax reduce + next embedding
  kNumStages
};
// Timer words: per stage the time from leaving the previous barrier to
// leaving this one (block 0), then launches and steps, then per stage
// block 0's own work (to arriving at the barrier), the slowest block's
// (its arrival, from block 0's stage start), and a scratch word per stage.
constexpr int kTimerWords = 2 + 5 * kNumStages;
constexpr int kTimerWork = kNumStages + 2, kTimerSlow = kTimerWork + kNumStages,
              kTimerScratch = kTimerSlow + kNumStages, kTimerPro = kTimerScratch + kNumStages;

// One matrix as this launch runs it: the layer stack and its split-K plan.
struct MatPlan {
  const void* w;
  const float* s;
  int form, ng, K, N;
  int ns;    // splits
  int rows;  // stored rows a split (a multiple of 128 for the grouped forms)
  int tm;    // its TMA tensor map: StepParams::tmap[tm]
};

struct Workspace {
  unsigned* bar;   // [2]: arrivals ever, and their count when the last launch ended
  float* x[2];     // residual ping-pong [H]
  float* part[2];  // split-K partials ping-pong [kMaxSplit * max_n]
  float* logits;   // [V] (generation)
  float* normed;   // [H] (generation)
  float* cand_v;   // argmax candidates, one a block
  int* cand_i;
  float* amerge_m;    // attention partials in device memory, a kv head's
  float* amerge_l;    // kAttnMaxCluster blocks: m, l [KVH][16][G],
  float* amerge_acc;  // acc [KVH][16][G][D], and the in-flight column:
  float* amerge_col;  // [KVH][kColFloats], its scores (8) then its values (D)
  unsigned* head_done;  // [KVH] block partials written, ever (never reset)
  unsigned long long* launches;  // launches of the kernel, ever (block 0 counts)
  unsigned long long* timers;  // [kTimerWords]
};

constexpr int kColFloats = 8 + kAttnD;

struct StepParams {
  // TMA tensor maps of the matrices, [L, rows, N] with a box of 64 columns x
  // one 16 KB chunk of rows (kTmQkv...)
  CUtensorMap tmap[5];
  MatPlan qkv, o, gu, down, head;  // head.w null: no head
  const bf16* input_norm;
  const bf16* q_norm;
  const bf16* k_norm;
  const bf16* post_norm;
  const bf16* final_norm;
  void* k_cache;
  void* v_cache;
  float* k_scale;
  float* v_scale;
  int L, H, I, HQ, KVH, S, V;
  float eps;
  const float* x_in;
  const bf16* embed;
  const int* first_token;
  int* tokens;
  int num_steps;
  const float* cos_tab;
  const float* sin_tab;
  int* positions;
  int n_sec, interleaved;
  int sec[kQttsMaxSections];
  float* normed;
  float* logits;
  Workspace ws;
};

size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

int max_width(int H, int I, int HQ, int KVH, int D, int V) {
  int n = HQ * D + 2 * KVH * D;
  if (H > n) n = H;
  if (2 * I > n) n = 2 * I;
  if (V > n) n = V;
  return n;
}

// The workspace: first the words that persist across launches (the grid
// barrier's, the heads' partial counts, the launch count, the stage
// timers) at offsets that no width moves, so
// that decoders of other widths sharing one workspace never write over
// them; then the scratch of one launch.
size_t workspace_bytes(int H, int I, int HQ, int KVH, int D, int V, Workspace* ws,
                       char* base) {
  const size_t max_n = max_width(H, I, HQ, KVH, D, V);
  const int grid = kMaxGrid;
  size_t off = 0;
  const size_t bar_off = off;  off += align_up(2 * sizeof(unsigned));
  const size_t hd_off = off;   off += align_up(kMaxKvHeads * sizeof(unsigned));
  const size_t ln_off = off;   off += align_up(sizeof(unsigned long long));
  const size_t tm_off = off;   off += align_up(kTimerWords * sizeof(unsigned long long));
  const size_t x_off = off;    off += 2 * align_up((size_t)H * sizeof(float));
  const size_t p_off = off;    off += 2 * align_up((size_t)kMaxSplit * max_n * sizeof(float));
  const size_t lg_off = off;   off += align_up((size_t)V * sizeof(float));
  const size_t nm_off = off;   off += align_up((size_t)H * sizeof(float));
  const size_t cv_off = off;   off += align_up((size_t)grid * sizeof(float));
  const size_t ci_off = off;   off += align_up((size_t)grid * sizeof(int));
  const size_t am = (size_t)KVH * kAttnMaxCluster * (HQ / KVH);
  const size_t mm_off = off;   off += align_up(am * sizeof(float));
  const size_t ml_off = off;   off += align_up(am * sizeof(float));
  const size_t ma_off = off;   off += align_up(am * D * sizeof(float));
  const size_t mo_off = off;   off += align_up((size_t)KVH * kColFloats * sizeof(float));
  if (ws != nullptr) {
    ws->bar = reinterpret_cast<unsigned*>(base + bar_off);
    for (int i = 0; i < 2; ++i) {
      ws->x[i] = reinterpret_cast<float*>(base + x_off + i * align_up((size_t)H * 4));
      ws->part[i] = reinterpret_cast<float*>(base + p_off + i * align_up(kMaxSplit * max_n * 4));
    }
    ws->logits = reinterpret_cast<float*>(base + lg_off);
    ws->normed = reinterpret_cast<float*>(base + nm_off);
    ws->cand_v = reinterpret_cast<float*>(base + cv_off);
    ws->cand_i = reinterpret_cast<int*>(base + ci_off);
    ws->amerge_m = reinterpret_cast<float*>(base + mm_off);
    ws->amerge_l = reinterpret_cast<float*>(base + ml_off);
    ws->amerge_acc = reinterpret_cast<float*>(base + ma_off);
    ws->amerge_col = reinterpret_cast<float*>(base + mo_off);
    ws->head_done = reinterpret_cast<unsigned*>(base + hd_off);
    ws->launches = reinterpret_cast<unsigned long long*>(base + ln_off);
    ws->timers = reinterpret_cast<unsigned long long*>(base + tm_off);
  }
  return off;
}

// Byte offset of the launch count in the workspace.
size_t launches_offset() {
  Workspace ws;
  workspace_bytes(64, 64, 1, 1, 128, 64, &ws, nullptr);
  return reinterpret_cast<size_t>(ws.launches);
}

// Byte offset of the stage timers in the workspace.
size_t timers_offset() {
  Workspace ws;
  workspace_bytes(64, 64, 1, 1, 128, 64, &ws, nullptr);
  return reinterpret_cast<size_t>(ws.timers);
}

// ── grid barrier ─────────────────────────────────────────────────────────

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Every block of the grid arrives before any leaves; the writes of every
// block before it are visible to every block after it. bar[0] counts
// arrivals, ever (a count that only grows, wrapping at 2^32); every block
// adds one and waits until the count reaches `target`, thread 0's running
// target (it starts at bar[1], the count when the last launch ended, which
// block 0 stores as the launch ends, and grows by the grid at every
// barrier). One atomic a block and no second word to flip: the waiters see
// the last arrival itself. Release on arrival, acquire on the way out, as
// CUTLASS's grid barrier does: __syncthreads orders the block's writes
// before thread 0's release, and its reads after thread 0's acquire. A
// wait longer than a second traps. In two halves, so that a block can
// start copies for the next stage between them (grid_sync_issuing).
__device__ __forceinline__ void grid_arrive(unsigned* bar, unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar) : "memory");
  }
}

__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    unsigned spins = 0;
    while ((int)(ld_acquire(bar) - target) < 0) {
      if ((++spins & 1023u) == 0 && global_ns() - t0 > 1000000000ull) __trap();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  grid_arrive(bar, target);
  grid_wait(bar, target);
}

// A grid barrier with `issue` (every thread calls it; thread 0 starts TMA
// copies for the stages ahead) between the block's arrival and its wait:
// issued before the arrival, the copies held up the release until they
// landed (PERF.md).
template <typename Issue>
__device__ __forceinline__ void grid_sync_issuing(unsigned* bar, unsigned& target, Issue issue) {
  grid_arrive(bar, target);
  issue();
  grid_wait(bar, target);
}

// Thread 0: wait until *counter reaches target (a count that only grows;
// wrap-safe), with grid_sync's bound.
__device__ __forceinline__ void wait_count(const unsigned* counter, unsigned target) {
  const unsigned long long t0 = global_ns();
  unsigned spins = 0;
  while ((int)(ld_acquire(counter) - target) < 0) {
    if ((++spins & 1023u) == 0 && global_ns() - t0 > 1000000000ull) __trap();
  }
}

// ── GEMV work items ──────────────────────────────────────────────────────

__device__ __forceinline__ void load_scales8(const float* __restrict__ p, float (&s)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

// Exact int8 / int4 -> f32 without the conversion instruction (I2F runs at
// a quarter of the FMA rate on sm_90; with one conversion per weight the
// int8 GEMVs of a talker step moved 0.99 TB/s on an H100, with this 1.05
// TB/s, PERF.md). A value v in [0, 255] placed in the low byte of
// 0x4B000000 is the float 2^23 + v, so one byte permute and one
// subtraction give it. Signed values are offset first: int8 b as b ^ 0x80
// = b + 128; an int4 nibble n as n ^ 8 = n + 8, which equals the Pallas
// kernel's sign extension ((int)b << 28) >> 28 (low nibble) and (int)b >> 4
// (high nibble) minus the offset.
__device__ __forceinline__ float biased_byte(uint32_t word, int j, float bias) {
  return __int_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | j)) - bias;
}

__device__ __forceinline__ void int8x8(const uint2& w, float (&f)[8]) {
  const uint32_t a = w.x ^ 0x80808080u, b = w.y ^ 0x80808080u;
  constexpr float kBias = 8388608.f + 128.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = biased_byte(a, j, kBias);
    f[4 + j] = biased_byte(b, j, kBias);
  }
}

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

// Weight streaming. Weights do not depend on activations, so each matrix's
// share of a block streams into shared memory ahead of its stage: two
// regions of 16 KB slots in the dynamic shared memory (6 and 3), QKV, gate|up
// and the head in region 0 (which the attention ring shares: the attention
// runs between QKV and gate|up), O-proj and down in region 1. As soon as a
// region's matrix is done, thread 0 issues the first chunks of the
// region's next matrix (one a slot), after its arrival at the next grid
// barrier, so a block's first 32-96 KB of every matrix land under the
// barrier and the stage between (not at
// a stage's start, where the copies would queue ahead of the stage's
// latency-bound loads of partials); a share above that streams through the
// slots as they free up. A chunk is one TMA tensor copy of a box of 64
// columns x 16 KB of one work item's rows (128 bf16 rows of 128 bytes, or
// 256 int8 / packed int4 rows of 64 bytes), reported to the slot's
// mbarrier; each thread tracks every slot's phase parity the same way.
// (On an H100, per-row bulk copies of 128 bytes were much slower, 16-byte
// cp.async copies from every thread no faster, and issuing a region's
// next matrix after the stage's loads of partials instead of before the
// barrier slower.)
constexpr int kSlots = 6;   // region 0's: QKV, gate|up, the head, the attention ring
constexpr int kSlots1 = 3;  // region 1's: O-proj, down
constexpr int kSlotBytes = 16384;
constexpr int kRegionBytes = kSlots * kSlotBytes;       // region 0
constexpr int kRegion1Bytes = kSlots1 * kSlotBytes;  // region 1
static_assert(attn_dyn_smem<bf16>() <= kRegionBytes && attn_dyn_smem<int8_t>() <= kRegionBytes,
              "the attention ring fits region 0");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A region's slots: their mbarriers (static shared memory) and the
// parity of each slot's next phase (a register, the same in every thread).
struct Region {
  char* mem;
  uint64_t* bar;
  int slots;
  unsigned parity;
};

// One work item of a matrix: its tile, its stored rows [k0, k1), its split.
struct Item {
  const char* w;  // the tile's first column in row 0 of this layer
  int N, k0, k1, sp, tile;
};

__device__ __forceinline__ Item mat_item(const MatPlan& m, int li, int item) {
  const int tiles = m.N / kGemvCols, esz = m.form == kFormBf16 ? 2 : 1;
  const int rows = m.form == kFormInt4 ? m.K / 2 : m.K;
  Item it;
  it.tile = item % tiles;
  it.sp = item / tiles;
  it.N = m.N;
  it.k0 = it.sp * m.rows;
  it.k1 = min(rows, it.k0 + m.rows);
  it.w = static_cast<const char*>(m.w) +
         (li * (size_t)rows * m.N + (size_t)it.tile * kGemvCols) * esz;
  return it;
}

__device__ __forceinline__ int row_bytes_of(const MatPlan& m) {
  return m.form == kFormBf16 ? 2 * kGemvCols : kGemvCols;
}

// The rows a chunk holds, and the chunks of one item.
__device__ __forceinline__ int chunk_rows(const MatPlan& m) {
  return kSlotBytes / row_bytes_of(m);
}
__device__ __forceinline__ int item_chunks(const MatPlan& m, const Item& it) {
  const int P = chunk_rows(m);
  return (it.k1 - it.k0 + P - 1) / P;
}

// Thread 0: issue chunk c of the block's share of layer li of matrix m (its
// items in order, each item's rows in chunks) into its slot, if the share
// has a chunk c: one TMA tensor copy of a [1 x 16 KB of rows x 64 columns]
// box (rows past the matrix read as zeros; rows past the item are never
// multiplied), reported to the slot's mbarrier.
__device__ __forceinline__ void stream_issue(const MatPlan& m, const CUtensorMap* tmap, int li,
                                             int c, Region& rg) {
  if (threadIdx.x != 0) return;
  const int items = (m.N / kGemvCols) * m.ns;
  int item = blockIdx.x, t = c;
  Item it;
  for (;; item += gridDim.x) {
    if (item >= items) return;
    it = mat_item(m, li, item);
    const int n = item_chunks(m, it);
    if (t < n) break;
    t -= n;
  }
  const int slot = c % rg.slots, r0 = it.k0 + t * chunk_rows(m);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after generic use
  mbar_expect_tx(&rg.bar[slot], kSlotBytes);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(rg.mem + slot * kSlotBytes)),
      "l"(reinterpret_cast<uint64_t>(tmap + m.tm)), "r"(it.tile * kGemvCols), "r"(r0), "r"(li),
      "r"(smem_addr(&rg.bar[slot]))
      : "memory");
}

// Issue the first chunks (one a slot) of the block's share of layer li of m into
// region rg (whose slots are all free).
__device__ __forceinline__ void stream_prime(const MatPlan& m, const CUtensorMap* tmap, int li,
                                             Region& rg) {
  if (m.w == nullptr) return;
  for (int c = 0; c < rg.slots; ++c) stream_issue(m, tmap, li, c, rg);
}

// The products of one chunk (rows [r0, r1) of item it, at slot memory st)
// added into acc: thread (cg, rg) takes columns cg*8..cg*8+7 of rows
// r0 + rg + 32u in 128-row passes; grouped forms scale each pass's
// partial by its group's scales.
template <int kForm, bool kGrouped>
__device__ __forceinline__ void gemv_chunk(const float* xs, const char* st, const float* scale,
                                           const Item& it, int r0, int r1, int K, float (&acc)[8]) {
  constexpr int RB = kForm == kFormBf16 ? 128 : 64;
  constexpr int kPasses = kSlotBytes / RB / kGroup;
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  const int N = it.N, col = it.tile * kGemvCols + cg * 8;
  const int Kh = K / 2, hi_groups = Kh / kGroup;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int k = r0 + pass * kGroup;  // the pass's first row
    if (k >= r1) break;
    const char* sp = st + pass * kGroup * RB;
    if constexpr (kForm == kFormBf16) {
      uint4 w[kGemvUnroll];
      float xv[kGemvUnroll];
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int r = rg + u * kGemvRows;
        const bool in = k + r < r1;  // rows past the chunk hold stale bytes
        w[u] = in ? *reinterpret_cast<const uint4*>(sp + r * RB + cg * 16)
                  : make_uint4(0u, 0u, 0u, 0u);
        xv[u] = in ? xs[k + r] : 0.f;
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
    } else if constexpr (kForm == kFormInt8) {
      float p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = 0.f;
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int r = rg + u * kGemvRows;
        const bool in = k + r < r1;
        const uint2 w = in ? *reinterpret_cast<const uint2*>(sp + r * RB + cg * 8)
                           : make_uint2(0u, 0u);
        const float xv = in ? xs[k + r] : 0.f;
        float f[8];
        int8x8(w, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) p[j] = fmaf(xv, f[j], p[j]);
      }
      if constexpr (kGrouped) {
        float s[8];
        load_scales8(scale + (size_t)(k / kGroup) * N + col, s);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(p[j], s[j], acc[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += p[j];
      }
    } else {  // packed int4-g128, halves layout
      float pl[8], ph[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) pl[j] = ph[j] = 0.f;
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int r = rg + u * kGemvRows;
        const bool in = k + r < r1;
        const uint2 w = in ? *reinterpret_cast<const uint2*>(sp + r * RB + cg * 8)
                           : make_uint2(0u, 0u);
        const float xl = in ? xs[k + r] : 0.f, xh = in ? xs[k + r + Kh] : 0.f;
        float lo[8], hi[8];
        int4x8(w, lo, hi);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pl[j] = fmaf(xl, lo[j], pl[j]);
          ph[j] = fmaf(xh, hi[j], ph[j]);
        }
      }
      const int g = k / kGroup;
      float sl[8], sh[8];
      load_scales8(scale + (size_t)g * N + col, sl);
      load_scales8(scale + (size_t)(g + hi_groups) * N + col, sh);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(ph[j], sh[j], fmaf(pl[j], sl[j], acc[j]));
    }
  }
}

// The block's work items of layer li of matrix m into part, from the
// stream in region rg (its first chunks issued by stream_prime): for each
// item, fill(k0, k1) first (every thread; it fills xs at the item's rows
// and ends in __syncthreads; a no-op when xs holds the whole input), then
// its chunks, then the 32 row lanes' sums in lane order (times the column
// scale for per-channel int8) into part[sp][tile's columns]. Every thread
// of the block calls it.
template <int kForm, bool kGrouped, typename Fill>
__device__ __forceinline__ void gemv_items(const MatPlan& m, const CUtensorMap* tmap, int li,
                                           float* part, const float* xs, Region& rg,
                                           float (*red)[kGemvCols + 1], Fill fill) {
  const int items = (m.N / kGemvCols) * m.ns, P = chunk_rows(m);
  const float* S = m.s != nullptr ? m.s + (size_t)li * m.ng * m.N : nullptr;
  const int tid = threadIdx.x, cgi = tid & 7;
  int c = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = mat_item(m, li, item);
    fill(it.k0, it.k1);
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int r0 = it.k0; r0 < it.k1; r0 += P, ++c) {
      const int slot = c % rg.slots;
      mbar_wait(&rg.bar[slot], (rg.parity >> slot) & 1u);
      gemv_chunk<kForm, kGrouped>(xs, rg.mem + slot * kSlotBytes, S, it, r0,
                                  min(it.k1, r0 + P), m.K, acc);
      __syncthreads();  // every thread is done with the slot
      rg.parity ^= 1u << slot;
      stream_issue(m, tmap, li, c + rg.slots, rg);
    }
    // the row lanes' sums: the warp's four by shuffles, then the warps' in
    // warp order (a fixed order: the same bits on every run)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 8);
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
    }
    if ((tid & 31) < 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[tid >> 5][cgi * 8 + j] = acc[j];
    }
    __syncthreads();
    if (tid < kGemvCols) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kAttnWarps; ++w) s += red[w][tid];
      const int n = it.tile * kGemvCols + tid;
      if (kForm == kFormInt8 && !kGrouped) s *= __ldg(S + n);
      part[(size_t)it.sp * m.N + n] = s;
    }
    __syncthreads();  // red and xs are free for the next item
  }
}

template <typename Fill>
__device__ __forceinline__ void gemv_stage(const MatPlan& m, const CUtensorMap* tmap, int li,
                                           float* part, const float* xs, Region& rg,
                                           float (*red)[kGemvCols + 1], Fill fill) {
  if (m.form == kFormBf16)
    gemv_items<kFormBf16, false>(m, tmap, li, part, xs, rg, red, fill);
  else if (m.form == kFormInt4)
    gemv_items<kFormInt4, true>(m, tmap, li, part, xs, rg, red, fill);
  else if (m.ng > 1)
    gemv_items<kFormInt8, true>(m, tmap, li, part, xs, rg, red, fill);
  else
    gemv_items<kFormInt8, false>(m, tmap, li, part, xs, rg, red, fill);
}

// Copies n floats (n a multiple of 4, both ends 16-byte aligned) written
// by other blocks into shared memory with cp.async (L2, coherent), every
// thread a share; the caller commits, waits and syncs. Data the next
// stage needs from the whole grid (split-K partials, the residual, the
// attention output) comes in this way, all of a block's loads in flight at
// once rather than a dependent L2 round trip per value.
constexpr int kStageFloats = 10240;  // the staging area: 40 KB after the regions
constexpr int kDynSmem = kRegionBytes + kRegion1Bytes + kStageFloats * (int)sizeof(float);

__device__ __forceinline__ void stage_copy(void* dst, const void* src, int n) {
  for (int c = threadIdx.x * 4; c < n; c += kThreads * 4)
    cp_async16(static_cast<float*>(dst) + c, static_cast<const float*>(src) + c);
}

__device__ __forceinline__ void stage_wait() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// sum_s part[s * stride + i] over s < ns, in split order, eight loads in
// flight at once.
__device__ __forceinline__ float sum_splits(const float* part, int ns, size_t stride, int i) {
  float p = 0.f;
  for (int s = 0; s < ns; s += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = s + j < ns ? __ldcg(part + (s + j) * stride + i) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) p += v[j];
  }
  return p;
}

// ── norms, attention, logits ─────────────────────────────────────────────

// xs[i] = bf16(rms_norm(x)[i] * w[i]) for x = base + sum_s part[s] (part
// summed first, in split order; base f32 or bf16, one of them set). Every
// block computes it and gets the same bits; block 0 stores x into x_out
// and, when y_out is set, the f32 normed row into y_out. stage holds
// kStageFloats floats (ns * H + H must fit).
__device__ __forceinline__ void residual_norm(const float* base_f, const bf16* base_b,
                                              const float* part, int ns, int H,
                                              const bf16* __restrict__ w, float eps,
                                              float* x_out, float* y_out, float* xs,
                                              float* stage, float* warp_ss) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_copy(stage, part, ns * H);
  if (base_f != nullptr) stage_copy(stage + ns * H, base_f, H);
  stage_wait();
  float ss = 0.f;
  for (int i = tid; i < H; i += kThreads) {
    float p = 0.f;
    for (int s = 0; s < ns; ++s) p += stage[s * H + i];
    const float b = base_f != nullptr ? stage[ns * H + i] : __bfloat162float(base_b[i]);
    const float v = b + p;
    xs[i] = v;
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kAttnWarps; ++i) t += warp_ss[i];
  const float r = rsqrtf(t / (float)H + eps);
  const bool owner = blockIdx.x == 0;
  for (int i = tid; i < H; i += kThreads) {
    const float v = xs[i];
    const float y = v * r * __bfloat162float(w[i]);
    if (owner) {
      if (x_out != nullptr) x_out[i] = v;
      if (y_out != nullptr) y_out[i] = y;
    }
    xs[i] = __bfloat162float(__float2bfloat16(y));
  }
  __syncthreads();
}

// This step's attention split over at most C blocks a kv head: 64-row
// tiles a block (*tpb) and the blocks that take tiles (at least one: a
// prefix of 0 rows is the in-flight column alone).
__device__ __forceinline__ int attn_split(int pos, int C, int* tpb) {
  const int nt = (pos + kAttnTile - 1) / kAttnTile;
  const int nb = nt < 1 ? 1 : (nt < C ? nt : C);
  *tpb = nt > 0 ? (nt + nb - 1) / nb : 0;
  return nt > 0 ? (nt + *tpb - 1) / *tpb : 1;
}

// The section of rotary frequency index j (see QttsStepIO).
__device__ __forceinline__ int rope_section(const StepParams& p, int j) {
  int s = 0;
  if (p.interleaved) {
    for (int si = 1; si < p.n_sec; ++si)
      if (j % p.n_sec == si && j < p.n_sec * p.sec[si]) s = si;
  } else {
    int start = 0;
    for (int si = 1; si < p.n_sec; ++si) {
      start += p.sec[si - 1];
      if (j >= start) s = si;
    }
  }
  return s;
}

struct BlockShared {
  AttnShared attn;
  float xs[kMaxK];
  float red[kGemvRows][kGemvCols + 1];
  float rope_c[kAttnD / 2];
  float rope_s[kAttnD / 2];
  float warp_ss[kAttnWarps];
  float cand_v[kAttnWarps];
  int cand_i[kAttnWarps];
  int pos[1 + kQttsMaxSections];
  int token;
  unsigned head_base[kMaxKvHeads];  // each kv head's attention count at the start
  uint64_t wbar[2][kSlots];  // the weight regions' slot barriers
};

// Kv head h's attention partials in the workspace.
__device__ __forceinline__ AttnGlobal head_partials(const StepParams& p, int h) {
  const int G = p.HQ / p.KVH;
  const size_t gw = (size_t)h * kAttnMaxCluster;
  return AttnGlobal{p.ws.amerge_m + gw * G, p.ws.amerge_l + gw * G,
                    p.ws.amerge_acc + gw * G * kAttnD, p.ws.amerge_col + (size_t)h * kColFloats,
                    p.ws.amerge_col + (size_t)h * kColFloats + 8, p.ws.head_done + h};
}

// Stage 2 of layer li: block `rank` of the nb blocks that attend for kv
// head h (attn_start has run): its partials go to the workspace, and the
// head's count grows by one.
template <typename CacheT, int KG>
__device__ __forceinline__ void attention_stage(const StepParams& p, BlockShared& sm,
                                                char* stages, int li, int pos, int n, int tpb,
                                                int h, int rank, int nb) {
  constexpr bool kKv8 = sizeof(CacheT) == 1;
  constexpr int D = kAttnD, D2 = kAttnD / 2;
  AttnShared& sh = sm.attn;
  const bool rank0 = rank == 0;
  const int G = p.HQ / p.KVH, Q = p.HQ * D, KV = p.KVH * D, qkv_n = Q + 2 * KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rows = (size_t)p.KVH * p.S;
  CacheT* kh = static_cast<CacheT*>(p.k_cache) + (li * rows + (size_t)h * p.S) * D;
  CacheT* vh = static_cast<CacheT*>(p.v_cache) + (li * rows + (size_t)h * p.S) * D;
  float* ksh = kKv8 ? p.k_scale + li * rows + (size_t)h * p.S : nullptr;
  float* vsh = kKv8 ? p.v_scale + li * rows + (size_t)h * p.S : nullptr;
  const float* part = p.ws.part[0];
  const bf16* q_norm = p.q_norm + (size_t)li * D;
  const bf16* k_norm = p.k_norm + (size_t)li * D;

  if (tid < D2) {  // the rope row of this step
    const int s = p.n_sec > 0 ? rope_section(p, tid) : 0;
    const size_t row = (size_t)((p.n_sec > 0 ? sm.pos[1 + s] : sm.pos[0]) + n);
    sm.rope_c[tid] = __ldg(p.cos_tab + row * D2 + tid);
    sm.rope_s[tid] = __ldg(p.sin_tab + row * D2 + tid);
  }
  {  // this kv head's q, k and v columns of every split, then their sums
    float* stage = reinterpret_cast<float*>(stages + kRegionBytes + kRegion1Bytes);
    const int W = (G + 2) * D;
    for (int sp = 0; sp < p.qkv.ns; ++sp) {
      const float* ps = part + (size_t)sp * qkv_n;
      stage_copy(stage + sp * W, ps + h * G * D, G * D);
      stage_copy(stage + sp * W + G * D, ps + Q + h * D, D);
      stage_copy(stage + sp * W + (G + 1) * D, ps + Q + KV + h * D, D);
    }
    stage_wait();
    for (int i = tid; i < W; i += kThreads) {
      float s = 0.f;
      for (int sp = 0; sp < p.qkv.ns; ++sp) s += stage[sp * W + i];
      sh.vecs[i / D][i % D] = s;
    }
  }
  __syncthreads();

  for (int r = warp; r < G + 1; r += kAttnWarps) {  // QK-RMSNorm
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) ss = fmaf(sh.vecs[r][d], sh.vecs[r][d], ss);
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)D + p.eps);
    const bf16* nw = r < G ? q_norm : k_norm;
    for (int d = lane; d < D; d += 32)
      sh.vecs[r][d] = sh.vecs[r][d] * inv * __bfloat162float(nw[d]);
  }
  __syncthreads();

  for (int i = tid; i < (G + 1) * D2; i += kThreads) {  // RoPE
    const int r = i / D2, j = i % D2;
    const float x1 = sh.vecs[r][j], x2 = sh.vecs[r][j + D2];
    const float c = sm.rope_c[j], s = sm.rope_s[j];
    sh.vecs[r][j] = x1 * c - x2 * s;
    sh.vecs[r][j + D2] = x2 * c + x1 * s;
  }
  __syncthreads();

  if (rank0) {  // the new K/V column, for later steps' TMA reads
    if constexpr (kKv8) {
      if (warp < 2) {  // warp 0 quantizes the k row, warp 1 the v row
        const float* row = sh.vecs[G + warp];
        float am = 0.f;
        for (int d = lane; d < D; d += 32) am = fmaxf(am, fabsf(row[d]));
        const float sc = fmaxf(warp_max(am), 1e-8f) / 127.f;
        CacheT* dst = (warp == 0 ? kh : vh) + (size_t)pos * D;
        for (int d = lane; d < D; d += 32)
          dst[d] = (CacheT)fminf(fmaxf(rintf(row[d] / sc), -127.f), 127.f);
        if (lane == 0) (warp == 0 ? ksh : vsh)[pos] = sc;
      }
    } else {
      for (int d = tid; d < D; d += kThreads) {
        kh[(size_t)pos * D + d] = __float2bfloat16(sh.vecs[G][d]);
        vh[(size_t)pos * D + d] = __float2bfloat16(sh.vecs[G + 1][d]);
      }
    }
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  const AttnGlobal gm = head_partials(p, h);
  attend_cluster<CacheT, KG>(sh, stages, kh, vh, ksh, vsh, G, pos, tpb, (float*)nullptr, rank,
                             nb, &gm);
}

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The best (value, index) of the block's threads, lowest index on a tie,
// in thread 0.
__device__ __forceinline__ void block_argmax(float& v, int& idx, BlockShared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    better(v, idx, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, idx, o));
  if (lane == 0) {
    sm.cand_v[warp] = v;
    sm.cand_i[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kAttnWarps; ++w) better(v, idx, sm.cand_v[w], sm.cand_i[w]);
  __syncthreads();
}

#ifdef QTTS_STAGE_TIMERS
#define QTTS_TIMER_DECL                                                                \
  unsigned long long t_acc[kNumStages] = {}, t_work[kNumStages] = {},                  \
                     t_slow[kNumStages] = {}, t_pro[kNumStages] = {}, t_prev = global_ns();
#define QTTS_TIMER_PRO(stage) \
  if (blockIdx.x == 0 && threadIdx.x == 0) t_pro[stage] += global_ns() - t_prev;
#define QTTS_TIMER_WORK(stage)                                                         \
  if (threadIdx.x == 0) {                                                              \
    const unsigned long long t_now = global_ns();                                      \
    atomicMax(p.ws.timers + kTimerScratch + (stage), t_now);                           \
    if (blockIdx.x == 0) t_work[stage] += t_now - t_prev;                              \
  }
#define QTTS_TIMER_MARK(stage)                                                         \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                                           \
    const unsigned long long t_now = global_ns();                                      \
    t_acc[stage] += t_now - t_prev;                                                    \
    t_slow[stage] += atomicExch(p.ws.timers + kTimerScratch + (stage), 0ull) - t_prev; \
    t_prev = t_now;                                                                    \
  }
#define QTTS_TIMER_STORE                                                               \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                                           \
    for (int s_ = 0; s_ < kNumStages; ++s_) {                                          \
      p.ws.timers[s_] += t_acc[s_];                                                    \
      p.ws.timers[kTimerWork + s_] += t_work[s_];                                      \
      p.ws.timers[kTimerSlow + s_] += t_slow[s_];                                      \
      p.ws.timers[kTimerPro + s_] += t_pro[s_];                                        \
    }                                                                                  \
    p.ws.timers[kNumStages] += 1;                                                      \
    p.ws.timers[kNumStages + 1] += p.num_steps;                                        \
  }
#else
#define QTTS_TIMER_DECL
#define QTTS_TIMER_PRO(stage)
#define QTTS_TIMER_WORK(stage)
#define QTTS_TIMER_MARK(stage)
#define QTTS_TIMER_STORE
#endif

// The persistent decode kernel: p.num_steps steps (see the file comment).
// Generation (p.tokens set) feeds each step's argmax back as the next
// step's input; otherwise the one step starts from p.x_in.
template <typename CacheT, int KG>
__global__ void __launch_bounds__(kThreads, 1) decode_persistent(const __grid_constant__ StepParams p) {
  __shared__ BlockShared sm;
  extern __shared__ __align__(128) char dsmem[];  // weight regions 0, 1; staging
  Region r0{dsmem, sm.wbar[0], kSlots, 0u};
  Region r1{dsmem + kRegionBytes, sm.wbar[1], kSlots1, 0u};
  float* const stage = reinterpret_cast<float*>(dsmem + kRegionBytes + kRegion1Bytes);
  const int tid = threadIdx.x;
  const bool gen = p.tokens != nullptr;
  const int B = gridDim.x / p.KVH;  // blocks a kv head
  const int C = B < kAttnMaxCluster ? B : kAttnMaxCluster;  // of them attending at most
  const int H = p.H, I = p.I, Q = p.HQ * kAttnD;
  const size_t rows = (size_t)p.KVH * p.S;
  const int h = blockIdx.x / B, rank = blockIdx.x % B;
  float* const xs = sm.xs;
  unsigned* const bar = p.ws.bar;
  unsigned bar_target = 0;  // thread 0's
  unsigned arrived = 0;     // block partials of each kv head this launch, so far
  QTTS_TIMER_DECL

  if (tid == 0) {
    bar_target = ld_acquire(bar + 1);
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&sm.wbar[0][i], 1);
      mbar_init(&sm.wbar[1][i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < p.KVH) sm.head_base[tid] = ld_acquire(p.ws.head_done + tid);  // before any partial
  if (tid < 1 + p.n_sec) sm.pos[tid] = __ldcg(p.positions + tid);
  if (tid == 0 && gen) sm.token = __ldcg(p.first_token);
  __syncthreads();
  stream_prime(p.qkv, p.tmap, 0, r0);
  stream_prime(p.o, p.tmap, 0, r1);

  for (int n = 0; n < p.num_steps; ++n) {
    const int pos = sm.pos[0] + n;
    int tpb;
    const int nb = attn_split(pos, C, &tpb);
    const bool attends = rank < nb;  // the head's other blocks skip the attention
    for (int li = 0; li < p.L; ++li) {
      // 1. residual + input norm + QKV (region 0; O-proj waits in region 1)
      const bf16* emb = gen && li == 0 ? p.embed + (size_t)sm.token * H : nullptr;
      residual_norm(li == 0 ? p.x_in : p.ws.x[0], emb, li == 0 ? nullptr : p.ws.part[1],
                    li == 0 ? 0 : p.down.ns, H, p.input_norm + (size_t)li * H, p.eps,
                    p.ws.x[1], nullptr, xs, stage, sm.warp_ss);
      QTTS_TIMER_PRO(kStageQkv)
      gemv_stage(p.qkv, p.tmap, li, p.ws.part[0], xs, r0, sm.red, [](int, int) {});
      QTTS_TIMER_WORK(kStageQkv)
      grid_sync_issuing(bar, bar_target, [&] {
        if (!attends) return;  // the prefix starts streaming into region 0 under the barrier
        const size_t off = li * rows + (size_t)h * p.S;
        if (tid == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        attn_start(sm.attn, dsmem, static_cast<const CacheT*>(p.k_cache) + off * kAttnD,
                   static_cast<const CacheT*>(p.v_cache) + off * kAttnD,
                   sizeof(CacheT) == 1 ? p.k_scale + off : nullptr,
                   sizeof(CacheT) == 1 ? p.v_scale + off : nullptr, pos, tpb, rank);
      });
      QTTS_TIMER_MARK(kStageQkv)

      // 2. attention (region 0): the attending blocks leave their partials
      // in the workspace; gate|up then streams into region 0 (a block with
      // no tiles to attend starts it at once). Then O-proj (region 1)
      // in the same stage: a work item of split sp holds the G x D rows of
      // kv head sp (int4's halves layout: heads sp and sp + KVH / 2), so it
      // waits for the count of those heads' partials, not for the grid, and
      // merges them itself. Down then streams into region 1.
      arrived += nb;
      if (attends) attention_stage<CacheT, KG>(p, sm, dsmem, li, pos, n, tpb, h, rank, nb);
      __syncthreads();
      stream_prime(p.gu, p.tmap, li, r0);
      QTTS_TIMER_PRO(kStageAttn)
      {
        const int Kh = p.o.form == kFormInt4 ? Q / 2 : 0, hd = p.HQ / p.KVH * kAttnD;
        gemv_stage(p.o, p.tmap, li, p.ws.part[1], xs, r1, sm.red, [&](int k0, int) {
          const int hh = k0 / hd, hh2 = hh + Kh / hd;  // the item's rows: head hh's (and hh2's)
          if (tid == 0) {
            wait_count(p.ws.head_done + hh, sm.head_base[hh] + arrived);
            if (Kh) wait_count(p.ws.head_done + hh2, sm.head_base[hh2] + arrived);
          }
          __syncthreads();
          merge_global(sm.attn, nb, p.HQ / p.KVH, head_partials(p, hh), xs + k0);
          if (Kh) {
            __syncthreads();
            merge_global(sm.attn, nb, p.HQ / p.KVH, head_partials(p, hh2), xs + k0 + Kh);
          }
          __syncthreads();
        });
      }
      QTTS_TIMER_WORK(kStageAttn)
      grid_sync_issuing(bar, bar_target, [&] { stream_prime(p.down, p.tmap, li, r1); });
      QTTS_TIMER_MARK(kStageAttn)

      // 4. residual + post norm + gate|up (region 0); then the next layer's
      // QKV (or the head) streams into region 0
      residual_norm(p.ws.x[1], nullptr, p.ws.part[1], p.o.ns, H, p.post_norm + (size_t)li * H,
                    p.eps, p.ws.x[0], nullptr, xs, stage, sm.warp_ss);
      QTTS_TIMER_PRO(kStageGateUp)
      gemv_stage(p.gu, p.tmap, li, p.ws.part[0], xs, r0, sm.red, [](int, int) {});
      QTTS_TIMER_WORK(kStageGateUp)
      grid_sync_issuing(bar, bar_target, [&] {
        if (li + 1 < p.L)
          stream_prime(p.qkv, p.tmap, li + 1, r0);
        else
          stream_prime(p.head, p.tmap, 0, r0);
      });
      QTTS_TIMER_MARK(kStageGateUp)

      // 5. SwiGLU of the item's rows from the gate|up partials, then down
      // (region 1); then the next layer's O-proj streams into region 1
      {
        const float* gu = p.ws.part[0];
        const int ns = p.gu.ns, Kh = p.down.form == kFormInt4 ? I / 2 : 0;
        const int R = Kh ? 4 : 2;  // runs a split: gate, up (and their high halves)
        gemv_stage(p.down, p.tmap, li, p.ws.part[1], xs, r1, sm.red, [&](int k0, int k1) {
          const int n = k1 - k0;
          for (int sp = 0; sp < ns; ++sp) {
            const float* ps = gu + (size_t)sp * 2 * I + k0;
            stage_copy(stage + (sp * R) * n, ps, n);
            stage_copy(stage + (sp * R + 1) * n, ps + I, n);
            if (Kh) {
              stage_copy(stage + (sp * R + 2) * n, ps + Kh, n);
              stage_copy(stage + (sp * R + 3) * n, ps + I + Kh, n);
            }
          }
          stage_wait();
          for (int j = tid; j < n; j += kThreads) {
            for (int half = 0; half < R / 2; ++half) {
              float g = 0.f, u = 0.f;
              for (int sp = 0; sp < ns; ++sp) {
                g += stage[(sp * R + 2 * half) * n + j];
                u += stage[(sp * R + 2 * half + 1) * n + j];
              }
              xs[k0 + half * Kh + j] =
                  __bfloat162float(__float2bfloat16(g / (1.f + expf(-g)) * u));
            }
          }
          __syncthreads();
        });
      }
      QTTS_TIMER_WORK(kStageDown)
      grid_sync_issuing(bar, bar_target, [&] {
        if (li + 1 < p.L) stream_prime(p.o, p.tmap, li + 1, r1);
      });
      QTTS_TIMER_MARK(kStageDown)
    }

    // the final norm and the head (region 0)
    float* normed = gen ? p.ws.normed : p.normed;
    residual_norm(p.ws.x[0], nullptr, p.ws.part[1], p.down.ns, H, p.final_norm, p.eps,
                  nullptr, normed, xs, stage, sm.warp_ss);
    if (p.head.w == nullptr) break;  // no head: one step, done
    gemv_stage(p.head, p.tmap, 0, p.ws.part[0], xs, r0, sm.red, [](int, int) {});
    QTTS_TIMER_WORK(kStageHead)
    grid_sync_issuing(bar, bar_target, [&] {
      if (gen && n + 1 < p.num_steps) {  // the next step's QKV and O-proj stream in
        stream_prime(p.qkv, p.tmap, 0, r0);
        stream_prime(p.o, p.tmap, 0, r1);
      }
    });
    QTTS_TIMER_MARK(kStageHead)

    // logits summed over the head's splits, a slice a block; candidates
    float* logits = gen ? p.ws.logits : p.logits;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int v = blockIdx.x * kThreads + tid; v < p.V; v += gridDim.x * kThreads) {
      const float s = sum_splits(p.ws.part[0], p.head.ns, p.V, v);
      logits[v] = s;
      better(bv, bi, s, v);
    }
    if (!gen) break;
    block_argmax(bv, bi, sm);
    if (tid == 0) {
      p.ws.cand_v[blockIdx.x] = bv;
      p.ws.cand_i[blockIdx.x] = bi;
    }
    QTTS_TIMER_WORK(kStageLogits)
    grid_sync(bar, bar_target);
    QTTS_TIMER_MARK(kStageLogits)

    // every block reduces the candidates to the same token
    bv = -INFINITY;
    bi = INT_MAX;
    for (int b = tid; b < (int)gridDim.x; b += kThreads)
      better(bv, bi, __ldcg(p.ws.cand_v + b), __ldcg(p.ws.cand_i + b));
    block_argmax(bv, bi, sm);
    if (tid == 0) {
      sm.token = bi;
      if (blockIdx.x == 0) p.tokens[n] = bi;
    }
    __syncthreads();
    QTTS_TIMER_MARK(kStageArgmax)
  }
  // every block read the positions before its first barrier
  if (blockIdx.x == 0 && tid < 1 + p.n_sec) p.positions[tid] = sm.pos[tid] + p.num_steps;
  if (blockIdx.x == 0 && tid == 0) {
    ++*p.ws.launches;
    bar[1] = bar_target;  // every block read it before its first arrival
  }
  QTTS_TIMER_STORE
}

}  // namespace

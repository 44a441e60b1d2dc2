// One decode step of one token through all L layers of a Qwen3 decoder
// (the 28-layer talker or the 5-layer code predictor), for sm_90a, as one
// persistent launch; and the host side of that launch, which generate.cu
// shares.
//
// Replaces the Pallas TPU kernel qwen_tts_tpu/ops/decode_step.py::_megakernel
// (body :98, pallas_call :607, wrapper megakernel_forward :453) in all its
// forms: bf16, int8 (per channel or per 128-row group), int4-g128 and mixed
// weights, an int8 or bf16 LM head, and a bf16 or int8 KV cache. What
// bounds it (weight bytes: 0.887 GB a bf16 talker step, 0.265 ms at 3.35
// TB/s; ~0.445 GB for int8, ~0.237 GB for int4) and the design that answers
// it (one launch, stages behind grid barriers, weights streamed into shared
// memory across them) are in decode_layer.cuh. It replaces a first design
// of eight small kernels a layer enqueued from a host loop (248 launches a
// talker step), whose host enqueue and inter-kernel gaps outweighed the
// device work; the one launch removed both but not the device time, which
// the stages' chains of latencies now set (PERF.md).
//
// The entry points are plain C functions (bound with ctypes): they launch on
// the caller's stream, do not synchronise, allocate nothing (the caller
// passes a workspace of qtts_workspace_bytes(...) bytes, zeroed once before
// its first use: it holds the grid barrier's count and the kv heads'
// counts of attention partials), and return the first CUDA error they see. The position is read from device memory (the
// `positions` array, which the launch advances), so a step can be replayed
// without the host.

#include "decode_layer.cuh"

namespace {

// Writes n ints (at most 1 + kQttsMaxSections) into dst.
struct IntRow {
  int v[1 + kQttsMaxSections];
};

__global__ void set_ints(int* dst, int n, IntRow row) {
  if ((int)threadIdx.x < n) dst[threadIdx.x] = row.v[threadIdx.x];
}

// Split-K plan of a [K, N] matrix over nblk blocks: the split whose most
// loaded block streams the fewest rows, counting 256 rows' worth for each
// of its items (its input, reduction and partial store cost about as much
// as streaming that many rows; ties: fewer splits), each
// split a whole number of 128-row passes (which also keeps the grouped
// forms' splits on their groups), at most max_ns splits (what its
// consumer can stage).
MatPlan plan_mat(const QttsMat& q, int K, int N, int nblk, int max_ns, int tm) {
  MatPlan m{q.w, q.s, q.form, q.ng, K, N, 1, 0, tm};
  const int Kp = q.form == kFormInt4 ? K / 2 : K, tiles = N / kGemvCols;
  long long best = -1;
  for (int s = 1; s <= kMaxSplit; ++s) {
    const int r = ((Kp + s - 1) / s + kGroup - 1) / kGroup * kGroup;
    const int ns = (Kp + r - 1) / r;
    if (ns > max_ns) break;
    const long long cost = (long long)((tiles * ns + nblk - 1) / nblk) * (r + 2 * kGroup);
    if (best < 0 || cost < best) {
      best = cost;
      m.ns = ns;
      m.rows = r;
    }
  }
  return m;
}

// The TMA tensor map of a layer-stacked matrix [L, rows, N] (bf16, or
// int8 bytes for the int8 and packed int4 forms): a box of 64 columns x one
// 16 KB chunk of rows x 1 layer, no swizzle (rows land densely, as the
// GEMV reads them). Encoded through the driver's entry point, no link to
// libcuda; a small cache keeps the maps of the matrices seen last.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t tensor_map(CUtensorMap* out, const MatPlan& m, int L) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || fn == nullptr)
      return e != cudaSuccess ? e : cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  struct Entry {
    const void* w;
    int form, K, N, L;
    CUtensorMap map;
  };
  static Entry cache[32];
  static int next = 0;
  for (const Entry& c : cache)
    if (c.w == m.w && c.form == m.form && c.K == m.K && c.N == m.N && c.L == L) {
      *out = c.map;
      return cudaSuccess;
    }
  const int esz = m.form == kFormBf16 ? 2 : 1;
  const cuuint64_t rows = m.form == kFormInt4 ? m.K / 2 : m.K;
  const cuuint64_t dims[3] = {(cuuint64_t)m.N, rows, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)m.N * esz, rows * m.N * esz};
  const cuuint32_t box[3] = {kGemvCols, (cuuint32_t)(kSlotBytes / (kGemvCols * esz)), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(out, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            3, const_cast<void*>(m.w), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  cache[next] = Entry{m.w, m.form, m.K, m.N, L, *out};
  next = (next + 1) % 32;
  return cudaSuccess;
}

// True when matrix m ([K, N]) is a form the kernel takes.
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

bool decoder_ok(const QttsDecoder& d) {
  const int Q = d.HQ * d.D, QKV = Q + 2 * d.KVH * d.D;
  return d.D == kAttnD && d.KVH > 0 && d.HQ % d.KVH == 0 && d.HQ / d.KVH <= kAttnMaxG &&
         d.H % kGemvCols == 0 && QKV % kGemvCols == 0 && (2 * d.I) % kGemvCols == 0 &&
         d.V % kGemvCols == 0 && d.H <= kMaxK && Q <= kMaxK && d.I <= kMaxK && d.KVH <= kMaxKvHeads &&
         (d.KVH + 1) * d.H <= kStageFloats && (d.wo.form != kFormInt4 || d.KVH % 2 == 0) && d.S % 8 == 0 &&
         d.L > 0 && mat_ok(d.wqkv, d.H) && mat_ok(d.wo, Q) && mat_ok(d.w_gate_up, d.H) &&
         mat_ok(d.w_down, d.I) && (d.lm_head.w == nullptr || mat_ok(d.lm_head, d.H)) &&
         (d.k_scale == nullptr) == (d.v_scale == nullptr);
}

struct GridInfo {
  int blocks;      // the grid: one block an SM, a multiple of KVH
  int per_head;    // blocks a kv head (the attention takes at most 16 of them)
  int per_sm;      // cudaOccupancyMaxActiveBlocksPerMultiprocessor
  int sms;
  int dyn_smem;
  int static_smem;
  int regs;
  int clusters[2];  // cudaOccupancyMaxActiveClusters at 8 and 16 blocks a cluster
};

// How many clusters of `size` blocks of this kernel the card holds at once
// (-1 if it cannot say): the attention stage would take KVH clusters of up
// to 16 blocks, one a kv head, if KVH of them could be co-resident.
int max_active_clusters(const void* fn, int size) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size * 8);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kDynSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess)
    n = -1;
  cudaGetLastError();  // a refused query is an answer here, not an error
  return n;
}

// The grid of this kernel: as many blocks as the card holds at once (one
// an SM: the kernel takes most of an SM's shared memory), rounded down to a
// multiple of KVH so that every kv head has as many. It is launched
// cooperatively, so a grid that could not be all resident (a persistent
// kernel whose blocks are not all resident deadlocks at its first barrier)
// fails to launch instead.
template <typename CacheT, int KG>
cudaError_t grid_for(int KVH, GridInfo* g) {
  const void* fn = (const void*)decode_persistent<CacheT, KG>;
  static const cudaError_t prep =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmem);
  if (prep != cudaSuccess) return prep;
  static int memo_kvh = -1;
  static GridInfo memo;
  if (memo_kvh == KVH) {
    *g = memo;
    return cudaSuccess;
  }
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_persistent<CacheT, KG>,
                                                    kThreads, kDynSmem);
  if (e != cudaSuccess) return e;
  int blocks = per_sm * sms;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  blocks -= blocks % KVH;
  *g = GridInfo{blocks, KVH > 0 ? blocks / KVH : 0, per_sm, sms, kDynSmem,
                (int)fa.sharedSizeBytes, fa.numRegs,
                {max_active_clusters(fn, 8), max_active_clusters(fn, 16)}};
  if (blocks < KVH) return cudaErrorCooperativeLaunchTooLarge;
  memo = *g;
  memo_kvh = KVH;
  return cudaSuccess;
}

template <typename CacheT, int KG>
int launch(const QttsDecoder& d, const QttsStepIO& io, cudaStream_t st, GridInfo* info_only) {
  GridInfo g;
  const cudaError_t ge = grid_for<CacheT, KG>(d.KVH, &g);
  if (info_only != nullptr) {
    *info_only = g;
    return (int)ge;
  }
  if (ge != cudaSuccess) return (int)ge;
  const int nblk = g.blocks, Q = d.HQ * d.D, QKV = Q + 2 * d.KVH * d.D;
  StepParams p;
  // each consumer stages its partials in kStageFloats floats: the
  // attention its kv head's (G + 2) x D columns a split, the norms H + 1
  // rows of H, the SwiGLU 2 (int4: 4) runs of a down item's rows a split
  const int G = d.HQ / d.KVH;
  p.qkv = plan_mat(d.wqkv, d.H, QKV, nblk, kStageFloats / ((G + 2) * d.D), 0);
  // O-proj: a split a kv head's G x D rows (int4: a pair of heads' rows in
  // its halves layout), consumed as soon as the head's attention is done
  p.o = MatPlan{d.wo.w, d.wo.s, d.wo.form, d.wo.ng, Q, d.H,
                (d.wo.form == kFormInt4 ? Q / 2 : Q) / (G * d.D), G * d.D, 1};
  p.down = plan_mat(d.w_down, d.I, d.H, nblk, kStageFloats / d.H - 1, 3);
  p.gu = plan_mat(d.w_gate_up, d.H, 2 * d.I, nblk,
                  kStageFloats / ((d.w_down.form == kFormInt4 ? 4 : 2) * p.down.rows), 2);
  p.head = d.lm_head.w != nullptr ? plan_mat(d.lm_head, d.H, d.V, nblk, kMaxSplit, 4)
                                  : MatPlan{nullptr, nullptr, kFormBf16, 1, d.H, d.V, 1, 0, 4};
  cudaError_t te;
  if ((te = tensor_map(&p.tmap[0], p.qkv, d.L)) != cudaSuccess ||
      (te = tensor_map(&p.tmap[1], p.o, d.L)) != cudaSuccess ||
      (te = tensor_map(&p.tmap[2], p.gu, d.L)) != cudaSuccess ||
      (te = tensor_map(&p.tmap[3], p.down, d.L)) != cudaSuccess ||
      (p.head.w != nullptr && (te = tensor_map(&p.tmap[4], p.head, 1)) != cudaSuccess))
    return (int)te;
  p.input_norm = static_cast<const bf16*>(d.input_norm);
  p.q_norm = static_cast<const bf16*>(d.q_norm);
  p.k_norm = static_cast<const bf16*>(d.k_norm);
  p.post_norm = static_cast<const bf16*>(d.post_norm);
  p.final_norm = static_cast<const bf16*>(d.final_norm);
  p.k_cache = d.k_cache;
  p.v_cache = d.v_cache;
  p.k_scale = d.k_scale;
  p.v_scale = d.v_scale;
  p.L = d.L;
  p.H = d.H;
  p.I = d.I;
  p.HQ = d.HQ;
  p.KVH = d.KVH;
  p.S = d.S;
  p.V = d.V;
  p.eps = d.eps;
  p.x_in = io.x_in;
  p.embed = static_cast<const bf16*>(io.embed);
  p.first_token = io.first_token;
  p.tokens = io.tokens;
  p.num_steps = io.num_steps;
  p.cos_tab = io.cos_tab;
  p.sin_tab = io.sin_tab;
  p.positions = io.positions;
  p.n_sec = io.n_sec;
  p.interleaved = io.interleaved;
  for (int s = 0; s < kQttsMaxSections; ++s) p.sec[s] = io.sec[s];
  p.normed = io.normed;
  p.logits = io.logits;
  workspace_bytes(d.H, d.I, d.HQ, d.KVH, d.D, d.V, &p.ws, static_cast<char*>(io.workspace));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kDynSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_persistent<CacheT, KG>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernel for this decoder's cache type and q heads per kv head.
int dispatch(const QttsDecoder& d, const QttsStepIO& io, cudaStream_t st, GridInfo* info_only) {
  const int G = d.HQ / d.KVH;
  if (d.k_scale != nullptr) {
    if (G == 1) return launch<int8_t, 1>(d, io, st, info_only);
    if (G == 2) return launch<int8_t, 2>(d, io, st, info_only);
    return launch<int8_t, kAttnMaxG>(d, io, st, info_only);
  }
  if (G == 1) return launch<bf16, 1>(d, io, st, info_only);
  if (G == 2) return launch<bf16, 2>(d, io, st, info_only);
  return launch<bf16, kAttnMaxG>(d, io, st, info_only);
}

}  // namespace

int qtts_run_steps(const QttsDecoder& d, const QttsStepIO& io, cudaStream_t st) {
  if (!decoder_ok(d) || io.num_steps <= 0 || io.n_sec < 0 || io.n_sec > kQttsMaxSections ||
      io.positions == nullptr || io.workspace == nullptr || io.cos_tab == nullptr ||
      io.sin_tab == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch(d, io, st, nullptr);
}

extern "C" {

// Bytes of scratch qtts_decode_step and qtts_generate need for these
// widths (zero it once before first use).
long long qtts_workspace_bytes(int H, int I, int HQ, int KVH, int D, int V) {
  return (long long)workspace_bytes(H, I, HQ, KVH, D, V, nullptr, nullptr);
}

// Byte offset in the workspace of the decode kernel's launch count (an
// unsigned 64-bit word that block 0 of every launch adds one to).
long long qtts_launch_count_offset() { return (long long)launches_offset(); }

// Byte offset in the workspace of the stage timers (kTimerWords unsigned
// 64-bit words: ns per stage summed over launches by block 0, the
// launches and the steps, then block 0's own work and the slowest block's
// per stage, a scratch word per stage, and block 0's norm per stage), or
// -1 when built without -DQTTS_STAGE_TIMERS.
long long qtts_stage_timers_offset() {
#ifdef QTTS_STAGE_TIMERS
  return (long long)timers_offset();
#else
  return -1;
#endif
}

// The persistent grid of this decoder's kernel: out[0] blocks, out[1]
// blocks a kv head, out[2] cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// out[3] SMs, out[4] dynamic and out[5] static shared memory bytes a
// block, out[6] registers a thread, out[7] and out[8]
// cudaOccupancyMaxActiveClusters with clusters of 8 and of 16 blocks (-1:
// refused). Returns 0, or the error the launch would return (out is filled
// either way).
int qtts_launch_info(const QttsDecoder* dec, int* out) {
  if (!decoder_ok(*dec)) return (int)cudaErrorInvalidValue;
  GridInfo g{};
  const int e = dispatch(*dec, QttsStepIO{}, nullptr, &g);
  const int vals[9] = {g.blocks, g.per_head, g.per_sm, g.sms, g.dyn_smem, g.static_smem,
                       g.regs, g.clusters[0], g.clusters[1]};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return e;
}

// dst[0:n] = vals[0:n] (host ints) on `stream`, one small launch: how the
// caller sets a positions array that the kernels did not advance to the
// values it needs.
int qtts_set_positions(void* dst, int n, const int* vals, void* stream) {
  if (n < 1 || n > 1 + kQttsMaxSections) return (int)cudaErrorInvalidValue;
  IntRow row{};
  for (int i = 0; i < n; ++i) row.v[i] = vals[i];
  set_ints<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(static_cast<int*>(dst), n,
                                                                  row);
  return (int)cudaGetLastError();
}

// One decode step of the decoder `dec` (device pointers, see QttsDecoder)
// from the f32 embedding [H], at the cache row and M-RoPE positions in
// `positions` (device int32 [1 + n_sec], advanced by one), with the f32
// rope tables [rows, D/2] and the sections `sec` (n_sec host ints,
// interleaved or chunked; n_sec == 0: standard RoPE). Writes the cache
// row, the f32 outputs normed [H] and, when dec->lm_head.w is set, logits
// [V] (logits must then be set, and null otherwise). Returns 0 or the first
// CUDA error.
int qtts_decode_step(const QttsDecoder* dec, const void* embed, const void* cos_tab,
                     const void* sin_tab, void* positions, int n_sec, int interleaved,
                     const int* sec, void* normed, void* logits, void* workspace, void* stream) {
  if ((dec->lm_head.w == nullptr) != (logits == nullptr) || n_sec < 0 ||
      n_sec > kQttsMaxSections)
    return (int)cudaErrorInvalidValue;
  QttsStepIO io{};
  io.x_in = static_cast<const float*>(embed);
  io.num_steps = 1;
  io.cos_tab = static_cast<const float*>(cos_tab);
  io.sin_tab = static_cast<const float*>(sin_tab);
  io.positions = static_cast<int*>(positions);
  io.n_sec = n_sec;
  io.interleaved = interleaved;
  for (int s = 0; s < n_sec; ++s) io.sec[s] = sec[s];
  io.normed = static_cast<float*>(normed);
  io.logits = static_cast<float*>(logits);
  io.workspace = workspace;
  if (io.x_in == nullptr || io.normed == nullptr) return (int)cudaErrorInvalidValue;
  return qtts_run_steps(*dec, io, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"

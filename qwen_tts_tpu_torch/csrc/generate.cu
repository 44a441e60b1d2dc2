// N greedy bf16 decode steps of the talker in one call, with the next
// token fed back on the device, for sm_90a.
//
// Replaces the Pallas TPU kernel qwen_tts_tpu/ops/generate_kernel.py
// ::_gen_kernel (:52; pallas_call :709 in _generate_impl :514, wrapper
// generate_megakernel :769) for bf16 weights and a bf16 KV cache. Per step
// n, at cache row pos0 + n:
//   1. rope_row builds the step's cos/sin row from the tables: section s of
//      the rotary frequency indices reads row pos0 + n + delta[s] (M-RoPE;
//      equal deltas give standard RoPE);
//   2. the decode step of decode_layer.cuh (the same code as
//      qtts_decode_step, so the same bits): L layers, the new K/V column
//      written into the cache at its row, final RMSNorm, LM head;
//   3. argmax_embed takes the argmax of the V logits (lowest index wins a
//      tie, as torch.argmax and jnp.argmax do), writes tokens[n] and loads
//      embed[token] as the f32 input of step n + 1.
// Step 0's input is embed[first_token]. The host knows every position, so
// it enqueues all N steps on the caller's stream at once; only the token
// lives on the device, and nothing waits for the host between steps (the
// design of the reference CUDA generate_nosync: N back-to-back steps with
// on-device token feedback). The Pallas kernel's VMEM tail ring, aligned
// flushes and one-hot embedding gather are TPU lowering rules and are not
// carried over: the cache row is written at its position directly.
//
// What bounds it on an H100: weight bytes, N x 0.887 GB for the talker.
// Step n + 1 needs step n's token, and 0.887 GB of weights do not fit the
// 50 MB L2, so every step streams them again: N x 0.265 ms at 3.35 TB/s,
// at most ~3,770 tokens/s. Fusing the N steps into one persistent launch
// is later work; this version enqueues ~230 small launches a step.

#include "decode_layer.cuh"

#include <limits.h>

namespace {

constexpr int kMaxSections = 4;
constexpr int kArgmaxThreads = 1024;

// Which table row each rotary frequency index reads: section s reads row
// pos + delta[s], with the interleaved layout of the released talker
// (models/decoder.py::mrope_section_masks): index j is in section s >= 1
// iff j % n == s and j < n * sec[s], else in section 0. n_sec <= 1 is
// standard RoPE.
struct RopeSpec {
  int n_sec;
  int sec[kMaxSections];
  int delta[kMaxSections];
};

__global__ void rope_row(const float* __restrict__ cos_tab,
                         const float* __restrict__ sin_tab, int d2, int pos,
                         RopeSpec rs, float* __restrict__ cos_out,
                         float* __restrict__ sin_out) {
  const int j = threadIdx.x;
  if (j >= d2) return;
  int s = 0;
  for (int si = 1; si < rs.n_sec; ++si)
    if (j % rs.n_sec == si && j < rs.n_sec * rs.sec[si]) s = si;
  const size_t row = (size_t)(pos + rs.delta[s]);
  cos_out[j] = cos_tab[row * d2 + j];
  sin_out[j] = sin_tab[row * d2 + j];
}

// x[i] = f32(embed[*token][i]).
__global__ void embed_row(const bf16* __restrict__ embed, const int* __restrict__ token,
                          int H, float* __restrict__ x) {
  const size_t base = (size_t)token[0] * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x)
    x[i] = __bfloat162float(embed[base + i]);
}

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// One block: token = argmax(logits[0:V]), lowest index on a tie;
// *token_out = token; when x_next is set, x_next[i] = f32(embed[token][i]).
__global__ void __launch_bounds__(kArgmaxThreads)
argmax_embed(const float* __restrict__ logits, int V, const bf16* __restrict__ embed,
             int H, int* __restrict__ token_out, float* __restrict__ x_next) {
  __shared__ float w_v[kArgmaxThreads / 32];
  __shared__ int w_i[kArgmaxThreads / 32];
  __shared__ int s_tok;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = -INFINITY;
  int idx = INT_MAX;
  for (int i = tid; i < V; i += blockDim.x) better(v, idx, logits[i], i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    better(v, idx, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, idx, o));
  if (lane == 0) {
    w_v[warp] = v;
    w_i[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? w_v[lane] : -INFINITY;
    idx = lane < nw ? w_i[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      better(v, idx, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, idx, o));
    if (lane == 0) {
      token_out[0] = idx;
      s_tok = idx;
    }
  }
  __syncthreads();
  if (x_next != nullptr) {
    const size_t base = (size_t)s_tok * H;
    for (int i = tid; i < H; i += blockDim.x) x_next[i] = __bfloat162float(embed[base + i]);
  }
}

struct GenWorkspace {
  Workspace step;
  float* x;       // [H] this step's input row
  float* rope;    // [D] cos row | sin row
  float* normed;  // [H]
  float* logits;  // [V]
};

size_t gen_workspace_bytes(int H, int I, int HQ, int KVH, int D, int V,
                           GenWorkspace* ws, char* base) {
  size_t off = workspace_bytes(H, I, HQ, KVH, D, V, ws ? &ws->step : nullptr, base);
  const size_t x_off = off;  off += align_up((size_t)H * sizeof(float));
  const size_t r_off = off;  off += align_up((size_t)D * sizeof(float));
  const size_t n_off = off;  off += align_up((size_t)H * sizeof(float));
  const size_t l_off = off;  off += align_up((size_t)V * sizeof(float));
  if (ws != nullptr) {
    ws->x = reinterpret_cast<float*>(base + x_off);
    ws->rope = reinterpret_cast<float*>(base + r_off);
    ws->normed = reinterpret_cast<float*>(base + n_off);
    ws->logits = reinterpret_cast<float*>(base + l_off);
  }
  return off;
}

}  // namespace

extern "C" {

// Bytes of scratch qtts_generate needs for these widths.
long long qtts_generate_workspace_bytes(int H, int I, int HQ, int KVH, int D, int V) {
  return (long long)gen_workspace_bytes(H, I, HQ, KVH, D, V, nullptr, nullptr);
}

// num_steps greedy steps from first_token (int32 [1], device) at cache
// rows pos0 .. pos0 + num_steps - 1. Weights as qtts_decode_step, plus the
// bf16 embedding table [V, H] and the f32 rope tables [rope_rows, D/2].
// tokens: int32 [num_steps], device. sec / delta: host arrays of n_sec
// ints, the interleaved M-RoPE sections and their position offsets
// (n_sec <= 4; n_sec <= 1 for standard RoPE). Returns 0 or the first
// CUDA error; launches on `stream` and does not synchronise.
int qtts_generate(const void* first_token, const void* embed, const void* input_norm,
                  const void* wqkv, const void* q_norm, const void* k_norm,
                  const void* wo, const void* post_norm, const void* w_gate_up,
                  const void* w_down, const void* final_norm, const void* lm_head,
                  const void* cos_tab, const void* sin_tab, int rope_rows,
                  void* k_cache, void* v_cache, void* tokens, void* workspace,
                  int L, int H, int I, int HQ, int KVH, int D, int S, int V,
                  int pos0, int num_steps, float eps, int n_sec, const int* sec,
                  const int* delta, void* stream) {
  const StepDims dims{L, H, I, HQ, KVH, D, S, V, eps};
  if (num_steps <= 0 || !dims_ok(dims, pos0) || pos0 + num_steps > S ||
      n_sec < 0 || n_sec > kMaxSections || lm_head == nullptr)
    return (int)cudaErrorInvalidValue;
  RopeSpec rs{n_sec > 1 ? n_sec : 1, {0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int s = 0; s < n_sec && n_sec > 1; ++s) {
    rs.sec[s] = sec[s];
    rs.delta[s] = delta[s];
  }
  for (int s = 0; s < rs.n_sec; ++s)
    if (pos0 + rs.delta[s] < 0 || pos0 + num_steps - 1 + rs.delta[s] >= rope_rows)
      return (int)cudaErrorInvalidValue;

  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  GenWorkspace ws;
  gen_workspace_bytes(H, I, HQ, KVH, D, V, &ws, reinterpret_cast<char*>(workspace));
  const StepWeights w{
      reinterpret_cast<const bf16*>(input_norm), reinterpret_cast<const bf16*>(wqkv),
      reinterpret_cast<const bf16*>(q_norm),     reinterpret_cast<const bf16*>(k_norm),
      reinterpret_cast<const bf16*>(wo),         reinterpret_cast<const bf16*>(post_norm),
      reinterpret_cast<const bf16*>(w_gate_up),  reinterpret_cast<const bf16*>(w_down),
      reinterpret_cast<const bf16*>(final_norm), reinterpret_cast<const bf16*>(lm_head)};
  const bf16* emb = reinterpret_cast<const bf16*>(embed);
  int* toks = reinterpret_cast<int*>(tokens);
  const int d2 = D / 2;

  embed_row<<<1, 256, 0, st>>>(emb, reinterpret_cast<const int*>(first_token), H, ws.x);
  for (int n = 0; n < num_steps; ++n) {
    const int pos = pos0 + n;
    rope_row<<<1, d2, 0, st>>>(reinterpret_cast<const float*>(cos_tab),
                               reinterpret_cast<const float*>(sin_tab), d2, pos, rs,
                               ws.rope, ws.rope + d2);
    const int err = enqueue_step(w, dims, ws.x, ws.rope, ws.rope + d2,
                                 reinterpret_cast<bf16*>(k_cache),
                                 reinterpret_cast<bf16*>(v_cache), ws.normed, ws.logits,
                                 ws.step, pos, st);
    if (err != 0) return err;
    argmax_embed<<<1, kArgmaxThreads, 0, st>>>(ws.logits, V, emb, H, toks + n,
                                               n + 1 < num_steps ? ws.x : nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// K1: fused traversal step (filter program + squared L2 + top-M queue merge
// + top-K result merge + per-clause counts), one thread block per query lane.
//
// Replaces the TPU kernel repro/kernels/fused_step.py::_fused_step_kernel
// with its tail _merge_core, _program_valid_kernel and
// kernels/topk.py::bitonic_topm. Wrapper and plain version:
// repro_torch/kernels/fused_step.py.
//
// What bounds it on an H100: bytes. A step reads the gathered rows
// x [B, R, d] f32 once (B*R*d*4 bytes, 6.3 MB at B=64, R=32, d=768) plus
// the lane's buffers; the arithmetic is ~2*R*d flops per lane. The design
// reads every gathered row exactly once, with one warp per row and
// neighbouring lanes on neighbouring addresses; everything else (program
// evaluation, both merges) stays in shared memory and writes only the
// merged buffers, the valid mask and four counters.
//
// The per-lane building blocks (query norm, one-warp row distance, filter
// program, bitonic merges) live in step_common.cuh, shared with K5 and K6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using step::kClauseSlots;
using step::kThreads;
using step::kWarps;

struct StepArgs {
  const float* q;          // [B, D]
  const float* x;          // [B, R, D]
  const int* nb;           // [B, R]
  const uint8_t* is_new;   // [B, R] bool
  const int* labels;       // [B, R, W] (uint32 bit patterns)
  const float* values;     // [B, R, V]
  step::Program prog;      // leaves [B, S, ...]
  const float* cand_dist;  // [B, M]
  const int* cand_pay;     // [B, M]
  const float* res_dist;   // [B, K]
  const int* res_idx;      // [B, K]
  float* out_cand_dist;    // [B, M]
  int* out_cand_pay;       // [B, M]
  float* out_res_dist;     // [B, K]
  int* out_res_idx;        // [B, K]
  uint8_t* out_valid;      // [B, R] bool
  int* out_counts;         // [B, 4]
  int R, D, M, K, wq, wr, pre;
};

__global__ void __launch_bounds__(kThreads) fused_step_kernel(StepArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wmax = a.wq > a.wr ? a.wq : a.wr;
  const int W = a.prog.W, V = a.prog.V;
  float* qs = smem;                          // [D]
  float* dist = qs + a.D;                    // [R]
  int* vld = reinterpret_cast<int*>(dist + a.R);   // [R]
  int* dmask = vld + a.R;                    // [R]
  float* key = reinterpret_cast<float*>(dmask + a.R);  // [wmax]
  int* pos = reinterpret_cast<int*>(key + wmax);        // [wmax]
  int* cnt = pos + wmax;                     // [4]
  float* red = reinterpret_cast<float*>(cnt + kClauseSlots);  // [kWarps + 1]

  // ---- query row and its squared norm ----
  if (tid < kClauseSlots) cnt[tid] = 0;
  const float qn = step::query_sqnorm(a.q + (size_t)b * a.D, qs, a.D, red);

  // ---- squared L2 to the R gathered rows: one warp per row ----
  for (int r = warp; r < a.R; r += kWarps) {
    const float d = step::row_sqdist(
        qs, a.x + ((size_t)b * a.R + r) * a.D, a.D, qn, lane);
    if (lane == 0) dist[r] = d;
  }

  // ---- filter program, one thread per gathered neighbor ----
  for (int r = tid; r < a.R; r += kThreads) {
    uint32_t sat = 0u;
    bool valid = step::program_eval(
        a.prog, b, a.labels + ((size_t)b * a.R + r) * W,
        a.values + ((size_t)b * a.R + r) * V, &sat);
    const bool is_new = a.is_new[(size_t)b * a.R + r] != 0;
    valid = valid && is_new;
    const int nc = a.prog.S < kClauseSlots ? a.prog.S : kClauseSlots;
    for (int c = 0; c < nc; ++c)
      if (is_new && ((sat >> c) & 1u)) atomicAdd(&cnt[c], 1);
    vld[r] = valid;
    dmask[r] = a.pre ? valid : is_new;
  }
  __syncthreads();

  const int* nb = a.nb + (size_t)b * a.R;
  // ---- candidate queue: best M of [old | new] ----
  step::queue_merge(a.cand_dist + (size_t)b * a.M, a.cand_pay + (size_t)b * a.M,
                    dist, dmask, vld, nb, a.M, a.R, a.wq, key, pos,
                    a.out_cand_dist + (size_t)b * a.M,
                    a.out_cand_pay + (size_t)b * a.M);
  // ---- result set: best K of [old | new valid] ----
  step::result_merge(a.res_dist + (size_t)b * a.K, a.res_idx + (size_t)b * a.K,
                     dist, dmask, vld, nb, a.K, a.R, a.wr, key, pos,
                     a.out_res_dist + (size_t)b * a.K,
                     a.out_res_idx + (size_t)b * a.K);

  for (int r = tid; r < a.R; r += kThreads)
    a.out_valid[(size_t)b * a.R + r] = (uint8_t)vld[r];
  if (tid < kClauseSlots) a.out_counts[b * kClauseSlots + tid] = cnt[tid];
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these widths, in bytes.
size_t fused_step_smem_bytes(int R, int D, int wq, int wr) {
  const int wmax = wq > wr ? wq : wr;
  return sizeof(float) * ((size_t)D + 3 * (size_t)R + 2 * (size_t)wmax +
                          kClauseSlots + kWarps + 1);
}

int fused_step_f32(
    const void* q, const void* x, const void* nb, const void* is_new,
    const void* labels, const void* values,
    const void* kinds, const void* masks, const void* lo, const void* hi,
    const void* vattr, const void* neg, const void* term, const void* active,
    const void* term_active,
    const void* cand_dist, const void* cand_pay, const void* res_dist,
    const void* res_idx,
    void* out_cand_dist, void* out_cand_pay, void* out_res_dist,
    void* out_res_idx, void* out_valid, void* out_counts,
    int B, int R, int D, int M, int K, int W, int V, int S, int T,
    int wq, int wr, int pre, void* stream) {
  StepArgs a;
  a.q = static_cast<const float*>(q);
  a.x = static_cast<const float*>(x);
  a.nb = static_cast<const int*>(nb);
  a.is_new = static_cast<const uint8_t*>(is_new);
  a.labels = static_cast<const int*>(labels);
  a.values = static_cast<const float*>(values);
  a.prog.kinds = static_cast<const int*>(kinds);
  a.prog.masks = static_cast<const int*>(masks);
  a.prog.lo = static_cast<const float*>(lo);
  a.prog.hi = static_cast<const float*>(hi);
  a.prog.vattr = static_cast<const int*>(vattr);
  a.prog.neg = static_cast<const uint8_t*>(neg);
  a.prog.term = static_cast<const int*>(term);
  a.prog.active = static_cast<const uint8_t*>(active);
  a.prog.term_active = static_cast<const uint8_t*>(term_active);
  a.cand_dist = static_cast<const float*>(cand_dist);
  a.cand_pay = static_cast<const int*>(cand_pay);
  a.res_dist = static_cast<const float*>(res_dist);
  a.res_idx = static_cast<const int*>(res_idx);
  a.out_cand_dist = static_cast<float*>(out_cand_dist);
  a.out_cand_pay = static_cast<int*>(out_cand_pay);
  a.out_res_dist = static_cast<float*>(out_res_dist);
  a.out_res_idx = static_cast<int*>(out_res_idx);
  a.out_valid = static_cast<uint8_t*>(out_valid);
  a.out_counts = static_cast<int*>(out_counts);
  a.prog.S = S; a.prog.T = T; a.prog.W = W; a.prog.V = V;
  a.R = R; a.D = D; a.M = M; a.K = K;
  a.wq = wq; a.wr = wr; a.pre = pre;
  const size_t smem = fused_step_smem_bytes(R, D, wq, wr);
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(fused_step_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  fused_step_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* fused_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

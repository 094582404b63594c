// K1: fused traversal step (filter program + squared L2 + top-M queue merge
// + top-K result merge + per-clause counts), one thread block per query lane,
// and its compressed-domain heads K3 (int8 ADC) and K4 (PQ ADC).
//
// Replaces the TPU kernels repro/kernels/fused_step.py::_fused_step_kernel
// (K1), _fused_step_int8_kernel (K3) and _fused_step_pq_kernel (K4), with
// their shared tail _merge_core, _program_valid_kernel and
// kernels/topk.py::bitonic_topm. Wrapper and plain version:
// repro_torch/kernels/fused_step.py. Only the distance head differs between
// the three; the program evaluation and merges are the same code.
//
// What bounds it on an H100: bytes. A K1 step reads the gathered rows
// x [B, R, d] f32 once (B*R*d*4 bytes, 6.3 MB at B=64, R=32, d=768) plus
// the lane's buffers; the arithmetic is ~2*R*d flops per lane. The design
// reads every gathered row exactly once, with one warp per row and
// neighbouring lanes on neighbouring addresses; everything else (program
// evaluation, both merges) stays in shared memory and writes only the
// merged buffers, the valid mask and four counters.
//   The merges are one merge by rank (step_common.cuh::merge_by_rank), not
// the reference's bitonic networks: the old queue's M keys and the old
// result set's K keys are staged in shared memory at the start (2 KB at
// M=512), the R new entries are rank-sorted by warp shuffles, and every
// entry of either run finds its output slot by binary search in the
// other, writing straight to the output tensors. That is one barrier for
// both merges where the 1024- and 64-wide bitonic sorts took 76 barrier
// stages (91 at R'=160, where the result sort is 256 wide). What is left
// on the critical path is the distance head and its barriers, with one
// block per lane on 64 of 132 SMs at B=64.
//   K3 reads the int8 codes [B, R, d] (1.6 MB) once, one warp per row as
// packed 4-byte words into __dp4a, with the quantized query in shared
// memory. K4 reads the uint8 codes [B, R, S·L] and, per row, S·L entries
// of the lane's table lut [S·L, Kc] f32 (576 KB per lane at S·L=576,
// Kc=256: too large for shared memory, so it stays in device memory; 64
// lanes' tables, 37.7 MB, fit the 50 MB L2). Its head is
// step_common.cuh::pq_head, shared with K5's pq branch: the table streams
// into shared memory by bulk copies of 48 rows, two buffers deep, while
// one thread per row sums the previous chunk's lookups in slot order, the
// reference kernels' order, carrying its sum across chunks; so K4 and
// K5's pq branch agree bit for bit. What bounds K4 is that stream into
// one SM and the slot-order sum; its note says more. Shared memory grows
// as R·S·L/4 + 2·48·Kc words (196 KB at R'=160), so K4 also runs at the
// widened frontier. Each head is its own kernel (kHead), so K1's and
// K3's code is compiled apart from K4's.
//
// The per-lane building blocks (query norm, row distances, filter program,
// the merge by rank) live in step_common.cuh, shared with K5 and K6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

extern "C" size_t fused_step_smem_bytes(int prec, int R, int D, int M, int K,
                                        int Kc);

namespace {

using step::kClauseSlots;
using step::kThreads;
using step::kWarps;

constexpr int kF32 = 0, kInt8 = 1, kPQ = 2;  // distance heads

struct StepArgs {
  int prec;                // kF32 (K1) | kInt8 (K3) | kPQ (K4)
  const float* q;          // [B, D] (K1)
  const float* x;          // [B, R, D] (K1)
  const void* codes;       // [B, R, D] int8 (K3) | [B, R, SL=D] uint8 (K4)
  const float* xn;         // [B, R] code norms (K3, K4)
  const int8_t* qq;        // [B, D] quantized query (K3)
  const float* sq;         // [B] its step (K3)
  const float* lut;        // [B, SL, Kc] lookup table (K4)
  const float* qn;         // [B] query norm (K3, K4)
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
  int R, D, M, K, pre;
  int QW, Kc;              // shared-memory words of the head; PQ Kc
};

// One kernel per distance head (kHead: kF32, kInt8 or kPQ), so that each
// head's code is compiled and register-allocated alone.
template <int kHead>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(StepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.prog.W, V = a.prog.V;
  float* qs = smem;  // [QW]: query row | packed qq | PQ head
  float* dist = qs + a.QW;                   // [R]
  int* vld = reinterpret_cast<int*>(dist + a.R);   // [R]
  int* dmask = vld + a.R;                    // [R]
  float* okq = reinterpret_cast<float*>(dmask + a.R);  // [M] old queue keys
  float* okr = okq + a.M;                    // [K] old result keys
  float* nkq = okr + a.K;                    // [R] new keys, sorted
  float* nkr = nkq + a.R;                    // [R]
  int* cnt = reinterpret_cast<int*>(nkr + a.R);        // [4]
  float* red = reinterpret_cast<float*>(cnt + kClauseSlots);  // [kWarps + 1]

  if (tid < kClauseSlots) cnt[tid] = 0;
  // the old keys, for the merge's binary searches (behind the head's
  // barriers)
  for (int i = tid; i < a.M; i += kThreads)
    okq[i] = a.cand_dist[(size_t)b * a.M + i];
  for (int i = tid; i < a.K; i += kThreads)
    okr[i] = a.res_dist[(size_t)b * a.K + i];
  if constexpr (kHead == kF32) {
    // ---- query row and its squared norm; squared L2, one warp per row ----
    const float qn = step::query_sqnorm(a.q + (size_t)b * a.D, qs, a.D, red);
    for (int r = warp; r < a.R; r += kWarps) {
      const float d = step::row_sqdist(
          qs, a.x + ((size_t)b * a.R + r) * a.D, a.D, qn, lane);
      if (lane == 0) dist[r] = d;
    }
  } else if constexpr (kHead == kInt8) {
    // ---- K3: packed query into shared memory; int8 ADC, one warp per row ----
    int* qq4 = reinterpret_cast<int*>(qs);
    const int* src = reinterpret_cast<const int*>(a.qq + (size_t)b * a.D);
    for (int i = tid; i < a.QW; i += kThreads) qq4[i] = src[i];
    __syncthreads();
    const float qn = a.qn[b], sq2 = __fmul_rn(2.f, a.sq[b]);
    const int8_t* codes = static_cast<const int8_t*>(a.codes);
    for (int r = warp; r < a.R; r += kWarps) {
      const size_t row = (size_t)b * a.R + r;
      const float d = step::row_int8_dist(qq4, codes + row * a.D, a.QW, qn,
                                          sq2, a.xn[row], lane);
      if (lane == 0) dist[r] = d;
    }
  } else {
    // ---- K4: PQ ADC, the table streamed by chunks of rows ----
    step::pq_head(dist, qs, a.lut + (size_t)b * a.D * a.Kc, a.Kc,
                  static_cast<const uint8_t*>(a.codes), a.xn, a.D, a.R,
                  nullptr, b * a.R, nullptr, a.qn[b], 0);
  }
  __syncthreads();

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

  // ---- queue: best M of [old | new]; results: best K of [old | new
  // valid] ----
  const size_t bm = (size_t)b * a.M, bk = (size_t)b * a.K;
  step::merge_by_rank(okq, a.cand_pay + bm, okr, a.res_idx + bk, dist, dmask,
                      vld, a.nb + (size_t)b * a.R, a.M, a.K, a.R, nkq, nkr,
                      a.out_cand_dist + bm, a.out_cand_pay + bm,
                      a.out_res_dist + bk, a.out_res_idx + bk);

  for (int r = tid; r < a.R; r += kThreads)
    a.out_valid[(size_t)b * a.R + r] = (uint8_t)vld[r];
  if (tid < kClauseSlots) a.out_counts[b * kClauseSlots + tid] = cnt[tid];
}

template <int kHead>
int launch_head(const StepArgs& a, int B, size_t smem, void* stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(fused_step_kernel<kHead>, opted_in);
  if (err != cudaSuccess) return (int)err;
  fused_step_kernel<kHead>
      <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Shared-memory words of the distance head: the query row (K1), the
// packed int8 query (K3), or step_common.cuh::pq_head_words (K4).
int head_words(int prec, int R, int D, int Kc) {
  return prec == kF32    ? D
         : prec == kInt8 ? D / 4
                         : (int)step::pq_head_words(R, D, Kc);
}

int launch(const StepArgs& a, int B, void* stream) {
  const size_t smem = fused_step_smem_bytes(a.prec, a.R, a.D, a.M, a.K, a.Kc);
  if (a.prec == kF32) return launch_head<kF32>(a, B, smem, stream);
  if (a.prec == kInt8) return launch_head<kInt8>(a, B, smem, stream);
  return launch_head<kPQ>(a, B, smem, stream);
}

// The shared tail of both entry points' pointer lists: nb, is_new, labels,
// values, the 9 program leaves, the 4 buffers and the 6 outputs.
void set_tail(StepArgs& a, void* const* p) {
  int i = 0;
  a.nb = static_cast<const int*>(p[i++]);
  a.is_new = static_cast<const uint8_t*>(p[i++]);
  a.labels = static_cast<const int*>(p[i++]);
  a.values = static_cast<const float*>(p[i++]);
  a.prog.kinds = static_cast<const int*>(p[i++]);
  a.prog.masks = static_cast<const int*>(p[i++]);
  a.prog.lo = static_cast<const float*>(p[i++]);
  a.prog.hi = static_cast<const float*>(p[i++]);
  a.prog.vattr = static_cast<const int*>(p[i++]);
  a.prog.neg = static_cast<const uint8_t*>(p[i++]);
  a.prog.term = static_cast<const int*>(p[i++]);
  a.prog.active = static_cast<const uint8_t*>(p[i++]);
  a.prog.term_active = static_cast<const uint8_t*>(p[i++]);
  a.cand_dist = static_cast<const float*>(p[i++]);
  a.cand_pay = static_cast<const int*>(p[i++]);
  a.res_dist = static_cast<const float*>(p[i++]);
  a.res_idx = static_cast<const int*>(p[i++]);
  a.out_cand_dist = static_cast<float*>(p[i++]);
  a.out_cand_pay = static_cast<int*>(p[i++]);
  a.out_res_dist = static_cast<float*>(p[i++]);
  a.out_res_idx = static_cast<int*>(p[i++]);
  a.out_valid = static_cast<uint8_t*>(p[i++]);
  a.out_counts = static_cast<int*>(p[i++]);
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these widths, in bytes: the
// head (prec: 0 = K1, 1 = K3, 2 = K4; D is d or S·L; Kc for K4), then the
// distances, masks, old keys, sorted new keys, counts and the reduction.
size_t fused_step_smem_bytes(int prec, int R, int D, int M, int K, int Kc) {
  return sizeof(float) * ((size_t)head_words(prec, R, D, Kc) +
                          5 * (size_t)R + (size_t)M +
                          (size_t)K + kClauseSlots + kWarps + 1);
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
    int B, int R, int D, int M, int K, int W, int V, int S, int T, int pre,
    void* stream) {
  StepArgs a = {};
  a.prec = kF32;
  a.q = static_cast<const float*>(q);
  a.x = static_cast<const float*>(x);
  void* const tail[] = {
      const_cast<void*>(nb), const_cast<void*>(is_new),
      const_cast<void*>(labels), const_cast<void*>(values),
      const_cast<void*>(kinds), const_cast<void*>(masks),
      const_cast<void*>(lo), const_cast<void*>(hi), const_cast<void*>(vattr),
      const_cast<void*>(neg), const_cast<void*>(term),
      const_cast<void*>(active), const_cast<void*>(term_active),
      const_cast<void*>(cand_dist), const_cast<void*>(cand_pay),
      const_cast<void*>(res_dist), const_cast<void*>(res_idx),
      out_cand_dist, out_cand_pay, out_res_dist, out_res_idx, out_valid,
      out_counts};
  set_tail(a, tail);
  a.prog.S = S; a.prog.T = T; a.prog.W = W; a.prog.V = V;
  a.R = R; a.D = D; a.M = M; a.K = K; a.pre = pre;
  a.QW = head_words(kF32, R, D, 0);
  return launch(a, B, stream);
}

// K3 / K4. ptrs: codes, xn, qq (K3) | lut (K4), sq (K3; null for K4), qn,
// then the shared tail of set_tail (28 pointers); dims: B, R, D, M, K, W,
// V, S, T, pre, prec (1 = int8, 2 = pq), Kc, where D is d (int8, a
// multiple of 4) or S·L (pq).
int fused_step_quant(void* const* ptrs, const int* dims, void* stream) {
  StepArgs a = {};
  a.codes = ptrs[0];
  a.xn = static_cast<const float*>(ptrs[1]);
  a.qn = static_cast<const float*>(ptrs[4]);
  set_tail(a, ptrs + 5);
  const int B = dims[0];
  a.R = dims[1]; a.D = dims[2]; a.M = dims[3]; a.K = dims[4];
  a.prog.W = dims[5]; a.prog.V = dims[6]; a.prog.S = dims[7];
  a.prog.T = dims[8]; a.pre = dims[9]; a.prec = dims[10]; a.Kc = dims[11];
  if (a.prec == kInt8) {
    a.qq = static_cast<const int8_t*>(ptrs[2]);
    a.sq = static_cast<const float*>(ptrs[3]);
  } else if (a.prec == kPQ) {
    a.lut = static_cast<const float*>(ptrs[2]);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  a.QW = head_words(a.prec, a.R, a.D, a.Kc);
  return launch(a, B, stream);
}

const char* fused_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

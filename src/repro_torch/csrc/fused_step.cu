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
// Merge order: entries sort on the pair (distance, position in
// [old | new | pad]). Positions are distinct, so the bitonic network
// realizes a total order equal to a stable argsort over [old | new] —
// the order the reference's host path and dense backend give, ties
// included (the TPU network has no such tie-break).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kClauseSlots = 4;

struct StepArgs {
  const float* q;          // [B, D]
  const float* x;          // [B, R, D]
  const int* nb;           // [B, R]
  const uint8_t* is_new;   // [B, R] bool
  const int* labels;       // [B, R, W] (uint32 bit patterns)
  const float* values;     // [B, R, V]
  const int* kinds;        // [B, S]
  const int* masks;        // [B, S, W]
  const float* lo;         // [B, S]
  const float* hi;         // [B, S]
  const int* vattr;        // [B, S]
  const uint8_t* neg;      // [B, S] bool
  const int* term;         // [B, S]
  const uint8_t* active;   // [B, S] bool
  const uint8_t* term_active;  // [B, T] bool
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
  int R, D, M, K, W, V, S, T, wq, wr, pre;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Ascending bitonic sort of distinct (key, pos) pairs; width is a power of 2.
__device__ void bitonic_sort(float* key, int* pos, int width) {
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < width; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const float ka = key[i], kb = key[p];
          const int pa = pos[i], pb = pos[p];
          const bool greater = ka > kb || (ka == kb && pa > pb);
          if (greater == ((i & k) == 0)) {
            key[i] = kb; key[p] = ka;
            pos[i] = pb; pos[p] = pa;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads) fused_step_kernel(StepArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wmax = a.wq > a.wr ? a.wq : a.wr;
  float* qs = smem;                          // [D]
  float* dist = qs + a.D;                    // [R]
  int* vld = reinterpret_cast<int*>(dist + a.R);   // [R]
  int* dmask = vld + a.R;                    // [R]
  float* key = reinterpret_cast<float*>(dmask + a.R);  // [wmax]
  int* pos = reinterpret_cast<int*>(key + wmax);        // [wmax]
  int* cnt = pos + wmax;                     // [4]
  float* red = reinterpret_cast<float*>(cnt + kClauseSlots);  // [kWarps + 1]

  // ---- query row and its squared norm ----
  const float* q = a.q + (size_t)b * a.D;
  float part = 0.f;
  for (int i = tid; i < a.D; i += kThreads) {
    const float v = q[i];
    qs[i] = v;
    part += v * v;
  }
  if (tid < kClauseSlots) cnt[tid] = 0;
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    red[kWarps] = s;
  }
  __syncthreads();
  const float qn = red[kWarps];

  // ---- squared L2 to the R gathered rows: one warp per row ----
  for (int r = warp; r < a.R; r += kWarps) {
    const float* xr = a.x + ((size_t)b * a.R + r) * a.D;
    float xx = 0.f, qx = 0.f;
    for (int i = lane; i < a.D; i += 32) {
      const float v = xr[i];
      xx += v * v;
      qx += qs[i] * v;
    }
    xx = warp_sum(xx);
    qx = warp_sum(qx);
    if (lane == 0)
      dist[r] = fmaxf(__fsub_rn(__fadd_rn(qn, xx), __fmul_rn(2.f, qx)), 0.f);
  }

  // ---- filter program, one thread per gathered neighbor ----
  for (int r = tid; r < a.R; r += kThreads) {
    const int* lab = a.labels + ((size_t)b * a.R + r) * a.W;
    const float* val = a.values + ((size_t)b * a.R + r) * a.V;
    uint32_t sat = 0u, fail = 0u;
    for (int s = 0; s < a.S; ++s) {
      const int so = b * a.S + s;
      const int* m = a.masks + (size_t)so * a.W;
      bool contain = true, equal = true, any = false;
      for (int w = 0; w < a.W; ++w) {
        const int l = lab[w], mm = m[w], inter = l & mm;
        contain = contain && inter == mm;
        equal = equal && l == mm;
        any = any || inter != 0;
      }
      int ch = a.vattr[so];
      ch = ch < 0 ? 0 : (ch > a.V - 1 ? a.V - 1 : ch);
      const float vs = val[ch];
      const bool in_range = vs >= a.lo[so] && vs <= a.hi[so];
      const int kind = a.kinds[so];
      const bool prim = kind == 0 ? contain : kind == 1 ? equal
                      : kind == 2 ? in_range : any;
      const bool lit = prim != (a.neg[so] != 0);
      if (a.active[so]) {
        if (lit) sat |= 1u << s; else fail |= 1u << s;
      }
    }
    bool valid = false;
    for (int t = 0; t < a.T; ++t) {
      if (!a.term_active[b * a.T + t]) continue;
      bool ok = true;
      for (int s = 0; s < a.S; ++s)
        if (((fail >> s) & 1u) && a.term[b * a.S + s] == t) ok = false;
      valid = valid || ok;
    }
    const bool is_new = a.is_new[(size_t)b * a.R + r] != 0;
    valid = valid && is_new;
    const int nc = a.S < kClauseSlots ? a.S : kClauseSlots;
    for (int c = 0; c < nc; ++c)
      if (is_new && ((sat >> c) & 1u)) atomicAdd(&cnt[c], 1);
    vld[r] = valid;
    dmask[r] = a.pre ? valid : is_new;
  }
  __syncthreads();

  const int* nb = a.nb + (size_t)b * a.R;

  // ---- candidate queue: best M of [old | new] ----
  const float* cd = a.cand_dist + (size_t)b * a.M;
  for (int i = tid; i < a.wq; i += kThreads) {
    float k = inf_f();
    if (i < a.M) k = cd[i];
    else if (i < a.M + a.R && dmask[i - a.M]) k = dist[i - a.M];
    key[i] = k;
    pos[i] = i;
  }
  __syncthreads();
  bitonic_sort(key, pos, a.wq);
  const int* cp = a.cand_pay + (size_t)b * a.M;
  for (int i = tid; i < a.M; i += kThreads) {
    const int p = pos[i];
    int pay = -1;
    if (p < a.M) pay = cp[p];
    else if (p < a.M + a.R && dmask[p - a.M]) pay = nb[p - a.M] | (vld[p - a.M] << 30);
    a.out_cand_dist[(size_t)b * a.M + i] = key[i];
    a.out_cand_pay[(size_t)b * a.M + i] = pay;
  }
  __syncthreads();

  // ---- result set: best K of [old | new valid] ----
  const float* rd = a.res_dist + (size_t)b * a.K;
  for (int i = tid; i < a.wr; i += kThreads) {
    float k = inf_f();
    if (i < a.K) k = rd[i];
    else if (i < a.K + a.R && vld[i - a.K] && dmask[i - a.K]) k = dist[i - a.K];
    key[i] = k;
    pos[i] = i;
  }
  __syncthreads();
  bitonic_sort(key, pos, a.wr);
  const int* ri = a.res_idx + (size_t)b * a.K;
  for (int i = tid; i < a.K; i += kThreads) {
    const int p = pos[i];
    int idx = -1;
    if (p < a.K) idx = ri[p];
    else if (p < a.K + a.R && vld[p - a.K] && dmask[p - a.K]) idx = nb[p - a.K];
    a.out_res_dist[(size_t)b * a.K + i] = key[i];
    a.out_res_idx[(size_t)b * a.K + i] = idx;
  }

  for (int r = tid; r < a.R; r += kThreads)
    a.out_valid[(size_t)b * a.R + r] = (uint8_t)vld[r];
  if (tid < kClauseSlots) a.out_counts[b * kClauseSlots + tid] = cnt[tid];
}

// Opt `kernel` into the device's largest dynamic shared memory, once per
// device and process: the attribute persists, and setting it before every
// launch would add a host call to every lockstep step.
template <typename Kernel>
cudaError_t opt_in_smem_once(Kernel kernel, bool* done, int n_done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < n_done && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < n_done) done[dev] = true;
  return err;
}

constexpr int kMaxDevices = 64;

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
  a.kinds = static_cast<const int*>(kinds);
  a.masks = static_cast<const int*>(masks);
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.vattr = static_cast<const int*>(vattr);
  a.neg = static_cast<const uint8_t*>(neg);
  a.term = static_cast<const int*>(term);
  a.active = static_cast<const uint8_t*>(active);
  a.term_active = static_cast<const uint8_t*>(term_active);
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
  a.R = R; a.D = D; a.M = M; a.K = K; a.W = W; a.V = V; a.S = S; a.T = T;
  a.wq = wq; a.wr = wr; a.pre = pre;
  const size_t smem = fused_step_smem_bytes(R, D, wq, wr);
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err = opt_in_smem_once(fused_step_kernel, opted_in, kMaxDevices);
  if (err != cudaSuccess) return (int)err;
  fused_step_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* fused_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

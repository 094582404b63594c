// Device code shared by the traversal kernels: K1 (fused_step.cu), K5
// (persistent_step.cu) and K6 (sqdist.cu); K2 (gbdt.cu) uses only the
// shared-memory opt-in at the end.
//
// Every kernel that computes a traversal distance calls `query_sqnorm` and
// `row_sqdist` from here with the same block size (kThreads) and the same
// thread-to-element mapping, so K1, K5 and K6 give bitwise-equal distances
// for the same (query, row) pair; the codec distances `row_int8_dist` (K3
// and K5's int8 branch) and `pq_dist_staged` (K4 and K5's pq branch)
// likewise. The merges sort (distance, position in
// [old | new | pad]) pairs; positions are distinct, so the bitonic network
// realizes a total order equal to a stable argsort over [old | new] — the
// order the reference's host path and dense backend give, ties included.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace step {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kClauseSlots = 4;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Copy the query row into shared memory and return its squared norm to
// every thread. `red` holds kWarps + 1 floats. Ends with a barrier.
__device__ __forceinline__ float query_sqnorm(const float* q, float* qs, int D,
                                              float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float part = 0.f;
  for (int i = tid; i < D; i += kThreads) {
    const float v = q[i];
    qs[i] = v;
    part += v * v;
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    red[kWarps] = s;
  }
  __syncthreads();
  return red[kWarps];
}

// Squared L2 between the query (in shared memory, squared norm qn) and one
// row, computed by one warp: max(qn + ‖x‖² − 2 q·x, 0). The value is valid
// on lane 0.
__device__ __forceinline__ float row_sqdist(const float* qs, const float* xr,
                                            int D, float qn, int lane) {
  float xx = 0.f, qx = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = xr[i];
    xx += v * v;
    qx += qs[i] * v;
  }
  xx = warp_sum(xx);
  qx = warp_sum(qx);
  return fmaxf(__fsub_rn(__fadd_rn(qn, xx), __fmul_rn(2.f, qx)), 0.f);
}

// int8 ADC distance between a lane's quantized query (qq4: the int8 query
// packed four to an int, in shared memory, nwords = d / 4 words) and one
// row of int8 codes (4-byte aligned), computed by one warp:
// max((qn + xn) − sq2·dot, 0) with sq2 = 2·sq rounded first, as
// `quant/codecs.py::_int8_assemble`. The dot is __dp4a over packed quads
// and an int32 warp sum: exact in any order (|dot| ≤ 127²·d). The value is
// valid on lane 0.
__device__ __forceinline__ float row_int8_dist(const int* qq4,
                                               const int8_t* codes_row,
                                               int nwords, float qn, float sq2,
                                               float xn, int lane) {
  const int* c4 = reinterpret_cast<const int*>(codes_row);
  int acc = 0;
  for (int i = lane; i < nwords; i += 32) acc = __dp4a(qq4[i], c4[i], acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(sq2, __int2float_rn(acc))),
               0.f);
}

// PQ ADC distance of one row from its staged lookups vals[j] =
// lut[j, code_j] (shared memory), computed by one thread:
// max((qn + xn) − 2·ip, 0) with ip the lookups summed in slot order
// 0..SL−1 — the reference kernels' order.
__device__ __forceinline__ float pq_dist_staged(const float* vals, int SL,
                                                float qn, float xn) {
  float ip = 0.f;
  for (int j = 0; j < SL; ++j) ip = __fadd_rn(ip, vals[j]);
  return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, ip)), 0.f);
}

// Row stride of the staged PQ lookups: odd, so the 32 threads of a warp
// summing 32 rows read 32 different banks.
__device__ __forceinline__ int pq_stage_ld(int SL) { return SL | 1; }

// Stage the table entries the code rows look up, by all threads of the
// block: vals[r · ld + j] = lut[j, code_r[j]] for the rows r < R with
// use[r] set (every row when use is null), ld = pq_stage_ld(SL), row r's
// codes at codes + row · SL with row = rows ? rows[r] : row0 + r. Each
// thread issues kStageLoads code loads, then kStageLoads table loads,
// before it stores, so the loads' latencies overlap. Callers put a
// barrier before reading vals.
constexpr int kStageLoads = 8;

__device__ __forceinline__ void pq_stage(float* vals, const float* lut,
                                         int Kc, const uint8_t* codes, int SL,
                                         int R, const int* rows, int row0,
                                         const int* use) {
  const int total = R * SL, ld = pq_stage_ld(SL);
  for (int base = threadIdx.x; base < total; base += kStageLoads * kThreads) {
    int code[kStageLoads], slot[kStageLoads], dst[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = base + u * kThreads;
      code[u] = -1;
      slot[u] = 0;
      dst[u] = 0;
      if (i < total) {
        const int r = i / SL, j = i - r * SL;
        if (use == nullptr || use[r]) {
          const int row = rows ? rows[r] : row0 + r;
          code[u] = codes[(size_t)row * SL + j];
          slot[u] = j;
          dst[u] = r * ld + j;
        }
      }
    }
    float v[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u)
      v[u] = code[u] >= 0 ? __ldg(lut + (size_t)slot[u] * Kc + code[u]) : 0.f;
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u)
      if (code[u] >= 0) vals[dst[u]] = v[u];
  }
}

// A compiled filter program (`filters/compile.py::FilterProgram`), leaves
// [B, S, ...] with the label masks as uint32 bit patterns.
struct Program {
  const int* kinds;            // [B, S]
  const int* masks;            // [B, S, W]
  const float* lo;             // [B, S]
  const float* hi;             // [B, S]
  const int* vattr;            // [B, S]
  const uint8_t* neg;          // [B, S] bool
  const int* term;             // [B, S]
  const uint8_t* active;       // [B, S] bool
  const uint8_t* term_active;  // [B, T] bool
  int S, T, W, V;
};

// The program on one neighbor's label words `lab` [W] and values `val`
// [V], for lane b: returns whether an active term holds, and the satisfied
// active clause slots as bits in *sat.
__device__ __forceinline__ bool program_eval(const Program& p, int b,
                                             const int* lab, const float* val,
                                             uint32_t* sat) {
  uint32_t s_bits = 0u, fail = 0u;
  for (int s = 0; s < p.S; ++s) {
    const int so = b * p.S + s;
    const int* m = p.masks + (size_t)so * p.W;
    bool contain = true, equal = true, any = false;
    for (int w = 0; w < p.W; ++w) {
      const int l = lab[w], mm = m[w], inter = l & mm;
      contain = contain && inter == mm;
      equal = equal && l == mm;
      any = any || inter != 0;
    }
    int ch = p.vattr[so];
    ch = ch < 0 ? 0 : (ch > p.V - 1 ? p.V - 1 : ch);
    const float vs = val[ch];
    const bool in_range = vs >= p.lo[so] && vs <= p.hi[so];
    const int kind = p.kinds[so];
    const bool prim = kind == 0 ? contain : kind == 1 ? equal
                    : kind == 2 ? in_range : any;
    const bool lit = prim != (p.neg[so] != 0);
    if (p.active[so]) {
      if (lit) s_bits |= 1u << s; else fail |= 1u << s;
    }
  }
  bool valid = false;
  for (int t = 0; t < p.T; ++t) {
    if (!p.term_active[b * p.T + t]) continue;
    bool ok = true;
    for (int s = 0; s < p.S; ++s)
      if (((fail >> s) & 1u) && p.term[b * p.S + s] == t) ok = false;
    valid = valid || ok;
  }
  *sat = s_bits;
  return valid;
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

// Candidate queue: best M of [old (cd, cp) | new], new entries being the
// R neighbors with dmask set (distance dist[r], payload nb | valid << 30).
// wq = next power of 2 ≥ M + R. The outputs must not alias the inputs.
// Starts and ends with the block in step (one barrier after the fill, one
// at the end).
__device__ __forceinline__ void queue_merge(
    const float* cd, const int* cp, const float* dist, const int* dmask,
    const int* vld, const int* nb, int M, int R, int wq, float* key, int* pos,
    float* out_cd, int* out_cp) {
  for (int i = threadIdx.x; i < wq; i += kThreads) {
    float k = inf_f();
    if (i < M) k = cd[i];
    else if (i < M + R && dmask[i - M]) k = dist[i - M];
    key[i] = k;
    pos[i] = i;
  }
  __syncthreads();
  bitonic_sort(key, pos, wq);
  for (int i = threadIdx.x; i < M; i += kThreads) {
    const int p = pos[i];
    int pay = -1;
    if (p < M) pay = cp[p];
    else if (p < M + R && dmask[p - M]) pay = nb[p - M] | (vld[p - M] << 30);
    out_cd[i] = key[i];
    out_cp[i] = pay;
  }
  __syncthreads();
}

// Result set: best K of [old (rd, ri) | new valid], new entries being the
// neighbors with vld and dmask set. wr = next power of 2 ≥ K + R. The
// outputs must not alias the inputs. Ends with a barrier.
__device__ __forceinline__ void result_merge(
    const float* rd, const int* ri, const float* dist, const int* dmask,
    const int* vld, const int* nb, int K, int R, int wr, float* key, int* pos,
    float* out_rd, int* out_ri) {
  for (int i = threadIdx.x; i < wr; i += kThreads) {
    float k = inf_f();
    if (i < K) k = rd[i];
    else if (i < K + R && vld[i - K] && dmask[i - K]) k = dist[i - K];
    key[i] = k;
    pos[i] = i;
  }
  __syncthreads();
  bitonic_sort(key, pos, wr);
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const int p = pos[i];
    int idx = -1;
    if (p < K) idx = ri[p];
    else if (p < K + R && vld[p - K] && dmask[p - K]) idx = nb[p - K];
    out_rd[i] = key[i];
    out_ri[i] = idx;
  }
  __syncthreads();
}

// Opt `kernel` into the device's largest dynamic shared memory, once per
// device and process: the attribute persists, and setting it before every
// launch would add a host call to every launch.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t opt_in_smem_once(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace step

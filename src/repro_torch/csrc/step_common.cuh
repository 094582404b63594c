// Device code shared by the traversal kernels: K1 (fused_step.cu), K5
// (persistent_step.cu) and K6 (sqdist.cu); K2 (gbdt.cu) uses only the
// shared-memory opt-in at the end.
//
// Every kernel that computes a traversal distance calls `query_sqnorm` and
// `row_sqdist` from here with the same block size (kThreads) and the same
// thread-to-element mapping, so K1, K5 and K6 give bitwise-equal distances
// for the same (query, row) pair; the codec distances `row_int8_dist` (K3
// and K5's int8 branch) and `pq_dist_staged` (K4 and K5's pq branch)
// likewise. The merges (`merge_by_rank`) place every entry by its rank in
// the stable argsort order over [old | new] — the order the reference's
// host path and dense backend give, ties included — relying on the old
// queue and result set being sorted ascending, as `SearchState` keeps them.
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

// Number of entries of the ascending run a[0..n) that are < key (strict)
// or <= key (!strict), by binary search.
__device__ __forceinline__ int count_below(const float* a, int n, float key,
                                           bool strict) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = strict ? a[mid] < key : a[mid] <= key;
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Both merges of a step, by rank. Queue: best M of [old (cd, cp) | new],
// the new entries being the R neighbors with key dmask ? dist : inf and
// payload nb | vld << 30. Result set: best K of [old (rd, ri) | new], new
// key vld && dmask ? dist : inf and payload nb. Old entries keep their
// payloads. The output is the stable argsort order over [old | new]
// (kernels/topk.py::merge_stable), ties included.
//
// cd [M] and rd [K] must be sorted ascending and lie in shared memory
// (binary searches run in them); cp and ri may lie anywhere, and so may the
// outputs, which must not alias the inputs. nkq, nkr [R] are shared
// scratch. dist, dmask, vld and nb must be visible to the whole block on
// entry. One barrier inside; none at the end, so a caller that reads the
// outputs or reuses the inputs puts one after.
//
// 1. The new run is sorted by (key, position) through rank counting:
//    warp w owns entries 32w..32w+31, one a lane, and takes the other
//    entries' keys 32 at a time by __shfl_sync (one warp at R=32, five at
//    R'=160). New entry r, of rank s in the new run, goes to
//    s + #{old <= key_r}: old entries win ties. A masked entry's key is
//    inf, so it lands at M (or K) or beyond and is never written.
// 2. After the barrier, old entry i goes to i + #{new < d_i}, searched in
//    the sorted new keys.
// The ranks are a permutation of 0..M+R-1 (0..K+R-1), so every output
// slot below M (K) is written exactly once.
__device__ __forceinline__ void merge_by_rank(
    const float* cd, const int* cp, const float* rd, const int* ri,
    const float* dist, const int* dmask, const int* vld, const int* nb,
    int M, int K, int R, float* nkq, float* nkr, float* out_cd, int* out_cp,
    float* out_rd, int* out_ri) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int base = tid - lane; base < R; base += kThreads) {
    const int r = base + lane;
    const bool qm = r < R && dmask[r] != 0;
    const bool rm = qm && vld[r] != 0;
    const float d = qm ? dist[r] : inf_f();
    const float kq = d, kr = rm ? d : inf_f();
    int sq = 0, sr = 0;
    for (int c = 0; c < R; c += 32) {
      const int j = c + lane;
      float cq = inf_f(), cr = inf_f();
      if (j < R && dmask[j]) {
        cq = dist[j];
        if (vld[j]) cr = cq;
      }
      for (int t = 0; t < 32; ++t) {
        const float oq = __shfl_sync(0xffffffffu, cq, t);
        const float orr = __shfl_sync(0xffffffffu, cr, t);
        const bool first = c + t < r;  // position order among equal keys
        sq += oq < kq || (oq == kq && first);
        sr += orr < kr || (orr == kr && first);
      }
    }
    if (r < R) {
      nkq[sq] = kq;
      nkr[sr] = kr;
    }
    if (qm) {
      const int o = sq + count_below(cd, M, kq, false);
      if (o < M) {
        out_cd[o] = kq;
        out_cp[o] = nb[r] | (vld[r] << 30);
      }
    }
    if (rm) {
      const int o = sr + count_below(rd, K, kr, false);
      if (o < K) {
        out_rd[o] = kr;
        out_ri[o] = nb[r];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < M + K; i += kThreads) {
    if (i < M) {
      const float k = cd[i];
      const int o = i + count_below(nkq, R, k, true);
      if (o < M) {
        out_cd[o] = k;
        out_cp[o] = cp[i];
      }
    } else {
      const int h = i - M;
      const float k = rd[h];
      const int o = h + count_below(nkr, R, k, true);
      if (o < K) {
        out_rd[o] = k;
        out_ri[o] = ri[h];
      }
    }
  }
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

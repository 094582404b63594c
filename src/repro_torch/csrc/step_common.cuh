// Device code shared by the traversal kernels: K1 (fused_step.cu), K5
// (persistent_step.cu) and K6 (sqdist.cu); K2 (gbdt.cu) uses only the
// shared-memory opt-in at the end.
//
// Every kernel that computes a traversal distance calls `query_sqnorm` and
// `row_sqdist` from here with the same block size (kThreads) and the same
// thread-to-element mapping, so K1, K5 and K6 give bitwise-equal distances
// for the same (query, row) pair; the codec distances `row_int8_dist` (K3
// and K5's int8 branch) and `pq_head` (K4 and K5's pq branch) likewise.
// The merges (`merge_by_rank`) place every entry by its rank in the
// stable argsort order over [old | new] — the order the reference's
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

// max(qn + xx − 2·qx, 0), each operation rounded once: the squared L2 of a
// (query, row) pair from the query's squared norm and the warp-summed ‖x‖²
// and q·x. Every float32 traversal distance ends here.
__device__ __forceinline__ float sqdist_of_sums(float qn, float xx, float qx) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, xx), __fmul_rn(2.f, qx)), 0.f);
}

// Squared L2 between the query (in shared memory, squared norm qn) and one
// row, computed by one warp: element i on lane i mod 32 in ascending i
// (`xx += v * v; qx += qs[i] * v`, which nvcc contracts into FMAs), then
// warp_sum. The value is valid on lane 0. K6 (sqdist.cu) keeps the row in
// registers but sums in exactly this order.
__device__ __forceinline__ float row_sqdist(const float* qs, const float* xr,
                                            int D, float qn, int lane) {
  float xx = 0.f, qx = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = xr[i];
    xx += v * v;
    qx += qs[i] * v;
  }
  return sqdist_of_sums(qn, warp_sum(xx), warp_sum(qx));
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

// ---- The PQ ADC head: K4 (fused_step.cu) and K5's pq branch ----
//
// dist[r] = max((qn + xn_r) − 2·ip_r, 0), each operation rounded once, with
// ip_r = ((0 + lut[0, c_r0]) + lut[1, c_r1]) + … + lut[SL−1, c_r,SL−1]
// summed in slot order, the reference kernels' order; so K4 and K5's pq
// branch agree bit for bit, and no staging layout can change a bit.
//
// What bounds it on an H100: bringing the lookups' table entries from the
// lane's table lut [SL, Kc] f32 (576 KB at SL=576, Kc=256: too large for
// shared memory, so it stays in device memory; 64 lanes' tables, 37.7 MB,
// live in the 50 MB L2) into one SM; and the slot-order sum, SL dependent
// adds a row (≈1.2 µs at SL=576), a floor the bits impose. A gather of
// the R·SL entries one by one (4 bytes each, a 32-byte sector fetched) is
// bound by the SM's load path, not by bytes: R=32 rows look up ~30 of a
// table row's 256 entries but touch ~20 of its 32 sectors. The design:
//  1. The table is streamed into shared memory by chunks of kPQChunk slot
//     rows (48 KB at Kc=256), each one bulk copy by the Tensor Memory
//     Accelerator (cp.async.bulk, completion on an mbarrier), so whole
//     lines move and no thread waits on a load; kPQStages buffers, so
//     the next chunk is in flight while one is summed.
//  2. The used rows' codes are copied into shared memory first (16-byte
//     loads where SL is a multiple of 16, behind chunk 0's copy), each row
//     padded to an odd number of words, so that 32 threads reading one
//     word of 32 consecutive rows hit 32 banks.
//  3. One thread a row adds its lookups of a chunk, read from the staged
//     table rows, to its sum carried across chunks, in slot order; a
//     chunk's lookups are loaded ahead of their adds.
// Shared memory grows as R·SL/4 + kPQStages·kPQChunk·Kc words, not as
// R·SL. What is left: the stream, a chunk at a time into one SM, and the
// sum, whose loads wait on random-bank conflicts; one block per lane keeps
// 64 of 132 SMs busy at B=64.
constexpr int kPQChunk = 48;   // table rows a chunk; a multiple of 4
constexpr int kPQStages = 2;   // chunk buffers: chunks in flight + 1
constexpr int kPQBarWords = (2 * kPQStages + 3) & ~3;  // their mbarriers

// Words of one row of codes in shared memory: SL bytes in whole words,
// padded to an odd count.
__host__ __device__ __forceinline__ int pq_code_words(int SL) {
  return ((SL + 3) >> 2) | 1;
}

// Shared-memory words of the head: the buffers' mbarriers, kPQStages
// chunk buffers [kPQChunk][Kc] of table rows, and the codes
// [R][pq_code_words(SL)].
__host__ __device__ __forceinline__ size_t pq_head_words(int R, int SL,
                                                         int Kc) {
  return kPQBarWords + (size_t)kPQStages * kPQChunk * Kc +
         (size_t)R * pq_code_words(SL);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous 4-byte copies into shared memory (cp.async, cached in L1):
// how a table that a bulk copy cannot take (not 16-byte aligned, or S·L·Kc
// not a multiple of 4) comes in.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPQStages − 1 of this thread's copy groups are in
// flight.
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPQStages - 1) : "memory");
}

// An mbarrier whose phases complete on one arrival and its bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`; by one thread. The
// proxy fence orders earlier reads of the buffer before the copy's writes.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for phase `parity` of `bar` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");  // the braces keep the label local to each use
}

// Row r's codes and norm sit at row rows ? rows[r] : row0 + r of codes
// [·, SL] and norms [·]; rows with use[r] == 0 are skipped (every row when
// use is null).
__device__ __forceinline__ size_t pq_row(const int* rows, int row0, int r) {
  return rows ? (size_t)rows[r] : (size_t)(row0 + r);
}

// Step 2: the used rows' codes into cw [R][ld] words, by all threads.
__device__ __forceinline__ void pq_stage_codes(uint32_t* cw, int ld,
                                               const uint8_t* codes, int SL,
                                               int R, const int* rows,
                                               int row0, const int* use) {
  constexpr int kLoads = 8;  // loads a thread has in flight
  if ((SL & 15) == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0) {
    const int per = SL >> 4, total = R * per;  // 16-byte pieces
    for (int base = threadIdx.x; base < total; base += kLoads * kThreads) {
      uint4 v[kLoads];
      int dst[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads;
        dst[u] = -1;
        if (i < total) {
          const int r = i / per, p = i - r * per;
          if (use == nullptr || use[r]) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(
                       codes + pq_row(rows, row0, r) * SL) + p);
            dst[u] = r * ld + 4 * p;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (dst[u] >= 0) {
          cw[dst[u]] = v[u].x;
          cw[dst[u] + 1] = v[u].y;
          cw[dst[u] + 2] = v[u].z;
          cw[dst[u] + 3] = v[u].w;
        }
    }
  } else {  // any SL: byte by byte
    for (int i = threadIdx.x; i < R * SL; i += kThreads) {
      const int r = i / SL, j = i - r * SL;
      if (use == nullptr || use[r])
        reinterpret_cast<uint8_t*>(cw + r * ld)[j] =
            codes[pq_row(rows, row0, r) * SL + j];
    }
  }
}

// Step 1 for one chunk: start copying table rows [j0, j0 + n) into buf,
// by one bulk copy from the block's last thread (`bulk`; a thread that
// sums no row while R < kThreads) or else 4-byte copies by every thread.
__device__ __forceinline__ void pq_table_chunk(float* buf, const float* lut,
                                               int Kc, int j0, int n,
                                               bool bulk, uint64_t* bar) {
  const float* src = lut + (size_t)j0 * Kc;
  if (bulk) {
    if (threadIdx.x == kThreads - 1) bulk_copy(buf, src, n * Kc * 4u, bar);
  } else {
    for (int i = threadIdx.x; i < n * Kc; i += kThreads)
      cp_async4(buf + i, src + i);
  }
  cp_async_commit();
}

// Step 3 for one row and chunk: ip + t[0, c_0] + t[1, c_1] + … over the
// chunk's n slots, in slot order, the codes c_jj read from the row's code
// words w. A full chunk's lookups are all loaded before the first add, so
// the loads (bank conflicts and all: the codes are random) overlap the
// chain of dependent adds.
__device__ __forceinline__ float pq_sum_chunk(float ip, const float* t,
                                              int Kc, const uint32_t* w,
                                              int n) {
  if (n == kPQChunk) {
    uint32_t c4[kPQChunk / 4];
#pragma unroll
    for (int q = 0; q < kPQChunk / 4; ++q) c4[q] = w[q];
    float v[kPQChunk];
#pragma unroll
    for (int jj = 0; jj < kPQChunk; ++jj)
      v[jj] = t[jj * Kc + __byte_perm(c4[jj >> 2], 0u, 0x4440u + (jj & 3))];
#pragma unroll
    for (int jj = 0; jj < kPQChunk; ++jj) ip = __fadd_rn(ip, v[jj]);
  } else {
    for (int jj = 0; jj < n; ++jj)
      ip = __fadd_rn(ip, t[jj * Kc + ((w[jj >> 2] >> (8 * (jj & 3))) & 255u)]);
  }
  return ip;
}

// The head: dist[r] for the used rows r < R, from the lane's table lut
// [SL, Kc], its query norm qn and the rows' codes and norms (`pq_row`).
// `head` is pq_head_words(R, SL, Kc) words of shared memory, 16-byte
// aligned; `nth` counts the heads this block ran before on it (K5 runs one
// a step; each buffer's mbarrier completes one phase a use, so the phase
// to wait for follows from it). Chunk c + kPQStages − 1 is copied while
// chunk c is summed. Every thread of the block calls it;
// dist[r] is written by the thread that summed row r, and the caller puts
// a barrier before reading it, and another between two calls.
__device__ __forceinline__ void pq_head(float* dist, float* head,
                                        const float* lut, int Kc,
                                        const uint8_t* codes,
                                        const float* norms, int SL, int R,
                                        const int* rows, int row0,
                                        const int* use, float qn, int nth) {
  const int tid = threadIdx.x, ld = pq_code_words(SL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(head);  // [kPQStages]
  float* tab = head + kPQBarWords;  // [kPQStages][kPQChunk * Kc]
  const int span = kPQChunk * Kc, nch = (SL + kPQChunk - 1) / kPQChunk;
  uint32_t* cw = reinterpret_cast<uint32_t*>(tab + kPQStages * span);
  // a chunk of table rows is a contiguous, 16-byte aligned range of a
  // multiple of 16 bytes when the lane's table is
  const bool bulk = ((SL * Kc) & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(lut) & 15) == 0;
  if (bulk && nth == 0 && tid == 0) {
    for (int b = 0; b < kPQStages; ++b) mbar_init(&bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // start chunk k's copy into buffer k % kPQStages (an empty copy group
  // past the last chunk)
  auto start = [&](int k) {
    if (k < nch) {
      const int b = k % kPQStages, n = SL - k * kPQChunk;
      pq_table_chunk(tab + b * span, lut, Kc, k * kPQChunk,
                     n < kPQChunk ? n : kPQChunk, bulk, &bar[b]);
    } else {
      cp_async_commit();
    }
  };
  for (int k = 0; k < kPQStages - 1; ++k) start(k);
  // this thread's first row's norm, loaded ahead of the sum
  const bool mine = tid < R && (use == nullptr || use[tid]);
  const float xn0 = mine ? norms[pq_row(rows, row0, tid)] : 0.f;
  pq_stage_codes(cw, ld, codes, SL, R, rows, row0, use);
  for (int r = tid; r < R; r += kThreads) dist[r] = 0.f;
  for (int c = 0; c < nch; ++c) {
    start(c + kPQStages - 1);
    const int b = c % kPQStages;
    if (bulk)  // buffer b's use c / kPQStages of this head, after the
               // (nch − b + kPQStages − 1) / kPQStages uses of each head
      mbar_wait(&bar[b], (nth * ((nch - b + kPQStages - 1) / kPQStages) +
                          c / kPQStages) & 1);
    else
      cp_async_wait_stages();  // this thread's copies of chunk c
    __syncthreads();           // everyone's; and the codes
    const int j0 = c * kPQChunk;
    const int n = SL - j0 < kPQChunk ? SL - j0 : kPQChunk;
    for (int r = tid; r < R; r += kThreads)
      if (use == nullptr || use[r])
        dist[r] = pq_sum_chunk(dist[r], tab + b * span, Kc,
                               cw + r * ld + (j0 >> 2), n);
    if (c + kPQStages < nch) __syncthreads();  // buffer b refills next
  }
  for (int r = tid; r < R; r += kThreads) {
    if (use != nullptr && !use[r]) continue;
    const float xn = r == tid ? xn0 : norms[pq_row(rows, row0, r)];
    dist[r] = fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, dist[r])),
                    0.f);
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

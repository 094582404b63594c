// K6q rows: the compressed squared L2 of (query, row) pairs by row id — the
// quantized scan plan's and the compressed oracle's distance. For lane b and
// position p: out[b, p] = the int8 or PQ ADC distance between lane b's
// prepared query and row ids[b, p] of the code store, +inf where
// mask[b, p] is false (the row is not read), NaN for an unmasked id outside
// [0, N).
//
// It has no TPU kernel to replace: the reference computes the same function
// in jnp over a gathered block of codes (repro/core/plans.py:152-161 for the
// scan, repro/quant/codecs.py::compressed_filtered_topk for the oracle). At
// N=1M that block would be 9.7 GB of PQ codes (12.9 GB int8) at B=64,
// V=2^18, before the widening to int32 or float32. Like K6's row-id variant
// (sqdist.cu), this kernel reads each row by id and builds no block.
// Wrapper and plain version: repro_torch/kernels/quant_rows.py.
//
// Bits. Every pair is computed as the traversal computes it, so a row
// reached by the scan and by traversal gets one distance:
//  - int8 (`rows_int8_kernel`): step_common.cuh::row_int8_dist itself, the
//    function K3 and K5's int8 branch call: __dp4a over packed words and an
//    int32 warp sum (exact in any order), then (qn + xn) − (2·sq)·dot,
//    each operation rounded once, clamped at 0.
//  - PQ (`rows_pq_kernel`): the slot-order sum of step_common.cuh::pq_head
//    (K4 and K5's PQ branch): ip = ((0 + lut[0, c_0]) + lut[1, c_1]) + …,
//    one thread a row, carried from chunk to chunk of the table, then
//    max((qn + xn) − 2·ip, 0), each operation rounded once. A chunk's
//    width changes no bit: the adds run in slot order whatever the cut.
//
// What bounds it on an H100: bytes by the function's count — the codes
// and norms of the unmasked pairs (576–768 B a row) and each PQ lane's
// table once. Under PQ two costs come first: the code bytes arrive as a
// 64-byte piece of each row per table chunk (random 64-byte reads), and
// every pair makes S·L random lookups in a shared-memory table (bank
// conflicts; chip_smoke.py::k6q_bound prints the lookups' floor beside the
// bound, and scripts/pair_kernels.py --ablate times each part alone).
//  - int8: grid (⌈V / 256⌉ tiles, B), 8 warps a block, one row a warp at a
//    time; the quantized query (d/4 words) in shared memory; a row's codes
//    are d/4 consecutive words, read coalesced across the warp.
//  - PQ, three launches. `rows_pq_count` and `rows_pq_compact` (one block
//    a tile of 4096 positions of a lane) list each lane's unmasked
//    positions in position order, by block prefix sums, and write +inf /
//    NaN everywhere else: masked positions cost no work after them.
//    `rows_pq_kernel`, one block an SM, takes an equal share of all
//    lanes' listed rows, so lanes whose pair counts differ by 10^5 still
//    fill the card; a share is cut into work items (lane, ≤ kSegRows
//    rows), and each item streams its lane's 576 KB table once — chunk by
//    chunk of 64 slots, TMA bulk copies two buffers deep, continuing
//    across items — while its rows' partial sums wait in shared memory.
//    A table is read once an item: 6.25% of a full item's code bytes,
//    against once a 1024-position tile before (5.1× the code bytes at
//    the compressed oracle's shape). A warp's
//    lanes load a quarter (16 bytes) of 8 rows' 64-byte pieces a load,
//    two batches of 32 rows ahead, and pass them to the lanes that sum
//    the rows through a swizzled per-warp stage.
// The scan's ids per lane are sorted and unique, so consecutive positions
// read consecutive rows; no bucketing by row is needed (K6 rows buckets
// because a float row is 3 KB and lanes share rows; here a row is read
// once a lane).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "step_common.cuh"

namespace {

using step::kThreads;
using step::kWarps;

constexpr int kInt8Rows = 256;             // rows a tile (int8): 32 a warp
constexpr int kMaxLanes = 65535;           // gridDim.y: lanes a launch (int8)

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// ------------------------------------------------------------ int8 ----
__global__ void __launch_bounds__(kThreads) rows_int8_kernel(
    const int8_t* __restrict__ qq, const float* __restrict__ sq,
    const float* __restrict__ qn, const int8_t* __restrict__ codes,
    const float* __restrict__ norms, const int* __restrict__ ids,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int V, int D,
    int N) {
  extern __shared__ int qq4[];  // [D / 4]: the lane's quantized query
  const int b = blockIdx.y, nw = D >> 2;
  const int* src = reinterpret_cast<const int*>(qq + (size_t)b * D);
  for (int i = threadIdx.x; i < nw; i += kThreads) qq4[i] = src[i];
  __syncthreads();
  const float qnb = qn[b], sq2 = __fmul_rn(2.f, sq[b]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kInt8Rows, p1 = min(p0 + kInt8Rows, V);
  for (int p = p0 + warp; p < p1; p += kWarps) {
    const size_t o = (size_t)b * V + p;
    float d = step::inf_f();
    if (mask[o]) {  // the same for the whole warp
      const int id = ids[o];
      d = (unsigned)id < (unsigned)N
              ? step::row_int8_dist(qq4, codes + (size_t)id * D, nw, qnb, sq2,
                                    norms[id], lane)
              : nan_f();
    }
    if (lane == 0) out[o] = d;
  }
}

// -------------------------------------------------------------- PQ ----
constexpr int kCompactThreads = 256;   // the compaction's blocks
constexpr int kCompactRounds = 4;      // 4 positions a thread a round
constexpr int kCompactPer = 4 * kCompactRounds;              // a thread's
constexpr int kCompactTile = kCompactThreads * kCompactPer;  // a block's
constexpr int kSegThreads = 512;       // the sum: one block an SM
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegSlots = 64;          // table rows a chunk: 64 code bytes
constexpr int kSegStages = 2;          // chunk buffers
constexpr int kSegRows = 16384;        // rows of a work item, at most
// a lane's table stream counted as rows when the blocks' shares are cut:
// an item with few rows cannot hide its table chunks' arrival
constexpr int kSegLaneRows = 256;
constexpr int kStageWords = 32 * kSegSlots / 4;  // a warp's staged codes
// the sum's shared-memory header, in floats: kSegStages mbarriers, the
// block scan's kSegWarps sums and the first lane's place (all in dynamic
// shared memory: static shared memory would lower the opt-in limit)
constexpr int kSegHead = 2 * kSegStages + 2 * kSegWarps + 4;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Inclusive sum of v over the block's threads (kW warps, all calling);
// *total gets the block's sum. `sh` holds kW values. Ends with a barrier.
template <typename T, int kW>
__device__ __forceinline__ T block_scan(T v, T* sh, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T x = lane < kW ? sh[lane] : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T t = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += t;
    }
    if (lane < kW) sh[lane] = x;
  }
  __syncthreads();
  const T out = v + (warp ? sh[warp - 1] : T(0));
  *total = sh[kW - 1];
  __syncthreads();
  return out;
}

// One thread's kCompactPer positions of a tile from p0: p0 + 4·256·q + 4t
// + i for round q and i < 4 (thread t; a warp's 4 positions a lane of one
// round are contiguous). Returns which are unmasked (bit 4q + i), and in
// idv their ids, −1 for an id outside [0, N); with `write`, out gets
// +inf where masked (and at an unmasked row, until the sum writes it) and
// NaN at an unmasked id outside [0, N). With `vec` (V a multiple of 4,
// ids and out 16-byte aligned, mask 4-byte aligned) a round moves in one
// 4-byte mask load, one 16-byte id load and one 16-byte store a thread;
// every index is a constant, so idv stays in registers. Without `ids`,
// only the mask is read.
__device__ __forceinline__ uint32_t compact_read(
    const int* __restrict__ ids, const uint8_t* __restrict__ mask,
    float* __restrict__ out, size_t o, int p0, int V, int N, bool vec,
    bool write, int (&idv)[kCompactPer]) {
  uint32_t valid = 0u;
#pragma unroll
  for (int q = 0; q < kCompactRounds; ++q) {
    const int p = p0 + 4 * (kCompactThreads * q + threadIdx.x);
    if (vec) {
      uint32_t mw = 0u;
      int4 iv = make_int4(0, 0, 0, 0);
      if (p < V) {
        mw = *reinterpret_cast<const uint32_t*>(mask + o + p);
        if (mw && ids) iv = __ldg(reinterpret_cast<const int4*>(ids + o + p));
      }
      const int e[4] = {iv.x, iv.y, iv.z, iv.w};
      float f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool on = (mw >> (8 * i)) & 0xffu;
        const bool ok = (unsigned)e[i] < (unsigned)N;
        idv[4 * q + i] = ok ? e[i] : -1;
        valid |= (uint32_t)on << (4 * q + i);
        f[i] = on && !ok ? nan_f() : step::inf_f();
      }
      if (write && p < V)
        *reinterpret_cast<float4*>(out + o + p) =
            make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        idv[4 * q + i] = 0;
        if (p + i < V) {
          const size_t at = o + p + i;
          const bool on = mask[at] != 0;
          const int e = on && ids ? ids[at] : 0;
          const bool ok = (unsigned)e < (unsigned)N;
          idv[4 * q + i] = ok ? e : -1;
          valid |= (uint32_t)on << (4 * q + i);
          if (write) out[at] = on && !ok ? nan_f() : step::inf_f();
        }
      }
    }
  }
  return valid;
}

__device__ __forceinline__ bool compact_vec(const int* ids,
                                            const uint8_t* mask,
                                            const float* out, int V) {
  return V % 4 == 0 && aligned16(ids) && aligned16(out) &&
         (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
}

// The compaction, in two launches over tiles of kCompactTile positions
// (block blockIdx.x = lane · tiles + tile): `rows_pq_count` counts each
// tile's unmasked positions into tcnt, from the mask alone;
// `rows_pq_compact` lists them in position order — cid [k] their ids (−1
// for an id outside [0, N), whose NaN it writes itself), pos [k] their
// positions — from the sum of
// the lane's earlier tiles' counts: a round's rows after the tile's
// earlier rounds' and, within a round, after the threads' before it (one
// block prefix sum of the four rounds' counts, packed 16 bits each).
// It writes out at every other position, and the lane's last tile
// writes the lane's count cnt[b].
__global__ void __launch_bounds__(kCompactThreads) rows_pq_count(
    const int* __restrict__ ids, const uint8_t* __restrict__ mask,
    int* __restrict__ tcnt, int V, int N, int tiles) {
  __shared__ int sh[kCompactThreads / 32];
  const int b = blockIdx.x / tiles, tile = blockIdx.x - b * tiles;
  int idv[kCompactPer];
  const uint32_t valid = compact_read(
      nullptr, mask, nullptr, (size_t)b * V, tile * kCompactTile, V, N,
      compact_vec(nullptr, mask, nullptr, V), false, idv);
  int total;
  block_scan<int, kCompactThreads / 32>(__popc(valid), sh, &total);
  if (threadIdx.x == 0) tcnt[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kCompactThreads) rows_pq_compact(
    const int* __restrict__ ids, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int* __restrict__ cid, int* __restrict__ pos,
    const int* __restrict__ tcnt, int* __restrict__ cnt, int V, int N,
    int tiles) {
  __shared__ unsigned long long sh[kCompactThreads / 32];
  const int b = blockIdx.x / tiles, tile = blockIdx.x - b * tiles;
  const int tid = threadIdx.x;
  const size_t o = (size_t)b * V;
  // the lane's earlier tiles' rows
  unsigned long long before = 0, base;
  for (int t = tid; t < tile; t += kCompactThreads)
    before += tcnt[(size_t)b * tiles + t];
  block_scan<unsigned long long, kCompactThreads / 32>(before, sh, &base);
  const int p0 = tile * kCompactTile;
  int idv[kCompactPer];
  const uint32_t valid = compact_read(ids, mask, out, o, p0, V, N,
                                      compact_vec(ids, mask, out, V), true,
                                      idv);
  unsigned long long mine = 0, total;  // round q's count in bits 16q..
#pragma unroll
  for (int q = 0; q < kCompactRounds; ++q)
    mine |= (unsigned long long)__popc((valid >> (4 * q)) & 15u) << (16 * q);
  const unsigned long long excl =
      block_scan<unsigned long long, kCompactThreads / 32>(mine, sh,
                                                           &total) - mine;
  int at0 = (int)base;
#pragma unroll
  for (int q = 0; q < kCompactRounds; ++q) {
    int at = at0 + (int)((excl >> (16 * q)) & 0xffffu);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((valid >> (4 * q + i)) & 1u) {
        cid[o + at] = idv[4 * q + i];
        pos[o + at] = p0 + 4 * (kCompactThreads * q + tid) + i;
        ++at;
      }
    at0 += (int)((total >> (16 * q)) & 0xffffu);
  }
  if (tile == tiles - 1 && tid == 0) cnt[b] = at0;
}

// A lane's weight in the blocks' shares: its listed rows, and
// kSegLaneRows for its table when it has any.
__device__ __forceinline__ long long lane_weight(int n) {
  return n ? (long long)n + kSegLaneRows : 0;
}

// The work items of one block, in order (every thread walks them alike):
// the lanes laid end to end by weight (`lane_weight`: kSegLaneRows, then
// the lane's listed (unmasked) positions), the block's share [start, end)
// of them cut at lane boundaries into pieces of rows, and each piece into
// ⌈rows / kSegRows⌉ near-equal parts. quant_rows.py::pq_work_items lists
// the same items.
struct Walk {
  const int* cnt;
  int B, lane;           // the next lane to look at
  long long off;         // its place by weight
  long long start, end;  // the block's share
  int pl, plo, plen;     // the current piece: lane, first row, rows
  int part, parts;

  __device__ __forceinline__ bool next(int* l, int* k0, int* k1) {
    while (part == parts) {
      if (lane >= B || off >= end) return false;
      const int n = cnt[lane];
      const long long r0 = off + kSegLaneRows;  // its rows' place
      const long long lo = r0 > start ? r0 : start;
      const long long hi = r0 + n < end ? r0 + n : end;
      if (hi > lo) {
        pl = lane;
        plo = (int)(lo - r0);
        plen = (int)(hi - lo);
        part = 0;
        parts = (plen + kSegRows - 1) / kSegRows;
      }
      off += lane_weight(n);
      ++lane;
    }
    *l = pl;
    *k0 = plo + (int)((long long)plen * part / parts);
    *k1 = plo + (int)((long long)plen * (part + 1) / parts);
    ++part;
    return true;
  }
};

// A quarter of one row's chunk codes: the first min(nb, 16) bytes from
// src as 4 words (zero past them; nothing is read for nb ≤ 0), by one
// 16-byte load cached in L2 only when `vec` (nb then ≤ 0 or ≥ 16, src
// 16-byte aligned), else byte by byte.
__device__ __forceinline__ uint4 quad_codes(const uint8_t* __restrict__ src,
                                            int nb, bool vec) {
  if (nb <= 0) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldcg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < nb) w[j >> 2] |= (uint32_t)src[j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A warp's staged codes: row r's quarter j at 16-byte unit 4r + (j ^
// ((r >> 1) & 3)), so that the lanes storing a quarter each of 8 rows,
// and the lanes reading a quarter of their own rows, meet 8 distinct
// 16-byte bank groups a quarter-warp.
__device__ __forceinline__ int stage_unit(int r, int j) {
  return 4 * r + (j ^ ((r >> 1) & 3));
}

// ip + t[0, c_0] + t[1, c_1] + … over a chunk's n slots, in slot order,
// the codes c_jj read from this lane's row of the warp's stage a quarter
// (16 slots, 4 words) at a time. A full chunk loads a quarter's 16
// lookups ahead of their adds. KC: Kc when known at compile time (256),
// else 0.
template <int KC>
__device__ __forceinline__ float seg_sum(float ip, const float* t, int Kc,
                                         const uint4* stage, int lane,
                                         int n) {
  const int kc = KC ? KC : Kc;
#pragma unroll
  for (int g = 0; g < kSegSlots / 16; ++g) {
    const uint4 q = stage[stage_unit(lane, g)];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    if (n == kSegSlots) {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int jj = 16 * g + i;
        v[i] = t[jj * kc + __byte_perm(w[i >> 2], 0u, 0x4440u + (i & 3))];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) ip = __fadd_rn(ip, v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int jj = 16 * g + i;
        if (jj < n)
          ip = __fadd_rn(
              ip, t[jj * kc + ((w[i >> 2] >> (8 * (i & 3))) & 255u)]);
      }
    }
  }
  return ip;
}

// The sum, one block an SM: the block's work items (`Walk`) one after
// another; for each, the lane's table streams into shared memory chunk by
// chunk of kSegSlots table rows (TMA bulk copies on an mbarrier, or 4-byte
// cp.async copies when the table is not 16-byte aligned), two buffers
// deep and continuing across items, so the next item's first chunk is in
// flight while this item's last one is summed. For each chunk warp w
// walks the item's batches of 32 rows w, w + kSegWarps, …, a row a lane,
// carrying ip[r] in shared memory from chunk to chunk; the last chunk
// writes the tail max((qn + xn) − 2·ip, 0) at the row's position. A row
// whose id lies outside [0, N) (cid −1) is skipped: the compaction wrote
// its NaN. Shared memory: kSegHead floats, the table chunks, ip of
// kSegRows rows, and kSegWarps stages of kStageWords.
template <int KC>
__global__ void __launch_bounds__(kSegThreads, 1) rows_pq_kernel(
    const float* __restrict__ lut, const float* __restrict__ qn,
    const uint8_t* __restrict__ codes, const float* __restrict__ norms,
    const int* __restrict__ cid, const int* __restrict__ pos,
    const int* __restrict__ cnt, float* __restrict__ out, int B, int V,
    int SL, int Kc) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [kSegStages]
  long long* sh = reinterpret_cast<long long*>(bar + kSegStages);
  long long& first_off = sh[kSegWarps];
  int& first_lane = *reinterpret_cast<int*>(sh + kSegWarps + 1);
  const int kc = KC ? KC : Kc, span = kSegSlots * kc;
  float* tab = smem + kSegHead;                // [kSegStages][span]
  float* part = tab + kSegStages * span;       // [kSegRows]
  uint4* stage = reinterpret_cast<uint4*>(part + kSegRows) +
                 (threadIdx.x >> 5) * (kStageWords / 4);  // this warp's
  const int tid = threadIdx.x;

  // the block's share of all lanes' weight: [T·i / G, T·(i + 1) / G)
  long long mine = 0, T;
  for (int b = tid; b < B; b += kSegThreads) mine += lane_weight(cnt[b]);
  block_scan<long long, kSegWarps>(mine, sh, &T);
  const long long start = T * blockIdx.x / gridDim.x;
  const long long end = T * (blockIdx.x + 1) / gridDim.x;
  if (start == end) return;
  // its first lane: the first whose weight ends past `start`
  long long run = 0;
  for (int b0 = 0; b0 < B; b0 += kSegThreads) {
    const int b = b0 + tid;
    const long long c = b < B ? lane_weight(cnt[b]) : 0;
    long long tot;
    const long long incl = run + block_scan<long long, kSegWarps>(c, sh, &tot);
    const int hits = __syncthreads_count(incl > start);  // a suffix
    if (hits > 0) {
      if (tid == kSegThreads - hits) {
        first_lane = b;
        first_off = incl - c;
      }
      __syncthreads();
      break;
    }
    run += tot;
  }
  Walk walk{cnt, B, first_lane, first_off, start, end, 0, 0, 0, 0, 0};
  int lane, k0, k1, nl, n0, n1;
  if (!walk.next(&lane, &k0, &k1)) return;  // a share of table weight only

  const bool bulk = ((SL * kc) & 3) == 0 && aligned16(lut);
  const bool vec = (SL & 15) == 0 && aligned16(codes);
  if (bulk && tid == 0) {
    for (int s = 0; s < kSegStages; ++s) step::mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nch = (SL + kSegSlots - 1) / kSegSlots;
  // start copying chunk c of lane l's table into buffer s
  auto issue = [&](int l, int c, int s) {
    const float* src = lut + ((size_t)l * SL + (size_t)c * kSegSlots) * kc;
    const int n = min(kSegSlots, SL - c * kSegSlots) * kc;
    if (bulk) {
      if (tid == 0) step::bulk_copy(tab + s * span, src, 4u * n, &bar[s]);
    } else {
      for (int i = tid; i < n; i += kSegThreads)
        step::cp_async4(tab + s * span + i, src + i);
      step::cp_async_commit();
    }
  };
  bool more = walk.next(&nl, &n0, &n1);
  issue(lane, 0, 0);
  for (unsigned u = 0;;) {  // u: chunks consumed, over all items
    const size_t lo = (size_t)lane * V;
    const float qnb = qn[lane];
    for (int c = 0; c < nch; ++c, ++u) {
      // the stream's next chunk into the other buffer, freed by the
      // barrier that ended chunk u − 1
      if (c + 1 < nch)
        issue(lane, c + 1, (u + 1) & 1);
      else if (more)
        issue(nl, 0, (u + 1) & 1);
      else if (!bulk)
        step::cp_async_commit();  // an empty group: the waits stay aligned
      const int s = u & 1;
      if (bulk)  // buffer s's use u / 2
        step::mbar_wait(&bar[s], (u >> 1) & 1);
      else
        step::cp_async_wait_stages();  // this thread's copies of chunk u
      __syncthreads();                 // everyone's
      const float* t = tab + s * span;
      const int j0 = c * kSegSlots, n = min(kSegSlots, SL - j0);
      const bool last = c == nch - 1;
      // warp w takes batches of 32 rows k0 + 32·β.., β = w, w + 16, …;
      // the codes of a batch come in with each lane loading a quarter of
      // a row (8 rows a load: whole 64-byte pieces), two batches ahead,
      // and reach the lane that sums the row through the warp's stage
      const int lane = tid & 31, quarter = lane & 3;
      const int nbat = (k1 - k0 + 31) >> 5;
      const uint8_t* src = codes + j0 + 16 * quarter;
      const int nb = n - 16 * quarter;
      auto row_id = [&](int beta) {  // the id of this lane's row of β
        const int row = k0 + 32 * beta + lane;
        return beta < nbat && row < k1 ? cid[lo + row] : -1;
      };
      auto load = [&](uint4 (&q)[4], int idv) {  // idv: row_id(β)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int id = __shfl_sync(0xffffffffu, idv, 8 * g + (lane >> 2));
          q[g] = id >= 0 ? quad_codes(src + (size_t)id * SL, nb, vec)
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      int beta = tid >> 5;
      int id0 = row_id(beta), id1 = row_id(beta + kSegWarps);
      uint4 pre0[4], pre1[4];
      load(pre0, id0);
      load(pre1, id1);
      int id2 = row_id(beta + 2 * kSegWarps);
      int id3 = row_id(beta + 3 * kSegWarps);
      for (; beta < nbat; beta += kSegWarps) {
        __syncwarp();
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          stage[stage_unit(8 * g + (lane >> 2), quarter)] = pre0[g];
          pre0[g] = pre1[g];
        }
        __syncwarp();
        const int id = id0, r = k0 + 32 * beta + lane;
        float xn = 0.f;
        int p = 0;
        if (last && id >= 0) {
          xn = norms[id];
          p = pos[lo + r];
        }
        load(pre1, id2);  // batch β + 32, while this one sums
        id0 = id1;
        id1 = id2;
        id2 = id3;
        id3 = row_id(beta + 4 * kSegWarps);
        if (id >= 0) {
          float ip = c == 0 ? 0.f : part[r - k0];
          ip = seg_sum<KC>(ip, t, kc, stage, lane, n);
          if (last)
            out[lo + p] = fmaxf(
                __fsub_rn(__fadd_rn(qnb, xn), __fmul_rn(2.f, ip)), 0.f);
          else
            part[r - k0] = ip;
        }
      }
      __syncthreads();  // buffer s is free; the next item may begin
    }
    if (!more) break;
    lane = nl;
    k0 = n0;
    k1 = n1;
    more = walk.next(&nl, &n0, &n1);
  }
}

size_t pq_smem_bytes(int Kc) {
  return sizeof(float) *
         (kSegHead + (size_t)kSegStages * kSegSlots * Kc + (size_t)kSegRows +
          (size_t)kSegWarps * kStageWords);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the int8 kernel (D: the code width) or the PQ
// kernel (Kc: centroids a slot), in bytes.
size_t quant_rows_smem_bytes(int prec, int D, int Kc) {
  return prec == 1 ? sizeof(int) * (size_t)(D / 4) : pq_smem_bytes(Kc);
}

// int8: qq [B, D] int8, sq [B], qn [B], codes [N, D] int8 (D a multiple of
// 4), norms [N], ids [B, V] int32, mask [B, V] bool -> out [B, V].
int quant_rows_int8(const void* qq, const void* sq, const void* qn,
                    const void* codes, const void* norms, const void* ids,
                    const void* mask, void* out, int B, int V, int D, int N,
                    void* stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(rows_int8_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  const int tiles = (V + kInt8Rows - 1) / kInt8Rows;
  for (int b0 = 0; b0 < B; b0 += kMaxLanes) {
    const int bc = std::min(kMaxLanes, B - b0);
    const size_t o = (size_t)b0 * V;
    rows_int8_kernel<<<dim3(tiles, bc), kThreads,
                       quant_rows_smem_bytes(1, D, 0),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(qq) + (size_t)b0 * D,
        static_cast<const float*>(sq) + b0, static_cast<const float*>(qn) + b0,
        static_cast<const int8_t*>(codes), static_cast<const float*>(norms),
        static_cast<const int*>(ids) + o,
        static_cast<const uint8_t*>(mask) + o, static_cast<float*>(out) + o,
        V, D, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// PQ: lut [B, SL, Kc] f32, qn [B], codes [N, SL] uint8, norms [N], ids
// [B, V] int32, mask [B, V] bool -> out [B, V]; cid and pos [B, V] int32
// and cnt [B + B·⌈V / kCompactTile⌉] int32 are scratch. Three launches:
// the count and the compaction (one block a tile of a lane), then the sum
// on `grid` blocks (one an SM).
int quant_rows_pq(const void* lut, const void* qn, const void* codes,
                  const void* norms, const void* ids, const void* mask,
                  void* out, void* cid, void* pos, void* cnt, int B, int V,
                  int SL, int Kc, int N, int grid, void* stream) {
  static bool opted_in[2][step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(rows_pq_kernel<256>, opted_in[0]);
  if (err == cudaSuccess)
    err = step::opt_in_smem_once(rows_pq_kernel<0>, opted_in[1]);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (V + kCompactTile - 1) / kCompactTile;
  int* lanes = static_cast<int*>(cnt);
  int* tcnt = lanes + B;
  rows_pq_count<<<(unsigned)B * tiles, kCompactThreads, 0, st>>>(
      static_cast<const int*>(ids), static_cast<const uint8_t*>(mask), tcnt,
      V, N, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows_pq_compact<<<(unsigned)B * tiles, kCompactThreads, 0, st>>>(
      static_cast<const int*>(ids), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), static_cast<int*>(cid),
      static_cast<int*>(pos), tcnt, lanes, V, N, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto sum = Kc == 256 ? rows_pq_kernel<256> : rows_pq_kernel<0>;
  sum<<<grid, kSegThreads, pq_smem_bytes(Kc), st>>>(
      static_cast<const float*>(lut), static_cast<const float*>(qn),
      static_cast<const uint8_t*>(codes), static_cast<const float*>(norms),
      static_cast<const int*>(cid), static_cast<const int*>(pos), lanes,
      static_cast<float*>(out), B, V, SL, Kc);
  return (int)cudaGetLastError();
}

const char* quant_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// K6: batched masked squared L2, q [B, d] x [B, R, d] -> [B, R] f32, +inf
// where the mask is false; and its row-id variant (the scan plan's and the
// exact oracle's distance), q [B, d], a row store base [N, d] and row ids
// [B, V] -> [B, V] f32.
//
// Replaces the TPU kernel repro/kernels/distance.py::_sqdist_kernel (called
// from sqdist_masked, and from kernels/ops.py::masked_scan_dist on the
// gathered scan block). Wrappers and plain versions:
// repro_torch/kernels/distance.py.
//
// Bits. Every (query, row) pair is computed as step_common.cuh::row_sqdist
// computes it in K1 and K5: element i on warp lane i mod 32 in ascending i
// (`xx += v * v; qx += qs[i] * v`, contracted into the same FMAs), the
// warp_sum tree, sqdist_of_sums, and qn from query_sqnorm at kThreads. The
// row sits in registers here (kTile floats a lane; elements beyond are read
// again from memory, in the same order), which moves no bit. So a pair
// gives the same value in any batch shape, in either kernel, and in K1/K5.
//
// What bounds both on an H100: bytes at the bound — each needed row read
// once, 4·d flops a pair.
//
// Gathered K6 (`sqdist_kernel`): grid (B, ⌈R / kWarps⌉), one row per warp,
// so B=64, R=32 gives 256 blocks for the 132 SMs. A warp issues all its
// row's loads into registers before the block computes the query's norm
// (query_sqnorm, the same code in every block, so the same bits), so the
// loads overlap that prologue's barriers. Masked rows are not read.
//
// Row-id variant (`sqdist_rows_f32`): reads each store row once per lane
// group per call (G ≤ 64 lanes a group; one group up to B = 64), not once
// per (lane, row) pair. On the "mixed" forced scan (B=64, V=2^19, N=1M)
// that is 3.07 GB against the 34.2 GB of 11.1 M pairs read one by one.
//   1. count: +inf at masked positions, and a histogram of the unmasked
//      (lane group, row) pairs over groups·N bins;
//   2. an exclusive scan of the bins (three small kernels);
//   3. scatter: each pair's flat output index into its bin's slot (by an
//      atomic cursor, so the order inside a bin varies from run to run; each
//      pair's value is computed alone, so the output does not);
//   4. qn: each lane's squared norm by query_sqnorm, once;
//   5. distances: about one block per SM for each lane group holds the
//      group's queries and norms in shared memory (G·(d+1) floats, 197 KB
//      at G=64, d=768). Each of its 24 warps takes 32 rows' bins at a time,
//      and for each row with pairs loads it into registers once, computes
//      ‖x‖² once and walks the bin: q·x per pair from the shared query.
//      Rows that no lane passes are not read.
// What is left above the bound (PERF.md): step 5 reads d floats of shared
// memory a pair and waits on its rows' loads (the row tile's registers cap
// a block at 24 warps); step 3's 4-byte stores land one to a sector.
// Ids outside [0, N) give NaN (the plain version raises or wraps); the
// lanes go in passes of at most INT_MAX / V, so flat indices fit an int.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "step_common.cuh"

namespace {

using step::kThreads;
using step::kWarps;

constexpr unsigned kFull = 0xffffffffu;

// Row floats a lane keeps in registers: elements lane + 32·j, j < kTile —
// the whole row at d ≤ 768. Elements beyond are read again from memory.
constexpr int kTile = 24;

__device__ __forceinline__ void load_tile(float (&xr)[kTile],
                                          const float* __restrict__ row, int D,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int i = lane + 32 * j;
    xr[j] = i < D ? row[i] : 0.f;
  }
}

// This lane's part of ‖x‖², in row_sqdist's order.
__device__ __forceinline__ float tile_xx(const float (&xr)[kTile],
                                         const float* __restrict__ row, int D,
                                         int lane) {
  float xx = 0.f;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (lane + 32 * j < D) {
      const float v = xr[j];
      xx += v * v;
    }
  }
  for (int i = lane + 32 * kTile; i < D; i += 32) {
    const float v = row[i];
    xx += v * v;
  }
  return xx;
}

// This lane's part of q·x (qs: the query in shared memory), in row_sqdist's
// order.
__device__ __forceinline__ float tile_qx(const float* qs,
                                         const float (&xr)[kTile],
                                         const float* __restrict__ row, int D,
                                         int lane) {
  float qx = 0.f;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int i = lane + 32 * j;
    if (i < D) {
      const float v = xr[j];
      qx += qs[i] * v;
    }
  }
  for (int i = lane + 32 * kTile; i < D; i += 32) {
    const float v = row[i];
    qx += qs[i] * v;
  }
  return qx;
}

// ------------------------------------------------------- gathered K6 ----
__global__ void __launch_bounds__(kThreads) sqdist_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int R, int D) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.y * kWarps + warp;
  const size_t o = (size_t)b * R + r;
  const bool live = r < R && mask[o];  // the same for the whole warp
  const float* row = x + o * D;
  float xr[kTile];
  if (live) load_tile(xr, row, D, lane);  // in flight across the prologue
  float* qs = smem;     // [D]
  float* red = qs + D;  // [kWarps + 1]
  const float qn = step::query_sqnorm(q + (size_t)b * D, qs, D, red);
  if (r >= R) return;
  float d = step::inf_f();
  if (live)
    d = step::sqdist_of_sums(qn, step::warp_sum(tile_xx(xr, row, D, lane)),
                             step::warp_sum(tile_qx(qs, xr, row, D, lane)));
  if (lane == 0) out[o] = d;
}

// ---------------------------------------------------- row-id variant ----
constexpr int kPrepThreads = 256;   // count, scatter and scan kernels
constexpr int kScanItems = 16;      // counts a scan thread owns
constexpr int kScanTile = kPrepThreads * kScanItems;
constexpr int kRowsThreads = 768;   // distance kernel: 24 warps, ≤ 85 regs
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kMaxGroup = 64;       // lanes whose queries a block holds
constexpr size_t kSmemBudget = 232448;  // _build.MAX_SMEM_BYTES

// Lanes of one pass: flat output indices b·V + p must fit an int.
int lanes_per_pass(int B, int V) { return std::max(1, std::min(B, INT_MAX / V)); }

// Lanes per group: as many queries as shared memory holds, at most 64.
int group_lanes(int B, int D) {
  const size_t fit = kSmemBudget / (sizeof(float) * ((size_t)D + 1));
  return (int)std::max<size_t>(1, std::min<size_t>(std::min(B, kMaxGroup), fit));
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

struct Scratch {  // one pass's bookkeeping, carved from the wrapper's buffer
  int* ends;      // [groups·N + 1]: ends[0] = 0, ends[1 + k]: bin k's count,
                  // then its start, then its end
  int* sums;      // [⌈groups·N / kScanTile⌉]
  int* pairs;     // [Bc·V]
  float* qn;      // [Bc]
};

// Byte offsets of Scratch's four arrays, and the total, in off[0..4].
void layout(int Bc, int V, int N, int G, size_t off[5]) {
  const size_t m = (size_t)((Bc + G - 1) / G) * N;
  off[0] = 0;
  off[1] = off[0] + align256(sizeof(int) * (m + 1));
  off[2] = off[1] + align256(sizeof(int) * ((m + kScanTile - 1) / kScanTile));
  off[3] = off[2] + align256(sizeof(int) * (size_t)Bc * V);
  off[4] = off[3] + align256(sizeof(float) * Bc);
}

Scratch carve(void* base, int Bc, int V, int N, int G) {
  size_t off[5];
  layout(Bc, V, N, G, off);
  char* p = static_cast<char*>(base);
  return {reinterpret_cast<int*>(p + off[0]), reinterpret_cast<int*>(p + off[1]),
          reinterpret_cast<int*>(p + off[2]),
          reinterpret_cast<float*>(p + off[3])};
}

// Steps 1 and 3 walk the [B, V] positions four at a time (V is a multiple
// of 64): one 4-byte mask word, and the four ids only if one is unmasked.
template <bool kScatter>
__global__ void __launch_bounds__(kPrepThreads) rows_bin_kernel(
    const int* __restrict__ ids, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int* __restrict__ ends, int* __restrict__ pairs,
    long long quads, int V, int N, int G) {
  const long long stride = (long long)gridDim.x * kPrepThreads;
  for (long long t = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
       t < quads; t += stride) {
    const unsigned m4 = reinterpret_cast<const unsigned*>(mask)[t];
    const long long o0 = 4 * t;
    if (m4 == 0) {
      if (!kScatter)
        reinterpret_cast<float4*>(out)[t] = make_float4(
            step::inf_f(), step::inf_f(), step::inf_f(), step::inf_f());
      continue;
    }
    const int4 i4 = reinterpret_cast<const int4*>(ids)[t];
    const int id[4] = {i4.x, i4.y, i4.z, i4.w};
    int* bins = ends + 1 + (size_t)((int)(o0 / V) / G) * N;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long o = o0 + k;
      const bool on = (m4 >> (8 * k)) & 0xffu;
      const bool in_range = (unsigned)id[k] < (unsigned)N;
      if (kScatter) {
        if (on && in_range) pairs[atomicAdd(bins + id[k], 1)] = (int)o;
      } else if (!on) {
        out[o] = step::inf_f();
      } else if (!in_range) {
        out[o] = __int_as_float(0x7fc00000);  // NaN
      } else {
        atomicAdd(bins + id[k], 1);
      }
    }
  }
}

// An exclusive scan of one int a thread over the block; *total gets the
// block's sum. `tot` holds one int a warp. Ends with a barrier.
__device__ __forceinline__ int block_exclusive_scan(int v, int* tot,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += n;
  }
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int t = tot[w];
    if (w < warp) before += t;
    all += t;
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

// Scan, pass 1: the sum of each tile of kScanTile counts.
__global__ void __launch_bounds__(kPrepThreads) scan_tile_sums(
    const int* __restrict__ c, int* __restrict__ sums, long long m) {
  __shared__ int tot[kPrepThreads / 32];
  const long long t0 = (long long)blockIdx.x * kScanTile;
  int s = 0;
  for (int i = threadIdx.x; i < kScanTile; i += kPrepThreads)
    if (t0 + i < m) s += c[t0 + i];
  int total;
  block_exclusive_scan(s, tot, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Scan, pass 2 (one block): the tile sums, exclusive, in place.
__global__ void __launch_bounds__(1024) scan_sums(int* sums, int n) {
  __shared__ int tot[32];
  int carry = 0;
  for (int s = 0; s < n; s += 1024) {
    const int i = s + threadIdx.x;
    const int v = i < n ? sums[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, tot, &total);
    if (i < n) sums[i] = carry + ex;
    carry += total;
  }
}

// Scan, pass 3: each tile, exclusive, in place, offset by its tile sum.
// The tile goes through shared memory (padded one int in 32, so a warp's
// runs of kScanItems hit 32 banks).
__global__ void __launch_bounds__(kPrepThreads) scan_tiles(
    int* __restrict__ c, const int* __restrict__ sums, long long m) {
  __shared__ int tile[kScanTile + kScanTile / 32];
  __shared__ int tot[kPrepThreads / 32];
  const long long t0 = (long long)blockIdx.x * kScanTile;
  auto at = [](int k) { return k + (k >> 5); };
  for (int i = threadIdx.x; i < kScanTile; i += kPrepThreads)
    tile[at(i)] = t0 + i < m ? c[t0 + i] : 0;
  __syncthreads();
  const int k0 = threadIdx.x * kScanItems;
  int run = 0;
  for (int j = 0; j < kScanItems; ++j) run += tile[at(k0 + j)];
  int total;
  int ex = sums[blockIdx.x] + block_exclusive_scan(run, tot, &total);
  for (int j = 0; j < kScanItems; ++j) {
    const int v = tile[at(k0 + j)];
    tile[at(k0 + j)] = ex;
    ex += v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kScanTile; i += kPrepThreads)
    if (t0 + i < m) c[t0 + i] = tile[at(i)];
}

// Step 4: each lane's squared norm, by K1's code.
__global__ void __launch_bounds__(kThreads) sqnorm_kernel(
    const float* __restrict__ q, float* __restrict__ qn, int D) {
  extern __shared__ float smem[];
  const float n = step::query_sqnorm(q + (size_t)blockIdx.x * D, smem, D,
                                     smem + D);
  if (threadIdx.x == 0) qn[blockIdx.x] = n;
}

// Step 5: grid (blocks per group, groups). Row r of group g has the pairs
// pairs[ends[g·N + r] .. ends[g·N + r + 1]), flat output indices b·V + p.
__global__ void __launch_bounds__(kRowsThreads, 1) sqdist_rows_kernel(
    const float* __restrict__ q, const float* __restrict__ qn,
    const float* __restrict__ base, const int* __restrict__ ends,
    const int* __restrict__ pairs, float* __restrict__ out, int B, int V,
    int D, int N, int G) {
  extern __shared__ float smem[];
  const int g = blockIdx.y, b0 = g * G, nb = min(G, B - b0);
  float* qs = smem;                 // [nb, D]: the group's queries
  float* qns = qs + (size_t)G * D;  // [nb]: their squared norms
  const float* qg = q + (size_t)b0 * D;
  for (int i = threadIdx.x; i < nb * D; i += kRowsThreads) qs[i] = qg[i];
  if ((int)threadIdx.x < nb) qns[threadIdx.x] = qn[b0 + threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* bin = ends + (size_t)g * N;
  const int chunks = N / 32 + (N % 32 != 0);
  for (int c = blockIdx.x * kRowsWarps + warp; c < chunks;
       c += gridDim.x * kRowsWarps) {
    const int r = c * 32 + lane;
    int s = 0, e = 0;
    if (r < N) {
      s = bin[r];
      e = bin[r + 1];
    }
    unsigned todo = __ballot_sync(kFull, e > s);
    while (todo) {  // the chunk's rows that some lane of the group passes
      const int k = __ffs(todo) - 1;
      todo &= todo - 1;
      const int start = __shfl_sync(kFull, s, k);
      const int end = __shfl_sync(kFull, e, k);
      const float* row = base + (size_t)(c * 32 + k) * D;
      float xr[kTile];
      load_tile(xr, row, D, lane);
      const float xx = step::warp_sum(tile_xx(xr, row, D, lane));
      for (int p0 = start; p0 < end; p0 += 32) {  // the row's pairs
        const int n = min(32, end - p0);
        int o = 0, bl = 0;
        if (lane < n) {
          o = pairs[p0 + lane];
          bl = o / V - b0;
        }
        for (int t = 0; t < n; ++t) {
          const int ot = __shfl_sync(kFull, o, t);
          const int bt = __shfl_sync(kFull, bl, t);
          const float qx = step::warp_sum(
              tile_qx(qs + (size_t)bt * D, xr, row, D, lane));
          if (lane == 0) out[ot] = step::sqdist_of_sums(qns[bt], xx, qx);
        }
      }
    }
  }
}

int rows_blocks_per_group(int groups, size_t smem) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sqdist_rows_kernel,
                                                kRowsThreads, smem);
  return std::max(1, (std::max(sms, 1) * std::max(occ, 1) + groups - 1) / groups);
}

// One pass over Bc lanes (pointers already offset to its first lane).
cudaError_t rows_pass(const float* q, const float* base, const int* ids,
                      const uint8_t* mask, float* out, void* scratch, int Bc,
                      int V, int D, int N, int G, cudaStream_t st) {
  const Scratch s = carve(scratch, Bc, V, N, G);
  const int groups = (Bc + G - 1) / G;
  const long long m = (long long)groups * N;
  cudaError_t err =
      cudaMemsetAsync(s.ends, 0, sizeof(int) * (size_t)(m + 1), st);
  if (err != cudaSuccess) return err;
  const long long quads = (long long)Bc * V / 4;
  const int grid = (int)std::min<long long>(
      (quads + kPrepThreads - 1) / kPrepThreads, 1 << 16);
  rows_bin_kernel<false><<<grid, kPrepThreads, 0, st>>>(
      ids, mask, out, s.ends, s.pairs, quads, V, N, G);
  const int tiles = (int)((m + kScanTile - 1) / kScanTile);
  if (tiles > 0) {
    scan_tile_sums<<<tiles, kPrepThreads, 0, st>>>(s.ends + 1, s.sums, m);
    scan_sums<<<1, 1024, 0, st>>>(s.sums, tiles);
    scan_tiles<<<tiles, kPrepThreads, 0, st>>>(s.ends + 1, s.sums, m);
  }
  rows_bin_kernel<true><<<grid, kPrepThreads, 0, st>>>(
      ids, mask, out, s.ends, s.pairs, quads, V, N, G);
  sqnorm_kernel<<<Bc, kThreads, sizeof(float) * ((size_t)D + kWarps + 1),
                  st>>>(q, s.qn, D);
  const size_t smem = sizeof(float) * (size_t)G * (D + 1);
  const dim3 rgrid(rows_blocks_per_group(groups, smem), groups);
  sqdist_rows_kernel<<<rgrid, kRowsThreads, smem, st>>>(
      q, s.qn, base, s.ends, s.pairs, out, Bc, V, D, N, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the gathered kernel and of the row-id
// variant's norm kernel for width D, in bytes. The row-id distance kernel
// sizes its lane group to fit (G·(D+1) floats ≤ kSmemBudget).
size_t sqdist_smem_bytes(int D) {
  return sizeof(float) * ((size_t)D + kWarps + 1);
}

int sqdist_f32(const void* q, const void* x, const void* mask, void* out,
               int B, int R, int D, void* stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(sqdist_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  const dim3 grid(B, (R + kWarps - 1) / kWarps);
  sqdist_kernel<<<grid, kThreads, sqdist_smem_bytes(D),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), R, D);
  return (int)cudaGetLastError();
}

// Bytes of scratch the row-id variant needs (the wrapper allocates it).
size_t sqdist_rows_scratch_bytes(int B, int V, int D, int N) {
  if (B == 0 || V == 0) return 0;
  const int bp = lanes_per_pass(B, V);
  size_t off[5];
  layout(bp, V, N, group_lanes(bp, D), off);
  return off[4];
}

// Row-id variant: ids [B, V], int32 rows of base [N, d]; V a multiple of
// 64; ids 16-byte and mask 4-byte aligned.
int sqdist_rows_f32(const void* q, const void* base, const void* ids,
                    const void* mask, void* out, void* scratch, int B, int V,
                    int D, int N, void* stream) {
  static bool opted_rows[step::kMaxDevices] = {};
  static bool opted_norm[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(sqdist_rows_kernel, opted_rows);
  if (err == cudaSuccess) err = step::opt_in_smem_once(sqnorm_kernel,
                                                       opted_norm);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  const int bp = lanes_per_pass(B, V), G = group_lanes(bp, D);
  for (int b0 = 0; b0 < B; b0 += bp) {
    const int bc = std::min(bp, B - b0);
    const size_t o = (size_t)b0 * V;
    err = rows_pass(static_cast<const float*>(q) + (size_t)b0 * D,
                    static_cast<const float*>(base),
                    static_cast<const int*>(ids) + o,
                    static_cast<const uint8_t*>(mask) + o,
                    static_cast<float*>(out) + o, scratch, bc, V, D, N, G,
                    static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* sqdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

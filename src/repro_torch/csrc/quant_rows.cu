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
//    one thread a row, chunk by chunk through step::pq_sum_chunk, then
//    max((qn + xn) − 2·ip, 0), each operation rounded once.
//
// What bounds it on an H100: bytes — the codes and norms of the unmasked
// pairs (576–768 B a row), plus, under PQ, the lane's table once a tile
// (576 KB at S·L=576, Kc=256; in L2 while a lane's tiles run, since the
// grid walks the tiles of one lane before the next).
//  - int8: grid (⌈V / 256⌉ tiles, B), 8 warps a block, one row a warp at a
//    time; the quantized query (d/4 words) in shared memory; a row's codes
//    are d/4 consecutive words, read coalesced across the warp.
//  - PQ: grid (⌈V / 1024⌉ tiles, B); the lane's table streams into shared
//    memory by chunks of step::kPQChunk table rows (TMA bulk copies on an
//    mbarrier, two buffers deep: step::pq_table_chunk), once a tile, while
//    each thread sums the previous chunk's lookups for its 4 rows, their
//    codes read straight from device memory (16-byte loads where S·L is a
//    multiple of 16). A tile with no unmasked row streams nothing.
// The scan's ids per lane are sorted and unique, so consecutive positions
// read consecutive rows; no bucketing by row is needed (K6 rows buckets
// because a float row is 3 KB and lanes share rows; here a row is read
// once a lane).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "step_common.cuh"

namespace {

using step::kPQChunk;
using step::kPQStages;
using step::kThreads;
using step::kWarps;

constexpr int kInt8Rows = 256;             // rows a tile (int8): 32 a warp
constexpr int kPQRowsPerThread = 4;        // rows a thread (PQ)
constexpr int kPQRows = kThreads * kPQRowsPerThread;  // rows a tile (PQ)
constexpr int kMaxLanes = 65535;           // gridDim.y: lanes a launch

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
// One chunk's codes of a row (n ≤ kPQChunk bytes from src) into words, as
// pq_sum_chunk reads them: 16-byte loads when `vec` (n a multiple of 16,
// src 16-byte aligned), else byte by byte.
__device__ __forceinline__ void load_chunk_codes(
    uint32_t (&w)[kPQChunk / 4], const uint8_t* __restrict__ src, int n,
    bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kPQChunk / 16; ++i)
      if (16 * i < n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
  } else {
#pragma unroll
    for (int i = 0; i < kPQChunk / 4; ++i) w[i] = 0u;
    for (int j = 0; j < n; ++j) w[j >> 2] |= (uint32_t)src[j] << (8 * (j & 3));
  }
}

__global__ void __launch_bounds__(kThreads, 2) rows_pq_kernel(
    const float* __restrict__ lut, const float* __restrict__ qn,
    const uint8_t* __restrict__ codes, const float* __restrict__ norms,
    const int* __restrict__ ids, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int V, int SL, int Kc, int N) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [kPQStages]
  float* tab = smem + step::kPQBarWords;  // [kPQStages][kPQChunk * Kc]
  const int tid = threadIdx.x, b = blockIdx.y;
  const int span = kPQChunk * Kc, nch = (SL + kPQChunk - 1) / kPQChunk;
  const float* lut_b = lut + (size_t)b * SL * Kc;
  const size_t o0 = (size_t)b * V + (size_t)blockIdx.x * kPQRows;
  const int p0 = blockIdx.x * kPQRows;

  // this thread's rows: p0 + tid + kThreads·k
  int id[kPQRowsPerThread];
  bool on[kPQRowsPerThread];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kPQRowsPerThread; ++k) {
    const int r = tid + kThreads * k;
    id[k] = 0;
    on[k] = false;
    if (p0 + r < V && mask[o0 + r]) {
      id[k] = ids[o0 + r];
      on[k] = (unsigned)id[k] < (unsigned)N;
      if (!on[k]) out[o0 + r] = nan_f();
    } else if (p0 + r < V) {
      out[o0 + r] = step::inf_f();
    }
    any = any || on[k];
  }
  if (!__syncthreads_or(any)) return;  // nothing to read in this tile

  // a chunk of table rows is a contiguous, 16-byte aligned range of a
  // multiple of 16 bytes when the lane's table is
  const bool bulk = ((SL * Kc) & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(lut) & 15) == 0;
  const bool vec = (SL & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  if (bulk && tid == 0) {
    for (int s = 0; s < kPQStages; ++s) step::mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto start = [&](int c) {  // chunk c's copy (an empty group past the last)
    if (c < nch) {
      const int s = c % kPQStages, n = min(kPQChunk, SL - c * kPQChunk);
      step::pq_table_chunk(tab + s * span, lut_b, Kc, c * kPQChunk, n, bulk,
                           &bar[s]);
    } else {
      step::cp_async_commit();
    }
  };
  for (int c = 0; c < kPQStages - 1; ++c) start(c);
  float xn[kPQRowsPerThread], ip[kPQRowsPerThread];
#pragma unroll
  for (int k = 0; k < kPQRowsPerThread; ++k) {
    xn[k] = on[k] ? norms[id[k]] : 0.f;  // loaded ahead of the sum
    ip[k] = 0.f;
  }
  for (int c = 0; c < nch; ++c) {
    start(c + kPQStages - 1);
    const int s = c % kPQStages;
    if (bulk)  // buffer s's use c / kPQStages in this block
      step::mbar_wait(&bar[s], (c / kPQStages) & 1);
    else
      step::cp_async_wait_stages();  // this thread's copies of chunk c
    __syncthreads();                 // everyone's
    const int j0 = c * kPQChunk, n = min(kPQChunk, SL - j0);
#pragma unroll
    for (int k = 0; k < kPQRowsPerThread; ++k) {
      if (!on[k]) continue;
      uint32_t w[kPQChunk / 4];
      load_chunk_codes(w, codes + (size_t)id[k] * SL + j0, n, vec);
      ip[k] = step::pq_sum_chunk(ip[k], tab + s * span, Kc, w, n);
    }
    if (c + kPQStages < nch) __syncthreads();  // buffer s refills next
  }
  const float qnb = qn[b];
#pragma unroll
  for (int k = 0; k < kPQRowsPerThread; ++k)
    if (on[k])
      out[o0 + tid + kThreads * k] = fmaxf(
          __fsub_rn(__fadd_rn(qnb, xn[k]), __fmul_rn(2.f, ip[k])), 0.f);
}

size_t pq_smem_bytes(int Kc) {
  return sizeof(float) *
         (step::kPQBarWords + (size_t)kPQStages * kPQChunk * Kc);
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
// [B, V] int32, mask [B, V] bool -> out [B, V].
int quant_rows_pq(const void* lut, const void* qn, const void* codes,
                  const void* norms, const void* ids, const void* mask,
                  void* out, int B, int V, int SL, int Kc, int N,
                  void* stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(rows_pq_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  const int tiles = (V + kPQRows - 1) / kPQRows;
  for (int b0 = 0; b0 < B; b0 += kMaxLanes) {
    const int bc = std::min(kMaxLanes, B - b0);
    const size_t o = (size_t)b0 * V;
    rows_pq_kernel<<<dim3(tiles, bc), kThreads, pq_smem_bytes(Kc),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lut) + (size_t)b0 * SL * Kc,
        static_cast<const float*>(qn) + b0,
        static_cast<const uint8_t*>(codes), static_cast<const float*>(norms),
        static_cast<const int*>(ids) + o,
        static_cast<const uint8_t*>(mask) + o, static_cast<float*>(out) + o,
        V, SL, Kc, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* quant_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

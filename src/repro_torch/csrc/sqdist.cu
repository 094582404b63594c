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
// Design: one thread block per query lane computes the query's squared
// norm, then one warp per row computes max(‖q‖² + ‖x‖² − 2 q·x, 0) with
// K1's code (step_common.cuh, same block size and thread mapping), so a
// (query, row) pair gives the same bits here as in K1 and K5. Masked rows
// are not read.
//
// What bounds it on an H100: bytes. It reads the unmasked rows of x once
// (B·R·d·4 B = 6.3 MB at B=64, R=32, d=768, all unmasked) for 4·d flops
// per row; with one block per lane, B=64 blocks fill 64 of the 132 SMs,
// which a later speed PR can split across rows.
//
// The row-id variant reads each unmasked row straight from the store: the
// scan's gathered block would be B·V·d·4 B, 103 GB at B=64, V=2^19,
// d=768, more than the card holds. Its grid is (⌈V / kRowsPerBlock⌉, B):
// a block takes kRowsPerBlock rows of one lane, computes the lane's query
// norm itself (the same code, so every block gets the same bits), and
// skips all of it when none of its rows is unmasked. Each (query, row)
// pair is computed by one warp in a fixed order, whatever B, V or the
// block the row lands in, so a pair gives the same bits in any batch
// shape, here and in K1, K5 and the gathered K6 alike.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using step::kThreads;
using step::kWarps;

__global__ void __launch_bounds__(kThreads) sqdist_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int R, int D) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qs = smem;          // [D]
  float* red = qs + D;       // [kWarps + 1]
  const float qn = step::query_sqnorm(q + (size_t)b * D, qs, D, red);
  for (int r = warp; r < R; r += kWarps) {
    const size_t o = (size_t)b * R + r;
    float d = step::inf_f();
    if (mask[o]) d = step::row_sqdist(qs, x + o * D, D, qn, lane);
    if (lane == 0) out[o] = d;
  }
}

constexpr int kRowsPerBlock = kThreads;  // rows of one lane per block

__global__ void __launch_bounds__(kThreads) sqdist_rows_kernel(
    const float* __restrict__ q, const float* __restrict__ base,
    const int* __restrict__ ids, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int V, int D) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kRowsPerBlock;
  const int v1 = min(v0 + kRowsPerBlock, V);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t lane0 = (size_t)b * V;
  const int v = v0 + (int)threadIdx.x;
  const bool mine = v < v1 && mask[lane0 + v];
  if (!__syncthreads_or(mine)) {  // every row of the block masked
    if (v < v1) out[lane0 + v] = step::inf_f();
    return;
  }
  float* qs = smem;          // [D]
  float* red = qs + D;       // [kWarps + 1]
  const float qn = step::query_sqnorm(q + (size_t)b * D, qs, D, red);
  const int* lane_ids = ids + lane0;
  for (int r = v0 + warp; r < v1; r += kWarps) {
    float d = step::inf_f();
    if (mask[lane0 + r])
      d = step::row_sqdist(qs, base + (size_t)lane_ids[r] * D, D, qn, lane);
    if (lane == 0) out[lane0 + r] = d;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for width D, in bytes.
size_t sqdist_smem_bytes(int D) {
  return sizeof(float) * ((size_t)D + kWarps + 1);
}

int sqdist_f32(const void* q, const void* x, const void* mask, void* out,
               int B, int R, int D, void* stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(sqdist_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  sqdist_kernel<<<B, kThreads, sqdist_smem_bytes(D),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), R, D);
  return (int)cudaGetLastError();
}

// Row-id variant: ids [B, V], int32 rows of base [N, d].
int sqdist_rows_f32(const void* q, const void* base, const void* ids,
                    const void* mask, void* out, int B, int V, int D,
                    void* stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(sqdist_rows_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  const dim3 grid((V + kRowsPerBlock - 1) / kRowsPerBlock, B);
  sqdist_rows_kernel<<<grid, kThreads, sqdist_smem_bytes(D),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(base),
      static_cast<const int*>(ids), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), V, D);
  return (int)cudaGetLastError();
}

const char* sqdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

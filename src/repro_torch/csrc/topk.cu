// K7: sorted-buffer top-M merge. A sorted-ascending buffer (dist [B, M],
// payload [B, M]) and R raw entries (new_dist [B, R], new_payload [B, R])
// -> the best M (dist, payload) of [old | new], in the order of a stable
// argsort over the concatenation: ties keep old entries first, then new
// entries in their positions.
//
// Replaces the TPU kernel repro/kernels/topk.py::_merge_kernel (called from
// topm_merge, reached through kernels/ops.py::queue_merge). Wrapper and
// plain version: repro_torch/kernels/topk.py.
//
// Design: a merge by rank, not the reference kernel's full bitonic
// re-sort of next_pow2(M + R) entries. One block per lane. The R new
// entries are sorted by (distance, position) by rank counting in shared
// memory: each thread counts, for its entries, the entries that come
// before them. Then every entry of either run finds its output rank as
// its own index plus its rank in the other run, by binary search: old
// entry i lands at i + #{new < d_i}, new entry s of the sorted run at
// s + #{old <= d_s} (old wins ties), and writes itself out if that rank is
// below M. The ranks are a permutation of 0..M+R-1, so every output slot
// is written once. The buffer must be sorted ascending (queue_merge's
// stated contract) and no distance may be NaN.
//
// What bounds it on an H100: bytes. It reads [B, M + R] distances and
// payloads once and writes [B, M] of each (≈ 0.54 MB at B=64, M=512,
// R=32); the work is (M + R)·log2 of the other run's length compares per
// lane plus R² for the rank sort of the new entries.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using step::kThreads;

// Number of entries of the ascending run a[0..n) that are < key (strict)
// or <= key (!strict).
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

__global__ void __launch_bounds__(kThreads) topm_merge_kernel(
    const float* __restrict__ dist, const int* __restrict__ pay,
    const float* __restrict__ new_dist, const int* __restrict__ new_pay,
    float* __restrict__ out_dist, int* __restrict__ out_pay, int M, int R) {
  extern __shared__ float smem[];
  float* old_k = smem;                                   // [M]
  float* raw_k = old_k + M;                              // [R]
  float* new_k = raw_k + R;                              // [R] sorted
  int* new_src = reinterpret_cast<int*>(new_k + R);      // [R] positions
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t om = (size_t)b * M, orr = (size_t)b * R;
  for (int i = tid; i < M; i += kThreads) old_k[i] = dist[om + i];
  for (int j = tid; j < R; j += kThreads) raw_k[j] = new_dist[orr + j];
  __syncthreads();
  // rank sort of the new entries by (distance, position)
  for (int j = tid; j < R; j += kThreads) {
    const float kj = raw_k[j];
    int rank = 0;
    for (int i = 0; i < R; ++i) {
      const float ki = raw_k[i];
      rank += (ki < kj) || (ki == kj && i < j);
    }
    new_k[rank] = kj;
    new_src[rank] = j;
  }
  __syncthreads();
  for (int i = tid; i < M; i += kThreads) {
    const float k = old_k[i];
    const int o = i + count_below(new_k, R, k, true);
    if (o < M) {
      out_dist[om + o] = k;
      out_pay[om + o] = pay[om + i];
    }
  }
  for (int s = tid; s < R; s += kThreads) {
    const float k = new_k[s];
    const int o = s + count_below(old_k, M, k, false);
    if (o < M) {
      out_dist[om + o] = k;
      out_pay[om + o] = new_pay[orr + new_src[s]];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these widths, in bytes.
size_t topm_merge_smem_bytes(int M, int R) {
  return sizeof(float) * ((size_t)M + 3 * (size_t)R);
}

int topm_merge_f32(const void* dist, const void* pay, const void* new_dist,
                   const void* new_pay, void* out_dist, void* out_pay, int B,
                   int M, int R, void* stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(topm_merge_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaSuccess;
  topm_merge_kernel<<<B, kThreads, topm_merge_smem_bytes(M, R),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const int*>(pay),
      static_cast<const float*>(new_dist), static_cast<const int*>(new_pay),
      static_cast<float*>(out_dist), static_cast<int*>(out_pay), M, R);
  return (int)cudaGetLastError();
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

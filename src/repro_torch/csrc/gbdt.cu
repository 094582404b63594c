// K2: GBDT ensemble inference (the E2E cost estimator), [B, F] -> [B].
//
// Replaces the TPU kernel repro/kernels/gbdt.py::_gbdt_kernel. Wrapper and
// plain version: repro_torch/kernels/gbdt.py.
//
// Trees are complete and heap-packed: feat/thresh [T, NI = 2^D - 1],
// leaf [T, NL = 2^D]. One block per query lane, one thread per tree (a
// thread takes trees t, t + blockDim, ... when T exceeds the block). The
// thread walks its tree — feature id, threshold, `x <= th`, descend — and
// leaves the leaf value in shared memory; then thread 0 adds the T values
// in tree order from 0, and `base` once: out = base + (((0 + v_0) + v_1)
// + ...), the bits of a float32 tree-by-tree sum.
//
// Design for the H100. The TPU kernel holds the forest resident in VMEM;
// here no block copies the forest (75 KB at T=200, D=5), since a walk
// needs 2D + 1 of its tree's 3·2^D - 2 words (11 of 94 at D=5; it loads
// 24, the rest for the branches not taken). Nodes and leaves come
// straight from device memory through the read-only path, and the forest
// stays in L2 after the first lane reads it. A walk then waits on round
// trips to L2, so levels go three at a time: a node and the six below it
// load together (`walk_round`), and the last round loads the candidate
// leaves with its nodes. At D=5 a walk waits on two round trips, not six.
// The lane's features are read through L1, into which the block
// prefetches them first. A block holds one whole lane, so its sum needs no
// second pass, and B blocks spread over B SMs.
//
// What bounds it on an H100: the walk's two rounds of loads, each (lane,
// tree) pair pulling its own lines from L2, and the T dependent adds of
// the tree-order sum — not the bytes it must move (≈ 93 KB at B=64, F=68,
// T=200, D=5) nor arithmetic. Blocks of 2, 4 or 8 lanes whose warps share
// trees, and lanes split over 2-block clusters, measured no faster.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"  // opt_in_smem_once

namespace {

constexpr int kMaxThreads = 1024;

// c[p] for p < N (a power of 2), by selects on the bits of p: c stays in
// registers, where an indexed read would go to local memory.
template <int N, typename T>
__device__ __forceinline__ T pick(const T* c, int p) {
  T v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = c[i];
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] = (p & w) ? v[i + w] : v[i];
  }
  return v[0];
}

// Level J of a round: of its 2^J nodes (f, h from index 2^J - 1), the one
// at position p decides; returns the position in the level below.
template <int J>
__device__ __forceinline__ int descend(const int* f, const float* h,
                                       const float* __restrict__ x, int p) {
  const int fj = pick<(1 << J)>(f + (1 << J) - 1, p);
  const float hj = pick<(1 << J)>(h + (1 << J) - 1, p);
  return 2 * p + (__ldg(x + fj) <= hj ? 0 : 1);
}

// One round trip of a walk: the K levels below and including node n
// (2^K - 1 nodes; level j's 2^j of them are the contiguous heap indices
// from (n + 1)·2^j - 1) load together, and, when those levels end at the
// leaves, the 2^K leaves below them with them. Then K compares descend:
// p, the position reached within each level, takes one bit a level.
// Returns the heap index reached; *leafv gets its leaf value if `leaves`.
template <int K>
__device__ __forceinline__ int walk_round(const int* __restrict__ tf,
                                          const float* __restrict__ tt,
                                          const float* __restrict__ tl,
                                          const float* __restrict__ x, int n,
                                          int NI, bool leaves, float* leafv) {
  int f[(1 << K) - 1];
  float h[(1 << K) - 1], l[1 << K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int q = 0; q < (1 << j); ++q) {
      const int node = ((n + 1) << j) - 1 + q;
      f[(1 << j) - 1 + q] = __ldg(tf + node);
      h[(1 << j) - 1 + q] = __ldg(tt + node);
    }
  }
  const int below = ((n + 1) << K) - 1;  // first heap index K levels down
  if (leaves) {
#pragma unroll
    for (int q = 0; q < (1 << K); ++q) l[q] = __ldg(tl + below - NI + q);
  }
  static_assert(K >= 1 && K <= 3, "a round takes 1 to 3 levels");
  int p = descend<0>(f, h, x, 0);
  if constexpr (K > 1) p = descend<1>(f, h, x, p);
  if constexpr (K > 2) p = descend<2>(f, h, x, p);
  if (leaves) *leafv = pick<(1 << K)>(l, p);
  return below + p;
}

// The leaf value tree (tf, tt, tl) gives the lane's features x: three
// levels a round trip, the last round with the leaves (two round trips at
// depth 4 to 6).
__device__ __forceinline__ float walk(const int* __restrict__ tf,
                                      const float* __restrict__ tt,
                                      const float* __restrict__ tl,
                                      const float* __restrict__ x, int NI,
                                      int depth) {
  int n = 0, d = 0;
  float v = 0.f;
  for (; depth - d > 3; d += 3)
    n = walk_round<3>(tf, tt, tl, x, n, NI, false, &v);
  switch (depth - d) {
    case 3: walk_round<3>(tf, tt, tl, x, n, NI, true, &v); break;
    case 2: walk_round<2>(tf, tt, tl, x, n, NI, true, &v); break;
    case 1: walk_round<1>(tf, tt, tl, x, n, NI, true, &v); break;
    default: v = __ldg(tl + n - NI);  // depth 0: the root is the leaf
  }
  return v;
}

__global__ void __launch_bounds__(kMaxThreads) gbdt_kernel(
    const float* __restrict__ feats, const int* __restrict__ feat,
    const float* __restrict__ thresh, const float* __restrict__ leaf,
    float base, float* __restrict__ out,
    int F, int T, int NI, int NL, int depth) {
  extern __shared__ float sv[];  // [T] the lane's leaf values, by tree
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* x = feats + (size_t)b * F;
  // one thread a 128-byte line of the lane's features
  const char* line = reinterpret_cast<const char*>(
      reinterpret_cast<uintptr_t>(x) & ~uintptr_t{127}) + 128 * tid;
  if (line < reinterpret_cast<const char*>(x + F))
    asm volatile("prefetch.global.L1 [%0];" ::"l"(line));
  for (int t = tid; t < T; t += blockDim.x)
    sv[t] = walk(feat + (size_t)t * NI, thresh + (size_t)t * NI,
                 leaf + (size_t)t * NL, x, NI, depth);
  __syncthreads();
  if (tid == 0) {  // tree order; 16-byte loads keep the adds fed
    float s = 0.f;
    int t = 0;
#pragma unroll 8
    for (; t + 4 <= T; t += 4) {
      const float4 v = *reinterpret_cast<const float4*>(sv + t);
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
    for (; t < T; ++t) s += sv[t];
    out[b] = base + s;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes: the lane's T leaf values.
size_t gbdt_smem_bytes(int T) { return sizeof(float) * (size_t)T; }

int gbdt_predict_f32(const void* feats, const void* feat, const void* thresh,
                     const void* leaf, float base, void* out,
                     int B, int F, int T, int NI, int NL, int depth,
                     void* stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(gbdt_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaSuccess;
  int threads = (T + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : threads;
  gbdt_kernel<<<B, threads, gbdt_smem_bytes(T),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const int*>(feat),
      static_cast<const float*>(thresh), static_cast<const float*>(leaf),
      base, static_cast<float*>(out), F, T, NI, NL, depth);
  return (int)cudaGetLastError();
}

const char* gbdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

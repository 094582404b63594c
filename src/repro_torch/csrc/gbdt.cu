// K2: GBDT ensemble inference (the E2E cost estimator), [B, F] -> [B].
//
// Replaces the TPU kernel repro/kernels/gbdt.py::_gbdt_kernel. Wrapper and
// plain version: repro_torch/kernels/gbdt.py.
//
// Trees are complete and heap-packed: feat/thresh [T, NI = 2^D - 1],
// leaf [T, NL = 2^D]. Each thread block takes kLanes query lanes, copies
// the whole forest and those lanes' features into shared memory, walks
// `depth` levels per (lane, tree) pair — feature id, threshold,
// `x <= th`, descend — and sums the T leaves of each lane in tree order
// before adding `base`.
//
// What bounds it on an H100: bytes and latency, not arithmetic. The forest
// (T*(2*NI + NL)*4 bytes, 75 KB at T=200, D=5) is read once per block and
// the features once; the work is B*T*depth dependent shared-memory loads.
// At B=64 the launch is a handful of blocks, so its time is the forest
// load and the launch itself; batching kLanes lanes per block amortizes
// the forest load across them.
#include <cuda_runtime.h>

#include "step_common.cuh"  // opt_in_smem_once

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;

__global__ void __launch_bounds__(kThreads) gbdt_kernel(
    const float* __restrict__ feats, const int* __restrict__ feat,
    const float* __restrict__ thresh, const float* __restrict__ leaf,
    float base, float* __restrict__ out,
    int B, int F, int T, int NI, int NL, int depth) {
  extern __shared__ float smem[];
  int* sf = reinterpret_cast<int*>(smem);   // [T, NI]
  float* st = smem + (size_t)T * NI;         // [T, NI]
  float* sl = st + (size_t)T * NI;           // [T, NL]
  float* sx = sl + (size_t)T * NL;           // [kLanes, F]
  float* sv = sx + (size_t)kLanes * F;       // [kLanes, T]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kLanes;
  const int nl = B - b0 < kLanes ? B - b0 : kLanes;

  for (int i = tid; i < T * NI; i += kThreads) { sf[i] = feat[i]; st[i] = thresh[i]; }
  for (int i = tid; i < T * NL; i += kThreads) sl[i] = leaf[i];
  for (int i = tid; i < nl * F; i += kThreads) sx[i] = feats[(size_t)b0 * F + i];
  __syncthreads();

  for (int p = tid; p < nl * T; p += kThreads) {
    const int l = p / T, t = p - l * T;
    int idx = 0;
    for (int d = 0; d < depth; ++d) {
      const float xv = sx[l * F + sf[t * NI + idx]];
      idx = 2 * idx + 1 + (xv <= st[t * NI + idx] ? 0 : 1);
    }
    sv[l * T + t] = sl[t * NL + idx - NI];
  }
  __syncthreads();

  if (tid < nl) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += sv[tid * T + t];
    out[b0 + tid] = base + s;
  }
}

}  // namespace

extern "C" {

size_t gbdt_smem_bytes(int F, int T, int NI, int NL) {
  return sizeof(float) * ((size_t)T * (2 * (size_t)NI + NL) +
                          (size_t)kLanes * (F + T));
}

int gbdt_predict_f32(const void* feats, const void* feat, const void* thresh,
                     const void* leaf, float base, void* out,
                     int B, int F, int T, int NI, int NL, int depth,
                     void* stream) {
  const size_t smem = gbdt_smem_bytes(F, T, NI, NL);
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(gbdt_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kLanes - 1) / kLanes;
  gbdt_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const int*>(feat),
      static_cast<const float*>(thresh), static_cast<const float*>(leaf),
      base, static_cast<float*>(out), B, F, T, NI, NL, depth);
  return (int)cudaGetLastError();
}

const char* gbdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// re-sort of next_pow2(M + R) entries. One block per lane, sized to the
// wider run. All four inputs load in one round, distances with their
// payloads, the buffer in 16-byte vectors where it is aligned (V = 4);
// every entry stays in its thread's registers until it is written out.
// The new entries are ranked by (distance, position) through warp
// shuffles: warp w owns entries 32w..32w+31, one a lane, and takes the
// other entries' keys 32 at a time by __shfl_sync, as merge_by_rank in
// step_common.cuh does for K1 and K5. The buffer's keys and the new run,
// sorted by rank, go to shared memory, and after the one barrier every
// entry finds its output rank in the other run: old entry i lands at
// i + #{new < d_i}, counted in one pass over the sorted new run (every
// thread reads the same word, and a thread's four entries count
// together), new entry s of the sorted run at s + #{old <= d_s} (old wins
// ties), by binary search, and each writes itself out if that rank is
// below M. The ranks are a permutation of 0..M+R-1, so every output slot
// is written once. The buffer must be sorted ascending (queue_merge's
// stated contract) and no distance may be NaN.
//
// What bounds it on an H100: latency — one round trip to memory, the
// rank's R shuffles a new entry, a barrier, R shared-memory reads per
// buffer load (broadcast, shared by its V entries) and log2 M for a new
// entry — not bytes (it reads [B, M + R] distances and payloads once and
// writes [B, M] of each: ≈ 0.54 MB at B=64, M=512, R=32).
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kGroups = 4;  // buffer loads a thread holds: M <= kGroups·V·1024

template <int V>  // buffer entries a load: 4 (one 16-byte vector) or 1
__global__ void __launch_bounds__(kMaxThreads) topm_merge_kernel(
    const float* __restrict__ dist, const int* __restrict__ pay,
    const float* __restrict__ new_dist, const int* __restrict__ new_pay,
    float* __restrict__ out_dist, int* __restrict__ out_pay, int M, int R) {
  extern __shared__ float smem[];
  float* old_k = smem;     // [M] the buffer's keys
  float* new_k = old_k + M;  // [R] the new run, sorted
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  const size_t om = (size_t)blockIdx.x * M, orr = (size_t)blockIdx.x * R;
  const float* nd = new_dist + orr;

  // the buffer: V entries a load, keys also to shared memory
  float k[kGroups][V];
  int p[kGroups][V];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int i = (tid + g * nt) * V;
    if (i < M) {
      if constexpr (V == 4) {
        const float4 kv = __ldg(reinterpret_cast<const float4*>(dist + om + i));
        const int4 pv = __ldg(reinterpret_cast<const int4*>(pay + om + i));
        k[g][0] = kv.x; k[g][1] = kv.y; k[g][2] = kv.z; k[g][3] = kv.w;
        p[g][0] = pv.x; p[g][1] = pv.y; p[g][2] = pv.z; p[g][3] = pv.w;
        *reinterpret_cast<float4*>(old_k + i) = kv;
      } else {
        k[g][0] = __ldg(dist + om + i);
        p[g][0] = __ldg(pay + om + i);
        old_k[i] = k[g][0];
      }
    }
  }
  // the new run: entry r on lane r mod 32 of warp r / 32, ranked by
  // (key, position) against every new entry
  const int r = tid;
  const bool has_new = r < R;
  const float kr = has_new ? __ldg(nd + r) : step::inf_f();
  const int pr = has_new ? __ldg(new_pay + orr + r) : 0;
  int s = 0;
  if (tid - lane < R) {
    for (int c = 0; c < R; c += 32) {
      const int j = c + lane;
      const float cj = c == tid - lane ? kr
                       : j < R ? __ldg(nd + j) : step::inf_f();
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float o = __shfl_sync(0xffffffffu, cj, t);
        s += o < kr || (o == kr && c + t < r);
      }
    }
    if (has_new) new_k[s] = kr;
  }
  __syncthreads();

  float* od = out_dist + om;
  int* op = out_pay + om;
  if (has_new) {
    const int o = s + step::count_below(old_k, M, kr, false);
    if (o < M) {
      od[o] = kr;
      op[o] = pr;
    }
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int i = (tid + g * nt) * V;
    if (i < M) {
      // #{new < d} for the V keys at once: one pass over the sorted new
      // run, every thread reading the same word (a broadcast)
      int c[V] = {};
      for (int j = 0; j < R; ++j) {
        const float e = new_k[j];
#pragma unroll
        for (int v = 0; v < V; ++v) c[v] += e < k[g][v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (i + v + c[v] < M) {
          od[i + v + c[v]] = k[g][v];
          op[i + v + c[v]] = p[g][v];
        }
      }
    }
  }
}

template <int V>
cudaError_t launch(const void* dist, const void* pay, const void* new_dist,
                   const void* new_pay, void* out_dist, void* out_pay, int B,
                   int M, int R, cudaStream_t stream) {
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(topm_merge_kernel<V>, opted_in);
  if (err != cudaSuccess) return err;
  const int loads = (M + V - 1) / V;
  int threads = ((loads > R ? loads : R) + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : threads;
  topm_merge_kernel<V><<<B, threads,
                         sizeof(float) * ((size_t)M + R), stream>>>(
      static_cast<const float*>(dist), static_cast<const int*>(pay),
      static_cast<const float*>(new_dist), static_cast<const int*>(new_pay),
      static_cast<float*>(out_dist), static_cast<int*>(out_pay), M, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these widths, in bytes, or 0
// when a block cannot take them: R > 1024, or M beyond the kGroups loads
// of V entries each of 1024 threads (vec: V = 4, the buffer 16-byte
// aligned with M a multiple of 4; else V = 1).
size_t topm_merge_smem_bytes(int M, int R, int vec) {
  const int V = vec ? 4 : 1;
  if (R > kMaxThreads || M > kGroups * V * kMaxThreads) return 0;
  return sizeof(float) * ((size_t)M + R);
}

int topm_merge_f32(const void* dist, const void* pay, const void* new_dist,
                   const void* new_pay, void* out_dist, void* out_pay, int B,
                   int M, int R, int vec, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dist) |
                         reinterpret_cast<uintptr_t>(pay);
  if (topm_merge_smem_bytes(M, R, vec) == 0 || (vec && (M % 4 || addr % 16)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<4>(dist, pay, new_dist, new_pay, out_dist,
                               out_pay, B, M, R, s)
                   : launch<1>(dist, pay, new_dist, new_pay, out_dist,
                               out_pay, B, M, R, s));
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

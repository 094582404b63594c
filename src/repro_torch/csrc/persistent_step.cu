// K5: persistent multi-step traversal (post mode; float32, int8 and PQ).
// One launch runs up to `steps` whole lockstep steps per query lane: pop,
// neighbor-id row, visited test-before-set, filter program, distances,
// queue and result merges, counters and the per-lane stop test.
//
// Replaces the TPU kernel repro/kernels/persistent_step.py::_persistent_kernel
// (called from persistent_multi_step). Wrapper and plain version:
// repro_torch/kernels/persistent_step.py.
//
// Design. One thread block per lane loops over the steps; lanes share
// nothing, so no block waits for another. The candidate queue (distance +
// packed payload, kernels/topk.py::pack_payload), the result set, the
// counters and the query row stay in shared memory across steps (≈12 KB
// at M=512, d=768); the merges write into a second pair of buffers, then
// the two swap, since the old payloads now live in shared memory. The
// visited bitset (⌈N/32⌉ words per lane, 125 KB at N=1M) stays in device
// memory and is updated in place. Each step reads the neighbor-id row and
// then, for the neighbors not yet visited only, their vector rows, label
// words and values straight from the index arrays: the TPU kernel's
// packed per-row DMA operands (build_persistent_operands) have no
// counterpart here. A lane's block exits after the step at which the lane
// stops (that step still runs: it clears `active` and evaluates the
// convergence test), and launches no step at all when no lane of the batch
// is active, which is when the reference's launch loop runs none.
//
// Codec branches (the reference kernel's int8 and PQ heads and distance
// blocks). The new neighbors' codes, ADC norms and reconstruction errors
// are read straight from the quant index (codes [N, d] int8 or [N, S·L]
// uint8, norms and err [N]); the int8 query (d bytes) sits in shared
// memory, the PQ table lut [S·L, Kc] of the lane stays in device memory.
// The PQ distances are K4's head (step_common.cuh::pq_head) over the new
// rows only: their codes read by id into shared memory, the lane's table
// streamed in by bulk copies of 48 rows while one thread per row sums the
// previous chunk in slot order; its note says what bounds it. The step's
// reconstruction errors of new neighbors are summed by the halving tree of
// core/step.py::tree_sum into q_err_sum, carried in a register and written
// back.
//
// Bit-exactness with the single-step path (core/step.py + K1/K3/K4): the
// distance, program and merge code is theirs (step_common.cuh, same block
// size and thread mapping); the pop takes the first minimum over
// unexpanded slots, as argmin does, by reducing (key, slot) pairs; every
// id of the row is tested against the pre-step words before any bit is
// set (a barrier between), and the set is an integer add, so an id
// repeated within a row counts as new twice and carries into the next bit.
//
// What bounds it on an H100: neither bytes nor operations but the latency
// of each lane's serial step chain. The bytes a launch must move are the
// new rows it gathers (≤ R·d·4 B = 98 KB per lane-step at R=32, d=768;
// ≈15 µs for 8 steps of 64 lanes at 3.35 TB/s), but the steps of a lane
// run one after another, each waiting on the last. The design removes the
// host from that chain — one launch and one readback per `steps` steps
// instead of ≈100 launches per step — and merges by rank
// (step_common.cuh::merge_by_rank, K1's merge): the new run rank-sorted
// by one warp's shuffles, every entry placed by binary search in the
// other run, straight from and into the shared-memory buffers. That
// replaces the 1024- and 64-wide bitonic sorts, 76 barrier stages a step,
// with one barrier, and frees their 8 KB of key and position buffers.
// What is left on a step's critical path is the chain of dependent reads
// pop → id row → visited words → rows, with its barriers, on one block
// per lane, 64 of the 132 SMs at B=64; under PQ, the head's table stream
// and its slot-order sum come first.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using step::kClauseSlots;
using step::kThreads;
using step::kWarps;

constexpr int kExpandedBit = 1 << 29;
constexpr int kValidBit = 1 << 30;
constexpr int kIdMask = (1 << 29) - 1;

constexpr int kF32 = 0, kInt8 = 1, kPQ = 2;  // distance heads

struct PersistArgs {
  const float* q;           // [B, D] (float32)
  const float* base;        // [N, D] (float32)
  const int* labels;        // [N, W] (uint32 bit patterns)
  const float* values;      // [N, V]
  const int* neighbors;     // [N, R]
  step::Program prog;       // leaves [B, S, ...]
  const int* budgets;       // [B]
  const float* gt;          // [B, K] or null
  // incoming SearchState leaves
  const float* cand_dist;   // [B, M]
  const int* cand_idx;      // [B, M]
  const uint8_t* cand_exp;  // [B, M] bool
  const uint8_t* cand_valid;  // [B, M] bool
  const float* res_dist;    // [B, K]
  const int* res_idx;       // [B, K]
  int* visited;             // [B, NW], updated in place
  const int* cnt;           // [B]
  const int* n_inspected;   // [B]
  const int* n_valid_visited;  // [B]
  const int* n_clause_valid;   // [B, 4]
  const int* n_pop_valid;   // [B]
  const int* hops;          // [B]
  const uint8_t* active;    // [B] bool
  const int* conv_cnt;      // [B]
  const int* res_full_cnt;  // [B]
  // outgoing leaves (same shapes)
  float* o_cand_dist;
  int* o_cand_idx;
  uint8_t* o_cand_exp;
  uint8_t* o_cand_valid;
  float* o_res_dist;
  int* o_res_idx;
  int* o_cnt;
  int* o_n_inspected;
  int* o_n_valid_visited;
  int* o_n_clause_valid;
  int* o_n_pop_valid;
  int* o_hops;
  uint8_t* o_active;
  int* o_conv_cnt;
  int* o_res_full_cnt;
  // codec branches (null under float32, where q_err_sum passes through)
  const void* codes;        // [N, D] int8 | [N, SL=D] uint8
  const float* qnorms;      // [N] ADC norms
  const float* qerr;        // [N] reconstruction errors
  const int8_t* qq;         // [B, D] quantized query (int8)
  const float* sq;          // [B] its step (int8)
  const float* qn;          // [B] query norm (int8, pq)
  const float* lut;         // [B, SL, Kc] lookup table (pq)
  const float* q_err_sum;   // [B]
  float* o_q_err_sum;       // [B]
  int B, R, D, M, K, NW, steps, greedy;
  int prec, Kc, QW, P;      // head; PQ Kc; query-head words; pow2 >= R
};

__global__ void __launch_bounds__(kThreads) persistent_step_kernel(PersistArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M, K = a.K, R = a.R, D = a.D;
  const int W = a.prog.W, V = a.prog.V;
  float* qs = smem;  // [QW]: query row | packed qq | PQ head
  float* cd = qs + a.QW;                                // [M] x 2
  float* cd2 = cd + M;
  int* cp = reinterpret_cast<int*>(cd2 + M);            // [M] x 2
  int* cp2 = cp + M;
  float* rd = reinterpret_cast<float*>(cp2 + M);        // [K] x 2
  float* rd2 = rd + K;
  int* ri = reinterpret_cast<int*>(rd2 + K);            // [K] x 2
  int* ri2 = ri + K;
  float* dist = reinterpret_cast<float*>(ri2 + K);      // [R]
  int* vld = reinterpret_cast<int*>(dist + R);          // [R]
  int* isnew = vld + R;                                 // [R]
  int* nbs = isnew + R;                                 // [R]
  float* nkq = reinterpret_cast<float*>(nbs + R);       // [R] new keys,
  float* nkr = nkq + R;                                 // [R] sorted
  int* ccnt = reinterpret_cast<int*>(nkr + R);          // [4]
  float* red = reinterpret_cast<float*>(ccnt + kClauseSlots);  // [kWarps + 1]
  float* popk = red + kWarps + 1;                       // [kWarps]
  int* pops = reinterpret_cast<int*>(popk + kWarps);    // [kWarps]
  int* ctl = pops + kWarps;                             // [4]
  float* ebuf = reinterpret_cast<float*>(ctl + 4);      // [P]

  // ---- the lane's state into shared memory ----
  const size_t bm = (size_t)b * M, bk = (size_t)b * K;
  for (int i = tid; i < M; i += kThreads) {
    const int idx = a.cand_idx[bm + i];
    cd[i] = a.cand_dist[bm + i];
    cp[i] = idx < 0 ? -1 : (idx | (a.cand_exp[bm + i] ? kExpandedBit : 0) |
                            (a.cand_valid[bm + i] ? kValidBit : 0));
  }
  for (int i = tid; i < K; i += kThreads) {
    rd[i] = a.res_dist[bk + i];
    ri[i] = a.res_idx[bk + i];
  }
  if (tid == 0) ctl[2] = 0;
  if (tid < kClauseSlots) ccnt[tid] = 0;
  __syncthreads();
  for (int i = tid; i < a.B; i += kThreads)
    if (a.active[i]) ctl[2] = 1;  // some lane of the launch is active
  // ---- the query head ----
  float qn, sq2 = 0.f;
  int* qq4 = reinterpret_cast<int*>(qs);
  const float* lut = nullptr;
  if (a.prec == kF32) {
    qn = step::query_sqnorm(a.q + (size_t)b * D, qs, D, red);
  } else {
    qn = a.qn[b];
    if (a.prec == kInt8) {
      const int* src = reinterpret_cast<const int*>(a.qq + (size_t)b * D);
      for (int i = tid; i < a.QW; i += kThreads) qq4[i] = src[i];
      sq2 = __fmul_rn(2.f, a.sq[b]);
    } else {
      lut = a.lut + (size_t)b * D * a.Kc;
    }
  }
  __syncthreads();
  const int nsteps = ctl[2] ? a.steps : 0;

  // per-lane counters: thread 0 owns them
  int cnt = 0, nin = 0, nvv = 0, npv = 0, hops = 0, conv = 0, rfull = 0;
  float qerr = 0.f;
  int ncl[kClauseSlots] = {0, 0, 0, 0};
  bool prev_act = a.active[b] != 0;
  int budget = 0;
  if (tid == 0) {
    cnt = a.cnt[b]; nin = a.n_inspected[b]; nvv = a.n_valid_visited[b];
    npv = a.n_pop_valid[b]; hops = a.hops[b]; conv = a.conv_cnt[b];
    rfull = a.res_full_cnt[b]; budget = a.budgets[b];
    if (a.prec != kF32) qerr = a.q_err_sum[b];
    for (int c = 0; c < kClauseSlots; ++c)
      ncl[c] = a.n_clause_valid[b * kClauseSlots + c];
  }
  const float* gt = a.gt ? a.gt + bk : nullptr;
  int* vis = a.visited + (size_t)b * a.NW;
  const int nc = a.prog.S < kClauseSlots ? a.prog.S : kClauseSlots;
  int pq_heads = 0;  // PQ heads run so far (step_common.cuh::pq_head)

  for (int s = 0; s < nsteps; ++s) {
    // ---- pop: first minimum over unexpanded slots, on (key, slot) ----
    float bkey = step::inf_f();
    int bslot = INT_MAX;
    for (int j = tid; j < M; j += kThreads) {
      const int pay = cp[j];
      const float k = (pay >= 0 && !(pay & kExpandedBit)) ? cd[j] : step::inf_f();
      if (k < bkey || (k == bkey && j < bslot)) { bkey = k; bslot = j; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ok = __shfl_down_sync(0xffffffffu, bkey, off);
      const int os = __shfl_down_sync(0xffffffffu, bslot, off);
      if (ok < bkey || (ok == bkey && os < bslot)) { bkey = ok; bslot = os; }
    }
    if (lane == 0) { popk[warp] = bkey; pops[warp] = bslot; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (popk[w] < bkey || (popk[w] == bkey && pops[w] < bslot)) {
          bkey = popk[w]; bslot = pops[w];
        }
      const int pay = cp[bslot];
      bool act = prev_act && isfinite(bkey) && cnt < budget;
      if (a.greedy) {
        const float worst = rd[K - 1];
        act = act && !(isfinite(worst) && bkey > worst);
      }
      if (act) {
        cp[bslot] = pay | kExpandedBit;
        npv += (pay & kValidBit) ? 1 : 0;
      }
      ctl[0] = act;
      ctl[1] = pay & kIdMask;
    }
    __syncthreads();
    if (!ctl[0]) {
      // the stopping step: the lane goes inactive, and the convergence
      // test still runs on the unchanged result set
      if (tid == 0) {
        if (gt && conv < 0) {
          bool covered = true;
          for (int i = 0; i < K; ++i)
            covered = covered && rd[i] <= __fadd_rn(gt[i], 1e-6f);
          if (covered) conv = cnt;
        }
        prev_act = false;
      }
      break;
    }
    const int u = ctl[1];

    // ---- neighbor ids and the visited test, on the pre-step words ----
    for (int r = tid; r < R; r += kThreads) {
      const int nb = a.neighbors[(size_t)u * R + r];
      const int ns = nb < 0 ? 0 : nb;
      const unsigned word = (unsigned)__ldcg(vis + (ns >> 5));
      nbs[r] = nb;
      isnew[r] = nb >= 0 && !(word & (1u << (ns & 31)));
    }
    __syncthreads();
    // ---- visited set: integer add, as the reference's uint32 add ----
    for (int r = tid; r < R; r += kThreads)
      if (isnew[r])
        atomicAdd(reinterpret_cast<unsigned*>(vis + (nbs[r] >> 5)),
                  1u << (nbs[r] & 31));

    // ---- distances to the new rows ----
    if (a.prec == kF32) {  // squared L2, one warp per row
      for (int r = warp; r < R; r += kWarps) {
        if (isnew[r]) {
          const float d = step::row_sqdist(qs, a.base + (size_t)nbs[r] * D,
                                           D, qn, lane);
          if (lane == 0) dist[r] = d;
        }
      }
    } else if (a.prec == kInt8) {  // int8 ADC, one warp per row
      const int8_t* codes = static_cast<const int8_t*>(a.codes);
      for (int r = warp; r < R; r += kWarps) {
        if (isnew[r]) {
          const float d = step::row_int8_dist(
              qq4, codes + (size_t)nbs[r] * D, a.QW, qn, sq2,
              a.qnorms[nbs[r]], lane);
          if (lane == 0) dist[r] = d;
        }
      }
    } else {  // PQ ADC of the new rows, the table streamed by chunks
      step::pq_head(dist, qs, lut, a.Kc, static_cast<const uint8_t*>(a.codes),
                    a.qnorms, D, R, nbs, 0, isnew, qn, pq_heads++);
    }
    // ---- reconstruction errors of the new rows, zero-padded to P ----
    if (a.prec != kF32)
      for (int r = tid; r < a.P; r += kThreads)
        ebuf[r] = (r < R && isnew[r]) ? a.qerr[nbs[r]] : 0.f;
    // ---- filter program on the new rows ----
    for (int r = tid; r < R; r += kThreads) {
      int valid = 0;
      if (isnew[r]) {
        uint32_t sat = 0u;
        valid = step::program_eval(a.prog, b, a.labels + (size_t)nbs[r] * W,
                                   a.values + (size_t)nbs[r] * V, &sat);
        for (int c = 0; c < nc; ++c)
          if ((sat >> c) & 1u) atomicAdd(&ccnt[c], 1);
      }
      vld[r] = valid;
    }
    __syncthreads();
    // the halving-tree sum of core/step.py::tree_sum; only thread 0 reads
    // ebuf until the next step's fill, which is behind the pop barrier
    if (a.prec != kF32 && tid == 0)
      for (int h = a.P >> 1; h > 0; h >>= 1)
        for (int i = 0; i < h; ++i) ebuf[i] = __fadd_rn(ebuf[i], ebuf[i + h]);

    // ---- merges into the second buffers, then swap ----
    step::merge_by_rank(cd, cp, rd, ri, dist, isnew, vld, nbs, M, K, R, nkq,
                        nkr, cd2, cp2, rd2, ri2);
    __syncthreads();
    { float* t = cd; cd = cd2; cd2 = t; }
    { int* t = cp; cp = cp2; cp2 = t; }
    { float* t = rd; rd = rd2; rd2 = t; }
    { int* t = ri; ri = ri2; ri2 = t; }

    // ---- counters (post mode: every new node gets a distance) ----
    if (tid == 0) {
      int ndc = 0, nval = 0;
      for (int r = 0; r < R; ++r) { ndc += isnew[r]; nval += vld[r]; }
      cnt += ndc;
      nin += ndc;
      nvv += nval;
      for (int c = 0; c < kClauseSlots; ++c) { ncl[c] += ccnt[c]; ccnt[c] = 0; }
      hops += 1;
      if (a.prec != kF32) qerr = __fadd_rn(qerr, ebuf[0]);
      if (gt && conv < 0) {
        bool covered = true;
        for (int i = 0; i < K; ++i)
          covered = covered && rd[i] <= __fadd_rn(gt[i], 1e-6f);
        if (covered) conv = cnt;
      }
      if (rfull < 0 && isfinite(rd[K - 1])) rfull = cnt;
    }
  }

  // ---- write the lane's state back ----
  for (int i = tid; i < M; i += kThreads) {
    const int pay = cp[i];
    a.o_cand_dist[bm + i] = cd[i];
    a.o_cand_idx[bm + i] = pay < 0 ? -1 : (pay & kIdMask);
    a.o_cand_exp[bm + i] = pay >= 0 && (pay & kExpandedBit);
    a.o_cand_valid[bm + i] = pay >= 0 && (pay & kValidBit);
  }
  for (int i = tid; i < K; i += kThreads) {
    a.o_res_dist[bk + i] = rd[i];
    a.o_res_idx[bk + i] = ri[i];
  }
  if (tid == 0) {
    a.o_cnt[b] = cnt; a.o_n_inspected[b] = nin; a.o_n_valid_visited[b] = nvv;
    a.o_n_pop_valid[b] = npv; a.o_hops[b] = hops; a.o_conv_cnt[b] = conv;
    a.o_res_full_cnt[b] = rfull; a.o_active[b] = prev_act;
    for (int c = 0; c < kClauseSlots; ++c)
      a.o_n_clause_valid[b * kClauseSlots + c] = ncl[c];
    if (a.prec != kF32) a.o_q_err_sum[b] = qerr;
  }
}

// Shared-memory words of the query head: the query row (float32), the
// packed int8 query, or step_common.cuh::pq_head_words (pq).
int head_words(int prec, int R, int D, int Kc) {
  return prec == kF32    ? D
         : prec == kInt8 ? D / 4
                         : (int)step::pq_head_words(R, D, Kc);
}

int pow2_at_least(int R) {
  int P = 1;
  while (P < R) P <<= 1;
  return P;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these widths, in bytes: the
// head (prec: 0 = float32, 1 = int8, 2 = pq; D is d or S·L; Kc for pq),
// both buffer pairs, the step's rows, counts, controls and the error sum.
size_t persistent_step_smem_bytes(int prec, int R, int D, int M, int K,
                                  int Kc) {
  return sizeof(float) * ((size_t)head_words(prec, R, D, Kc) +
                          4 * (size_t)M + 4 * (size_t)K +
                          6 * (size_t)R + kClauseSlots + 3 * kWarps + 1 + 4 +
                          (size_t)pow2_at_least(R));
}

// ptrs: the 56 pointers of PersistArgs in declaration order (gt, and the
// codec pointers under float32, may be null); dims: B, R, D, M, K, W, V, S,
// T, NW, steps, greedy, prec (0 = float32, 1 = int8, 2 = pq), Kc,
// where steps is the number of steps this launch may take and D is d
// (float32; int8, a multiple of 4) or S·L (pq).
int persistent_step_f32(void* const* ptrs, const int* dims, void* stream) {
  PersistArgs a;
  const void* const* p = ptrs;
  int i = 0;
  a.q = static_cast<const float*>(p[i++]);
  a.base = static_cast<const float*>(p[i++]);
  a.labels = static_cast<const int*>(p[i++]);
  a.values = static_cast<const float*>(p[i++]);
  a.neighbors = static_cast<const int*>(p[i++]);
  a.prog.kinds = static_cast<const int*>(p[i++]);
  a.prog.masks = static_cast<const int*>(p[i++]);
  a.prog.lo = static_cast<const float*>(p[i++]);
  a.prog.hi = static_cast<const float*>(p[i++]);
  a.prog.vattr = static_cast<const int*>(p[i++]);
  a.prog.neg = static_cast<const uint8_t*>(p[i++]);
  a.prog.term = static_cast<const int*>(p[i++]);
  a.prog.active = static_cast<const uint8_t*>(p[i++]);
  a.prog.term_active = static_cast<const uint8_t*>(p[i++]);
  a.budgets = static_cast<const int*>(p[i++]);
  a.gt = static_cast<const float*>(p[i++]);
  a.cand_dist = static_cast<const float*>(p[i++]);
  a.cand_idx = static_cast<const int*>(p[i++]);
  a.cand_exp = static_cast<const uint8_t*>(p[i++]);
  a.cand_valid = static_cast<const uint8_t*>(p[i++]);
  a.res_dist = static_cast<const float*>(p[i++]);
  a.res_idx = static_cast<const int*>(p[i++]);
  a.visited = static_cast<int*>(const_cast<void*>(p[i++]));
  a.cnt = static_cast<const int*>(p[i++]);
  a.n_inspected = static_cast<const int*>(p[i++]);
  a.n_valid_visited = static_cast<const int*>(p[i++]);
  a.n_clause_valid = static_cast<const int*>(p[i++]);
  a.n_pop_valid = static_cast<const int*>(p[i++]);
  a.hops = static_cast<const int*>(p[i++]);
  a.active = static_cast<const uint8_t*>(p[i++]);
  a.conv_cnt = static_cast<const int*>(p[i++]);
  a.res_full_cnt = static_cast<const int*>(p[i++]);
  a.o_cand_dist = static_cast<float*>(const_cast<void*>(p[i++]));
  a.o_cand_idx = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_cand_exp = static_cast<uint8_t*>(const_cast<void*>(p[i++]));
  a.o_cand_valid = static_cast<uint8_t*>(const_cast<void*>(p[i++]));
  a.o_res_dist = static_cast<float*>(const_cast<void*>(p[i++]));
  a.o_res_idx = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_cnt = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_n_inspected = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_n_valid_visited = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_n_clause_valid = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_n_pop_valid = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_hops = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_active = static_cast<uint8_t*>(const_cast<void*>(p[i++]));
  a.o_conv_cnt = static_cast<int*>(const_cast<void*>(p[i++]));
  a.o_res_full_cnt = static_cast<int*>(const_cast<void*>(p[i++]));
  a.codes = p[i++];
  a.qnorms = static_cast<const float*>(p[i++]);
  a.qerr = static_cast<const float*>(p[i++]);
  a.qq = static_cast<const int8_t*>(p[i++]);
  a.sq = static_cast<const float*>(p[i++]);
  a.qn = static_cast<const float*>(p[i++]);
  a.lut = static_cast<const float*>(p[i++]);
  a.q_err_sum = static_cast<const float*>(p[i++]);
  a.o_q_err_sum = static_cast<float*>(const_cast<void*>(p[i++]));
  a.B = dims[0]; a.R = dims[1]; a.D = dims[2]; a.M = dims[3]; a.K = dims[4];
  a.prog.W = dims[5]; a.prog.V = dims[6]; a.prog.S = dims[7];
  a.prog.T = dims[8]; a.NW = dims[9]; a.steps = dims[10]; a.greedy = dims[11];
  a.prec = dims[12]; a.Kc = dims[13];
  if (a.prec < kF32 || a.prec > kPQ) return (int)cudaErrorInvalidValue;
  a.QW = head_words(a.prec, a.R, a.D, a.Kc);
  a.P = pow2_at_least(a.R);
  const size_t smem =
      persistent_step_smem_bytes(a.prec, a.R, a.D, a.M, a.K, a.Kc);
  static bool opted_in[step::kMaxDevices] = {};
  cudaError_t err = step::opt_in_smem_once(persistent_step_kernel, opted_in);
  if (err != cudaSuccess) return (int)err;
  persistent_step_kernel<<<a.B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* persistent_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

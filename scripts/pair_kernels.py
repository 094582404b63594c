#!/usr/bin/env python3
"""Time the traversal kernels of two checkouts on one card, in turns.

    python3 scripts/pair_kernels.py BEFORE AFTER     # runs BEFORE, AFTER,
                                                     # AFTER, BEFORE

Each turn is a process that imports BEFORE's or AFTER's `src/` (the
kernels, built from that checkout's `csrc/`) and runs THIS checkout's
kernel checks on them, so both are timed by the same code within one
call: K1 at R=32 and R'=160, K3, K4 and K5's three branches at the main
path's shapes (B=64, d=768, M=512, K=10; K5 over its N=1M synthetic
index), K6 at B=64, R=32, K6's row-id variant at the "mixed" forced
scan's shape (B=64, N=1M, V=2^19, ≈11.1 M pairs) and the oracle's (V =
2^18), K2 at B=64, F=68, T=200, D=5, K7 at B=64, M=512, R=32, and K6q
rows int8 and PQ at the scan's and the compressed oracle's shapes
(`chip_smoke.k6q_timing_inputs`; ms by CUDA events). Each check holds the
kernel against its plain version. Prints one JSON line
per turn, {"root", "turn", "ms": {kernel: device ms}, "call_ms": {...},
"floor": {kernel: the launch floor measured beside it}}, then the card's
`nvidia-smi` name and power limit.
Needs a CUDA device and nvcc; the wrappers' signatures must be the same
in both checkouts.

    python3 scripts/pair_kernels.py --stamps ROOT [ROOT ...]

breaks the PQ head of K4 and K5's pq branch and K2 down by in-kernel
`clock64()` stamps, for each checkout in turn: a copy of ROOT's `src/`
under `build/stamps/` gets the stamps inserted at fixed points of its
head (either the whole-row staging `pq_stage` or the chunked `pq_head`)
and of its K2 (the forest staged per block of 8 lanes, or walked where it
lies, one block a lane), is built, and runs K4 at B=64, R=32 (and R'=160
where the head takes it), one 8-step K5 pq launch over the N=1M synthetic
index of `chip_smoke.py`, K2 at B=64, F=68, T=200, D=5, and K7 at B=64,
M=512, R=32 where its merge loads in one round (an older K7 is not
stamped), and K6q rows PQ at the scan's and the oracle's shapes (the
earlier kernel over 1024-position tiles or the work-item kernel, found by
its text). Thread 0 of each block
adds the cycles between stamps into a device array, so each phase reads
as cycles per lane-step (K2, K7: per block); barrier-to-barrier phases
are the block's, and the rest thread 0's own. K6q's stamps are every
thread's own cycles, summed over all threads, and read as each phase's
share of the whole. Prints one JSON line per checkout and kernel, with
the SM clock `nvidia-smi` read under load. The committed sources carry
no stamps.

    python3 scripts/pair_kernels.py --ablate ROOT

times ROOT's K6q rows PQ (the segment kernel) at both shapes as it is,
with its table lookups replaced by register arithmetic, with its code
loads replaced by a hash of the address, and with neither (`ABLATIONS`;
a patched copy under `build/ablate/` each, values wrong, timing only):
what each part of the work costs. One JSON line per ablation.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = (  # (kernel, chip_smoke function, its arguments after the device)
    ("K1", "check_step_kernel", ()),
    ("K1 R'=160", "check_step_kernel", ("float32", 160)),
    ("K3", "check_step_kernel", ("int8",)),
    ("K4", "check_step_kernel", ("pq",)),
    ("K5", "check_k5", ()),
    ("K5 int8", "check_k5_codec", ("int8",)),
    ("K5 pq", "check_k5_codec", ("pq",)),
    ("K6", "check_k6", ()),
    ("K6 rows", "time_k6_rows", ("scan",)),
    ("K6 rows oracle", "time_k6_rows", ("oracle",)),
    ("K2", "check_k2", (False,)),
    ("K7", "check_k7", ()),
    ("K6q int8", "time_k6q_rows", ("int8", ("scan",), False)),
    ("K6q int8 oracle", "time_k6q_rows", ("int8", ("oracle",), False)),
    ("K6q PQ", "time_k6q_rows", ("pq", ("scan",), False)),
    ("K6q PQ oracle", "time_k6q_rows", ("pq", ("oracle",), False)),
)


def one_turn(root: str) -> dict:
    """Run this checkout's checks on `root`'s kernels in this process and
    return their times."""
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    import contextlib
    import io

    import torch

    import repro_torch  # noqa: F401  (root's package, before chip_smoke's)
    from repro_torch.kernels import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    device = torch.device("cuda")
    ms, call_ms, floor = {}, {}, {}
    for name, fn, extra in CHECKS:
        with contextlib.redirect_stdout(io.StringIO()):  # its phase lines
            out = getattr(chip_smoke, fn)(device, *extra)
        ms[name], call_ms[name] = out["ms"], out["call_ms"]
        if "floor_ms" in out:  # the launch floor, measured beside it
            floor[name] = {"ms": out["floor_ms"],
                           "call_ms": out["floor_call_ms"]}
    return {"root": root, "src": os.path.dirname(repro_torch.__file__),
            "ms": ms, "call_ms": call_ms, "floor": floor}


# ------------------------------------------------------------ stamps ----
STAMP_PRELUDE = """namespace step {
__device__ unsigned long long g_stamp[16];
__device__ __forceinline__ void stamp_lap(int slot, long long* t) {
  const long long now = clock64();
  if (threadIdx.x == 0)
    atomicAdd(&g_stamp[slot], (unsigned long long)(now - *t));
  *t = now;
}
template <typename T>
__device__ __forceinline__ void stamp_wait(const T* a, int n) {
  if (threadIdx.x == 0) {  // consume the loaded values: wait for them
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += (float)a[i];
    asm volatile("mov.b32 %0, %0;" : "+f"(acc));
  }
}
// per-thread laps (K6q): every thread adds its own cycles into *acc;
// stamp_flush sums a warp's and adds them to slot `slot`
__device__ __forceinline__ void stamp_acc(long long* acc, long long* t) {
  const long long now = clock64();
  *acc += now - *t;
  *t = now;
}
__device__ __forceinline__ void stamp_flush(int slot, long long v) {
  unsigned long long u = (unsigned long long)v;
  for (int off = 16; off > 0; off >>= 1)
    u += __shfl_down_sync(0xffffffffu, u, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(&g_stamp[slot], u);
}
template <int N>
__device__ __forceinline__ void stamp_use(const uint32_t (&w)[N]) {
  uint32_t x = 0u;  // consume the loaded words: wait for them
#pragma unroll
  for (int i = 0; i < N; ++i) x ^= w[i];
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
}
"""
STAMP_READER = """
extern "C" int stamps_io(unsigned long long* host, int clear) {
  if (clear) {
    unsigned long long z[16] = {};
    return (int)cudaMemcpyToSymbol(step::g_stamp, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, step::g_stamp,
                                   16 * sizeof(unsigned long long));
}
"""

# the head's count of lane-steps, by thread 0 ({} is the indent)
COUNT_HEAD = "{}if (tid == 0) atomicAdd(&step::g_stamp[0], 1ull);\n"
# (file, text, stamped text) for both heads: the K4 kernel and the K5 step
# from start to end, under PQ.
STAMP_COMMON = [
    ("step_common.cuh", "namespace step {\n", STAMP_PRELUDE),
    ("fused_step.cu", "  if (tid < kClauseSlots) cnt[tid] = 0;\n",
     "  long long k_ = clock64(), h_ = 0, s_ = 0;\n"
     "  if (tid < kClauseSlots) cnt[tid] = 0;\n"),
    ("fused_step.cu",
     "  if (tid < kClauseSlots) a.out_counts[b * kClauseSlots + tid] = "
     "cnt[tid];\n}\n",
     "  if (tid < kClauseSlots) a.out_counts[b * kClauseSlots + tid] = "
     "cnt[tid];\n  if (a.prec == kPQ) step::stamp_lap(7, &k_);\n}\n"),
    ("fused_step.cu",
     "  }\n  __syncthreads();\n\n  // ---- filter program",
     "  }\n  __syncthreads();\n  if (a.prec == kPQ) {\n"
     "    step::stamp_lap(6, &s_);\n    step::stamp_lap(1, &h_);\n  }\n\n"
     "  // ---- filter program"),
    ("persistent_step.cu",
     "    // ---- pop: first minimum over unexpanded slots",
     "    long long k_ = clock64();\n"
     "    // ---- pop: first minimum over unexpanded slots"),
    ("persistent_step.cu",
     "      if (rfull < 0 && isfinite(rd[K - 1])) rfull = cnt;\n    }\n",
     "      if (rfull < 0 && isfinite(rd[K - 1])) rfull = cnt;\n    }\n"
     "    if (a.prec == kPQ) step::stamp_lap(7, &k_);\n"),
]
STAMP_HEADS = {
    # the whole-row staging: every thread stages rounds of 8 lookups (code
    # loads, table loads, stores), then one thread per row sums
    "pq_stage": {
        "phases": {1: "head", 2: "code loads (thread 0)",
                   3: "table loads (thread 0)", 4: "stores (thread 0)",
                   5: "staging barrier", 6: "sum and barrier",
                   7: "kernel (K4) or step (K5)"},
        "patches": [
            ("step_common.cuh",
             "  const int total = R * SL, ld = pq_stage_ld(SL);\n",
             "  const int total = R * SL, ld = pq_stage_ld(SL);\n"
             "  long long t_ = clock64();\n"),
            ("step_common.cuh", "    float v[kStageLoads];\n",
             "    stamp_wait(code, kStageLoads);\n    stamp_lap(2, &t_);\n"
             "    float v[kStageLoads];\n"),
            ("step_common.cuh",
             "      v[u] = code[u] >= 0 ? __ldg(lut + (size_t)slot[u] * Kc + "
             "code[u]) : 0.f;\n",
             "      v[u] = code[u] >= 0 ? __ldg(lut + (size_t)slot[u] * Kc + "
             "code[u]) : 0.f;\n"
             "    stamp_wait(v, kStageLoads);\n    stamp_lap(3, &t_);\n"),
            ("step_common.cuh",
             "      if (code[u] >= 0) vals[dst[u]] = v[u];\n",
             "      if (code[u] >= 0) vals[dst[u]] = v[u];\n"
             "    stamp_lap(4, &t_);\n"),
            ("fused_step.cu", "    const int ld = step::pq_stage_ld(a.D);\n",
             "    h_ = clock64();\n" + COUNT_HEAD.format("    ") +
             "    const int ld = step::pq_stage_ld(a.D);\n"),
            ("fused_step.cu",
             "                   b * a.R, nullptr);\n    __syncthreads();\n",
             "                   b * a.R, nullptr);\n    s_ = clock64();\n"
             "    __syncthreads();\n    step::stamp_lap(5, &s_);\n"),
            ("persistent_step.cu",
             "      const int ld = step::pq_stage_ld(D);\n",
             "      long long h_ = clock64(), s_ = 0;\n" +
             COUNT_HEAD.format("      ") +
             "      const int ld = step::pq_stage_ld(D);\n"),
            ("persistent_step.cu",
             "                     R, nbs, 0, isnew);\n      __syncthreads();\n",
             "                     R, nbs, 0, isnew);\n      s_ = clock64();\n"
             "      __syncthreads();\n      step::stamp_lap(5, &s_);\n"),
            ("persistent_step.cu",
             "                                         a.qnorms[nbs[r]]);\n"
             "    }\n",
             "                                         a.qnorms[nbs[r]]);\n"
             "      __syncthreads();\n      step::stamp_lap(6, &s_);\n"
             "      step::stamp_lap(1, &h_);\n    }\n"),
        ]},
    # the chunked head: per chunk the next chunk's table rows issued (one
    # bulk copy, by the block's last thread), this chunk's wait and
    # barrier, its sum
    "pq_head": {
        "phases": {1: "head", 2: "first copy issued, codes (thread 0)",
                   3: "next copy issued", 4: "wait and barrier",
                   5: "sum and barrier", 6: "barrier after the head",
                   7: "kernel (K4) or step (K5)"},
        "patches": [
            ("step_common.cuh",
             "  const int tid = threadIdx.x, ld = pq_code_words(SL);\n",
             "  const int tid = threadIdx.x, ld = pq_code_words(SL);\n"
             "  long long t_ = clock64();\n"),
            ("step_common.cuh",
             "  for (int r = tid; r < R; r += kThreads) dist[r] = 0.f;\n",
             "  for (int r = tid; r < R; r += kThreads) dist[r] = 0.f;\n"
             "  stamp_lap(2, &t_);\n"),
            ("step_common.cuh", "    start(c + kPQStages - 1);\n",
             "    start(c + kPQStages - 1);\n    stamp_lap(3, &t_);\n"),
            ("step_common.cuh",
             "    __syncthreads();           // everyone's; and the codes\n",
             "    __syncthreads();           // everyone's; and the codes\n"
             "    stamp_lap(4, &t_);\n"),
            ("step_common.cuh",
             "    if (c + kPQStages < nch) __syncthreads();  // buffer b "
             "refills next\n",
             "    if (c + kPQStages < nch) __syncthreads();  // buffer b "
             "refills next\n    stamp_lap(5, &t_);\n"),
            ("fused_step.cu", "    step::pq_head(dist, qs, a.lut",
             "    h_ = clock64();\n" + COUNT_HEAD.format("    ") +
             "    step::pq_head(dist, qs, a.lut"),
            ("fused_step.cu",
             "                  nullptr, b * a.R, nullptr, a.qn[b], 0);\n",
             "                  nullptr, b * a.R, nullptr, a.qn[b], 0);\n"
             "    s_ = clock64();\n"),
            ("persistent_step.cu", "      step::pq_head(dist, qs, lut",
             "      long long h_ = clock64(), s_ = 0;\n" +
             COUNT_HEAD.format("      ") + "      step::pq_head(dist, qs, lut"),
            ("persistent_step.cu",
             "                    a.qnorms, D, R, nbs, 0, isnew, qn, "
             "pq_heads++);\n",
             "                    a.qnorms, D, R, nbs, 0, isnew, qn, "
             "pq_heads++);\n"
             "      s_ = clock64();\n      __syncthreads();\n"
             "      step::stamp_lap(6, &s_);\n"
             "      step::stamp_lap(1, &h_);\n"),
        ]},
}


# K2 (gbdt.cu), thread 0 of each block (one block a lane group): the
# block count in slot 0; per block, from the kernel's start
K2_START = ("{}long long t_ = clock64(), k_ = t_;\n"
            "{}if (tid == 0) atomicAdd(&step::g_stamp[0], 1ull);\n")
STAMP_K2 = {
    # the first port: 8 lanes a block stage the whole forest, walk from
    # shared memory, then 8 threads sum
    "staged": {
        "phases": {1: "forest and features staged, barrier",
                   2: "walk and barrier", 3: "sum (thread 0)",
                   4: "whole kernel"},
        "patches": [
            ("gbdt.cu",
             "  const int nl = B - b0 < kLanes ? B - b0 : kLanes;\n",
             "  const int nl = B - b0 < kLanes ? B - b0 : kLanes;\n" +
             K2_START.format("  ", "  ")),
            ("gbdt.cu", "  __syncthreads();\n\n  for (int p = tid;",
             "  __syncthreads();\n  step::stamp_lap(1, &t_);\n\n"
             "  for (int p = tid;"),
            ("gbdt.cu", "  __syncthreads();\n\n  if (tid < nl) {",
             "  __syncthreads();\n  step::stamp_lap(2, &t_);\n\n"
             "  if (tid < nl) {"),
            ("gbdt.cu", "    out[b0 + tid] = base + s;\n",
             "    out[b0 + tid] = base + s;\n    step::stamp_lap(3, &t_);\n"
             "    step::stamp_lap(4, &k_);\n"),
        ]},
    # one block a lane, one thread a tree, reading the forest where it
    # lies; then thread 0 sums
    "walk": {
        "phases": {1: "feature prefetch issued", 2: "walk and barrier",
                   3: "sum (thread 0)", 4: "whole kernel"},
        "patches": [
            ("gbdt.cu", "  const float* x = feats + (size_t)b * F;\n",
             K2_START.format("  ", "  ") +
             "  const float* x = feats + (size_t)b * F;\n"),
            ("gbdt.cu", '"l"(line));\n',
             '"l"(line));\n  step::stamp_lap(1, &t_);\n'),
            ("gbdt.cu", "  __syncthreads();\n  if (tid == 0) {",
             "  __syncthreads();\n  step::stamp_lap(2, &t_);\n"
             "  if (tid == 0) {"),
            ("gbdt.cu", "    out[b] = base + s;\n",
             "    out[b] = base + s;\n    step::stamp_lap(3, &t_);\n"
             "    step::stamp_lap(4, &k_);\n"),
        ]},
}


# K7 (topk.cu), the merge by rank with one load round (this tree's), thread
# 0 of each block (one block a lane): loads, and the rank of the new run
# (warp 0); the barrier; thread 0's searches and stores
STAMP_K7 = {
    "phases": {1: "loads and rank (thread 0)", 2: "barrier",
               3: "search and scatter (thread 0)", 4: "whole kernel"},
    "patches": [
        ("topk.cu", "  const float* nd = new_dist + orr;\n",
         "  const float* nd = new_dist + orr;\n" +
         K2_START.format("  ", "  ")),
        ("topk.cu", "    if (has_new) new_k[s] = kr;\n  }\n  __syncthreads();\n",
         "    if (has_new) new_k[s] = kr;\n  }\n  step::stamp_lap(1, &t_);\n"
         "  __syncthreads();\n  step::stamp_lap(2, &t_);\n"),
        ("topk.cu", "  }\n}\n\ntemplate <int V>\ncudaError_t launch(",
         "  }\n  step::stamp_lap(3, &t_);\n  step::stamp_lap(4, &k_);\n}\n\n"
         "template <int V>\ncudaError_t launch("),
    ]}


def k6q_flush(n: int) -> str:
    """Every thread's n phase sums into slots 1..n."""
    return "".join(f"  step::stamp_flush({i + 1}, a{i}_);\n" for i in range(n))


# K6q rows PQ (quant_rows.cu), every thread's own cycles by phase, summed
# over the threads of all blocks (slot 0: blocks that read a table)
STAMP_K6Q = {
    # the earlier kernel: grid (1024-position tiles, lanes), the lane's table
    # streamed chunk by chunk into every tile; each thread's 4 rows
    "tile": {
        "phases": {1: "prologue: mask, ids, early exit, xn",
                   2: "table chunk: issue, wait, barrier", 3: "code loads",
                   4: "lookups and adds", 5: "chunk-end barrier",
                   6: "tail", 7: "whole kernel"},
        "patches": [
            ("quant_rows.cu", "  const int p0 = blockIdx.x * kPQRows;\n",
             "  const int p0 = blockIdx.x * kPQRows;\n"
             "  long long t_ = clock64(), k_ = t_, a0_ = 0, a1_ = 0, a2_ = 0,\n"
             "            a3_ = 0, a4_ = 0, a5_ = 0, a6_ = 0;\n"),
            ("quant_rows.cu",
             "  if (!__syncthreads_or(any)) return;  // nothing to read in "
             "this tile\n",
             "  if (!__syncthreads_or(any)) return;  // nothing to read in "
             "this tile\n  if (tid == 0) atomicAdd(&step::g_stamp[0], 1ull);\n"),
            ("quant_rows.cu",
             "  for (int c = 0; c < nch; ++c) {\n    start(c + kPQStages - 1);\n",
             "  step::stamp_acc(&a0_, &t_);\n"
             "  for (int c = 0; c < nch; ++c) {\n    start(c + kPQStages - 1);\n"),
            ("quant_rows.cu", "    __syncthreads();                 // everyone's\n",
             "    __syncthreads();                 // everyone's\n"
             "    step::stamp_acc(&a1_, &t_);\n"),
            ("quant_rows.cu",
             "      load_chunk_codes(w, codes + (size_t)id[k] * SL + j0, n, vec);\n",
             "      load_chunk_codes(w, codes + (size_t)id[k] * SL + j0, n, vec);\n"
             "      step::stamp_use(w);\n      step::stamp_acc(&a2_, &t_);\n"),
            ("quant_rows.cu",
             "      ip[k] = step::pq_sum_chunk(ip[k], tab + s * span, Kc, w, n);\n",
             "      ip[k] = step::pq_sum_chunk(ip[k], tab + s * span, Kc, w, n);\n"
             "      step::stamp_acc(&a3_, &t_);\n"),
            ("quant_rows.cu",
             "    if (c + kPQStages < nch) __syncthreads();  // buffer s refills "
             "next\n",
             "    if (c + kPQStages < nch) __syncthreads();  // buffer s refills "
             "next\n    step::stamp_acc(&a4_, &t_);\n"),
            ("quant_rows.cu",
             "          __fsub_rn(__fadd_rn(qnb, xn[k]), __fmul_rn(2.f, ip[k])), "
             "0.f);\n}\n",
             "          __fsub_rn(__fadd_rn(qnb, xn[k]), __fmul_rn(2.f, ip[k])), "
             "0.f);\n  step::stamp_acc(&a5_, &t_);\n"
             "  step::stamp_acc(&a6_, &k_);\n" + k6q_flush(7) + "}\n"),
        ]},
}


STAMP_K6Q["segment"] = {
    # this kernel's sum, one block an SM, by work item, chunk and batch of
    # 32 rows a warp (the count and compaction launches are timed by the
    # profiler beside it)
    "phases": {1: "prologue: share, first lane, setup",
               2: "table chunk: issue, wait, barrier",
               3: "code wait (loaded two batches ahead) and staging",
               4: "next batch: id and code loads issued",
               5: "lookups and adds",
               6: "tail loads, partial-sum store or output",
               7: "chunk-end barrier", 8: "whole kernel"},
    "patches": [
        ("quant_rows.cu",
         "  const int tid = threadIdx.x;\n\n  // the block's share",
         "  const int tid = threadIdx.x;\n"
         "  long long t_ = clock64(), k_ = t_, a0_ = 0, a1_ = 0, a2_ = 0,\n"
         "            a3_ = 0, a4_ = 0, a5_ = 0, a6_ = 0, a7_ = 0;\n\n"
         "  // the block's share"),
        ("quant_rows.cu", "  int lane, k0, k1, nl, n0, n1;\n",
         "  if (tid == 0) atomicAdd(&step::g_stamp[0], 1ull);\n"
         "  step::stamp_acc(&a0_, &t_);\n  int lane, k0, k1, nl, n0, n1;\n"),
        ("quant_rows.cu",
         "      __syncthreads();                 // everyone's\n",
         "      __syncthreads();                 // everyone's\n"
         "      step::stamp_acc(&a1_, &t_);\n"),
        ("quant_rows.cu",
         "          pre0[g] = pre1[g];\n        }\n        __syncwarp();\n",
         "          pre0[g] = pre1[g];\n        }\n        __syncwarp();\n"
         "        step::stamp_acc(&a2_, &t_);\n"),
        ("quant_rows.cu", "          p = pos[lo + r];\n        }\n",
         "          p = pos[lo + r];\n        }\n"
         "        step::stamp_acc(&a5_, &t_);\n"),
        ("quant_rows.cu", "        id3 = row_id(beta + 4 * kSegWarps);\n",
         "        id3 = row_id(beta + 4 * kSegWarps);\n"
         "        step::stamp_acc(&a3_, &t_);\n"),
        ("quant_rows.cu",
         "          ip = seg_sum<KC>(ip, t, kc, stage, lane, n);\n",
         "          ip = seg_sum<KC>(ip, t, kc, stage, lane, n);\n"
         "          step::stamp_acc(&a4_, &t_);\n"),
        ("quant_rows.cu", "            part[r - k0] = ip;\n",
         "            part[r - k0] = ip;\n          step::stamp_acc(&a5_, &t_);\n"),
        ("quant_rows.cu",
         "      __syncthreads();  // buffer s is free; the next item may "
         "begin\n",
         "      __syncthreads();  // buffer s is free; the next item may "
         "begin\n      step::stamp_acc(&a6_, &t_);\n"),
        ("quant_rows.cu",
         "    more = walk.next(&nl, &n0, &n1);\n  }\n}\n",
         "    more = walk.next(&nl, &n0, &n1);\n  }\n"
         "  step::stamp_acc(&a7_, &k_);\n" + k6q_flush(8) + "}\n"),
    ]}


def stamped_copy(root: str, dest: str) -> tuple:
    """Copy `root`'s src/ to `dest` with the stamps inserted; returns the
    names of its PQ head and its K2, and whether its K7 is stamped (the
    merge with one load round; an older K7 is not). Every stamped text must
    occur exactly once."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(root, "src"), os.path.join(dest, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dest, "src", "repro_torch", "csrc")
    common = open(os.path.join(csrc, "step_common.cuh")).read()
    head = "pq_head" if "void pq_head(" in common else "pq_stage"
    gbdt = open(os.path.join(csrc, "gbdt.cu")).read()
    k2 = "walk" if "float walk(" in gbdt else "staged"
    k7 = "__shfl_sync" in open(os.path.join(csrc, "topk.cu")).read()
    k6q = ("tile" if "load_chunk_codes(" in open(
        os.path.join(csrc, "quant_rows.cu")).read() else "segment")
    texts = {}
    for fname, old, new in (STAMP_COMMON + STAMP_HEADS[head]["patches"] +
                            STAMP_K2[k2]["patches"] +
                            (STAMP_K7["patches"] if k7 else []) +
                            STAMP_K6Q[k6q]["patches"]):
        path = os.path.join(csrc, fname)
        text = texts.get(path) or open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"stamp point not found once in {fname}: "
                               f"{old!r}")
        texts[path] = text.replace(old, new)
    for name in ("fused_step.cu", "persistent_step.cu", "gbdt.cu",
                 "quant_rows.cu") + (("topk.cu",) if k7 else ()):
        texts[os.path.join(csrc, name)] += STAMP_READER
    for path, text in texts.items():
        with open(path, "w") as f:
            f.write(text)
    return head, k2, k7, k6q


def stamp_turn(root: str) -> list:
    """Stamp `root`'s PQ head and return one breakdown per kernel."""
    import ctypes
    import contextlib
    import io

    import numpy as np

    root = os.path.abspath(root)
    dest = os.path.join(HERE, "build", "stamps",
                        os.path.basename(root.rstrip("/")) or "root")
    head, k2, k7, k6q = stamped_copy(root, dest)
    sys.path.insert(0, os.path.join(dest, "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.gbdt import gbdt_predict
    from repro_torch.kernels.persistent_step import persistent_multi_step
    from repro_torch.kernels.quant_rows import sqdist_rows_quant
    from repro_torch.kernels.topk import topm_merge

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _build.build_all()
    device = torch.device("cuda")
    buf = (ctypes.c_ulonglong * 16)()

    def measure(lib_name, run, iters, phases=STAMP_HEADS[head]["phases"]):
        io_ = _build.load(lib_name).stamps_io
        io_.argtypes = [ctypes.c_void_p, ctypes.c_int]
        io_.restype = ctypes.c_int
        run()
        torch.cuda.synchronize()
        _build.check(io_(None, 1), lib_name)
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        _build.check(io_(ctypes.addressof(buf), 0), lib_name)
        n = max(int(buf[0]), 1)
        return {"heads": int(buf[0]), "raw": list(buf), "cycles_per_lane_step": {
            phases[i]: buf[i] / n for i in sorted(phases)}}

    out = []
    shapes = [32, 160] if head == "pq_head" else [32]
    for r in shapes:
        rng = np.random.default_rng(4)
        args, quant = cs.step_inputs(rng, 64, r, cs.DIM, 512, 10, 2, 2, False,
                                     device, "pq")
        def run():
            return fused_step(*args, quant=quant, precision="pq")

        res = measure("fused_step", run, 20)
        res["sm_mhz"] = cs.sm_clock_under(run, 2000)
        out.append({"kernel": "K4", "R": r, **res})
    with contextlib.redirect_stdout(io.StringIO()):
        args, state, kw = cs.k5_world(7, True, device, "pq")
    clones = iter([cs.copy_state(state) for _ in range(12)])
    run = lambda: persistent_multi_step(  # noqa: E731
        *args, next(clones), 1 << 30, None, steps=cs.K5_STEPS, **kw)
    res = measure("persistent_step", run, 10)
    out.append({"kernel": "K5 pq", "R": 32, **res})
    # K2 at the main path's shape (check_k2's inputs); "heads" counts
    # blocks here and the cycles are a block's
    b, f, t, depth = 64, 68, 200, 5
    rng = np.random.default_rng(1)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    forest = (to(rng.normal(size=(b, f)).astype(np.float32)),
              to(rng.integers(0, f, (t, (1 << depth) - 1)).astype(np.int32)),
              to(rng.normal(size=(t, (1 << depth) - 1)).astype(np.float32)),
              to((0.1 * rng.normal(size=(t, 1 << depth))).astype(np.float32)))
    run = lambda: gbdt_predict(*forest, 5.25, depth)  # noqa: E731
    res = measure("gbdt", run, 50, STAMP_K2[k2]["phases"])
    res["sm_mhz"] = cs.sm_clock_under(run, 20000)
    out.append({"kernel": "K2", "variant": k2, "B": b, "T": t, "D": depth,
                **res})
    if k7:  # K7 at check_k7's shape, blocks counted as for K2
        args = cs.merge_inputs(np.random.default_rng(8), 64, 512, 32, True,
                               device)
        res = measure("topk", lambda: topm_merge(*args), 50,
                      STAMP_K7["phases"])
        out.append({"kernel": "K7", "B": 64, "M": 512, "R": 32, **res})
    # K6q rows PQ at the scan's and the oracle's shapes: thread-cycles by
    # phase over all threads of all blocks, each phase's share of the
    # whole, and the stamped kernel's ms by CUDA events
    phases = STAMP_K6Q[k6q]["phases"]
    for layout in ("scan", "oracle"):
        with contextlib.redirect_stdout(io.StringIO()):
            prep, codes, norms, ids, mask = cs.k6q_timing_inputs(
                device, "pq", layout)
        run = lambda: sqdist_rows_quant(prep, codes, norms, ids,  # noqa: E731
                                        mask)
        raw = measure("quant_rows", run, 3, phases)["raw"]
        # thread-cycles a call by phase of the sum; its share of the whole
        total = {phases[i]: raw[i] / 3 for i in sorted(phases)}
        whole = max(total["whole kernel"], 1.0)
        extra = {"kernel_ms": cs.kernel_breakdown(run)}
        out.append({
            "kernel": "K6q PQ", "variant": k6q, "layout": layout,
            "B": mask.shape[0], "V": mask.shape[1],
            "pairs": int(mask.sum()), "blocks_a_call": raw[0] / 3,
            "thread_cycles_a_call": total,
            "share": {k: c / whole for k, c in total.items()}, **extra,
            "stamped_ms": cs.time_cuda(run, iters=3, warmup=1),
            "sm_mhz": cs.sm_clock_under(run, 300)})
        del prep, codes, norms, ids, mask
        torch.cuda.empty_cache()
    return [{"root": root, "head": head, **o} for o in out]


# ------------------------------------------------------------ ablation ----
# K6q rows PQ with a part of its work taken out, for timing only (the
# values are wrong): the lookups replaced by register arithmetic, or the
# code loads by a hash of the address, or both; (file, text, replacement)
K6Q_LOOKUP = ("        v[i] = t[jj * kc + __byte_perm(w[i >> 2], 0u, 0x4440u + "
              "(i & 3))];\n")
K6Q_LOADS = ("  if (vec) return __ldcg(reinterpret_cast<const uint4*>(src));"
             "\n")
ABLATIONS = {
    "whole": [],
    "no lookups": [("quant_rows.cu", K6Q_LOOKUP,
                    "        v[i] = __uint_as_float(w[i >> 2] + jj);\n")],
    "no code loads": [("quant_rows.cu", K6Q_LOADS,
                       "  if (vec) {\n    const uint32_t h = (uint32_t)"
                       "reinterpret_cast<uintptr_t>(src) * 2654435761u;\n"
                       "    return make_uint4(h, h * 3u, h * 5u, h * 7u);\n"
                       "  }\n")],
}
ABLATIONS["neither"] = ABLATIONS["no lookups"] + ABLATIONS["no code loads"]


def ablate_one(dest: str) -> dict:
    """Time K6q rows PQ from the (patched) copy `dest` at the scan's and
    the oracle's shapes: ms by CUDA events and the profiler's per kernel."""
    sys.path.insert(0, os.path.join(dest, "src"))
    import torch

    import repro_torch  # noqa: F401  (dest's package, before chip_smoke's)
    from repro_torch.kernels import _build
    from repro_torch.kernels.quant_rows import sqdist_rows_quant

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _build.build_all()
    device, out = torch.device("cuda"), {}
    for layout in ("scan", "oracle"):
        prep, codes, norms, ids, mask = cs.k6q_timing_inputs(device, "pq",
                                                             layout)
        run = lambda: sqdist_rows_quant(prep, codes, norms, ids,  # noqa: E731
                                        mask)
        out[layout] = {"ms": cs.time_cuda(run, iters=5, warmup=1),
                       "kernel_ms": cs.kernel_breakdown(run)}
        del prep, codes, norms, ids, mask
        torch.cuda.empty_cache()
    return out


def ablate(root: str) -> list:
    """One line per ablation of `root`'s K6q rows PQ (`ABLATIONS`), each
    from a patched copy under build/ablate/ in a process of its own."""
    out = []
    for name, patches in ABLATIONS.items():
        dest = os.path.join(HERE, "build", "ablate", name.replace(" ", "_"))
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(os.path.join(root, "src"), os.path.join(dest, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for fname, old, new in patches:
            path = os.path.join(dest, "src", "repro_torch", "csrc", fname)
            text = open(path).read()
            if text.count(old) != 1:
                raise RuntimeError(f"ablation point not found once in "
                                   f"{fname}: {old!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ablate-one", dest], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(res.stdout + res.stderr)
        out.append({"root": os.path.abspath(root), "kernel": "K6q PQ",
                    "ablation": name,
                    **json.loads(res.stdout.strip().splitlines()[-1])})
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one_turn(argv[1])), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--stamp-one":
        print(json.dumps(stamp_turn(argv[1])), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--ablate-one":
        print(json.dumps(ablate_one(argv[1])), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--ablate":
        for line in ablate(argv[1]):
            print(json.dumps(line), flush=True)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout.strip()
        print(smi, flush=True)
        return 0
    if len(argv) >= 2 and argv[0] == "--stamps":
        for root in argv[1:]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--stamp-one", root], capture_output=True,
                                 text=True, timeout=900)
            if out.returncode != 0:
                sys.stderr.write(out.stdout + out.stderr)
                return out.returncode
            for line in json.loads(out.stdout.strip().splitlines()[-1]):
                print(json.dumps(line), flush=True)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout.strip()
        print(smi, flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    before, after = argv
    for turn, root in enumerate((before, after, after, before)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": turn, **line}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

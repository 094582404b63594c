#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # Tripclick scale: N=1,000,000, d=768
    python3 chip_smoke.py --n 100000 --train-queries 128   # ~1 min smoke

Phases, each printed as one JSON line with its wall seconds:
  1. the card (and the raw `nvidia-smi` name/power-limit line);
  2. the kernel build (`nvcc`, one process per source, in parallel);
  3. K1 (fused traversal step) and its int8 and PQ heads K3 and K4
     against `fused_step_plain` on the card, at the main path's shapes,
     post and pre mode: exact-arithmetic inputs with injected ties and
     duplicate ids, and a tie case (rows repeated 4 ways, old keys equal
     to new ones, all-inf queues, runs with every new entry masked;
     everything must be equal in both), and float inputs (K1:
     distances within rtol 1e-5; K3: everything equal; K4: distances
     within rtol 1e-5 plus the bound on the lookup sums' rounding); K1,
     K3 and K4 again at R'=160, the widened frontier of pre/widen mode
     (`k1_wide_check`, `k3_wide_check`, `k4_wide_check`, the same
     tolerances);
  4. K2 (GBDT inference) against `gbdt_predict_plain` (rtol 1e-5) and
     bit for bit against the tree-order sum (each tree's leaf by the
     plain walk, float32 adds in tree order, then base) over T ∈ {1, 7,
     200, 401}, depth 1–6, B ∈ {1, 33, 64, 130} on random forests with
     +inf thresholds and feature F − 1, and at the main path's shape;
     then the launch floor (a one-element in-place add) on its own line;
  5. K6 (masked distance) against `sqdist_masked_plain` at B=64, R=32,
     d=768: equal on exact-arithmetic inputs, rtol 1e-5 on float ones,
     and each pair bit for bit K1's (one K1 step from an all-inf queue);
     K6's row-id variant (the scan's and the oracle's distance) over an
     N=1M store at V ∈ {4096, 65536, 2^18}, and at B=130 (three lane
     groups) over N=999,983 with unpassed rows and lanes, against its
     plain per-lane version, and bit for bit against itself alone, padded,
     reordered and gathered (`k6_scan_check`); the row-id variant timed
     without the planner at the "mixed" scan's shape (B=64, V=2^19,
     ≈11.1 M pairs) and the oracle's (`k6_rows_timing`); K6q rows (the
     compressed distance by row id of the quantized scan and oracle), int8
     and PQ, against its plain version bit for bit over an N=1M code store
     (scan and oracle layouts, the oracle's with a fully unmasked lane and
     one unmasked only at its last position, B=130 with dead lanes,
     widths off 32, lane, width and order invariance) and each pair bit
     for bit K3's / K4's (`k6q_int8_check`, `k6q_pq_check`), then timed at
     the "mixed" scan's and the compressed oracle's shapes
     (`k6q_*_timing`; under PQ with the kernel's table reads and the
     lookups' floor beside the bound);
  6. K7 (sorted-buffer merge) against `topm_merge_plain`, bit for bit,
     ties, R=1, R'=160, M=500 and M=42 (4-byte loads) included, with the
     library call pair's time (`k7_check`), then the launch floor;
  7. K5 (persistent multi-step) against `persistent_multi_step_plain`
     over an N=1M synthetic index, 8 steps a launch, with lanes stopping
     mid-launch, lanes already stopped, repeated ids and convergence:
     every field equal on exact-arithmetic inputs; on float inputs each
     step replayed alone agrees up to near-tie moves, which must explain
     every lane whose 8-step trajectory differs; K5's int8 and PQ
     branches after one 8-step launch: every field equal; and each branch
     on a tie case (4096 distinct rows over the N=1M store, all-inf
     queues, lanes whose every neighbor is visited, fresh lanes): every
     field equal;
  8. dataset (made with its workloads in a spawned child process since
     step 2, `make_world`: the generator is one host thread), graph
     build, ground truth (the exact oracle on K6's row-id variant) and
     estimator training, with the share of training lanes
     whose exhaustive traversal reaches recall 10/10 beside the share
     whose W_q label converged, and the share of the first PLAIN_LABELS =
     128 labels that the plain path gives alike;
     K2 on the trained forest, bit for bit the tree-order sum
     (`k2_trained_check`);
  9. `e2e_search` with backend "fused" (the main path) for α ∈ {1, 2} on a
     contain-label and a range workload of 64 lanes each: recall@10, mean
     NDC, e2e ms (median of 3 calls), per-stage ms (one separate stage-by-
     stage run); the same runs with backend "dense" (plain PyTorch; its
     e2e ms is its one checked call's):
     recall within 0.01 and ≥ 95% of lanes with identical top-10 ids and
     NDC;
 10. the same four cells with backend "persistent" (K5): every
     SearchState field equal to the fused run's, with e2e ms and the
     launch loop's launches, compactions and steps per batch; and contain α=1
     with backend "dense" + `use_pallas` (K6): top-10 ids and NDC of all
     lanes equal to fused's. Each path runs with every kernel count set
     to 0 just before it, and each of its kernels must launch; then the
     paper's §5 baselines on contain α=1, persistent (`baselines`: naive at
     ef 64 and 512 — the recall at exhaustion —, a fixed budget, LAET, the
     oracle W_q), recall@10 and mean NDC each;
 11. a `profile` line per backend (fused, persistent) for one batch:
     device busy ms, idle share, kernel launches per lockstep step,
     host-to-device copies, and forest uploads, which must be 0 (the
     estimator keeps its forest on the card after its first call); the
     profiler traces the card's activity only (the host's op events of
     the fused batch took 20–28 s more to gather);
 12. observability and serving on the persistent path: `obs_e2e`
     (contain α=1 through `e2e_search` plain and with a tracer and
     explain=True: every SearchState field and dispatch_counters delta
     equal, one launch span a launch, each report's probe + resume NDC =
     cnt; traced and untraced medians of 3), `serve` (the cost-aware
     scheduler over the 64 contain and 64 range requests, lane width 16,
     under direct and escalate: every request bit for bit its lane of the
     one-shot `e2e_search`, launches_total = the dispatch delta, no forest
     upload), `serve_narrow` (lane widths 4 and 1, and lanes 0..b−1 alone
     for b ∈ {1, 4, 8, 16}: ids, distance bits, NDC, budgets, probe
     features and `d_start` all equal to the 64-lane batch bit for bit,
     float32 and PQ), `launch_split` (the traced batches' wall time split into
     launch spans — K5 and its `hops`/`active` readback —, the rest of the
     search calls, and everything outside them) and `graph_recall` (the
     graph's neighbour recall@32 on 1024 rows by `knn_exact`, and recall@10
     of an exhaustive search under a filter every row passes);
 12b. the RAG tail: `lm_full_width` (olmo-1b at full width — 16 layers,
     d 2048, vocab 50304, float32, ≈1.18 B parameters — built on the card
     from a seeded torch.Generator: a [16, 18] prefill and 32 greedy
     KV-cache decode steps, each step's logits within LM_TOL of a fresh
     prefill over the same prefix and the greedy ids equal where the
     top-2 margin exceeds it; a 2-layer full-width model on the CPU and
     then on the card, same weights, within LM_XDEV_TOL; prefill ms and
     decode ms a token beside their bounds, and a decode step's device
     time by kernel), then `rag` (the first 16 contain requests through
     the scheduler on the serving phases' engine and estimator, each bit
     for bit its one-shot lane, K5, K2 and K6 launched; their ids as
     context tokens for the full-width olmo-1b: retrieval p50 / p99,
     prefill ms, decode ms a token a request);
 13. the planner path on composite And/Or/Not workloads: `plan_training`
     (256 "mixed" queries: oracle, probe and the two exhaustion resumes'
     seconds, converged shares, fit seconds); `plan_forced` (each plan
     forced equals `run_plan` in every field, the scan equals the oracle
     bit for bit with recall 1.0, widen on persistent equals widen on
     fused); `plan_e2e` on an "and" and a "mixed" batch (plan mix, recall,
     NDC, e2e ms for fused and persistent, which must agree in every
     field; fused and dense widen, and on "and" fused and dense pre, give
     identical top-10 and NDC on ≥ 95% of lanes); a `profile` line for one
     planned batch; `obs_e2e` on the planned "mixed" batch (traced ≡
     plain); `serve` with plan="auto" on "mixed" (two runs identical, a
     resubmission hits the cache with identical results; the plan mix);
 14. per codec (int8, PQ): the quantized engine's build (seconds,
     `index_nbytes`, `store_ratio`), training labels with the compressed
     target on the first QUANT_TRAIN = 128 of the 512 training queries
     (a depth cut), the estimator, and `e2e_search` with the
     terminal rerank on
     contain and range at α=1 with backends fused (K3 / K4), persistent
     (K5's codec branch; every SearchState field equal to fused's, bit
     for bit) and dense (≥ 95% of lanes identical to fused, recall
     within 0.01), and a `profile` line for the persistent batch; then
     the planner on that engine (`plan_quant_*`: trained on 128 "mixed"
     queries with the compressed target; forced ≡ `run_plan`, widen
     persistent ≡ fused with K3 / K4 at R'=160; planned "and" and "mixed"
     batches, persistent ≡ fused, recall after the rerank; on scan lanes
     the scan ≡ `compressed_filtered_topk` bit for bit; a `mode="pre"`
     cell);
     PQ also `serve` under direct (64 contain requests, each bit for bit
     its lane of the one-shot batch after the rerank);
 14b. scale-out on the same world (`run_sharded`): S = 4 contiguous
     shards of 250,000 rows, a graph each built on the card, and S = 1
     (the plain graph as one shard); the float32 shards view the plain
     engine's vectors. `shard_build`; `shard_merge` (S = 1 ≡ the plain
     engine in every field of an e2e batch; S = 4 search ≡ each shard
     searched alone under ⌈W/4⌉ and merged by a flat stable sort on (dist,
     pos), every merged field; probe → resume ≡ direct; the merge's ms);
     `shard_scan` (S = 4 scan ≡ the unsharded scan ≡ `filtered_knn_exact`
     on "mixed", cnt = σ·N); `shard_training` (an estimator fitted on the
     S = 4 engine, 128 queries); `shard_e2e` (S = 1 and S = 4: e2e ms,
     NDC, recall@10, K5 launches, work balance; EXPLAIN's shard sections add
     up to cnt, hops and n_inspected; an active lane's cnt ≥ its budget;
     tracing on ≡ off); `shard_profile`; `shard_tier` (int8 S = 4, host
     tier ≡ device tier after the rerank, the host tier holding no [N, d]
     float32 tensor on the card; the gather's ms and the profiler's copy
     kind); `shard_serve` (64 requests, lane width 16, direct: scheduled ≡
     one-shot, per-shard NDC adds up to Σ request NDC);
 14c. `mesh` (`run_mesh`): the search meshes on cuda:0 repeated (the
     single-controller mesh may list a device more than once), no new
     build: `ShardedSearchEngine` on the 2-D (data, index) meshes (1, 4),
     (2, 2), (4, 1) — float32 fused one shot, float32 persistent probed
     at ⌊W/2⌋ and resumed to W, int8 fused one shot, contain α=1 — every
     per-shard and merged leaf ≡ the loop path's; `e2e_search` on the
     (2, 2) engine ≡ on the loop engine (budgets, every leaf; mesh and
     loop e2e ms beside the card's name and power limit); `SearchEngine`
     on a 4-position batch mesh over MESH_LANES = 30 lanes (2 pad lanes)
     at a quarter of their budgets, fused and persistent ≡ the unmeshed
     runs; K1, K3, K6 and K2 launched
     on those runs and `dispatch_counters` unmoved; `butterfly_merge` at
     D ∈ {2, 3, 4} on [64, 512] and [64, 10] pools with ties ≡
     `merge_stacked` bit for bit;
 15. `launcher`: `python -m repro_torch.launch.serve --status
     --prometheus --gen-len 8` in four child processes started
     together, at its default corpus: olmo-1b's tiny config, the MoE's
     (`--shards 4 --arch phi3.5-moe-42b-a6.6b`, behind the sharded
     retrieval), deepseek-v3's (`--arch deepseek-v3-671b`: MLA and its
     latent cache behind K5, K2 and K6) and zamba2's (`--arch
     zamba2-2.7b`: Mamba2 layers and the shared attention block behind
     K5, K2 and K6; its 18-token prompt runs at the tiny chunk of 16, the
     SSD's padding); each must exit 0, print its
     `generation:` line naming its arch, and give a scrape that
     `validate_prometheus` accepts (with shards, carrying
     `shard_ndc_total`);
 15b. `lm_train`, last, so that every earlier phase runs as before (TF32
     off): olmo-1b at full width built on the card, 6 AdamW steps
     (float32 moments, lr 3e-4, grad_accum 2, remat) on one seeded
     [8, 64] batch — every loss finite, the last below the first —, step
     ms and tokens/s beside the step's bound, a step under torch's sync
     debug mode "error" (no host sync), one step's device time by kernel
     and idle share, the state's bytes and the card's peak; 2 steps with
     int8 moments and int8 error feedback (moment bytes against float32
     moments); a 2-layer full-width model's loss, gradients, parameters
     and moments after one step on the CPU and on the card, same
     weights, within LM_TRAIN_XDEV_TOL; resume ≡ uninterrupted on that
     model (2 steps, save, restore into a fresh model's state — equal bit
     for bit —, 2 more, against 4 uninterrupted; LM_TRAIN_RESUME_TOL);
     and `python -m repro_torch.launch.train` as a child process, 4
     steps with a checkpoint every 2, then `--resume --steps 6` (both on
     a thread beside the card ≡ CPU and resume checks);
 15c. `lm_moe`, last (TF32 off), on a card holding no earlier
     model: phi3.5-moe-42b-a6.6b at full width (d 4096, 32 heads / 8 KV
     heads of 128, 16 experts top-2 of d_ff 6400, vocab 32064, untied,
     float32) from a seeded generator. (a) Serving, depth cut to 8 of 32
     layers (42.66 GB; all 32 are 168 GB): the rag phase's 16 requests'
     ids and 8 prompt tokens prefilled, 32 greedy decode steps, every
     logit finite; decode ≡ a teacher-forced prefill within LM_TOL on
     the rows whose prefill dropped no assignment, at the published
     capacity factor and, same weights, at capacity factor E/k for 8
     steps (no drop possible; ≥ 8 rows compared), drops a row printed;
     prefill ms and decode ms a token beside the weight-read and the
     padded-work bounds; a decode step's device time by kernel. (b) One
     full-width MoE layer on the card and the CPU, same weights, [2, 32]
     (cap 8): forward with the aux loss and the gradients of Σ out·r +
     aux; ids and keep equal where the routing gaps exceed 1e-6, out, aux
     and every gradient within MOE_XDEV_TOL. (c) Training, depth cut to 2
     layers (2.86 B parameters): 6 AdamW steps (float32 moments, lr 3e-4,
     grad_accum 2, remat) on one seeded [8, 64] batch, losses and aux
     finite and falling, step ms and tokens/s beside the step's bound, a
     step under sync debug mode "error", a step's kernels and idle share,
     state bytes and peak; resume ≡ uninterrupted bit for bit at 1 layer
     (the state after 2 steps copied on the card, restored after the
     uninterrupted 2 more);
 15d. `lm_mla`, last (TF32 off), on a card holding no earlier model:
     deepseek-v3-671b at its published widths (d 7168, 128 heads, q_lora
     1536, kv_lora 512, rope 64, nope 128, v 128, d_ff 18432 in the dense
     prefix, 256 experts top-8 of d_ff 2048 and one shared, vocab
     129280, untied, float32) from a seeded generator. (a) Serving at the
     3 dense-prefix layers and 1 MoE layer of 61, without the MTP block
     (15.10 B parameters, 60.4 GB): the rag phase's 16 requests' ids and
     8 prompt tokens prefilled (K/V materialised from the latent), 8
     greedy absorbed decode steps over the latent cache; decode ≡ a
     teacher-forced prefill within LM_TOL at capacity factor E/k (32:
     nothing drops; all 16 rows), drops a row at the published 1.25;
     prefill and decode ms beside the weight-read and padded-work
     bounds, a decode step's kernels, the cache's bytes a token beside
     gqa K/V's. (b) One full-width MLA + dense block (0.58 B) on the card
     and the CPU, same weights, [2, 32]: the prefill's output and latent
     cache, an absorbed decode step's output and cache, every gradient
     in train mode, within MLA_XDEV_TOL. (c) Training with the MTP head,
     1 dense + 1 MoE layer, 16 of 256 experts (top-8 and the shared
     expert kept; 4.41 B): 6 AdamW steps (int8 moments, grad_accum 2,
     remat) on one seeded [8, 64] batch, loss, ce, aux and mtp_ce finite
     and the loss falling, step ms and tokens/s beside the bound, a step
     under sync debug "error", kernels, peak allocated; resume ≡
     uninterrupted bit for bit at 1 MoE layer and the MTP block (3.83 B,
     grad_accum 1: the MoE dispatch's slot-order backward at top-8);
 15e. `lm_ssm`, last (TF32 off), on a card holding no earlier model:
     mamba2-2.7b (64 Mamba2 layers: d 2560, d_inner 5120, 80 heads of
     64, state 128, conv 4, chunk 256, vocab 50280) and zamba2-2.7b (54
     Mamba2 layers at state 64 in 9 groups of 6, each followed by the
     shared attention + MLP block: 32 heads of 80, d_ff 10240, vocab
     32000) at full width and full depth, float32, from a seeded
     generator, the SSM leaves the reference draws as constants redrawn
     at Mamba2's published init (`ssm_redraw`). (a) Serving each over
     the rag phase's 16 requests' ids and 8 prompt tokens: 8 greedy
     decode steps over the recurrent state ≡ a teacher-forced prefill
     within LM_TOL on all 16 rows; prefill and decode ms beside their
     bounds by bytes and by operations (`ssm_work`), a decode step's
     kernels and launches, the cache's bytes a row against olmo-1b's
     K/V. (b) One full-width Mamba2 block on the card and the CPU, same
     weights, [2, 512] (two chunks of 256): the prefill's output and
     state, 3 decode steps, every gradient — all finite, each within
     SSM_XDEV_TOL; the largest exponent the reference's SSD would
     exponentiate must pass ln FLT_MAX (its backward would be NaN).
     (c) One full-width zamba2 group card ≡ CPU at [2, 64]: loss and
     every gradient, the never-read leaves' gradients 0. (d) Training
     (float32 moments, grad_accum 2, remat): mamba2 at full depth 6
     steps, zamba2 at 2 groups 4 steps (its never-read moments stay 0),
     losses finite and falling, step ms beside the bound, peak; resume ≡
     uninterrupted bit for bit on zamba2 at 1 group;
 15f. `lm_cross`, last (TF32 off), on a card holding no earlier model:
     llama-3.2-vision-90b (d 8192, 64 / 8 heads of 128, d_ff 28672,
     vocab 128256, untied; (4 gqa, then gqa + cross) × 20, 1601 memory
     rows) and whisper-small (12 bidirectional encoder layers over 1500
     frames, 12 decoder layers of gqa + cross; d 768, 12 heads of 64,
     d_ff 3072, layernorm, GELU, vocab 51865) at their published widths,
     float32, from a seeded generator; stub memories 0.02 · N(0, 1)
     (`cross_memory`). (a) Serving the rag phase's 16 requests' ids and 8
     prompt tokens over a memory: the VLM at 3 of 20 periods (15 of 100
     layers, 15.39 B parameters, 61.56 GB), whisper at full depth
     (encode, then prefill); 8 greedy decode steps over the self K/V and
     the static cross K/V ≡ a teacher-forced prefill within LM_TOL on
     all 16 rows; prefill (and encode) ms and decode ms a token beside
     their bounds by bytes and operations (`cross_work`), a decode step's
     kernels, launches and idle share, the cross cache's bytes a row a
     layer, the peak. (b) The VLM's full-width cross block (1.01 B) card
     ≡ CPU at [2, 64] over 1601 unit-normal memory rows: the prefill's
     output and caches, a decode step, every gradient (the memory's too)
     within CROSS_XDEV_TOL. (c) whisper at 1 + 1 layers card ≡ CPU: loss
     and every gradient. (d) Training (batch 8 × 64, remat): whisper at
     full depth (float32 moments, grad_accum 2: the frames split with
     the tokens) with falling losses and resume ≡ uninterrupted bit for
     bit; the VLM at 1 period (6.53 B parameters, int8 moments,
     grad_accum 1) with falling losses, its peak printed;
 16. the `kernels` line (launches, ms, bound, plain ms per kernel, K1–K7,
     K6's row-id variant and K6q rows; K2 and K7 also their status and the
     launch floor; `serve_launches` where a serving path runs the kernel;
     `mesh_launches` where the `mesh` phase's runs launch it; K6's `launches_by_path` and K6q rows' `entry_launches_by_path`: the
     entry distance and the rerank on each path).
The last line is `{"ok": true, "device": {...}}`. Any failed check raises
and the script exits non-zero. It needs a CUDA device and the repository's
`src/` beside it; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12    # H100 SXM int8 dense (tensor cores)
DIM = 768                   # Tripclick's embedding width; never cut
EVAL_LANES = 64             # lanes per evaluation batch
REPEATS = 3                 # timed calls per e2e cell; the median is kept
PROFILE_ATTEMPTS = 3        # profiles taken before "no device time" fails


_LAST_EMIT = [time.perf_counter()]


def emit(obj) -> None:
    """Print one JSON line. A phase line without its own `seconds` gets
    the wall seconds since the previous line: the work of that phase."""
    now = time.perf_counter()
    if "phase" in obj and "seconds" not in obj:
        obj = {**obj, "seconds": now - _LAST_EMIT[0]}
    _LAST_EMIT[0] = now
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class CardMemoryPeak:
    """The card's peak `memory.used` (MiB, every process on it) over the
    run, read by `nvidia-smi` on a thread once a second."""

    def __init__(self, period_s: float = 1.0):
        self.peak_mib, self.samples = 0, 0
        self._period = period_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits", "--id=0"],
                capture_output=True, text=True, timeout=30).stdout.strip()
            if out:
                self.peak_mib = max(self.peak_mib, int(out.split()[0]))
                self.samples += 1
            self._stop.wait(self._period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def median_ms(fn, n: int = REPEATS) -> float:
    return float(np.median([wall_ms(fn)[1] for _ in range(n)]))


def _kernel_events(prof):
    """Device-side (kernel) entries of a profile, with their device µs."""
    from torch.autograd import DeviceType

    return [(e, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def kernel_breakdown(fn, iters: int = 3, warm: bool = False,
                     launches: list | None = None) -> dict:
    """Device ms per call of each kernel (and memset) that `fn` launches,
    by name, from one profile of `iters` calls (after a warm-up call
    unless the caller has just made one: `warm`); `launches`, a list,
    receives the kernels a call launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out, n = {}, 0
    for e, us in _kernel_events(prof):
        name = e.key.replace("void ", "").replace("(anonymous namespace)::",
                                                  "").split("(")[0]
        out[name] = out.get(name, 0.0) + us / 1e3 / iters
        n += e.count
    if launches is not None:
        launches.append(n / iters)
    return out


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call: the kernels' own time, from
    torch.profiler (CUPTI), without the host's launch overhead, after
    `warmup` calls. A profile that recorded no kernel at all (CUPTI drops
    one now and then) is taken again, up to PROFILE_ATTEMPTS times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(us for _, us in _kernel_events(prof))
        if total > 0:
            return total / 1e3 / iters
    raise AssertionError("the profiler recorded no device time")


FOREST_UPLOADS = [0]  # GBDTModel.packed calls: forest copies to the card


def count_forest_uploads() -> None:
    """Count every upload of an estimator's forest (`GBDTModel.packed`,
    three host-to-device copies) in FOREST_UPLOADS[0]."""
    from repro_torch.core.gbdt import GBDTModel

    real = GBDTModel.packed

    def packed(self, device):
        FOREST_UPLOADS[0] += 1
        return real(self, device)

    GBDTModel.packed = packed


# ---------------------------------------------------------------- K1 ----
def four_slot_program(rng, b, w, v, equal_rows, device):
    """4 slots in 2 terms, varied per lane: (contain ∧ range) ∨ (¬in ∧
    equal); `equal_rows` [b, w] uint32 are the label words the equal slot
    matches."""
    import torch

    from repro_torch.filters.compile import FilterProgram

    s, t = 4, 2
    kinds = np.tile(np.array([0, 2, 3, 1], np.int32), (b, 1))
    masks = np.zeros((b, s, w), np.uint32)
    for i in range(b):
        masks[i, 0, rng.integers(0, w)] = np.uint32(1) << np.uint32(
            rng.integers(0, 32))
        masks[i, 2, :] = rng.integers(0, 1 << 32, w, dtype=np.uint64)
        masks[i, 3, :] = equal_rows[i]
    lo = rng.random((b, s)).astype(np.float32) * 0.5
    hi = lo + 0.5
    vattr = rng.integers(0, v, (b, s)).astype(np.int32)
    neg = np.tile(np.array([False, False, True, False]), (b, 1))
    term = np.tile(np.array([0, 0, 1, 1], np.int32), (b, 1))
    active = np.ones((b, s), bool)
    term_active = np.ones((b, t), bool)
    return FilterProgram(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                           for a in (kinds, masks.view(np.int32), lo, hi,
                                     vattr, neg, term, active, term_active)))


K4_SLOTS, K4_KC = 576, 256  # PQ at d=768: S=192 subspaces × L=3, Kc=256
HEADS = {"float32": "K1", "int8": "K3", "pq": "K4"}


def step_head(rng, b, r, d, exact: bool, device, precision):
    """The distance head of one fused step at the main path's shapes: K1's
    (q, x), or K3's / K4's QuantGather (int8 codes [b, r, d], or uint8
    codes [b, r, 576] with a [b, 576, 256] table).

    exact=True makes every distance exact in float32 whatever the order of
    the sums (K1: grid 1/8 in [-2, 2]; K3: integer dots, dyadic sq, grid
    norms; K4: table and norms on the grid 1/64) and copies rows to make
    equal distances. The float codec cases take the main path's
    magnitudes: unit-norm data, so qn ≈ xn ≈ 1 and the inner product
    (2·sq·dot, or the lookup sum) is of order 1, with distances down to
    the clamp at 0. Returns (q, x, quant).
    """
    import torch

    from repro_torch.quant.codecs import Int8Prep, PQPrep, QuantGather

    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    grid = lambda a: np.round(a * 64) / 64  # noqa: E731
    if precision == "float32":
        if exact:
            q = np.clip(np.round(rng.normal(size=(b, d)) * 4) / 8, -2, 2)
            x = np.clip(np.round(rng.normal(size=(b, r, d)) * 4) / 8, -2, 2)
            x[:, 1] = x[:, 0]                   # equal distances
            x[:, 5] = x[:, 3]
        else:
            q = rng.normal(size=(b, d))
            x = rng.normal(size=(b, r, d))
        return to(q.astype(np.float32)), to(x.astype(np.float32)), None
    width = d if precision == "int8" else K4_SLOTS
    if precision == "int8":
        codes = rng.integers(-127, 128, (b, r, width)).astype(np.int8)
    else:
        codes = rng.integers(0, K4_KC, (b, r, width)).astype(np.uint8)
    codes[:, 1] = codes[:, 0]
    codes[:, 5] = codes[:, 3]
    xn = rng.random((b, r)) * 4
    qn = rng.random(b) * 4
    if not exact:
        xn, qn = 0.9 + xn / 20, 0.9 + qn / 20
    if precision == "int8":
        qq = rng.integers(-127, 128, (b, width)).astype(np.int8)
        if exact:  # |dot| ≤ 127²·d, so dot / 1024 is exact
            sq = np.full(b, 1 / 2048)
            xn, qn = grid(xn * 64), grid(400 + qn * 64)
        else:  # dot has std ≈ 1.5e5 at d=768
            sq = 2e-6 * (1 + rng.random(b))
        prep = Int8Prep(qq=to(qq), sq=to(sq.astype(np.float32)),
                        qn=to(qn.astype(np.float32)))
    else:
        lut = rng.normal(size=(b, width, K4_KC)) * (
            0.05 if exact else 0.5 / np.sqrt(width))
        if exact:
            lut, xn, qn = grid(lut), grid(xn * 64), grid(qn * 64)
        prep = PQPrep(lut=to(lut.astype(np.float32)),
                      qn=to(qn.astype(np.float32)))
    xn[:, 1] = xn[:, 0]
    xn[:, 5] = xn[:, 3]
    return None, None, QuantGather(prep=prep, codes=to(codes),
                                   norms=to(xn.astype(np.float32)))


def step_inputs(rng, b, r, d, m, k, w, v, exact: bool, device,
                precision="float32", ties: bool = False):
    """Inputs of one fused step at the main path's shapes: the head of
    `step_head`, then ids with duplicates, flags, attributes, a 4-slot
    program and sorted buffers whose old entries take values of the new
    distances when exact (ties across old and new). ties=True (with
    exact) also repeats 4 rows over each lane's R, empties the queue and
    result set of lanes 1 mod 3 (all inf) and masks every new entry of
    lanes 2 mod 3 (none first-visit). Returns (args, quant)."""
    import torch

    from repro_torch.kernels.distance import sqdist_bdrd
    from repro_torch.quant.codecs import QuantGather, quant_dist

    qt, xt, quant = step_head(rng, b, r, d, exact, device, precision)
    if ties:
        rows = torch.arange(r, device=device) % 4
        if quant is None:
            xt = xt[:, rows].contiguous()
        else:
            quant = QuantGather(prep=quant.prep,
                                codes=quant.codes[:, rows].contiguous(),
                                norms=quant.norms[:, rows].contiguous())
    nb = rng.integers(0, 1 << 20, (b, r)).astype(np.int32)
    nb[:, 7] = nb[:, 6]                         # duplicate ids
    is_new = rng.random((b, r)) < 0.8
    labels = rng.integers(0, 1 << 32, (b, r, w), dtype=np.uint64)
    labels = labels.astype(np.uint32).view(np.int32)
    values = rng.random((b, r, v)).astype(np.float32)
    prog = four_slot_program(
        rng, b, w, v,
        labels[np.arange(b), rng.integers(0, r, b)].view(np.uint32), device)
    dnew = (sqdist_bdrd(qt, xt) if quant is None
            else quant_dist(precision, quant)).cpu().numpy()
    if exact:
        base = np.sort(dnew, axis=1)
        cd = np.sort(np.concatenate(
            [np.repeat(base, (m // 2 + r - 1) // r, axis=1)[:, : m // 2],
             np.full((b, m - m // 2), np.inf, np.float32)], axis=1), axis=1)
        rd = np.sort(np.concatenate(
            [base[:, : k // 2], np.full((b, k - k // 2), np.inf)], axis=1),
            axis=1).astype(np.float32)
    else:
        lo_d, hi_d = float(dnew.min()), float(dnew.max())
        cd = np.sort(lo_d + rng.random((b, m)) * (hi_d - lo_d), axis=1)
        cd[:, m // 2:] = np.inf
        rd = np.sort(lo_d + rng.random((b, k)) * (hi_d - lo_d), axis=1)
        rd[:, k // 2:] = np.inf
    cd = cd.astype(np.float32)
    rd = rd.astype(np.float32)
    if ties:
        cd[1::3] = np.inf
        rd[1::3] = np.inf
        is_new[2::3] = False
    cp = rng.integers(0, 1 << 29, (b, m)).astype(np.int32)
    cp[np.isinf(cd)] = -1
    ri = rng.integers(0, 1 << 29, (b, k)).astype(np.int32)
    ri[np.isinf(rd)] = -1
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (qt, xt, to(nb), to(is_new), prog, to(labels), to(values),
            to(cd), to(cp), to(rd), to(ri)), quant


def pq_sum_atol(quant) -> np.ndarray:
    """[b, 1]: how far K4's distances may lie from the plain ones in each
    lane. Both sum a row's S·L looked-up entries in float32, K4 in slot
    order and the plain version in torch.sum's, and any order lands within
    γ_{n−1}·Σ|entries| of the exact sum (γ_n = n·u / (1 − n·u), u = 2⁻²⁴;
    Higham, Accuracy and Stability of Numerical Algorithms, §4.2). The
    distance takes twice the sum, so two sums differ in it by at most
    4·γ·Σ|entries|, here the lane's largest; the tail's own rounding stays
    inside rtol 1e-5."""
    import torch

    n = quant.codes.shape[2]
    u = 2.0 ** -24
    gamma = (n - 1) * u / (1 - (n - 1) * u)
    idx = quant.codes.to(torch.int64).transpose(1, 2)          # [b, S·L, r]
    abs_sum = torch.gather(quant.prep.lut.abs().double(), 2, idx).sum(dim=1)
    return (4 * gamma * abs_sum.amax(dim=1, keepdim=True)).cpu().numpy()


def check_step_kernel(device, precision="float32", r=32):
    """K1 (float32), K3 (int8) or K4 (pq) against `fused_step_plain` at
    B=64, R=r, d=768, M=512, K=10, post and pre mode: exact inputs (every
    output equal), the tie case of `step_inputs` (repeated rows, all-inf
    queues, all-masked runs: every output equal, bit for bit) and float
    inputs. On float inputs K3 must be equal too
    (an exact integer dot, the same tail); K1's distances must lie within
    rtol 1e-5 and K4's within rtol 1e-5 plus the lookup sums' rounding
    bound (`pq_sum_atol`), payloads moving only between entries that
    close. R=32 is the 1-hop frontier; K1 and K4 also run at R'=160, the
    widened frontier of pre and widen mode (32 + 32·32/8 at
    two_hop_stride 8)."""
    import torch

    from repro_torch.kernels.fused_step import fused_step, fused_step_plain

    b, d, m, k, w, v = 64, 768, 512, 10, 2, 2
    kid = HEADS[precision]
    seed = {"float32": 0, "int8": 3, "pq": 4}[precision]
    rng = np.random.default_rng(seed)
    tie_rng = np.random.default_rng(seed + 10)
    names = ("cand_dist", "cand_pay", "res_dist", "res_idx", "valid",
             "clause_add")
    max_err, err_over_atol, n_near, bitwise, n_ties = 0.0, 0.0, 0, True, 0
    for case in ("exact", "float", "ties"):
        exact = case != "float"
        args, quant = step_inputs(tie_rng if case == "ties" else rng, b, r,
                                  d, m, k, w, v, exact, device, precision,
                                  ties=case == "ties")
        kw = dict(quant=quant, precision=precision)
        strict = exact or precision == "int8"
        atol = (pq_sum_atol(quant) if precision == "pq" and not exact
                else np.zeros((b, 1)))
        for pre in (False, True):
            got = fused_step(*args, pre=pre, **kw)
            want = fused_step_plain(*args, pre=pre, **kw)
            torch.cuda.synchronize()
            got = [a.cpu().numpy() for a in got]
            want = [a.cpu().numpy() for a in want]
            if case == "ties":
                with np.errstate(invalid="ignore"):  # inf - inf pads
                    n_ties += int((np.diff(want[0], axis=1) == 0).sum())
            for name, g, wa in zip(names, got, want):
                if g.dtype != np.float32:
                    continue
                require(np.array_equal(np.isinf(g), np.isinf(wa)),
                        f"{kid} {name}: inf pattern differs (pre={pre})")
                fin = np.isfinite(wa)
                lane_atol = np.broadcast_to(atol, wa.shape)[fin]
                err = np.abs(g[fin] - wa[fin])
                max_err = max(max_err, float(err.max(initial=0.0)))
                if precision == "pq" and not exact:
                    err_over_atol = max(err_over_atol,
                                        float((err / lane_atol).max()))
                bitwise = bitwise and np.array_equal(g[fin], wa[fin])
                require((err <= 1e-5 * np.abs(wa[fin]) + lane_atol).all(),
                        f"{kid} {name}: distances beyond the stated "
                        f"tolerance (pre={pre}, max abs err {err.max()})")
                if strict:
                    require(np.array_equal(g[fin], wa[fin]),
                            f"{kid} {name}: distances differ (pre={pre}, "
                            f"{case} case)")
            for name in ("valid", "clause_add"):
                i = names.index(name)
                require(np.array_equal(got[i], want[i]),
                        f"{kid} {name} differs (pre={pre}, {case} case)")
            for di, pi in ((0, 1), (2, 3)):
                same = got[pi] == want[pi]
                if strict:
                    require(same.all(), f"{kid} {names[pi]} differs "
                            f"(pre={pre}, {case} case)")
                else:
                    # float inputs: a payload may move only between entries
                    # whose distances are within the stated tolerance
                    dw = want[di]
                    with np.errstate(invalid="ignore"):  # inf - inf pads
                        gap = np.minimum(
                            np.abs(np.diff(dw, axis=1, prepend=-np.inf)),
                            np.abs(np.diff(dw, axis=1, append=np.inf)))
                    near = gap <= 1e-5 * np.abs(dw) + atol
                    n_near += int((~same & near).sum())
                    require((same | near).all(),
                            f"{kid} {names[pi]} differs away from near-ties "
                            f"(pre={pre})")
    args, quant = step_inputs(rng, b, r, d, m, k, w, v, False, device,
                              precision)
    kw = dict(quant=quant, precision=precision)
    ms = device_ms(lambda: fused_step(*args, **kw))
    plain_ms = device_ms(lambda: fused_step_plain(*args, **kw))
    call_ms = time_cuda(lambda: fused_step(*args, **kw))
    plain_call_ms = time_cuda(lambda: fused_step_plain(*args, **kw))
    q, x, nb, is_new, prog, lab, val, cd, cp, rd, ri = args
    tail = (nb, is_new, lab, val, cd, cp, rd, ri, *prog)
    out_bytes = b * m * 8 + b * k * 8 + b * r + b * 4 * 4
    if quant is None:
        head_bytes = sum(t.numel() * t.element_size() for t in (q, x))
        t_ops = 4 * b * r * d / FP32_FLOP_PER_S  # x·x and q·x
    else:
        codes = quant.codes
        if precision == "int8":   # int8 multiply-adds over the int8 peak
            head = (codes, quant.norms, *quant.prep)
            t_ops = 2 * codes.numel() / INT8_OPS_PER_S
        else:  # the codes and the table entries they look up, adds
            head = (codes, quant.norms, quant.prep.qn)
            t_ops = codes.numel() / FP32_FLOP_PER_S
        head_bytes = sum(t.numel() * t.element_size() for t in head)
        if precision == "pq":
            head_bytes += codes.numel() * 4
    nbytes = head_bytes + out_bytes + sum(
        t.numel() * t.element_size() for t in tail)
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               call_ms=call_ms, plain_call_ms=plain_call_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    shapes = dict(B=b, R=r, d=d, M=m, K=k, W=w, V=v, S=4, T=2)
    if precision == "pq":
        shapes.update(SL=K4_SLOTS, Kc=K4_KC)
        out_pq = {"float_case_max_err_over_rounding_bound": err_over_atol}
    else:
        out_pq = {}
    phase = f"{kid.lower()}_check" if r == 32 else f"{kid.lower()}_wide_check"
    emit({"phase": phase, "ok": True, "precision": precision,
          "shapes": shapes, "modes": ["post", "pre"],
          "float_case_bitwise": bitwise, "tie_case_bitwise": True,
          "tie_case_equal_adjacent_queue_keys": n_ties, **out_pq,
          "float_case_payload_moves_at_near_ties": n_near, "bytes": nbytes,
          **out})
    return out


# ---------------------------------------------------------------- K2 ----
def launch_floor(device, kernel: str) -> dict:
    """The card's floor for one launch, printed beside `kernel`'s check:
    the time of a kernel that does next to nothing (a one-element in-place
    add, one block), by the profiler and by CUDA events. A kernel near
    this floor has little left to take."""
    import torch

    z = torch.zeros(1, device=device)
    out = {"floor_ms": device_ms(lambda: z.add_(1.0)),
           "floor_call_ms": time_cuda(lambda: z.add_(1.0))}
    emit({"phase": "launch_floor", "kernel": kernel,
          "op": "one-element in-place add_ (1 block)", **out})
    return out


K2_TREES, K2_DEPTHS, K2_LANES = (1, 7, 200, 401), range(1, 7), (1, 33, 64, 130)
K2_STATUS = K7_STATUS = "redesigned"  # the kernels line's status


def tree_order_sum(feats, feat, thresh, leaf, base, depth) -> np.ndarray:
    """K2's bits by another route, in numpy: each tree's leaf by the heap
    walk, then float32 adds in tree order from 0, each rounded once, then
    base."""
    x, feat, thresh, leaf = (a.cpu().numpy() for a in (feats, feat, thresh,
                                                       leaf))
    n, ni = x.shape[0], feat.shape[1]
    acc = np.zeros(n, np.float32)
    for t in range(feat.shape[0]):
        idx = np.zeros(n, np.int64)
        for _ in range(depth):
            go_left = x[np.arange(n), feat[t, idx]] <= thresh[t, idx]
            idx = 2 * idx + 1 + (~go_left)
        acc = (acc + leaf[t, idx - ni]).astype(np.float32)
    return (np.float32(base) + acc).astype(np.float32)


def k2_bitwise(feats, feat, thresh, leaf, base, depth, what: str,
               atol: float = 1e-5) -> None:
    """K2 == the tree-order sum bit for bit, and within rtol 1e-5 (and
    `atol`: leaf sums near 0 cancel) of `gbdt_predict_plain`."""
    import torch

    from repro_torch.kernels.gbdt import gbdt_predict, gbdt_predict_plain

    got = gbdt_predict(feats, feat, thresh, leaf, base, depth)
    want = tree_order_sum(feats, feat, thresh, leaf, base, depth)
    require(np.array_equal(got.cpu().numpy().view(np.int32),
                           want.view(np.int32)),
            f"K2 differs from the tree-order sum ({what})")
    plain = gbdt_predict_plain(feats, feat, thresh, leaf, base, depth)
    require(torch.allclose(got, plain, rtol=1e-5, atol=atol),
            f"K2 differs from plain beyond rtol 1e-5, atol {atol} ({what})")


def check_k2(device, sweep: bool = True):
    """K2 against `gbdt_predict_plain` (rtol 1e-5) and, bit for bit,
    against the tree-order sum: at the main path's shape (B=64, F=68,
    T=200, D=5) and (`sweep`) over T ∈ {1, 7, 200, 401}, D 1–6,
    B ∈ {1, 33, 64, 130} on random forests with +inf thresholds and
    feature F − 1; timed at the main path's shape, beside the launch
    floor."""
    import torch

    from repro_torch.kernels.gbdt import gbdt_predict, gbdt_predict_plain

    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    rng = np.random.default_rng(12)
    for t in K2_TREES if sweep else ():
        for depth in K2_DEPTHS:
            for b in K2_LANES:
                ni, nl, f = (1 << depth) - 1, 1 << depth, 68
                thresh = rng.normal(size=(t, ni)).astype(np.float32)
                thresh[rng.random((t, ni)) < 0.2] = np.inf
                feat = rng.integers(0, f, (t, ni)).astype(np.int32)
                feat[:, rng.integers(0, ni)] = f - 1
                k2_bitwise(to(rng.normal(size=(b, f)).astype(np.float32)),
                           to(feat), to(thresh),
                           to(rng.normal(size=(t, nl)).astype(np.float32)),
                           float(np.float32(rng.normal())), depth,
                           f"random forest T={t} D={depth} B={b}")
    b, f, t, depth = 64, 68, 200, 5
    ni, nl = (1 << depth) - 1, 1 << depth
    rng = np.random.default_rng(1)
    feats = to(rng.normal(size=(b, f)).astype(np.float32))
    feat = to(rng.integers(0, f, (t, ni)).astype(np.int32))
    thresh = to(rng.normal(size=(t, ni)).astype(np.float32))
    leaf = to((0.1 * rng.normal(size=(t, nl))).astype(np.float32))
    base = 5.25
    k2_bitwise(feats, feat, thresh, leaf, base, depth, "main path's shape",
               atol=0.0)
    got = gbdt_predict(feats, feat, thresh, leaf, base, depth)
    want = gbdt_predict_plain(feats, feat, thresh, leaf, base, depth)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = device_ms(lambda: gbdt_predict(feats, feat, thresh, leaf, base,
                                        depth))
    plain_ms = device_ms(lambda: gbdt_predict_plain(feats, feat, thresh,
                                                    leaf, base, depth))
    call_ms = time_cuda(lambda: gbdt_predict(feats, feat, thresh, leaf, base,
                                             depth))
    plain_call_ms = time_cuda(lambda: gbdt_predict_plain(
        feats, feat, thresh, leaf, base, depth))
    nbytes = 4 * (b * f + t * (2 * ni + nl) + b)
    ops = b * t * depth  # compares; additions b*t
    bound = max(nbytes / HBM_BYTES_PER_S, (ops + b * t) / FP32_FLOP_PER_S)
    emit({"phase": "k2_check", "ok": True,
          "shapes": dict(B=b, F=f, T=t, D=depth), "max_abs_err": err,
          "bitwise_tree_order": {"T": K2_TREES, "D": list(K2_DEPTHS),
                                 "B": K2_LANES} if sweep else "B=64 only",
          "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
          "plain_call_ms": plain_call_ms, "bound_ms": bound * 1e3})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, call_ms=call_ms,
                plain_call_ms=plain_call_ms,
                bound_ms=bound * 1e3, bound_by="bytes",
                **launch_floor(device, "K2"))


def k2_trained_check(est, feats, device) -> None:
    """K2 on the e2e estimator's trained forest and the training lanes'
    probe features, 64 lanes a batch and all lanes at once: bit for bit
    the tree-order sum, within rtol 1e-5 and atol 1e-5 of plain."""
    import torch

    feat, thresh, leaf, base = est.packed(device)
    z = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(device)
    for lo in range(0, z.shape[0], EVAL_LANES):
        k2_bitwise(z[lo:lo + EVAL_LANES], feat, thresh, leaf, base,
                   est.model.depth, f"trained forest, lanes {lo}+")
    k2_bitwise(z, feat, thresh, leaf, base, est.model.depth,
               "trained forest, all lanes")
    emit({"phase": "k2_trained_check", "ok": True, "lanes": z.shape[0],
          "T": int(feat.shape[0]), "D": est.model.depth,
          "bitwise_tree_order": True})


# ---------------------------------------------------------------- K6 ----
def check_k6(device):
    import torch

    from repro_torch.kernels.distance import sqdist_masked, sqdist_masked_plain

    b, r, d = 64, 32, 768
    rng = np.random.default_rng(2)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    max_err = 0.0
    for exact in (True, False):
        q = rng.normal(size=(b, d))
        x = rng.normal(size=(b, r, d))
        if exact:  # grid 1/8 in [-2, 2]: every distance exact in float32
            q, x = (np.clip(np.round(a * 4) / 8, -2, 2) for a in (q, x))
        mask = rng.random((b, r)) < 0.8
        qt, xt, mt = to(q.astype(np.float32)), to(x.astype(np.float32)), \
            to(mask)
        got = sqdist_masked(qt, xt, mt).cpu().numpy()
        want = sqdist_masked_plain(qt, xt, mt).cpu().numpy()
        require(np.array_equal(np.isinf(got), ~mask)
                and np.array_equal(np.isinf(want), ~mask),
                "K6: +inf pattern is not the mask's complement")
        err = float(np.abs(got[mask] - want[mask]).max())
        max_err = max(max_err, err)
        if exact:
            require(np.array_equal(got, want),
                    "K6: exact-arithmetic distances differ")
        else:
            require(np.allclose(got[mask], want[mask], rtol=1e-5, atol=0.0),
                    f"K6: distances beyond rtol 1e-5 (max abs err {err})")
    k1_pairs = k6_equals_k1(device)
    ms = device_ms(lambda: sqdist_masked(qt, xt, mt))
    plain_ms = device_ms(lambda: sqdist_masked_plain(qt, xt, mt))
    call_ms = time_cuda(lambda: sqdist_masked(qt, xt, mt))
    plain_call_ms = time_cuda(lambda: sqdist_masked_plain(qt, xt, mt))
    rows = int(mask.sum())  # the kernel reads unmasked rows only
    nbytes = 4 * b * d + 4 * rows * d + b * r + 4 * b * r
    flops = 4 * rows * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    out = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               call_ms=call_ms, plain_call_ms=plain_call_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "k6_check", "ok": True,
          "shapes": dict(B=b, R=r, d=d, unmasked_rows=rows),
          "equals_k1_bitwise_pairs": k1_pairs, **out})
    return out


def k6_equals_k1(device) -> int:
    """K6's value for each (query, row) pair == K1's, bit for bit, at B=64,
    R=32, d=768, M=512 on exact and float inputs: one K1 step from an
    all-inf queue stores every new pair's distance (M >= R), found again
    by its payload (the row's position). Returns the pairs compared."""
    import torch

    from repro_torch.kernels.distance import sqdist_masked
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.topk import unpack_payload

    b, r, d, m, k = EVAL_LANES, 32, DIM, 512, 10
    rng = np.random.default_rng(16)
    pairs = 0
    for exact in (True, False):
        args, _ = step_inputs(rng, b, r, d, m, k, 2, 2, exact, device)
        args = list(args)
        q, x = args[0], args[1]
        args[2] = torch.arange(r, dtype=torch.int32,
                               device=device).repeat(b, 1)
        args[3] = torch.ones((b, r), dtype=torch.bool, device=device)
        args[7] = torch.full_like(args[7], float("inf"))
        args[8] = torch.full_like(args[8], -1)
        cd, cp = fused_step(*args)[:2]
        k6 = sqdist_masked(q, x, args[3])
        pos = unpack_payload(cp[:, :r])[0].long()
        torch.cuda.synchronize()
        require(bool(torch.isinf(cd[:, r:]).all())
                and torch.equal(torch.sort(pos, dim=1)[0], args[2].long()),
                "K6 = K1: the step did not store every new pair")
        require(torch.equal(cd[:, :r], torch.gather(k6, 1, pos)),
                f"K6 = K1: a pair's distance differs (exact={exact})")
        pairs += b * r
    return pairs


# ---------------------------------------------------------------- K7 ----
def merge_inputs(rng, b, m, r, ties: bool, device):
    """K7's inputs: sorted [b, m] buffers whose last quarter is +inf
    (payload -1) and raw [b, r] entries. ties=True draws distances on the
    grid 1/8 in [0, 3), so equal keys fall within the new entries, within
    the old ones and across the two."""
    import torch

    draw = ((lambda shape: rng.integers(0, 24, shape) / 8) if ties
            else (lambda shape: rng.random(shape) * 3))
    dist = np.sort(draw((b, m)).astype(np.float32), axis=1)
    dist[:, 3 * m // 4:] = np.inf
    pay = rng.integers(0, 1 << 29, (b, m)).astype(np.int32)
    pay[np.isinf(dist)] = -1
    nd = draw((b, r)).astype(np.float32)
    npay = rng.integers(0, 1 << 29, (b, r)).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (dist, pay, nd, npay)]


def library_merge(cat_d, cat_p, m):
    """One PyTorch call pair computing K7's function on the concatenation
    [old | new]: a stable sort, then a gather of the payloads."""
    import torch

    sd, order = torch.sort(cat_d, dim=1, stable=True)
    return sd[:, :m], torch.gather(cat_p, 1, order[:, :m])


def check_k7(device):
    """K7 (merge by rank) against `topm_merge_plain`, bit for bit, at
    B=64, M=512, R=32 on sorted buffers with +inf tails: forced ties
    within and across the runs, R=1, R'=160, an M that is not a power of
    two, one off a multiple of 4 (4-byte loads, not vectors), and float
    distances; the library call pair must give the same order. Timed
    beside the launch floor."""
    import torch

    from repro_torch.kernels.topk import topm_merge, topm_merge_plain

    b, m, r = EVAL_LANES, 512, 32
    rng = np.random.default_rng(8)
    cases = [(m, r, True), (m, 1, True), (500, r, True), (m, r, False),
             (m, 160, True), (42, r, True)]
    for cm, cr, ties in cases:
        args = merge_inputs(rng, b, cm, cr, ties, device)
        gd, gp = topm_merge(*args)
        wd, wp = topm_merge_plain(*args)
        ld, lp = library_merge(torch.cat(args[0::2], 1),
                               torch.cat(args[1::2], 1), cm)
        torch.cuda.synchronize()
        require(torch.equal(gd, wd) and torch.equal(gp, wp),
                f"K7 differs from its plain version (M={cm}, R={cr}, "
                f"ties={ties})")
        require(torch.equal(ld, wd) and torch.equal(lp, wp),
                f"K7's library call pair differs (M={cm}, R={cr})")
    args = merge_inputs(rng, b, m, r, True, device)
    cat_d, cat_p = torch.cat(args[0::2], 1), torch.cat(args[1::2], 1)
    out = dict(
        max_abs_err=0.0, ms=device_ms(lambda: topm_merge(*args)),
        plain_ms=device_ms(lambda: topm_merge_plain(*args)),
        call_ms=time_cuda(lambda: topm_merge(*args)),
        plain_call_ms=time_cuda(lambda: topm_merge_plain(*args)),
        library_ms=device_ms(lambda: library_merge(cat_d, cat_p, m)))
    nbytes = b * (m + r) * 8 + b * m * 8  # read both runs, write best M
    out.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    emit({"phase": "k7_check", "ok": True, "shapes": dict(B=b, M=m, R=r),
          "cases": [dict(M=cm, R=cr, ties=t) for cm, cr, t in cases],
          "bitwise": True, "bytes": nbytes,
          "library": "torch.sort(stable=True) over [B, M+R] + gather", **out})
    return {**out, **launch_floor(device, "K7")}


# ---------------------------------------------------------- K6 row ids ----
ORACLE_BLOCK = 1 << 18  # filtered_knn_exact's n_block: its rows per call


def check_k6_scan(device):
    """K6's row-id variant (the scan's and the oracle's distance) over an
    N=1M, d=768 store: against its plain per-lane version (equal on grid
    data, rtol 1e-5 on float data), and bit for bit against itself with
    one lane alone, with 64·j padded rows, and against the gathered K6 on
    the same rows, and with its lanes in another order. Layouts: the
    scan's (sorted ids, a masked tail) at V ∈ {4096, 65536}, and the
    oracle's (one block of consecutive ids in every lane, masked by
    validity) at its block width V = 2^18, with B=64 (one lane group);
    and the scan's at V=4096 with B=130 (three lane groups) over the first
    N=999,983 rows (a multiple of no tile), ids below 0.8·N (rows that no
    lane passes) and two lanes that pass no row."""
    import torch

    from repro_torch.kernels.distance import (SCAN_ALIGN, sqdist_masked,
                                              sqdist_rows, sqdist_rows_plain)

    n_full, d, b_max = K5_N, DIM, 130
    g = torch.Generator(device=device).manual_seed(9)
    max_err, checked = 0.0, []
    for exact in (True, False):
        if exact:  # grid 1/8 in [-2, 2]: every distance exact in float32
            store = torch.randint(-16, 17, (n_full, d), generator=g,
                                  device=device,
                                  dtype=torch.int32).to(torch.float32) / 8
            q_all = torch.randint(-16, 17, (b_max, d), generator=g,
                                  device=device,
                                  dtype=torch.int32).to(torch.float32) / 8
        else:
            store = torch.randn((n_full, d), generator=g, device=device)
            q_all = torch.randn((b_max, d), generator=g, device=device)
        for v, layout, b, n in ((4096, "scan", EVAL_LANES, n_full),
                                (65536, "scan", EVAL_LANES, n_full),
                                (ORACLE_BLOCK, "oracle", EVAL_LANES, n_full),
                                (4096, "scan", b_max, n_full - 17)):
            base, q = store[:n], q_all[:b]
            hi = n if b == EVAL_LANES else int(0.8 * n)
            if layout == "scan":
                ids = torch.sort(torch.randint(0, hi, (b, v), generator=g,
                                               device=device), dim=1)[0]
                counts = torch.randint(v // 2, v + 1, (b, 1), generator=g,
                                       device=device)
                mask = torch.arange(v, device=device)[None, :] < counts
            else:  # the oracle's third block: rows 2^19 .. 2^19 + 2^18
                ids = torch.arange(2 * v, 3 * v, device=device)[None]
                ids = ids.expand(b, v)
                sel = torch.rand((b, 1), generator=g, device=device) * 0.3
                mask = torch.rand((b, v), generator=g, device=device) < sel
            if b != EVAL_LANES:
                mask[[1, b - 1]] = False
            ids = ids.to(torch.int32).contiguous()
            got = sqdist_rows(q, base, ids, mask)
            want = sqdist_rows_plain(q, base, ids, mask)
            pad = 3 * SCAN_ALIGN
            wide = sqdist_rows(q, base,
                               torch.nn.functional.pad(ids, (0, pad)),
                               torch.nn.functional.pad(mask, (0, pad)))
            lanes = (0, b // 3, b - 1)
            ones = [sqdist_rows(q[i:i + 1], base, ids[i:i + 1],
                                mask[i:i + 1]) for i in lanes]
            gl = EVAL_LANES * 4096 // v  # gathered rows: 0.8 GB a case
            gathered = sqdist_masked(q[:gl], base[ids[:gl].long()],
                                     mask[:gl])
            perm = torch.randperm(b, generator=g, device=device)
            moved = sqdist_rows(q[perm], base, ids[perm], mask[perm])
            torch.cuda.synchronize()
            require(torch.equal(torch.isinf(got), ~mask),
                    "K6 rows: +inf pattern is not the mask's complement")
            err = float((got[mask] - want[mask]).abs().max())
            max_err = max(max_err, err)
            if exact:
                require(torch.equal(got, want),
                        f"K6 rows: exact distances differ at V={v}")
            else:
                require(torch.allclose(got[mask], want[mask], rtol=1e-5,
                                       atol=0.0),
                        f"K6 rows: beyond rtol 1e-5 at V={v} ({err})")
            require(torch.equal(wide[:, :v], got),
                    f"K6 rows: padded width changed a value at V={v}")
            require(all(torch.equal(o[0], got[i]) for o, i in zip(ones,
                                                                  lanes)),
                    f"K6 rows: a lane alone differs from the batch at V={v}")
            require(torch.equal(gathered, got[:gl]),
                    f"K6 rows: differs from the gathered K6 at V={v}")
            require(torch.equal(moved, got[perm]),
                    f"K6 rows: reordered lanes differ at V={v}, B={b}")
            checked.append(dict(V=v, layout=layout, B=b, N=n, exact=exact,
                                max_abs_err=err))
            del got, want, wide, gathered, moved
        del store, base
        torch.cuda.empty_cache()
    emit({"phase": "k6_scan_check", "ok": True, "shapes": dict(d=d),
          "cases": checked, "max_abs_err": max_err, "lane_invariant": True,
          "width_invariant": True, "lane_order_invariant": True,
          "equals_gathered_k6": True})


K6_ROWS_V = 1 << 19  # the "mixed" forced scan's width at N=1M


def time_k6_rows(device, layout="scan"):
    """K6's row-id variant timed without the planner at B=64, N=1M, d=768:
    layout "scan" at V=2^19 with per-lane σ from 3e-06 to 0.48 like the
    "mixed" forced scan's (each lane's passing rows ascending, a masked
    tail; ≈11.1 M pairs), or "oracle" at V = ORACLE_BLOCK (rows 2^19 ..
    2^19 + 2^18 in every lane, masked at the same σ). Held against the
    plain version (+inf where masked, rtol 1e-5); device and call ms, the
    device ms of each kernel the call launches, and the bound: each
    distinct passing row once plus query, ids, mask and output, or 4·d
    flops a pair."""
    import torch

    from repro_torch.kernels.distance import sqdist_rows, sqdist_rows_plain

    n, d, b = K5_N, DIM, EVAL_LANES
    g = torch.Generator(device=device).manual_seed(17)
    base = torch.randn((n, d), generator=g, device=device)
    q = torch.randn((b, d), generator=g, device=device)
    sigma = np.maximum(3e-06, 0.48 * (np.arange(b) / (b - 1)) ** 1.76)
    sig = torch.from_numpy(sigma.astype(np.float32)).to(device)[:, None]
    if layout == "scan":
        v = K6_ROWS_V
        passing = torch.rand((b, n), generator=g, device=device) < sig
        order = torch.argsort((~passing).to(torch.uint8), dim=1,
                              stable=True)[:, :v]
        mask = (torch.arange(v, device=device)[None]
                < passing.sum(1, keepdim=True))
        ids = torch.where(mask, order, 0).to(torch.int32).contiguous()
        del passing, order
    else:
        v = ORACLE_BLOCK
        ids = torch.arange(2 * v, 3 * v, dtype=torch.int32,
                           device=device)[None].expand(b, v).contiguous()
        mask = torch.rand((b, v), generator=g, device=device) < sig
    got = sqdist_rows(q, base, ids, mask)
    want = sqdist_rows_plain(q, base, ids, mask)
    require(torch.equal(torch.isinf(got), ~mask)
            and torch.equal(torch.isinf(want), ~mask),
            f"K6 rows ({layout}): +inf pattern is not the mask's complement")
    err = float((got[mask] - want[mask]).abs().max())
    require(torch.allclose(got[mask], want[mask], rtol=1e-5, atol=0.0),
            f"K6 rows ({layout}): beyond rtol 1e-5 (max abs err {err})")
    del got, want
    rows = int(mask.sum())
    distinct = int(torch.unique(ids[mask]).numel())
    nbytes = 4 * b * d + 9 * b * v + 4 * distinct * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * rows * d / FP32_FLOP_PER_S
    call = lambda: sqdist_rows(q, base, ids, mask)  # noqa: E731
    out = dict(max_abs_err=err, ms=device_ms(call, iters=5),
               call_ms=time_cuda(call, iters=5, warmup=1),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "k6_rows_timing", "ok": True, "layout": layout,
          "shapes": dict(B=b, N=n, d=d, V=v, passing_pairs=rows,
                         distinct_rows=distinct, bytes=nbytes), **out,
          "kernel_ms": kernel_breakdown(call)})
    return out


# ------------------------------------------------------------ K6q rows ----
K6Q_ORACLE_LANES = 128  # compressed_filtered_topk's query chunk


def k6q_world(g, precision, b, n, width, kc, device):
    """K6q rows' inputs at unrounded, main-path magnitudes: a code store
    [n, width] (int8, or uint8 codes of a PQ table with kc centroids) with
    norms near 1, and a prep of b lanes (int8: qq, sq ≈ 2e-6, qn near 1;
    PQ: a [b, width, kc] table of order 1/√width). Returns (prep, codes,
    norms)."""
    import torch

    from repro_torch.quant.codecs import Int8Prep, PQPrep

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    if precision == "int8":
        codes = torch.randint(-127, 128, (n, width), generator=g,
                              device=device, dtype=torch.int32).to(torch.int8)
        prep = Int8Prep(
            qq=torch.randint(-127, 128, (b, width), generator=g,
                             device=device, dtype=torch.int32).to(torch.int8),
            sq=2e-6 * (1 + rand(b)), qn=0.9 + rand(b) / 20)
    else:
        codes = torch.randint(0, kc, (n, width), generator=g, device=device,
                              dtype=torch.int32).to(torch.uint8)
        lut = torch.randn((b, width, kc), generator=g, device=device)
        prep = PQPrep(lut=lut * (0.5 / np.sqrt(width)),
                      qn=0.9 + rand(b) / 20)
    return prep, codes.contiguous(), 0.9 + rand(n) / 20


def k6q_layout(g, layout, b, v, n, device, sigma=None):
    """ids [b, v] int32 and mask [b, v]: the scan's (each lane's passing
    rows ascending — drawn at per-lane σ when given, else a sorted draw —
    then a masked tail) or the oracle's (one block of consecutive rows in
    every lane, masked by validity at σ, default ≤ 0.3)."""
    import torch

    if layout == "scan":
        if sigma is None:
            ids = torch.sort(torch.randint(0, n, (b, v), generator=g,
                                           device=device), dim=1)[0]
            counts = torch.randint(v // 2, v + 1, (b, 1), generator=g,
                                   device=device)
        else:
            passing = torch.rand((b, n), generator=g, device=device) < sigma
            ids = torch.argsort((~passing).to(torch.uint8), dim=1,
                                stable=True)[:, :v]
            counts = passing.sum(1, keepdim=True)
            del passing
        mask = torch.arange(v, device=device)[None] < counts
        ids = torch.where(mask, ids, 0)
    else:
        ids = torch.arange(2 * v, 3 * v, device=device)[None].expand(b, v)
        if sigma is None:
            sigma = torch.rand((b, 1), generator=g, device=device) * 0.3
        mask = torch.rand((b, v), generator=g, device=device) < sigma
    return ids.to(torch.int32).contiguous(), mask.contiguous()


def k6q_bitwise(got, want) -> bool:
    import torch

    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def k6q_rows_check(device, precision):
    """K6q rows (int8 or PQ) against its plain version, bit for bit (int8:
    an exact dot and K3's tail; PQ: the same slot-order sum), on float
    data: the scan's layout at V ∈ {4096, 65536} and the oracle's at its
    block width V = 2^18, B=64, over an N=1M store of the main path's
    width (d=768 codes; S·L=576, Kc=256); B=130 over N=999,983 with two
    lanes that pass no row; widths off a multiple of 32 (int8 d=740; PQ
    S·L=97 by byte loads with Kc=256 by bulk copies, and S·L=99, Kc=13 by
    4-byte copies); the oracle's layout with lane 0 fully unmasked and
    lane 1 unmasked at its last position only ("oracle edges"); each bit
    for bit against itself alone, padded by 192 rows and with its lanes in
    another order; then each (query, row) pair equal to K3's / K4's
    (`k6q_equals_step`)."""
    import torch

    from repro_torch.kernels.quant_rows import (sqdist_rows_quant,
                                                sqdist_rows_quant_plain)

    width = DIM if precision == "int8" else K4_SLOTS
    g = torch.Generator(device=device).manual_seed(23)
    prep_all, codes, norms = k6q_world(g, precision, 130, K5_N, width, K4_KC,
                                       device)
    cases = [(4096, "scan", EVAL_LANES, K5_N, width, K4_KC),
             (65536, "scan", EVAL_LANES, K5_N, width, K4_KC),
             (ORACLE_BLOCK, "oracle", EVAL_LANES, K5_N, width, K4_KC),
             (ORACLE_BLOCK, "oracle edges", EVAL_LANES, K5_N, width, K4_KC),
             (4096, "scan", 130, K5_N - 17, width, K4_KC)]
    if precision == "int8":
        cases.append((4096, "scan", EVAL_LANES, 100_000, 740, 0))
    else:
        cases += [(4096, "scan", EVAL_LANES, 100_000, 97, K4_KC),
                  (4096, "oracle", EVAL_LANES, 100_000, 99, 13)]
    checked = []
    for v, layout, b, n, w, kc in cases:
        if w == width:
            prep = type(prep_all)(*(t[:b] for t in prep_all))
            cs, ns = codes[:n], norms[:n]
        else:
            prep, cs, ns = k6q_world(g, precision, b, n, w, kc, device)
        ids, mask = k6q_layout(g, layout.split()[0], b, v, n, device)
        if b != EVAL_LANES:
            mask[[1, b - 1]] = False
        if layout == "oracle edges":
            mask[0] = True
            mask[1] = torch.arange(v, device=device) == v - 1
        got = sqdist_rows_quant(prep, cs, ns, ids, mask)
        want = sqdist_rows_quant_plain(prep, cs, ns, ids, mask)
        pad = 3 * 64
        wide = sqdist_rows_quant(prep, cs, ns,
                                 torch.nn.functional.pad(ids, (0, pad)),
                                 torch.nn.functional.pad(mask, (0, pad)))
        lanes = (0, b // 3, b - 1)
        ones = [sqdist_rows_quant(type(prep)(*(t[i:i + 1] for t in prep)),
                                  cs, ns, ids[i:i + 1], mask[i:i + 1])
                for i in lanes]
        perm = torch.randperm(b, generator=g, device=device)
        moved = sqdist_rows_quant(type(prep)(*(t[perm] for t in prep)), cs,
                                  ns, ids[perm], mask[perm])
        torch.cuda.synchronize()
        require(torch.equal(torch.isinf(got), ~mask),
                f"K6q {precision}: +inf pattern is not the mask's complement")
        require(k6q_bitwise(got, want),
                f"K6q {precision}: differs from its plain version at V={v}, "
                f"B={b}, width {w}")
        require(torch.equal(wide[:, :v], got) and
                bool(torch.isinf(wide[:, v:]).all()),
                f"K6q {precision}: padded width changed a value at V={v}")
        require(all(torch.equal(o[0], got[i]) for o, i in zip(ones, lanes)),
                f"K6q {precision}: a lane alone differs at V={v}")
        require(torch.equal(moved, got[perm]),
                f"K6q {precision}: reordered lanes differ at V={v}")
        checked.append(dict(V=v, layout=layout, B=b, N=n, width=w, Kc=kc,
                            unmasked=int(mask.sum())))
        del got, want, wide, moved
    del prep_all, codes, norms
    torch.cuda.empty_cache()
    pairs = k6q_equals_step(device, precision)
    emit({"phase": f"k6q_{precision}_check", "ok": True, "cases": checked,
          "bitwise_equal_plain": True, "lane_invariant": True,
          "width_invariant": True, "lane_order_invariant": True,
          "equals_step_kernel_bitwise_pairs": pairs,
          "step_kernel": HEADS[precision]})


def k6q_equals_step(device, precision) -> int:
    """K6q rows' value for each (query, row) pair == K3's / K4's, bit for
    bit, at B=64, R=32 (d=768; S·L=576, Kc=256), M=512 on exact and float
    inputs: one fused step from an all-inf queue stores every new pair's
    distance, found again by its payload; K6q reads the same rows from a
    store of the B·R gathered rows by id. Returns the pairs compared."""
    import torch

    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.quant_rows import sqdist_rows_quant
    from repro_torch.kernels.topk import unpack_payload

    b, r, m, k = EVAL_LANES, 32, 512, 10
    rng = np.random.default_rng(24)
    pairs = 0
    for exact in (True, False):
        args, quant = step_inputs(rng, b, r, DIM, m, k, 2, 2, exact, device,
                                  precision)
        args = list(args)
        args[2] = torch.arange(r, dtype=torch.int32,
                               device=device).repeat(b, 1)
        args[3] = torch.ones((b, r), dtype=torch.bool, device=device)
        args[7] = torch.full_like(args[7], float("inf"))
        args[8] = torch.full_like(args[8], -1)
        cd, cp = fused_step(*args, quant=quant, precision=precision)[:2]
        width = quant.codes.shape[2]
        store = quant.codes.reshape(b * r, width).contiguous()
        ids = torch.arange(b * r, dtype=torch.int32,
                           device=device).reshape(b, r)
        k6q = sqdist_rows_quant(quant.prep, store,
                                quant.norms.reshape(-1).contiguous(), ids,
                                args[3])
        pos = unpack_payload(cp[:, :r])[0].long()
        torch.cuda.synchronize()
        require(bool(torch.isinf(cd[:, r:]).all())
                and torch.equal(torch.sort(pos, dim=1)[0], args[2].long()),
                f"K6q = {HEADS[precision]}: the step did not store every "
                "new pair")
        require(k6q_bitwise(cd[:, :r], torch.gather(k6q, 1, pos)),
                f"K6q = {HEADS[precision]}: a pair's distance differs "
                f"(exact={exact})")
        pairs += b * r
    return pairs


H100_SMS = 132              # streaming multiprocessors of an H100 SXM
SMEM_BANKS = 32             # shared-memory banks: 4-byte words a cycle


def k6q_bound(prep, codes, ids, mask, precision, sm_mhz=None):
    """The least time of a K6q rows call on these inputs, by HBM bytes —
    each unmasked pair's code row, norm and id, the mask and the output
    at every position, and the prep (under PQ each lane's table, once) —
    or by operations (int8: 2·d a pair at the int8 peak; PQ: S·L adds a
    pair at the float32 peak). Returns a dict of bound_ms, bound_by and
    bytes and, beside the bound and never inside it, under PQ: what the
    kernel reads of the tables — `table_reads` work items, each a whole
    table (`quant_rows.pq_work_items`; left out for a kernel without
    them, as `scripts/pair_kernels.py` may time), and
    `table_stream_bytes` — and the lookups (pairs × S·L) with
    `lookup_floor_ms`, the lookups at SMEM_BANKS a cycle per SM over
    H100_SMS SMs at the SM clock `sm_mhz` (read under load): a floor
    that bank conflicts of random codes only raise."""
    from repro_torch.kernels import quant_rows

    b, v = mask.shape
    width = codes.shape[1]
    pairs = int(mask.sum())
    nbytes = pairs * (width * codes.element_size() + 8) + 5 * b * v + sum(
        t.numel() * t.element_size() for t in prep)
    out = {}
    if precision == "pq":
        if hasattr(quant_rows, "pq_work_items"):
            reads = len(quant_rows.pq_work_items(
                mask.sum(1).tolist(), quant_rows.pq_grid(ids.device)))
            out.update(table_reads=reads, table_stream_bytes=reads * width *
                       prep.lut.shape[2] * 4)
        lookups = pairs * width
        out.update(code_bytes=pairs * width, lookups=lookups)
        if sm_mhz:
            out.update(sm_mhz=sm_mhz, lookup_floor_ms=lookups / (
                SMEM_BANKS * H100_SMS * sm_mhz * 1e6) * 1e3)
        t_ops = lookups / FP32_FLOP_PER_S
    else:
        t_ops = 2 * pairs * width / INT8_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, **out)


def sm_clock_under(fn, times: int) -> float:
    """The SM clock (MHz) `nvidia-smi` reads while `fn` runs `times` times
    back to back. Each result is dropped as soon as it is made, so the
    calls hold no more device memory than one call does."""
    import threading

    import torch

    mhz = []
    reader = threading.Thread(target=lambda: mhz.append(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]))
    reader.start()
    for _ in range(times):
        fn()
    reader.join()
    torch.cuda.synchronize()
    return float(mhz[0])


K6Q_PQ_NOTE = ("a launch is one wrapper call: three kernels, the count and "
               "the compaction of each lane's unmasked positions, then the "
               "sum (rows_pq_count, rows_pq_compact, rows_pq_kernel); ms is "
               "the call's, all three")
K6Q_LAYOUTS = {"scan": (EVAL_LANES, K6_ROWS_V),
               "oracle": (K6Q_ORACLE_LANES, ORACLE_BLOCK)}


def k6q_timing_inputs(device, precision, layout):
    """K6q rows' inputs at the "mixed" forced scan's shape (B=64, V=2^19,
    per-lane σ from 3e-06 to 0.48, ≈11.2 M pairs, as `time_k6_rows`) or
    the compressed oracle's (B=128, V=2^18 consecutive rows masked at the
    same σ), N=1M, d=768 / S·L=576, Kc=256. One generator draws the store,
    then the scan's layout, then the oracle's, so each layout's inputs are
    the same whichever is asked for. Returns (prep, codes, norms, ids,
    mask)."""
    import torch

    width = DIM if precision == "int8" else K4_SLOTS
    g = torch.Generator(device=device).manual_seed(29)
    prep_all, codes, norms = k6q_world(g, precision, K6Q_ORACLE_LANES, K5_N,
                                       width, K4_KC, device)
    for name, (b, v) in K6Q_LAYOUTS.items():
        sigma = np.maximum(3e-06, 0.48 * (np.arange(b) / (b - 1)) ** 1.76)
        sig = torch.from_numpy(sigma.astype(np.float32)).to(device)[:, None]
        ids, mask = k6q_layout(g, name, b, v, K5_N, device, sigma=sig)
        if name == layout:
            return (type(prep_all)(*(t[:b] for t in prep_all)), codes,
                    norms, ids, mask)
        del ids, mask
    raise ValueError(f"unknown K6q layout {layout!r}")


def time_k6q_rows(device, precision, layouts=("scan", "oracle"),
                  plain=True):
    """K6q rows timed without the planner at each of `layouts`
    (`k6q_timing_inputs`): held bit for bit to the plain version; ms by
    CUDA events (the profiler's beside it, and its per-kernel breakdown),
    and the bound (`k6q_bound`) at HBM_BYTES_PER_S; with `plain`, the
    plain version's ms at the scan's shape. Returns the first layout's
    numbers."""
    import torch

    from repro_torch.kernels.quant_rows import (sqdist_rows_quant,
                                                sqdist_rows_quant_plain)

    out = None
    for layout in layouts:
        prep, codes, norms, ids, mask = k6q_timing_inputs(device, precision,
                                                          layout)
        b, v = mask.shape
        call = lambda: sqdist_rows_quant(prep, codes, norms, ids, mask)  # noqa: E731
        plain_fn = lambda: sqdist_rows_quant_plain(prep, codes, norms, ids,  # noqa: E731
                                                   mask)
        got, want = call(), plain_fn()
        require(k6q_bitwise(got, want),
                f"K6q {precision} ({layout}): differs from its plain version")
        del got, want
        # ms by CUDA events over back-to-back calls (each call is one
        # launch of several ms); the profiler loses the PQ kernel's records
        call_ms = time_cuda(call, iters=5, warmup=1)
        mhz = sm_clock_under(call, int(1500 / call_ms) + 1) \
            if precision == "pq" else None
        bound = k6q_bound(prep, codes, ids, mask, precision, mhz)
        res = dict(max_abs_err=0.0, ms=call_ms, call_ms=call_ms,
                   profiler_ms=device_ms(call, iters=5),
                   bound_ms=bound.pop("bound_ms"),
                   bound_by=bound.pop("bound_by"))
        if plain and layout == "scan":  # the check warmed the plain version
            res.update(plain_ms=device_ms(plain_fn, iters=1, warmup=0),
                       plain_call_ms=time_cuda(plain_fn, iters=1, warmup=0))
        out = out or res
        emit({"phase": f"k6q_{precision}_timing", "ok": True,
              "layout": layout, "bitwise_equal_plain": True,
              "shapes": dict(B=b, N=K5_N, width=codes.shape[1], V=v,
                             passing_pairs=int(mask.sum()), **bound),
              "hbm_bytes_per_s": HBM_BYTES_PER_S, **res,
              "kernel_ms": kernel_breakdown(call)})
        del prep, codes, norms, ids, mask
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- K5 ----
K5_STEPS = 8  # SearchConfig.steps_per_launch's default
K5_N = 1_000_000  # rows of K5's synthetic index: the main path's N
K5_TIE_ROWS = 4096  # distinct rows of its tie case
TRAJ_FIELDS = ("visited", "cnt", "n_inspected", "n_valid_visited",
               "n_clause_valid", "n_pop_valid", "hops", "active",
               "conv_cnt", "res_full_cnt")


def copy_state(state):
    return type(state)(*(a.clone() for a in state))


def k5_quant(g, n, b, d, precision, exact: bool, device):
    """A synthetic quant index over N rows and its per-query state, at the
    main path's widths: int8 codes [N, 768], or uint8 codes [N, 576] with
    64 tables [576, 256]; norms and errors per row. exact=True puts the
    tables, norms, errors and the query step on dyadic grids (every ADC
    distance and error sum exact in float32); the int8 dot is exact in any
    case."""
    import torch

    from repro_torch.quant.codecs import Int8Index, Int8Prep, PQIndex, PQPrep

    kw = dict(generator=g, device=device)
    grid = (lambda t: torch.round(t * 64) / 64) if exact else (  # noqa: E731
        lambda t: t)
    norms = grid(torch.rand((n,), **kw) * 4)
    err = grid(torch.rand((n,), **kw) * 0.25)
    qn = grid(torch.rand((b,), **kw) * 4)
    if precision == "int8":
        codes = torch.randint(-127, 128, (n, d), dtype=torch.int8, **kw)
        qq = torch.randint(-127, 128, (b, d), dtype=torch.int8, **kw)
        sq = (torch.full((b,), 1 / 2048, device=device) if exact
              else 1e-4 * (1 + torch.rand((b,), **kw)))
        index = Int8Index(codes=codes, scale=torch.full((d,), 1 / 32,
                                                        device=device),
                          zero=torch.zeros(d, device=device), norms=norms,
                          err=err)
        return index, Int8Prep(qq=qq, sq=sq, qn=300 + qn)
    codes = torch.randint(0, K4_KC, (n, K4_SLOTS), dtype=torch.uint8, **kw)
    books = grid(torch.randn((3, K4_SLOTS // 3, K4_KC, d * 3 // K4_SLOTS),
                             **kw) * 0.05)
    lut = grid(torch.randn((b, K4_SLOTS, K4_KC), **kw) * 0.05)
    index = PQIndex(codes=codes, codebooks=books, norms=norms, err=err)
    return index, PQPrep(lut=lut, qn=qn)


def k5_world(seed, exact: bool, device, precision="float32",
             ties: bool = False):
    """A synthetic index at the main path's shapes on the card — N=1M
    rows of d=768 (and, under a codec, the index of `k5_quant`), a random
    graph of degree 32 with a repeated id in every row and some -1
    padding, 2 label words, 2 value channels — 64 queries, a 4-slot
    program, and a state advanced by 24 plain steps, with budgets that stop
    lanes inside the next launch and some lanes already stopped. Returns
    (args, state, kw) with kw the quant keywords of the calls.

    exact=True puts vectors on the grid 1/8 in [-2, 2] (every squared
    distance exact in float32, ties frequent); otherwise N(0, 1).
    ties=True repeats K5_TIE_ROWS distinct rows (vectors, or codes, norms
    and errors) over the N, so queued and new distances are often equal,
    and then gives lanes 1 mod 4 an all-inf queue and result set, lanes
    2 mod 4 a visited set holding every node (each new run all masked)
    and lanes 3 mod 4 the state of init_state.
    """
    import torch

    from repro_torch.core import SearchConfig, init_state
    from repro_torch.kernels.persistent_step import persistent_multi_step_plain

    n, d, r, b, w, v = K5_N, DIM, 32, EVAL_LANES, 2, 2
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device).manual_seed(seed)
    if exact:
        base = torch.randint(-16, 17, (n, d), generator=g, device=device,
                             dtype=torch.int32).to(torch.float32) / 8
        queries = torch.randint(-16, 17, (b, d), generator=g, device=device,
                                dtype=torch.int32).to(torch.float32) / 8
    else:
        base = torch.randn((n, d), generator=g, device=device)
        queries = torch.randn((b, d), generator=g, device=device)
    if ties:
        rows = torch.randint(0, K5_TIE_ROWS, (n,), generator=g, device=device)
        base = base[rows]
    nbrs = torch.randint(0, n, (n, r), generator=g, device=device,
                         dtype=torch.int32)
    nbrs[:, 7] = nbrs[:, 6]                     # repeated ids
    nbrs[::5, -1] = -1                          # graph padding
    labels = torch.randint(-(1 << 31), 1 << 31, (n, w), generator=g,
                           device=device, dtype=torch.int64).to(torch.int32)
    values = torch.rand((n, v), generator=g, device=device)
    equal_rows = labels[torch.from_numpy(rng.integers(0, n, b)).to(device)]
    prog = four_slot_program(rng, b, w, v,
                             equal_rows.cpu().numpy().view(np.uint32), device)
    attrs = (labels, values)
    cfg = SearchConfig(k=10, queue_size=512, degree=r, precision=precision)
    kw = {}
    if precision != "float32":
        quant, qprep = k5_quant(g, n, b, d, precision, exact, device)
        if ties:
            quant = quant._replace(codes=quant.codes[rows],
                                   norms=quant.norms[rows],
                                   err=quant.err[rows])
        kw = dict(quant=quant, qprep=qprep)
    big = torch.full((b,), 1 << 30, dtype=torch.int32, device=device)
    fresh = init_state(cfg, queries, prog, base, attrs, 0, **kw)
    state = persistent_multi_step_plain(cfg, queries, prog, base, attrs, nbrs,
                                        big, copy_state(fresh), 1 << 30, None,
                                        steps=24, **kw)
    if ties:
        for f in state._fields:
            getattr(state, f)[3::4] = getattr(fresh, f)[3::4]
        for f, empty in (("cand_dist", float("inf")), ("cand_idx", -1),
                         ("cand_exp", False), ("cand_valid", False),
                         ("res_dist", float("inf")), ("res_idx", -1)):
            getattr(state, f)[1::4] = empty
        state.visited[2::4] = -1
    cnt = state.cnt.cpu().numpy()
    budgets = torch.from_numpy(
        (cnt + rng.integers(0, K5_STEPS * r, b)).astype(np.int32)).to(device)
    active = np.ones(b, bool)
    active[::9] = False                         # stopped before the launch
    state = state._replace(active=torch.from_numpy(active).to(device))
    args = (cfg, queries, prog, base, attrs, nbrs, budgets)
    return args, state, kw


def k5_compare(got, want, what):
    """K5 against its plain version on float data, lane by lane.

    Lanes whose trajectory fields (visited, counters, flags) are equal
    must have distances within rtol 1e-5, and their ids and flags may
    move only between entries whose distances are within that tolerance
    (near-ties), as in check_step_kernel. Returns (lanes with equal trajectories,
    lanes where some payload moved, max abs error, moved entries).
    """
    g = {f: getattr(got, f).cpu().numpy() for f in got._fields}
    w = {f: getattr(want, f).cpu().numpy() for f in want._fields}
    b = g["cnt"].shape[0]
    traj = np.ones(b, bool)
    for f in TRAJ_FIELDS:
        traj &= (g[f] == w[f]).reshape(b, -1).all(axis=1)
    moved = np.zeros(b, bool)
    max_err, n_near = 0.0, 0
    for dist, lanes in (("cand_dist", ("cand_idx", "cand_exp", "cand_valid")),
                        ("res_dist", ("res_idx",))):
        gd, wd = g[dist][traj], w[dist][traj]
        require(np.array_equal(np.isinf(gd), np.isinf(wd)),
                f"K5 {what} {dist}: inf pattern differs")
        fin = np.isfinite(wd)
        err = np.abs(gd[fin] - wd[fin])
        max_err = max(max_err, float(err.max(initial=0.0)))
        require(np.allclose(gd[fin], wd[fin], rtol=1e-5, atol=0.0),
                f"K5 {what} {dist}: distances beyond rtol 1e-5")
        with np.errstate(invalid="ignore"):  # inf - inf pads
            gap = np.minimum(np.abs(np.diff(wd, axis=1, prepend=-np.inf)),
                             np.abs(np.diff(wd, axis=1, append=np.inf)))
        near = gap <= 1e-5 * np.abs(wd)
        same = np.ones_like(near)
        for f in lanes:
            same &= g[f][traj] == w[f][traj]
        require((same | near).all(),
                f"K5 {what} {lanes[0]} differs away from near-ties")
        n_near += int((~same).sum())
        moved[np.flatnonzero(traj)[(~same).any(axis=1)]] = True
    return traj, moved, max_err, n_near


def k5_tie_check(device, precision, seed):
    """K5 against its plain version on the tie world of `k5_world` (exact
    arithmetic, K5_TIE_ROWS distinct rows, all-inf queues, all-masked
    runs, fresh lanes), one 8-step launch: every field equal, bit for bit.
    Returns the equal adjacent finite queue keys of the result, a count of
    the ties the merges met."""
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.kernels.persistent_step import (
        persistent_multi_step, persistent_multi_step_plain)

    args, state, kw = k5_world(seed, True, device, precision, ties=True)
    got = persistent_multi_step(*args, copy_state(state), 1 << 30, None,
                                steps=K5_STEPS, **kw)
    want = persistent_multi_step_plain(*args, copy_state(state), 1 << 30,
                                       None, steps=K5_STEPS, **kw)
    torch.cuda.synchronize()
    for f, a, b_ in zip(got._fields, state_to_numpy(got),
                        state_to_numpy(want)):
        require(np.array_equal(a, b_), f"K5 {precision} {f} differs on the "
                "tie case")
    with np.errstate(invalid="ignore"):  # inf - inf pads
        n_ties = int((np.diff(want.cand_dist.cpu().numpy(), axis=1) == 0)
                     .sum())
    require(n_ties > 0, f"K5 {precision}: the tie case met no tie")
    del args, state, got, want, kw
    torch.cuda.empty_cache()
    return n_ties


def check_k5(device):
    """K5 against persistent_multi_step_plain at N=1M, 8 steps a launch."""
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.kernels.persistent_step import (
        persistent_multi_step, persistent_multi_step_plain)

    big = 1 << 30
    # exact arithmetic: every field equal
    args, state, _ = k5_world(5, True, device)
    # even lanes converge when their results reach those of 3 more steps
    gt = persistent_multi_step_plain(*args, copy_state(state), big, None,
                                     steps=3).res_dist
    gt[1::2] = 0.0
    got = persistent_multi_step(*args, copy_state(state), big, gt,
                                steps=K5_STEPS)
    want = persistent_multi_step_plain(*args, copy_state(state), big, gt,
                                       steps=K5_STEPS)
    torch.cuda.synchronize()
    for f, a, b_ in zip(got._fields, state_to_numpy(got),
                        state_to_numpy(want)):
        require(np.array_equal(a, b_), f"K5 {f} differs on exact data")
    stopped = int((~got.active.cpu().numpy()).sum())
    conv = int((got.conv_cnt.cpu().numpy() > 0).sum())
    del args, state, got, want, gt
    torch.cuda.empty_cache()
    n_ties = k5_tie_check(device, "float32", 9)

    # float data: every step replayed alone explains any lane that moved
    args, state, _ = k5_world(6, False, device)
    want = [copy_state(state)]
    for _ in range(K5_STEPS):
        want.append(persistent_multi_step_plain(*args, copy_state(want[-1]),
                                                big, None, steps=1))
    moved, max_err, n_near = np.zeros(EVAL_LANES, bool), 0.0, 0
    for s in range(K5_STEPS):
        one = persistent_multi_step(*args, copy_state(want[s]), big, None,
                                    steps=1)
        traj, mv, err, nn = k5_compare(one, want[s + 1], f"step {s}")
        require(traj.all(), f"K5 step {s}: a counter or visited differs "
                "from the plain step on the same input")
        moved |= mv
        max_err, n_near = max(max_err, err), n_near + nn
    got = persistent_multi_step(*args, copy_state(state), big, None,
                                steps=K5_STEPS)
    traj, _, err, _ = k5_compare(got, want[-1], "8 steps")
    require(not (~traj & ~moved).any(),
            "K5: a lane's trajectory diverged without a near-tie move")
    max_err = max(max_err, err)

    out, timed = k5_time_and_bound(args, state, {}, got)
    out = dict(max_abs_err=max_err, **out)
    cfg, queries, prog, base, (labels, values), nbrs, budgets = args
    b, d = queries.shape
    m, k, r = cfg.queue_size, cfg.k, nbrs.shape[1]
    w, v = labels.shape[1], values.shape[1]
    emit({"phase": "k5_check", "ok": True, "shapes": dict(
        B=b, N=base.shape[0], d=d, M=m, K=k, R=r, W=w, V=v, S=4, T=2,
        steps=K5_STEPS), "exact_case_lanes_stopped": stopped,
        "exact_case_lanes_converged": conv, "tie_case_all_fields_equal": True,
        "tie_case_equal_adjacent_queue_keys": n_ties,
        "float_case_lanes_moved_at_near_ties": int(moved.sum()),
        "float_case_payload_moves_at_near_ties": n_near,
        "timed_launch": timed, **out})
    del args, state, got, want
    torch.cuda.empty_cache()
    return out


def k5_time_and_bound(args, state, kw, got):
    """Device and call ms of one 8-step launch from `state` (kernel and
    plain version; the state is consumed, so each call takes a clone), and
    the least time for that launch's work (`got` is its result): the bytes
    it must move, or its operations."""
    from repro_torch.kernels.persistent_step import (
        persistent_multi_step, persistent_multi_step_plain)

    big, iters = 1 << 30, 10
    n_clones = 4 * iters + 10  # device_ms's retries and time_cuda's calls
    clones = iter([copy_state(state) for _ in range(n_clones)])
    run_k = lambda: persistent_multi_step(  # noqa: E731
        *args, next(clones), big, None, steps=K5_STEPS, **kw)
    run_p = lambda: persistent_multi_step_plain(  # noqa: E731
        *args, next(clones), big, None, steps=K5_STEPS, **kw)
    ms = device_ms(run_k, iters=iters)
    call_ms = time_cuda(run_k, iters=iters, warmup=2)
    clones = iter([copy_state(state) for _ in range(n_clones)])
    plain_ms = device_ms(run_p, iters=iters)
    plain_call_ms = time_cuda(run_p, iters=iters, warmup=2)

    cfg, queries, prog, base, (labels, values), nbrs, budgets = args
    precision = cfg.precision or "float32"
    b, d = queries.shape
    m, k, r = cfg.queue_size, cfg.k, nbrs.shape[1]
    w, v = labels.shape[1], values.shape[1]
    new_rows = int((got.cnt - state.cnt).sum())
    lane_steps = int((got.hops - state.hops).sum())
    # buffers, 11 counters (+ q_err_sum under a codec), active
    state_bytes = b * (m * 10 + k * 8 + 4 * (11 + (precision != "float32"))
                       + 1)
    nbytes = (2 * state_bytes
              + sum(t.numel() * t.element_size() for t in (*prog, budgets))
              + lane_steps * r * 4 * 2           # id row + visited words read
              + new_rows * 4                     # visited words written
              + new_rows * 4 * (w + v))          # new rows' labels, values
    if precision == "float32":
        nbytes += 4 * b * d + new_rows * 4 * d   # queries, new rows
        t_ops = 4 * new_rows * d / FP32_FLOP_PER_S
    else:
        width = kw["quant"].codes.shape[1]
        nbytes += new_rows * (width + 8)         # codes, norm and error
        nbytes += sum(t.numel() * t.element_size() for t in kw["qprep"]
                      if t.dim() < 3)            # qq, sq, qn
        if precision == "int8":
            t_ops = 2 * new_rows * width / INT8_OPS_PER_S
        else:                                    # table entries looked up
            nbytes += new_rows * width * 4
            t_ops = new_rows * width / FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = dict(ms=ms, plain_ms=plain_ms, call_ms=call_ms,
               plain_call_ms=plain_call_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out, dict(new_rows=new_rows, lane_steps=lane_steps, bytes=nbytes)


def check_k5_codec(device, precision):
    """K5's int8 or PQ branch against persistent_multi_step_plain after one
    8-step launch over the N=1M synthetic index: every field equal, float
    fields and q_err_sum included (int8 on float data — its dot is exact
    — and PQ on exact data), then on the tie case of `k5_tie_check`."""
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.kernels.persistent_step import (
        persistent_multi_step, persistent_multi_step_plain)

    big = 1 << 30
    exact = precision == "pq"
    args, state, kw = k5_world(7, exact, device, precision)
    gt = persistent_multi_step_plain(*args, copy_state(state), big, None,
                                     steps=3, **kw).res_dist
    gt[1::2] = 0.0
    got = persistent_multi_step(*args, copy_state(state), big, gt,
                                steps=K5_STEPS, **kw)
    want = persistent_multi_step_plain(*args, copy_state(state), big, gt,
                                       steps=K5_STEPS, **kw)
    torch.cuda.synchronize()
    for f, a, b_ in zip(got._fields, state_to_numpy(got),
                        state_to_numpy(want)):
        require(np.array_equal(a, b_), f"K5 {precision} {f} differs")
    require(bool((got.q_err_sum > state.q_err_sum).any()),
            f"K5 {precision}: q_err_sum did not grow")
    stopped = int((~got.active.cpu().numpy()).sum())
    conv = int((got.conv_cnt.cpu().numpy() > 0).sum())
    got = persistent_multi_step(*args, copy_state(state), big, None,
                                steps=K5_STEPS, **kw)
    out, timed = k5_time_and_bound(args, state, kw, got)
    out = dict(max_abs_err=0.0, **out)  # every field equal
    width = int(kw["quant"].codes.shape[1])
    del args, state, got, want, gt, kw
    torch.cuda.empty_cache()
    n_ties = k5_tie_check(device, precision, 10)
    emit({"phase": f"k5_{precision}_check", "ok": True,
          "data": "exact" if exact else "float", "shapes": dict(
              B=EVAL_LANES, N=K5_N, row_width=width,
              M=512, K=10, R=32, steps=K5_STEPS),
          "all_fields_equal": True, "lanes_stopped": stopped,
          "lanes_converged": conv, "tie_case_all_fields_equal": True,
          "tie_case_equal_adjacent_queue_keys": n_ties,
          "timed_launch": timed, **out})
    return out


# ---------------------------------------------------------- main path ----
COUNTED = ("fused_step", "fused_step_int8", "fused_step_pq", "gbdt_predict",
           "persistent_multi_step", "persistent_multi_step_int8",
           "persistent_multi_step_pq", "sqdist_masked", "sqdist_rows",
           "sqdist_rows_quant_int8", "sqdist_rows_quant_pq", "topm_merge")


def _wrappers():
    from repro_torch.kernels.distance import sqdist_masked, sqdist_rows
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.gbdt import gbdt_predict
    from repro_torch.kernels.persistent_step import persistent_multi_step
    from repro_torch.kernels.quant_rows import sqdist_rows_quant
    from repro_torch.kernels.topk import topm_merge

    return (fused_step, gbdt_predict, persistent_multi_step, sqdist_masked,
            sqdist_rows, topm_merge, sqdist_rows_quant)


def reset_counts() -> None:
    """Every kernel launch count to 0 (fused_step, persistent_multi_step
    and sqdist_rows_quant count per precision: one count per kernel
    head)."""
    for fn in _wrappers():
        if isinstance(fn.launches, dict):
            fn.launches.update(dict.fromkeys(fn.launches, 0))
        else:
            fn.launches = 0


def read_counts() -> dict:
    """Launches per kernel since the last reset: K1, K3, K4 (the heads of
    fused_step), K2, K5's three branches, K6 and its row-id variant, K6q
    rows (int8, PQ), K7."""
    fused, gbdt, pers, sqd, rows, merge, qrows = _wrappers()
    out = {"gbdt_predict": gbdt.launches, "sqdist_masked": sqd.launches,
           "sqdist_rows": rows.launches, "topm_merge": merge.launches}
    for fn in (fused, pers, qrows):
        for prec, n in fn.launches.items():
            name = fn.__name__ + ("" if prec == "float32" else f"_{prec}")
            out[name] = n
    return {k: out[k] for k in COUNTED}

def make_world(n: int, train_queries: int, vectors_path: str):
    """The Tripclick-scale dataset (`make_dataset` on the "tripclick-s"
    preset at N = n) with the training and evaluation workloads, and the
    seconds they took. `main` runs it in a child process beside the kernel
    checks: the generator is one host thread (≈35–140 s by host) and the
    checks are card work. The [N, d] vectors go back through the file
    `vectors_path` (`load_world` reads it): pickled through the pool's
    pipe they took ≈60 s."""
    import dataclasses

    from repro_torch.data.synthetic import (DATASET_PRESETS, make_dataset,
                                            make_label_workload,
                                            make_range_workload)

    preset = dict(DATASET_PRESETS["tripclick-s"])
    preset.update(n=n, dim=DIM)
    t = time.perf_counter()
    ds = make_dataset(name="tripclick", n_value_attrs=2, **preset)
    wl_train = make_label_workload(ds, batch=train_queries, kind="contain",
                                   seed=10)
    evals = {"contain": make_label_workload(ds, batch=EVAL_LANES,
                                            kind="contain", seed=20),
             "range": make_range_workload(ds, batch=EVAL_LANES, seed=21)}
    ds.vectors.tofile(vectors_path)
    ds = dataclasses.replace(ds, vectors=np.empty((0, DIM), np.float32))
    return ds, wl_train, evals, time.perf_counter() - t


def load_world(world, vectors_path: str):
    """`make_world`'s result with the vectors read back (the file is
    removed)."""
    import dataclasses

    ds, wl_train, evals, gen_s = world.get()
    vectors = np.fromfile(vectors_path, np.float32).reshape(-1, DIM)
    os.remove(vectors_path)
    return (dataclasses.replace(ds, vectors=vectors), wl_train, evals,
            gen_s)


def run_pipeline(args, device, k5_ms, world, vectors_path):
    import torch

    from repro_torch.core import (CostEstimator, SearchConfig, SearchEngine,
                                  e2e_search, generate_training_data,
                                  predict_budgets, probe_and_features)
    from repro_torch.index.bruteforce import filtered_knn_exact, recall_at_k
    from repro_torch.index.builder import build_graph_index
    from repro_torch.core import dispatch_counters

    # made in a child process since the start (`make_world`)
    t = time.perf_counter()
    ds, wl_train, evals, gen_s = load_world(world, vectors_path)
    emit({"phase": "dataset", "N": ds.n, "d": ds.dim, "W": ds.n_words,
          "V": ds.n_value_attrs, "child_seconds": gen_s,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    graph = build_graph_index(ds.vectors, degree=32, seed=0, device=device)
    torch.cuda.synchronize()
    deg = graph.out_degrees().to(torch.float32)
    emit({"phase": "graph", "seconds": time.perf_counter() - t,
          "degree": graph.degree, "mean_out_degree": float(deg.mean()),
          "entry_point": graph.entry_point})

    eng = SearchEngine.build(ds, graph, device=device)
    gts = {}
    t = time.perf_counter()
    for name, wl in evals.items():
        gts[name] = filtered_knn_exact(
            wl.queries, eng.base_vectors, wl.spec, ds.labels_packed,
            ds.value_matrix, 10, device=device)
    emit({"phase": "ground_truth", "seconds": time.perf_counter() - t,
          "queries": sum(w.batch for w in evals.values())})

    cfg = SearchConfig(k=10, queue_size=512)
    probe = 96
    t = time.perf_counter()
    td = generate_training_data(eng, ds, wl_train,
                                SearchConfig(k=10, queue_size=512,
                                             backend="fused"),
                                probe_budget=probe, chunk=128, n_probes=2)
    train_s = time.perf_counter() - t
    est = CostEstimator.fit(td.features, td.w_q, n_trees=200, depth=5)
    fit_s = time.perf_counter() - t - train_s
    # the first chunk's labels through the plain path: how often W_q
    # differs when the traversal's distances come from K1 instead of plain
    # PyTorch (PLAIN_LABELS queries, a depth cut)
    td_plain = generate_training_data(eng, ds,
                                      first_queries(wl_train, PLAIN_LABELS),
                                      SearchConfig(k=10, queue_size=512,
                                                   backend="dense"),
                                      probe_budget=probe, chunk=128,
                                      n_probes=2)
    emit({"phase": "training", "label_seconds": train_s, "fit_seconds": fit_s,
          "queries": int(td.w_q.shape[0]),
          "converged_frac": float(td.converged.mean()),
          "w_q_median": float(np.median(td.w_q)),
          "w_q_equal_plain_vs_kernel_frac": float(
              (td.w_q[:PLAIN_LABELS] == td_plain.w_q).mean()),
          "w_q_plain_queries": int(td_plain.w_q.shape[0]),
          "features": int(td.features.shape[1]),
          **convergence_check(eng, wl_train, td, probe, chunk=128)})
    k2_trained_check(est, td.features, device)

    cells = [(name, alpha) for name in evals for alpha in (1.0, 2.0)]

    def run(backend: str, only=None, **kw):
        """e2e_search on the cells (all four by default); per cell
        (result, wall ms, persistent launch-loop dispatch deltas)."""
        c = SearchConfig(k=10, queue_size=512, backend=backend, **kw)
        out = {}
        for name, alpha in only or cells:
            wl = evals[name]
            d0 = dispatch_counters()
            res, ms = wall_ms(lambda: e2e_search(
                eng, est, c, wl.queries, wl.spec, probe_budget=probe,
                alpha=alpha, n_probes=2))
            d1 = dispatch_counters()
            out[(name, alpha)] = (res, ms, {k: d1[k] - d0[k] for k in d0})
        return out

    def e2e_median_ms(backend: str, key, first_ms: float, **kw) -> float:
        """Median of the counted call and REPEATS - 1 more of the cell."""
        c = SearchConfig(k=10, queue_size=512, backend=backend, **kw)
        wl = evals[key[0]]
        more = [wall_ms(lambda: e2e_search(
            eng, est, c, wl.queries, wl.spec, probe_budget=probe,
            alpha=key[1], n_probes=2))[1] for _ in range(REPEATS - 1)]
        return float(np.median([first_ms, *more]))

    def drive(path: str, backend: str, only=None, **kw):
        """One path of the main path: every kernel count set to 0 just
        before, read just after; each kernel of the path must launch."""
        reset_counts()
        out = run(backend, only, **kw)
        counts = read_counts()
        need = {"fused": ("fused_step", "gbdt_predict"),
                "persistent": ("persistent_multi_step", "gbdt_predict"),
                "dense_use_pallas": ("sqdist_masked", "gbdt_predict")}[path]
        require(all(counts[n] > 0 for n in need),
                f"{path}: a kernel of the path was never launched: {counts}")
        return out, counts

    # ---- the main path (fused), then the persistent path (K5) ----
    fused, fused_counts = drive("fused", "fused")
    n_batches = len(fused)
    persistent, pers_counts = drive("persistent", "persistent")
    dense = run("dense")

    rows = []
    for key in fused:
        name, alpha = key
        fr, fms, _ = fused[key]
        dr, dms, _ = dense[key]
        fms = e2e_median_ms("fused", key, fms)
        # the plain yardstick's ms is its one checked call's: a median
        # would cost 2 more dense batches a cell
        gi = gts[name][0]
        f_idx, d_idx = fr.state.res_idx.cpu().numpy(), dr.state.res_idx.cpu().numpy()
        f_cnt, d_cnt = fr.state.cnt.cpu().numpy(), dr.state.cnt.cpu().numpy()
        f_dist = fr.state.res_dist.cpu().numpy()
        require(f_idx.shape == (EVAL_LANES, 10), "result shape")
        require(not np.isnan(f_dist).any(), "NaN result distance")
        f_rec = float(recall_at_k(f_idx, gi).mean())
        d_rec = float(recall_at_k(d_idx, gi).mean())
        same = float(((f_idx == d_idx).all(axis=1) & (f_cnt == d_cnt)).mean())
        budget_same = float((fr.predicted_budget == dr.predicted_budget).mean())
        # per-stage time: a separate run that calls the three stages one
        # by one, synchronised between them, so the stages need not add up
        # to e2e_ms (one run: each resume is a fused batch)
        wl = evals[name]
        c = SearchConfig(k=10, queue_size=512, backend="fused")
        (st, z), p_ms = wall_ms(lambda: probe_and_features(
            eng, c, wl.queries, wl.spec, probe, 2))
        (bud, _), e_ms = wall_ms(lambda: predict_budgets(est, z, alpha))
        _, r_ms = wall_ms(lambda: eng.search(c, wl.queries, wl.spec, bud,
                                             state=st))
        row = {"phase": "e2e", "workload": name, "alpha": alpha,
               "fused": {"recall@10": f_rec, "mean_ndc": float(f_cnt.mean()),
                         "e2e_ms": fms, "probe_ms": p_ms, "estimate_ms": e_ms,
                         "resume_ms": r_ms,
                         "mean_budget": float(fr.predicted_budget.mean())},
               "dense": {"recall@10": d_rec, "mean_ndc": float(d_cnt.mean()),
                         "e2e_ms": dms, "timed_calls": 1},
               "identical_top10_and_ndc_frac": same,
               "identical_budget_frac": budget_same}
        emit(row)
        rows.append(row)
        require(abs(f_rec - d_rec) <= 0.01,
                f"{name} α={alpha}: fused recall {f_rec} vs dense {d_rec}")
        require(same >= 0.95,
                f"{name} α={alpha}: only {same:.3f} of lanes identical")
        require(0.0 < f_rec <= 1.0 and (f_cnt > 1).all(),
                f"{name} α={alpha}: recall {f_rec}, min NDC {f_cnt.min()}")

    # ---- persistent rows: every SearchState field equal to fused's ----
    pers_rows = []
    for key in fused:
        name, alpha = key
        fr, fms, _ = fused[key]
        pr, pms, disp = persistent[key]
        pms = e2e_median_ms("persistent", key, pms)
        differ = [f for f, a, b in zip(pr.state._fields, pr.state, fr.state)
                  if not torch.equal(a, b)]
        require(not differ, f"persistent {name} α={alpha}: SearchState "
                f"fields differ from fused: {differ}")
        require(np.array_equal(pr.predicted_budget, fr.predicted_budget),
                f"persistent {name} α={alpha}: budgets differ from fused")
        p_idx = pr.state.res_idx.cpu().numpy()
        row = {"phase": "e2e_persistent", "workload": name, "alpha": alpha,
               "recall@10": float(recall_at_k(p_idx, gts[name][0]).mean()),
               "mean_ndc": float(pr.state.cnt.float().mean()),
               "e2e_ms": pms, "fused_e2e_ms": next(
                   r["fused"]["e2e_ms"] for r in rows
                   if (r["workload"], r["alpha"]) == key),
               "launches": disp["launches"],
               "compactions": disp["compactions"], "steps": disp["steps"],
               "all_fields_equal_fused": True}
        emit(row)
        pers_rows.append(row)

    # ---- dense with use_pallas (K6), contain α=1: identical to fused ----
    key = ("contain", 1.0)
    k6_run, k6_counts = drive("dense_use_pallas", "dense", [key],
                              use_pallas=True)
    kr, kms, _ = k6_run[key]
    fr = fused[key][0]
    kms = e2e_median_ms("dense", key, kms, use_pallas=True)
    same_ids = (kr.state.res_idx == fr.state.res_idx).all(dim=1)
    same_ndc = kr.state.cnt == fr.state.cnt
    lanes_same = int((same_ids & same_ndc).sum())
    require(lanes_same == EVAL_LANES,
            f"dense+use_pallas: {lanes_same} of {EVAL_LANES} lanes have "
            "fused's top-10 ids and NDC")
    emit({"phase": "e2e_dense_use_pallas", "workload": key[0],
          "alpha": key[1], "e2e_ms": kms,
          "identical_top10_and_ndc_lanes": lanes_same,
          "all_fields_equal_fused": all(
              torch.equal(a, b) for a, b in zip(kr.state, fr.state))})

    emit({"phase": "main_path", "query_batches": n_batches,
          "batch": EVAL_LANES, "launches": {
              "fused": fused_counts, "persistent": pers_counts,
              "dense_use_pallas": k6_counts}})
    profile_e2e(eng, est, evals["contain"], probe, "fused",
                rows[0]["fused"]["e2e_ms"])
    profile_e2e(eng, est, evals["contain"], probe, "persistent",
                pers_rows[0]["e2e_ms"])
    # ---- observability and serving on the persistent path ----
    e2e_split = run_obs_e2e(eng, est, evals["contain"], probe,
                            k5_ms["float32"])
    serve_counts, serve_splits = run_serve(
        eng, est, {name: (evals[name], persistent[(name, 1.0)][0])
                   for name in evals},
        probe, "float32", ("direct", "escalate"), k5_ms["float32"],
        ("persistent_multi_step", "gbdt_predict"))
    emit({"phase": "launch_split", "backend": "persistent",
          "precision": "float32", "obs_e2e": e2e_split,
          **{f"serve_{p}": v for p, v in serve_splits.items()}})
    run_serve_narrow(eng, est, evals["contain"],
                     persistent[("contain", 1.0)][0], probe)
    run_graph_recall(ds, eng, graph, evals["contain"], device)
    # ---- the RAG tail: a full-width decoder LM over the served ids ----
    lm = run_lm_full_width(device)
    rag_ids = run_rag(eng, est, evals["contain"],
                      persistent[("contain", 1.0)][0], probe, lm)
    del lm
    torch.cuda.empty_cache()
    launches = {"fused_step": fused_counts["fused_step"],
                "gbdt_predict": fused_counts["gbdt_predict"],
                "persistent_multi_step": pers_counts["persistent_multi_step"],
                "sqdist_masked": k6_counts["sqdist_masked"],
                # K6 as the entry distance of every search call without a
                # carried state (and, under a codec, the rerank)
                "k6_paths": {"fused float32 (4 batches)":
                             fused_counts["sqdist_masked"],
                             "persistent float32 (4 batches)":
                             pers_counts["sqdist_masked"]}}
    run_baselines(eng, ds, est, td, evals["contain"], gts["contain"][0],
                  persistent[("contain", 1.0)][0].predicted_budget, probe)
    plan_launches, k6r, plan_evals, plan_gts = run_planner(ds, eng, est,
                                                           probe, device)
    launches.update(plan_launches)
    launches["sharded"] = run_sharded(
        ds, eng, graph, est, evals, gts, plan_evals, plan_gts,
        persistent[("contain", 1.0)][0], probe, device)
    launches["serve:float32"] = serve_counts
    del eng
    torch.cuda.empty_cache()
    launches.update(run_quant(ds, graph, wl_train, evals, gts, probe,
                              device, plan_evals, plan_gts, k5_ms))
    return launches, k6r, rag_ids


# ---------------------------------------------------------- scale-out ----
SHARDS = 4         # index-axis shards of the sharded cells
SHARD_TRAIN = 128  # training queries of the sharded engine's estimator


# A host tier's gather under torch.profiler, in a child process: in this
# long process CUPTI dropped the copy's device records of a short window
# three times out of three, while a fresh process records every one.
GATHER_PROFILE = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.quant.tiering import HostVectorStore
b, p, n, d = (int(a) for a in sys.argv[1:5])
g = torch.Generator().manual_seed(0)
store = HostVectorStore(torch.randn(n, d, generator=g), sys.argv[5])
pool = torch.randint(-1, n, (b, p), generator=g, dtype=torch.int32)
pool = pool.to(store.device)
store.gather(pool)
acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                 if store.device.type == "cuda" else [])
with profile(activities=acts) as prof:
    for _ in range(3):
        store.gather(pool)
    if store.device.type == "cuda":
        torch.cuda.synchronize()
print(json.dumps(sorted({e.key for e in prof.key_averages()
                         if e.key.startswith("Memcpy HtoD")})))
"""


def host_gather_copies(pool_shape, device, rows: int = 250_000) -> list:
    """The host-to-device copy kinds ("Memcpy HtoD (Pinned -> Device)")
    that torch.profiler records for `HostVectorStore.gather` of a [B, P]
    pool over `rows` float32 rows of width DIM, run in a child process
    (taken again, up to PROFILE_ATTEMPTS times, while none is recorded)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    copies = []
    for _ in range(PROFILE_ATTEMPTS):
        proc = subprocess.run(
            [sys.executable, "-c", GATHER_PROFILE, *map(str, pool_shape),
             str(rows), str(DIM), device], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)
        require(proc.returncode == 0,
                f"the gather profile exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        copies = json.loads(proc.stdout.strip().splitlines()[-1])
        if copies:
            break
    return copies


def flat_merge(parts, offsets):
    """The merged view of per-shard states ([B, ...] SearchStates, shard
    order) by one flat stable sort of the union on (dist, position) — the
    yardstick of the sharded engine's merge — and the counters summed
    in shard order. Returns {field: tensor} for all 18 fields."""
    import torch

    dev = parts[0].cnt.device
    off = [int(o) for o in offsets]

    def pool(dname, iname, width):
        d = torch.cat([getattr(p, dname) for p in parts], dim=1)
        i = torch.cat([torch.where(getattr(p, iname) >= 0,
                                   getattr(p, iname) + o, -1)
                       for p, o in zip(parts, off)], dim=1)
        order = torch.sort(d, dim=1, stable=True)[1][:, :width]
        return order, torch.gather(d, 1, order), torch.gather(i, 1, order)

    k, m = parts[0].res_dist.shape[1], parts[0].cand_dist.shape[1]
    _, rd, ri = pool("res_dist", "res_idx", k)
    order, cd, ci = pool("cand_dist", "cand_idx", m)

    def flag(name):
        f = torch.cat([getattr(p, name) for p in parts], dim=1)
        return torch.gather(f, 1, order) & (ci >= 0)

    def total(name):
        out = getattr(parts[0], name)
        for p in parts[1:]:
            out = out + getattr(p, name)
        return out

    def reached(name):
        x = torch.stack([getattr(p, name) for p in parts], dim=1)
        return torch.where((x >= 0).all(dim=1), total(name),
                           -1).to(torch.int32)

    out = {"cand_dist": cd, "cand_idx": ci.to(torch.int32),
           "cand_exp": flag("cand_exp"), "cand_valid": flag("cand_valid"),
           "res_dist": rd, "res_idx": ri.to(torch.int32),
           "visited": torch.cat([p.visited for p in parts], dim=1),
           "active": torch.stack([p.active for p in parts]).any(dim=0),
           "d_start": torch.stack([p.d_start for p in parts]).min(
               dim=0).values,
           "conv_cnt": reached("conv_cnt"),
           "res_full_cnt": reached("res_full_cnt")}
    for name in ("cnt", "n_inspected", "n_valid_visited", "n_clause_valid",
                 "n_pop_valid", "q_err_sum", "hops"):
        out[name] = total(name)
    assert all(v.device == dev for v in out.values())
    return out


def merged_differ(state, want: dict) -> list:
    """Fields of a merged SearchState that differ from `want`."""
    import torch

    return [f for f in state._fields
            if not torch.equal(getattr(state, f), want[f])]


def run_sharded(ds, eng, graph, est, evals, gts, plan_evals, plan_gts, one,
                probe, device):
    """The scale-out phases on the Tripclick world: index-axis sharding on
    one card. S = 4 contiguous slices of 250,000 rows, a graph each built
    on the card (`build_sharded_graph_index`), and S = 1 (the plain
    graph as one shard); the float32 shards view the plain engine's
    vector tensor slice by slice. Checks (each a `require`): S = 1 ≡ the
    plain engine (every field, e2e contain α=1, persistent); S = 4 search
    ≡ each shard searched alone under ⌈W/4⌉ and merged by a flat stable
    sort on (dist, pos), every merged field, and probe → resume ≡ direct;
    the S = 4 scan ≡ the unsharded scan and `filtered_knn_exact` on the
    "mixed" batch; S = 4 `e2e_search(explain=True)` with an estimator
    fitted on the sharded engine: shard sections sum to the merged cnt,
    hops and n_inspected, an active lane's cnt ≥ its budget, tracing on ≡
    off; int8 host tier ≡ device tier after the rerank, with no [N, d]
    float32 tensor on the card for the host tier; serving on S = 4
    (scheduled ≡ one-shot, per-shard NDC adds up); then `run_mesh` on
    these engines. Returns the sharded path's kernel counts, the mesh
    phase's under "mesh"."""
    import dataclasses

    import torch

    from repro_torch.core import (CostEstimator, SearchConfig,
                                  ShardedSearchEngine, dispatch_counters,
                                  e2e_search, generate_training_data,
                                  scan_search)
    from repro_torch.core.plans import scan_stats
    from repro_torch.core.sharded import merge_shard_states
    from repro_torch.core.state import stack_shards
    from repro_torch.data.synthetic import make_label_workload
    from repro_torch.index import build_sharded_graph_index, recall_at_k
    from repro_torch.index.graph import GraphIndex, ShardedGraphIndex
    from repro_torch.obs import Tracer, work_balance
    from repro_torch.quant.rerank import rerank_pool
    from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                                   requests_from_workload)

    cfg = SearchConfig(k=10, queue_size=512, backend="persistent")
    wl = evals["contain"]
    gi = gts["contain"][0]
    # the float32 shards view the plain engine's [N, d] tensor
    sds = dataclasses.replace(ds, vectors=eng.base_vectors)

    t = time.perf_counter()
    sg4 = build_sharded_graph_index(eng.base_vectors, SHARDS, degree=32,
                                    seed=0, device=device)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t
    sg1 = ShardedGraphIndex([GraphIndex(
        neighbors=graph.neighbors, entry_point=graph.entry_point,
        dim=graph.dim, shard=0, offset=0)])
    t = time.perf_counter()
    s1 = ShardedSearchEngine.build(sds, sg1, device=device)
    s4 = ShardedSearchEngine.build(sds, sg4, device=device)
    torch.cuda.synchronize()
    views = all(sh.base_vectors.data_ptr() == eng.base_vectors.data_ptr()
                + int(o) * DIM * 4 for sh, o in zip(s4.shards, s4.offsets))
    require(views, "shard_build: the float32 shards copied the vectors")
    emit({"phase": "shard_build", "shards": SHARDS,
          "rows_per_shard": s4.shard_size, "graph_seconds": graph_s,
          "engine_seconds": time.perf_counter() - t,
          "entry_points": [int(e) for e in s4.entry_points],
          "mean_out_degree": [float(g.out_degrees().float().mean())
                              for g in sg4.shards],
          "shards_view_plain_vectors": views})

    # ---- S = 1 ≡ the plain engine (e2e contain α=1, persistent) ----
    r1 = e2e_search(s1, est, cfg, wl.queries, wl.spec, probe_budget=probe,
                    alpha=1.0, n_probes=2)
    differ = [f for f, a, b in zip(one.state._fields, one.state,
                                   r1.state.merged) if not torch.equal(a, b)]
    differ += [f"shard.{f}" for f, a, b in zip(one.state._fields, one.state,
                                               r1.state.shard)
               if not torch.equal(a, b[:, 0])]
    require(not differ, f"S=1 sharded differs from the plain engine: {differ}")
    require(np.array_equal(r1.predicted_budget, one.predicted_budget),
            "S=1 sharded: budgets differ from the plain engine")

    # ---- S = 4: the sharded search ≡ the shards alone + a flat sort ----
    w = torch.as_tensor(one.predicted_budget).to(device, torch.int32)
    direct = s4.search(cfg, wl.queries, wl.spec, w)
    sbud = ((w.long() + SHARDS - 1) // SHARDS).to(torch.int32)
    parts = [sh.search(cfg, wl.queries, wl.spec, sbud) for sh in s4.shards]
    differ = merged_differ(direct.merged, flat_merge(parts, s4.offsets))
    require(not differ, f"S=4: merged fields differ from the per-shard "
            f"searches' flat merge: {differ}")
    st = s4.search(cfg, wl.queries, wl.spec, probe)
    st = s4.search(cfg, wl.queries, wl.spec, w, state=st)
    differ = [f for f, a, b in zip(direct.merged._fields, direct.merged,
                                   st.merged) if not torch.equal(a, b)]
    require(not differ, f"S=4: probe → resume differs from direct: {differ}")
    merge_ms = median_ms(lambda: merge_shard_states(stack_shards(parts),
                                                    s4.offsets), n=5)
    emit({"phase": "shard_merge", "shards": SHARDS, "batch": EVAL_LANES,
          "budget": "the plain e2e's budgets", "merged_equal_flat_sort": True,
          "probe_resume_equal_direct": True,
          "merge_ms": merge_ms,
          "s1_equals_plain_engine_all_fields": True})

    # ---- S = 4 scan ≡ the unsharded scan ≡ the exact oracle ("mixed") ----
    mixed = plan_evals["mixed"]
    a = scan_search(eng, cfg, mixed.queries, mixed.filters)
    b = scan_search(s4, cfg, mixed.queries, mixed.filters)
    counts = scan_stats(eng, eng.compile(mixed.filters)).counts
    mgi, mgd = plan_gts["mixed"]
    require(torch.equal(a.res_idx, b.res_idx) and torch.equal(
        a.res_dist.view(torch.int32), b.res_dist.view(torch.int32)),
        "S=4 scan differs from the unsharded scan")
    require(np.array_equal(b.cnt.cpu().numpy(), counts),
            "S=4 scan: cnt is not σ·N")
    require(np.array_equal(b.res_idx.cpu().numpy(), mgi) and np.array_equal(
        b.res_dist.cpu().numpy().view(np.uint32), mgd.view(np.uint32)),
        "S=4 scan differs from filtered_knn_exact")
    emit({"phase": "shard_scan", "workload": "mixed", "shards": SHARDS,
          "equal_unsharded_scan": True, "equal_filtered_knn_exact": True,
          "cnt_equals_sigma_n": True,
          "mean_sigma_n": float(counts.mean())})

    # ---- S = 4 estimator, e2e with EXPLAIN, tracing on ≡ off ----
    t = time.perf_counter()
    wl_tr = make_label_workload(ds, batch=SHARD_TRAIN, kind="contain",
                                seed=10)
    td4 = generate_training_data(s4, sds, wl_tr, cfg, probe_budget=probe,
                                 chunk=SHARD_TRAIN, n_probes=2)
    est4 = CostEstimator.fit(td4.features, td4.w_q, n_trees=200, depth=5)
    emit({"phase": "shard_training", "shards": SHARDS,
          "queries": SHARD_TRAIN,
          "converged_frac": float(td4.converged.mean()),
          "w_q_median": float(np.median(td4.w_q)),
          "seconds": time.perf_counter() - t})

    def e2e(engine, estimator, **kw):
        return e2e_search(engine, estimator, cfg, wl.queries, wl.spec,
                          probe_budget=probe, alpha=1.0, n_probes=2, **kw)

    rows = {}
    path_counts = None
    for s, engine, estimator in ((1, s1, est), (SHARDS, s4, est4)):
        reset_counts()
        d0 = dispatch_counters()
        res, ms = wall_ms(lambda: e2e(engine, estimator))
        d1 = dispatch_counters()
        counts = read_counts()
        need = ("persistent_multi_step", "gbdt_predict", "sqdist_masked")
        require(all(counts[n] > 0 for n in need),
                f"sharded S={s}: a kernel of the path was never launched: "
                f"{counts}")
        if s == SHARDS:
            path_counts = counts
        ms = float(np.median([ms] + [wall_ms(lambda: e2e(engine,
                                                           estimator))[1]
                                     for _ in range(REPEATS - 1)]))
        bal = work_balance(res.state.shard.cnt.cpu().numpy())
        rows[s] = {"e2e_ms": ms,
                   "mean_ndc": float(res.state.cnt.float().mean()),
                   "recall@10": float(recall_at_k(
                       res.state.res_idx.cpu().numpy(), gi).mean()),
                   "k5_launches": d1["launches"] - d0["launches"],
                   "steps": d1["steps"] - d0["steps"],
                   "work_balance_mean": float(bal.mean()),
                   "work_balance_min": float(bal.min()),
                   "kernel_launches": counts}
        if s == SHARDS:
            one4 = res
    tr = Tracer()
    traced = e2e(s4, est4, tracer=tr, explain=True)
    differ = [f"{part}.{f}" for part in ("merged", "shard")
              for f, a, b in zip(one4.state.merged._fields,
                                 getattr(one4.state, part),
                                 getattr(traced.state, part))
              if not torch.equal(a, b)]
    require(not differ, f"S=4: tracing changed the state: {differ}")
    require(np.array_equal(one4.predicted_budget, traced.predicted_budget),
            "S=4: tracing changed the budgets")
    cnt = traced.state.cnt.cpu().numpy()
    hops = traced.state.hops.cpu().numpy()
    insp = traced.state.n_inspected.cpu().numpy()
    active = traced.state.active.cpu().numpy()
    for i, rep in enumerate(traced.reports):
        require(len(rep.shards) == SHARDS
                and sum(x.ndc for x in rep.shards) == cnt[i]
                and sum(x.hops for x in rep.shards) == hops[i]
                and sum(x.n_inspected for x in rep.shards) == insp[i],
                f"S=4 EXPLAIN: lane {i}'s shard sections do not add up")
    bud = traced.predicted_budget
    require(bool((cnt[active] >= bud[active]).all()),
            "S=4: an active lane's cnt is below its budget")
    spans = tr.spans(name="shard-search")
    emit({"phase": "shard_e2e", "workload": "contain", "alpha": 1.0,
          "backend": "persistent", "S1": rows[1], f"S{SHARDS}": rows[SHARDS],
          "explain_sections_add_up": True, "tracing_equal_plain": True,
          "active_lanes": int(active.sum()),
          "shard_search_spans": len(spans),
          "terminations_by_shard": [
              {t: sum(1 for r in traced.reports if r.shards[j].termination
                      == t) for t in {r.shards[j].termination
                                      for r in traced.reports}}
              for j in range(SHARDS)]})

    profile_e2e(s4, est4, wl, probe, "persistent", rows[SHARDS]["e2e_ms"],
                phase="shard_profile")

    # ---- int8: host tier ≡ device tier, no float store on the card ----
    c8 = SearchConfig(k=10, queue_size=512, backend="persistent")
    out, mem = {}, {}
    t = time.perf_counter()
    for tier in ("device", "host"):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(device)
        q8 = ShardedSearchEngine.build(ds, sg4, precision="int8", tier=tier,
                                       device=device)
        torch.cuda.synchronize()
        mem[tier] = torch.cuda.memory_allocated(device) - m0
        st8 = q8.search(c8, wl.queries, wl.spec, w)
        rr = q8.rerank(c8, wl.queries, st8)
        out[tier] = (q8, st8, rr)
    build_s = time.perf_counter() - t
    (dq, dst8, drr), (hq, hst, hrr) = out["device"], out["host"]
    require(torch.equal(drr.res_idx, hrr.res_idx) and torch.equal(
        drr.res_dist.view(torch.int32), hrr.res_dist.view(torch.int32)),
        "int8 host tier: the rerank differs from the device tier")
    store = hq.vector_store
    nd_bytes = ds.n * DIM * 4
    require(store.kind == "host" and store.pinned
            and store._host.is_pinned() and not store._host.is_cuda
            and all(sh.base_vectors.shape[1] == 0 for sh in hq.shards)
            and mem["host"] < nd_bytes <= mem["device"],
            f"int8 host tier: a float32 store on the card? {mem}")
    pool = rerank_pool(hst.cand_idx, hst.cand_valid, hst.res_idx)
    gather_ms = median_ms(lambda: store.gather(pool), n=5)
    copies = host_gather_copies(tuple(pool.shape), "cuda")
    require(bool(copies) and all("Pinned" in c for c in copies),
            f"int8 host tier: the gather's copy is not from pinned memory: "
            f"{copies}")
    emit({"phase": "shard_tier", "precision": "int8", "shards": SHARDS,
          "rerank_equal_device_tier": True,
          "device_tier_bytes_on_card": mem["device"],
          "host_tier_bytes_on_card": mem["host"],
          "store_nbytes": store.nbytes, "float_store_on_card": False,
          "pool_rows": int(pool.numel()), "gather_ms": gather_ms,
          "gather_bytes": int(pool.numel()) * DIM * 4,
          "profiler_htod": copies, "copy_from_pinned": True,
          "build_seconds": build_s})
    del out, hq, store
    torch.cuda.empty_cache()

    # ---- serving on S = 4: scheduled ≡ one-shot, shard NDC adds up ----
    sched = CostAwareScheduler(s4, est4, cfg, ServeConfig(
        lane_width=16, probe_budget=probe, n_probes=2, alpha=1.0,
        cache_capacity=0, policy="direct"))
    reqs = requests_from_workload(wl)
    reset_counts()
    wall = serve_run(sched, reqs)
    counts = read_counts()
    serve_equals_oneshot(reqs, one4, "serve sharded float32 direct")
    s = sched.summary()
    require(s["n_shards"] == SHARDS and s["shards"]["n_shards"] == SHARDS,
            f"serve sharded: n_shards {s['n_shards']}")
    require(sum(s["shards"]["ndc_by_shard"]) == sum(r.ndc for r in reqs),
            "serve sharded: per-shard NDC does not add up")
    require(all(counts[n] > 0 for n in ("persistent_multi_step",
                                          "gbdt_predict", "sqdist_masked")),
            f"serve sharded: a kernel was never launched: {counts}")
    emit({"phase": "shard_serve", "precision": "float32", "policy": "direct",
          "backend": "persistent", "shards": SHARDS,
          "workloads": ["contain"], "equals_oneshot_bitwise": True,
          "ndc_by_shard": s["shards"]["ndc_by_shard"],
          "shard_work_balance": s["shards"]["work_balance"],
          **serve_report(sched, reqs, wall), "launches": counts})
    path_counts["mesh"] = run_mesh(eng, s4, dq, est, wl, w, probe,
                                   {"float32": direct, "int8": dst8},
                                   device)
    del dq, dst8
    torch.cuda.empty_cache()
    return path_counts


MESH_SHAPES = ((1, 4), (2, 2), (4, 1))  # (data, index), cuda:0 repeated
MESH_LANES = 30    # the batch mesh's lanes: 2 pad lanes at 4 positions
BUTTERFLY_SIZES = (2, 3, 4)


def leaves_differ(a, b) -> list:
    """The per-shard and merged leaves in which two ShardedSearchStates
    differ."""
    return [f"{part}.{f}" for part in ("merged", "shard")
            for f in fields_differ(getattr(a, part), getattr(b, part))]


def check_butterfly(device) -> dict:
    """`butterfly_merge` on the card over D ∈ BUTTERFLY_SIZES positions of
    cuda:0 repeated (the XOR butterfly at 2 and 4, the gather at 3), on
    [64, 512] and [64, 10] pools with forced ties (distances from 8
    values, inf pads): every position's pool ≡ `merge_stacked` of all D
    pools, distances, payloads and positions bit for bit."""
    import torch

    from repro_torch.distributed import butterfly_merge, merge_stacked

    g = torch.Generator(device=device).manual_seed(7)
    cases = 0
    for n in BUTTERFLY_SIZES:
        for m in (512, 10):
            d = torch.randint(0, 8, (EVAL_LANES, n, m), generator=g,
                              device=device).float()
            d[torch.rand(d.shape, generator=g, device=device) < 0.1] = \
                float("inf")
            d = torch.sort(d, dim=2).values
            p = torch.randint(0, 1 << 29, d.shape, generator=g,
                              device=device, dtype=torch.int32)
            want = merge_stacked(d, p, m)
            local = [merge_stacked(d[:, i:i + 1], p[:, i:i + 1], m,
                                   shard0=i) for i in range(n)]
            for (gd, gp, go) in butterfly_merge(local, m, [device] * n):
                require(torch.equal(gd.view(torch.int32),
                                    want[0].view(torch.int32))
                        and torch.equal(gp, want[1])
                        and torch.equal(go, want[2]),
                        f"butterfly D={n} m={m}: differs from merge_stacked")
            cases += 1
    return {"sizes": list(BUTTERFLY_SIZES), "widths": [512, 10],
            "lanes": EVAL_LANES, "cases": cases,
            "equal_merge_stacked_bitwise": True}


def run_mesh(eng, s4, q8, est, wl, w, probe, loop, device):
    """The search meshes on one card (`mesh`), every mesh position on
    cuda:0 — the single-controller mesh may repeat a device, so one card
    runs every line of the mesh paths with the main path's kernels, the
    positions one after another. No new build: the sharded phases' S = 4
    engines (float32, and the int8 device tier), the plain engine and its
    estimator `est`, the contain batch at α = 1 (the plain e2e's budgets
    `w`).

    (1) `ShardedSearchEngine` on the 2-D (data, index) meshes
    MESH_SHAPES: float32 fused one shot, float32 persistent (run_search
    on each position, as in the reference) probed at ⌊w/2⌋ and resumed to
    w, int8 fused one shot — every per-shard and merged leaf ≡ the loop
    path's one shot (`loop`: the sharded phases' persistent runs at w,
    which equal fused bit for bit). (2) `e2e_search` on the (2, 2) engine
    ≡ on the loop engine: budgets, every leaf. (3) `SearchEngine` on a
    4-position batch mesh, MESH_LANES lanes (2 pad lanes) at ⌊w/4⌋, fused
    and persistent ≡ the unmeshed runs in every leaf. Kernel counts are set
    to 0 just before (1)–(3) and read just after: K1, K3, K6 and K2 must
    launch; `dispatch_counters` must not move (no launch loop under a
    mesh). (4) `check_butterfly`. Returns the mesh runs' kernel
    counts."""
    import dataclasses

    import torch

    from repro_torch.core import (SearchConfig, dispatch_counters,
                                  e2e_search, make_search_mesh)
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.sharding import canonical_device

    card = canonical_device(device)
    cfg = {b: SearchConfig(k=10, queue_size=512, backend=b)
           for b in ("fused", "persistent")}

    def grid(*shape):
        return Mesh(np.full(shape, card, dtype=object), ("data", "index"))

    def e2e(engine):
        return e2e_search(engine, est, cfg["persistent"], wl.queries,
                          wl.spec, probe_budget=probe, alpha=1.0,
                          n_probes=2)

    half = w // 2
    wlb = first_queries(wl, MESH_LANES)
    # a quarter of each lane's budget (a depth cut): the batch mesh's 4
    # positions run the per-step K1 loop one after another
    wb = w[:MESH_LANES] // 4
    # the yardsticks, outside the counted run
    t = time.perf_counter()
    plain = {b: eng.search(c, wlb.queries, wlb.spec, wb)
             for b, c in cfg.items()}
    loop_e2e, loop_ms = wall_ms(lambda: e2e(s4))
    yard_s = time.perf_counter() - t

    reset_counts()
    d0 = dispatch_counters()
    secs, runs = {}, {}
    for shape in MESH_SHAPES:
        t = time.perf_counter()
        m32 = dataclasses.replace(s4, mesh=grid(*shape))
        runs[shape, "float32 fused"] = m32.search(
            cfg["fused"], wl.queries, wl.spec, w)
        st = m32.search(cfg["persistent"], wl.queries, wl.spec, half)
        runs[shape, "float32 persistent, probe ⌊w/2⌋ → w"] = m32.search(
            cfg["persistent"], wl.queries, wl.spec, w, state=st)
        runs[shape, "int8 fused"] = dataclasses.replace(
            q8, mesh=grid(*shape)).search(cfg["fused"], wl.queries, wl.spec,
                                          w)
        torch.cuda.synchronize()
        secs[f"{shape}"] = time.perf_counter() - t
    m22 = dataclasses.replace(s4, mesh=grid(2, 2))
    mesh_e2e, mesh_ms = wall_ms(lambda: e2e(m22))
    t = time.perf_counter()
    bmesh = dataclasses.replace(eng, mesh=make_search_mesh([card] * 4))
    batch = {b: bmesh.search(c, wlb.queries, wlb.spec, wb)
             for b, c in cfg.items()}
    torch.cuda.synchronize()
    secs["batch mesh"] = time.perf_counter() - t
    counts = read_counts()
    d1 = dispatch_counters()

    for (shape, case), st in runs.items():
        differ = leaves_differ(st, loop[case.split()[0]])
        require(not differ, f"mesh {shape} {case}: leaves differ from the "
                f"loop path: {differ}")
    require(np.array_equal(mesh_e2e.predicted_budget,
                           loop_e2e.predicted_budget),
            "mesh (2, 2) e2e: budgets differ from the loop engine's")
    differ = leaves_differ(mesh_e2e.state, loop_e2e.state)
    require(not differ, f"mesh (2, 2) e2e: leaves differ: {differ}")
    for b, st in batch.items():
        differ = fields_differ(st, plain[b])
        require(not differ, f"batch mesh {b}: leaves differ from the "
                f"unmeshed run: {differ}")
    need = ("fused_step", "fused_step_int8", "sqdist_masked",
            "gbdt_predict")
    require(all(counts[n] > 0 for n in need),
            f"mesh: a kernel of the path was never launched: {counts}")
    moved = {k: d1[k] - d0[k] for k in d0 if d1[k] != d0[k]}
    require(not moved, f"mesh: dispatch_counters moved: {moved}")
    t = time.perf_counter()
    butterfly = check_butterfly(card)
    secs["butterfly"] = time.perf_counter() - t
    emit({"phase": "mesh", "nvidia_smi": smi_line(),
          "mesh_devices": str(card), "shapes": [list(s) for s in MESH_SHAPES],
          "shards": SHARDS, "lanes": EVAL_LANES, "workload": "contain",
          "alpha": 1.0, "cases": sorted({c for _, c in runs}),
          "every_leaf_equal_loop_path": True,
          "e2e_2x2": {"budgets_and_every_leaf_equal_loop": True,
                      "mesh_e2e_ms": mesh_ms, "loop_e2e_ms": loop_ms,
                      "mean_ndc": float(mesh_e2e.state.cnt.float().mean())},
          "batch_mesh": {"positions": 4, "lanes": MESH_LANES,
                         "budget": "⌊w/4⌋",
                         "pad_lanes": (-MESH_LANES) % 4,
                         "backends": sorted(batch),
                         "every_leaf_equal_unmeshed": True},
          "butterfly": butterfly, "launches": counts,
          "dispatch_counters_delta": 0, "seconds_by_part": secs,
          "yardstick_seconds": yard_s,
          "note": "one card runs the positions one after another: no "
                  "speed claim"})
    return counts


# ---------------------------------------------------------- baselines ----
BASELINE_EFS = (64, 512)  # naive beam widths; 512 = the main path's queue


def run_baselines(eng, ds, est, td, wl, gt_idx, e2e_budgets, probe):
    """The paper's §5 baselines on the float32 contain batch (α=1), backend
    persistent: naive (a static beam of width ef, unlimited budget; ef=512
    is the recall at exhaustion of the main path's queue), a fixed budget
    (the e2e batch's mean), LAET (an estimator fitted on the training
    features with the filter group ablated) and the oracle (each lane
    stopped at its own W_q, from `generate_training_data` on the batch):
    recall@10 and mean NDC each."""
    import torch

    from repro_torch.core import (CostEstimator, SearchConfig,
                                  ablate_filter_features, baselines,
                                  generate_training_data)
    from repro_torch.index.bruteforce import recall_at_k

    cfg = SearchConfig(k=10, queue_size=512, backend="persistent")
    q, spec = wl.queries, wl.spec

    def row(state, ms):
        idx = state.res_idx.cpu().numpy()
        require(idx.shape == (EVAL_LANES, 10), "baseline result shape")
        return {"recall@10": float(recall_at_k(idx, gt_idx).mean()),
                "mean_ndc": float(state.cnt.float().mean()), "ms": ms}

    out = {}
    for ef in BASELINE_EFS:
        st, ms = wall_ms(lambda: baselines.naive_search(eng, cfg, q, spec,
                                                        ef))
        out[f"naive_ef{ef}"] = row(st, ms)
    budget = int(np.mean(e2e_budgets))
    st, ms = wall_ms(lambda: baselines.fixed_budget_search(eng, cfg, q, spec,
                                                           budget))
    out["fixed_budget"] = {**row(st, ms), "budget": budget}
    t = time.perf_counter()
    est_nf = CostEstimator.fit(
        ablate_filter_features(torch.from_numpy(td.features)).numpy(),
        td.w_q, n_trees=200, depth=5)
    fit_s = time.perf_counter() - t
    res, ms = wall_ms(lambda: baselines.laet_search(
        eng, est_nf, cfg, q, spec, probe_budget=probe))
    out["laet"] = {**row(res.state, ms), "fit_seconds": fit_s,
                   "mean_budget": float(res.predicted_budget.mean())}
    t = time.perf_counter()
    td_eval = generate_training_data(eng, ds, wl, cfg, probe_budget=probe,
                                     chunk=EVAL_LANES, n_probes=2)
    label_s = time.perf_counter() - t
    st, ms = wall_ms(lambda: baselines.oracle_search(eng, cfg, q, spec,
                                                     td_eval.w_q))
    require(np.array_equal(td_eval.gt_idx, gt_idx),
            "the oracle's labels use another ground truth")
    out["oracle"] = {**row(st, ms), "label_seconds": label_s,
                     "converged_frac": float(td_eval.converged.mean())}
    emit({"phase": "baselines", "workload": "contain", "alpha": 1.0,
          "backend": "persistent", "batch": EVAL_LANES, **out,
          "recall_at_exhaustion": out["naive_ef512"]["recall@10"]})


# ------------------------------------------------------------ planner ----
PLAN_TRAIN = 256    # "mixed" planner training queries, 4 chunks of 64
PLAN_CHUNK = 64


def plan_cfg(backend: str, **kw):
    from repro_torch.core import SearchConfig

    return SearchConfig(k=10, queue_size=512, two_hop_stride=8,
                        backend=backend, **kw)


def fields_differ(a, b) -> list:
    import torch

    return [f for f, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]


def same_lanes(a, b) -> float:
    """Share of lanes with equal top-10 ids and NDC."""
    return float(((a.res_idx == b.res_idx).all(dim=1)
                  & (a.cnt == b.cnt)).float().mean())


def time_scan_kernel(eng, wl, stats):
    """K6's row-id variant on this batch's scan inputs (the planner's scan
    shape): held against its plain version on them (+inf exactly where
    masked, values within rtol 1e-5; the max abs error and whether they are
    bitwise equal), device and call ms, the plain version's, and the bound
    — each distinct passing row of the store read once (lanes share rows)
    plus ids, mask, query and output, or 4·d flops per (lane, passing row)
    pair, whichever is larger."""
    import torch

    from repro_torch.core.plans import scan_rows
    from repro_torch.kernels.distance import sqdist_rows, sqdist_rows_plain

    idx, mask = scan_rows(stats)
    q = torch.from_numpy(wl.queries).to(eng.device)
    base = eng.base_vectors
    b, v = idx.shape
    d = base.shape[1]
    rows = int(mask.sum())
    distinct = int(torch.unique(idx[mask]).numel())
    got = sqdist_rows(q, base, idx, mask)
    want = sqdist_rows_plain(q, base, idx, mask)
    require(torch.equal(torch.isinf(got), ~mask)
            and torch.equal(torch.isinf(want), ~mask),
            "K6 rows (planner scan): +inf pattern is not the mask's "
            "complement")
    err = float((got[mask] - want[mask]).abs().max())
    require(torch.allclose(got[mask], want[mask], rtol=1e-5, atol=0.0),
            f"K6 rows (planner scan): beyond rtol 1e-5 (max abs err {err})")
    bitwise = torch.equal(got, want)
    del got, want
    nbytes = 4 * b * d + 9 * b * v + 4 * distinct * d  # ids, mask, out
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * rows * d / FP32_FLOP_PER_S
    out = dict(max_abs_err=err, bitwise_equal_plain=bitwise,
               ms=device_ms(lambda: sqdist_rows(q, base, idx, mask), iters=5),
               plain_ms=device_ms(lambda: sqdist_rows_plain(q, base, idx,
                                                            mask), iters=2),
               call_ms=time_cuda(lambda: sqdist_rows(q, base, idx, mask),
                                 iters=5, warmup=1),
               plain_call_ms=time_cuda(lambda: sqdist_rows_plain(
                   q, base, idx, mask), iters=2, warmup=1),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out, dict(B=b, V=v, d=d, passing_rows=rows,
                     distinct_rows=distinct, bytes=nbytes)


def run_planner(ds, eng, est, probe, device):
    """The planning path on the float32 engine: composite workloads, the
    planner's training (oracle on K6's row-id variant, a shared probe and
    two exhaustion resumes, persistent backend), forced plans against
    run_plan, and planned_search end to end on an "and" and a "mixed"
    batch with the fused and persistent backends. Returns the launch
    counts of the planner path, the row-id kernel's measurements, and the
    two evaluation workloads with their exact ground truth."""
    import torch

    from repro_torch.core import (PLANS, fit_planner,
                                  generate_plan_training_data, planned_search,
                                  run_plan, scan_stats)
    from repro_torch.core.planner import PLAN_SCAN, PLAN_WIDEN
    from repro_torch.data.synthetic import make_composite_workload
    from repro_torch.index.bruteforce import filtered_knn_exact, recall_at_k

    t = time.perf_counter()
    wl_train = make_composite_workload(ds, batch=PLAN_TRAIN,
                                       structure="mixed", seed=10)
    evals = {"and": make_composite_workload(ds, batch=EVAL_LANES,
                                            structure="and", seed=21),
             "mixed": make_composite_workload(ds, batch=EVAL_LANES,
                                              structure="mixed", seed=22)}
    emit({"phase": "plan_workloads", "seconds": time.perf_counter() - t,
          "train_queries": PLAN_TRAIN,
          "sigma": {name: {"min": float(wl.sigma_global.min()),
                           "median": float(np.median(wl.sigma_global)),
                           "max": float(wl.sigma_global.max())}
                    for name, wl in evals.items()}})
    t = time.perf_counter()
    gts = {name: filtered_knn_exact(wl.queries, eng.base_vectors, wl.exprs,
                                    ds.labels_packed, ds.value_matrix, 10,
                                    device=device)
           for name, wl in evals.items()}
    emit({"phase": "plan_ground_truth", "seconds": time.perf_counter() - t,
          "queries": 2 * EVAL_LANES})

    # ---- training: one probe, two exhaustion resumes per query ----
    secs = {}
    t = time.perf_counter()
    data = generate_plan_training_data(
        eng, ds, wl_train, plan_cfg("persistent"), probe_budget=probe,
        chunk=PLAN_CHUNK, n_probes=2, seconds=secs)
    label_s = time.perf_counter() - t
    t = time.perf_counter()
    planner = fit_planner(data, probe_budget=probe)
    emit({"phase": "plan_training", "label_seconds": label_s,
          "stage_seconds": secs, "fit_seconds": time.perf_counter() - t,
          "queries": int(data.w_traverse.shape[0]),
          "converged_t": float(data.converged_t.mean()),
          "converged_w": float(data.converged_w.mean()),
          "w_traverse_median": float(np.median(data.w_traverse)),
          "w_widen_median": float(np.median(data.w_widen)),
          "sigma_median": float(np.median(data.sigma))})

    # ---- forced plans ("mixed" batch): planned_search ≡ run_plan ----
    wl = evals["mixed"]
    gi, gd = gts["mixed"]
    kw = dict(probe_budget=probe, n_probes=2)
    reset_counts()
    forced = {}
    for p in PLANS:
        f = planned_search(eng, planner, plan_cfg("fused"), wl.queries,
                           wl.exprs, force_plan=p, **kw)
        direct = run_plan(eng, planner, p, plan_cfg("fused"), wl.queries,
                          wl.exprs, **kw)
        differ = fields_differ(f.state, direct)
        require(not differ, f"planned_search(force_plan={p!r}) differs "
                f"from run_plan in {differ}")
        forced[p] = f.state
    forced_counts = read_counts()
    need = ("sqdist_rows", "fused_step", "gbdt_predict")
    require(all(forced_counts[n] > 0 for n in need),
            f"forced plans: a kernel of the path was never launched: "
            f"{forced_counts}")
    # widen on the persistent backend: the probe is post mode (K5), the
    # widen resume steps K1 at R'=160, so K1's count is its wide launches
    reset_counts()
    widen_p = run_plan(eng, planner, "widen", plan_cfg("persistent"),
                       wl.queries, wl.exprs, **kw)
    widen_counts = read_counts()
    differ = fields_differ(widen_p, forced["widen"])
    require(not differ, f"widen on persistent differs from fused: {differ}")
    need = ("persistent_multi_step", "fused_step", "gbdt_predict")
    require(all(widen_counts[n] > 0 for n in need),
            f"widen on persistent: a kernel of the path was never launched: "
            f"{widen_counts}")
    scan = forced["scan"]
    s_idx, s_dist = scan.res_idx.cpu().numpy(), scan.res_dist.cpu().numpy()
    require(np.array_equal(s_idx, gi)
            and np.array_equal(s_dist.view(np.uint32), gd.view(np.uint32)),
            "the float32 scan differs from filtered_knn_exact")
    scan_rec = float(recall_at_k(s_idx, gi).mean())
    require(scan_rec == 1.0, f"scan recall {scan_rec}")
    stats = scan_stats(eng, eng.compile(wl.exprs))
    k6r, k6r_shape = time_scan_kernel(eng, wl, stats)
    emit({"phase": "plan_forced", "workload": "mixed", "batch": EVAL_LANES,
          "forced_equals_run_plan": {p: True for p in PLANS},
          "widen_persistent_equals_fused": True,
          "scan_equals_oracle_bitwise": True, "scan_recall@10": scan_rec,
          "recall@10": {p: float(recall_at_k(st.res_idx.cpu().numpy(),
                                             gi).mean())
                        for p, st in forced.items()},
          "mean_ndc": {p: float(st.cnt.float().mean())
                       for p, st in forced.items()},
          "launches": {"forced_fused": forced_counts,
                       "widen_persistent": widen_counts},
          "k6_rows": {**k6r_shape, **k6r}})

    # ---- planned_search end to end ----
    plan_counts, e2e_rows = {}, []
    for name, wl in evals.items():
        gi = gts[name][0]
        res, ms = {}, {}
        for backend in ("fused", "persistent"):
            reset_counts()
            res[backend], first = wall_ms(lambda: planned_search(
                eng, planner, plan_cfg(backend), wl.queries, wl.exprs, **kw))
            plan_counts[(name, backend)] = read_counts()
            ms[backend] = float(np.median([first, *(
                wall_ms(lambda: planned_search(
                    eng, planner, plan_cfg(backend), wl.queries, wl.exprs,
                    **kw))[1] for _ in range(REPEATS - 1))]))
        fr, pr = res["fused"], res["persistent"]
        differ = fields_differ(pr.state, fr.state)
        require(not differ, f"planned {name}: persistent differs from fused "
                f"in {differ}")
        require(np.array_equal(pr.plan, fr.plan), f"planned {name}: plans "
                "differ between backends")
        scanned = bool((fr.plan == PLAN_SCAN).any())
        widened = bool((fr.plan == PLAN_WIDEN).any())
        for backend, need in (("fused", ("fused_step", "gbdt_predict")),
                              ("persistent", ("persistent_multi_step",
                                              "gbdt_predict"))):
            need = need + (("sqdist_rows",) if scanned else ()) + (
                ("fused_step",) if widened else ())
            c = plan_counts[(name, backend)]
            require(all(c[n] > 0 for n in need),
                    f"planned {name} {backend}: a kernel of the path was "
                    f"never launched: {c}")
        # widen and pre traversal: fused (K1 at R'=160) against dense
        wf = run_plan(eng, planner, "widen", plan_cfg("fused"), wl.queries,
                      wl.exprs, **kw)
        wd = run_plan(eng, planner, "widen", plan_cfg("dense"), wl.queries,
                      wl.exprs, **kw)
        widen_same = same_lanes(wf, wd)
        require(widen_same >= 0.95, f"widen {name}: only {widen_same} of "
                "lanes identical between fused and dense")
        row = {"phase": "plan_e2e", "workload": name, "batch": EVAL_LANES,
               "plan_share": {p: float((fr.plan == i).mean())
                              for i, p in enumerate(PLANS)},
               "stage0_share": float(fr.pre_probe.mean()),
               "recall@10": float(recall_at_k(fr.state.res_idx.cpu().numpy(),
                                              gi).mean()),
               "mean_ndc": float(fr.state.cnt.float().mean()),
               "e2e_ms": ms, "persistent_fields_equal_fused": True,
               "widen_fused_vs_dense_identical_frac": widen_same,
               "widen_recall@10": float(recall_at_k(
                   wf.res_idx.cpu().numpy(), gi).mean()),
               "launches": {b: plan_counts[(name, b)]
                            for b in ("fused", "persistent")}}
        if name == "and":
            pf = run_plan(eng, planner, "traverse", plan_cfg("fused",
                                                             mode="pre"),
                          wl.queries, wl.exprs, **kw)
            pd = run_plan(eng, planner, "traverse", plan_cfg("dense",
                                                             mode="pre"),
                          wl.queries, wl.exprs, **kw)
            pre_same = same_lanes(pf, pd)
            require(pre_same >= 0.95, f"pre {name}: only {pre_same} of "
                    "lanes identical between fused and dense")
            row.update(pre_fused_vs_dense_identical_frac=pre_same,
                       pre_recall=float(recall_at_k(
                           pf.res_idx.cpu().numpy(), gi).mean()),
                       pre_mean_ndc=float(pf.cnt.float().mean()))
        emit(row)
        e2e_rows.append(row)
        planned_persistent = pr
    profile_planned(eng, planner, evals["mixed"], probe,
                    e2e_rows[-1]["e2e_ms"]["persistent"])
    run_obs_planned(eng, planner, evals["mixed"], probe)
    auto_counts = run_serve_auto(eng, est, planner, evals["mixed"],
                                 planned_persistent, probe)
    main_counts = plan_counts[("mixed", "fused")]
    # the widen resume is where R'=160 steps run (K3 / K4 on the quantized
    # engines: `run_plan_quant`)
    return ({"fused_step_wide": widen_counts["fused_step"],
             "sqdist_rows": main_counts["sqdist_rows"],
             "topm_merge": main_counts["topm_merge"],
             "serve:auto": auto_counts}, k6r, evals, gts)


def profile_planned(eng, planner, wl, probe, wall_unprofiled_ms):
    """Where one planned_search batch (persistent backend) spends its
    time: device-busy ms, idle share against the unprofiled median, kernel
    launches per lockstep step, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dispatch_counters, planned_search

    torch.cuda.synchronize()
    u0 = FOREST_UPLOADS[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        d0 = dispatch_counters()
        t = time.perf_counter()
        res = planned_search(eng, planner, plan_cfg("persistent"),
                             wl.queries, wl.exprs, probe_budget=probe)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        d1 = dispatch_counters()
    uploads = FOREST_UPLOADS[0] - u0
    require(uploads == 0, f"a planned batch uploaded {uploads} forests")
    evs = _kernel_events(prof)
    busy = sum(us for _, us in evs) / 1e3
    launches = sum(e.count for e, _ in evs)
    steps = d1["steps"] - d0["steps"]
    top = sorted(evs, key=lambda x: x[1], reverse=True)[:10]
    emit({"phase": "profile", "path": "planned_search",
          "backend": "persistent", "precision": eng.precision,
          "workload": "mixed",
          "wall_ms_profiled": wall, "wall_ms": wall_unprofiled_ms,
          "plan_share": {p: float((res.plan == i).mean())
                         for i, p in enumerate(("scan", "traverse",
                                                "widen"))},
          "device_busy_ms": busy if evs else "not measured",
          "device_idle_share": ((1.0 - busy / wall_unprofiled_ms) if evs
                                else "not measured"),
          "kernel_launches": launches, "lockstep_steps": steps,
          "kernel_launches_per_step": launches / max(steps, 1),
          "htod_copies": sum(e.count for e, _ in evs if "HtoD" in e.key),
          "forest_uploads": uploads,
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "device_ms": us / 1e3} for e, us in top]})


QUANT_TRAIN = 128  # training queries of each codec's estimator
PLAIN_LABELS = 128  # training queries labelled again on the plain path


def first_queries(wl, n: int):
    """The first n queries of a single-kind workload."""
    import dataclasses

    return dataclasses.replace(wl, queries=wl.queries[:n],
                               spec=wl.filter_slice(0, n),
                               sigma_global=wl.sigma_global[:n],
                               hardness=wl.hardness[:n])


def run_quant(ds, graph, wl_train, evals, gts, probe, device, plan_evals,
              plan_gts, k5_ms):
    """The quantized engines on the same dataset and graph: per codec,
    build (train + encode on the card), training labels with the
    compressed convergence target on the first QUANT_TRAIN training
    queries, the estimator, and e2e_search with the
    terminal exact rerank on contain and range at α=1, backends fused
    (K3 / K4 + K2, the path's launches counted), persistent (K5's codec
    branch + K2, counted) and dense (plain); then the planner on the same
    engine (`run_plan_quant`). Returns the launch counts."""
    import torch

    from repro_torch.core import (CostEstimator, SearchConfig, SearchEngine,
                                  dispatch_counters, e2e_search,
                                  generate_training_data)
    from repro_torch.index.bruteforce import recall_at_k
    from repro_torch.quant import index_nbytes, store_ratio

    cells = [(name, 1.0) for name in evals]
    launches = {}
    wl_train = first_queries(wl_train, QUANT_TRAIN)
    for precision in ("int8", "pq"):
        t = time.perf_counter()
        qeng = SearchEngine.build(ds, graph, device=device,
                                  precision=precision)
        torch.cuda.synchronize()
        emit({"phase": "quant_build", "precision": precision,
              "seconds": time.perf_counter() - t,
              "codes": list(qeng.quant.codes.shape),
              "codes_dtype": str(qeng.quant.codes.dtype),
              "index_nbytes": index_nbytes(qeng.quant),
              "store_ratio": store_ratio(qeng.quant, qeng.base_vectors),
              "codec_key": qeng.codec_key()})

        t = time.perf_counter()
        td = generate_training_data(
            qeng, ds, wl_train,
            SearchConfig(k=10, queue_size=512, backend="persistent"),
            probe_budget=probe, chunk=128, n_probes=2)
        label_s = time.perf_counter() - t
        est = CostEstimator.fit(td.features, td.w_q, n_trees=200, depth=5)
        emit({"phase": "quant_training", "precision": precision,
              "label_seconds": label_s,
              "fit_seconds": time.perf_counter() - t - label_s,
              "queries": int(td.w_q.shape[0]),
              "converged_frac": float(td.converged.mean()),
              "w_q_median": float(np.median(td.w_q)),
              **quant_convergence_check(qeng, ds, wl_train, td, probe,
                                        chunk=128)})

        def call(backend: str, key):
            wl = evals[key[0]]
            return e2e_search(
                qeng, est, SearchConfig(k=10, queue_size=512,
                                        backend=backend),
                wl.queries, wl.spec, probe_budget=probe, alpha=key[1],
                n_probes=2)

        def run(backend: str):
            """One call per cell: (result, wall ms, dispatch deltas)."""
            out = {}
            for key in cells:
                d0 = dispatch_counters()
                res, ms = wall_ms(lambda: call(backend, key))
                d1 = dispatch_counters()
                out[key] = (res, ms, {k: d1[k] - d0[k] for k in d0})
            return out

        def drive(backend: str, need):
            """Counts set to 0 just before the path, read just after; each
            of its kernels must launch."""
            reset_counts()
            out = run(backend)
            counts = read_counts()
            require(all(counts[n] > 0 for n in need),
                    f"quant {precision} {backend}: a kernel of the path was "
                    f"never launched: {counts}")
            return out, counts

        def median_e2e_ms(backend: str, key, first: float) -> float:
            return float(np.median([first, *(
                wall_ms(lambda: call(backend, key))[1]
                for _ in range(REPEATS - 1))]))

        fused, f_counts = drive("fused", (f"fused_step_{precision}",
                                          "gbdt_predict"))
        pers, p_counts = drive("persistent",
                               (f"persistent_multi_step_{precision}",
                                "gbdt_predict"))
        dense = run("dense")
        launches[f"fused_step_{precision}"] = f_counts[
            f"fused_step_{precision}"]
        launches[f"persistent_multi_step_{precision}"] = p_counts[
            f"persistent_multi_step_{precision}"]
        # under a codec K6 scores the rerank, K6q rows the entry distance
        launches[f"k6_paths:{precision}"] = {
            f"persistent {precision} (2 batches)": p_counts["sqdist_masked"],
            f"entry: persistent {precision} (2 batches)": p_counts[
                f"sqdist_rows_quant_{precision}"]}
        pers_ms = {}
        for key in cells:
            name, alpha = key
            (fr, fms, _), (pr, pms, disp), (dr, dms, _) = (
                fused[key], pers[key], dense[key])
            fms = median_e2e_ms("fused", key, fms)
            pms = median_e2e_ms("persistent", key, pms)
            # the plain yardstick's ms: its one checked call's
            gi = gts[name][0]
            f_idx = fr.state.res_idx.cpu().numpy()
            d_idx = dr.state.res_idx.cpu().numpy()
            f_cnt, d_cnt = fr.state.cnt.cpu().numpy(), dr.state.cnt.cpu().numpy()
            f_dist = fr.state.res_dist.cpu().numpy()
            require(f_idx.shape == (EVAL_LANES, 10), "result shape")
            require(not np.isnan(f_dist).any(), "NaN result distance")
            f_rec = float(recall_at_k(f_idx, gi).mean())
            d_rec = float(recall_at_k(d_idx, gi).mean())
            p_rec = float(recall_at_k(pr.state.res_idx.cpu().numpy(),
                                      gi).mean())
            same = float(((f_idx == d_idx).all(axis=1)
                          & (f_cnt == d_cnt)).mean())
            # persistent vs fused: every field bitwise, the float ones
            # included (K3/K4 and K5 share their distance code, and K5
            # replays make_step's q_err_sum tree)
            differ = [f for f, a, b_ in zip(pr.state._fields, pr.state,
                                            fr.state) if not torch.equal(a, b_)]
            require(not differ, f"quant {precision} {name}: persistent "
                    f"fields differ from fused: {differ}")
            require(np.array_equal(pr.predicted_budget, fr.predicted_budget),
                    f"quant {precision} {name}: budgets differ from fused")
            pers_ms[key] = pms
            emit({"phase": "e2e_quant", "precision": precision,
                  "workload": name, "alpha": alpha,
                  "fused": {"recall@10": f_rec,
                            "mean_ndc": float(f_cnt.mean()), "e2e_ms": fms,
                            "mean_budget": float(fr.predicted_budget.mean())},
                  "dense": {"recall@10": d_rec,
                            "mean_ndc": float(d_cnt.mean()), "e2e_ms": dms,
                            "timed_calls": 1},
                  "persistent": {"recall@10": p_rec, "e2e_ms": pms,
                                 "launches": disp["launches"],
                                 "compactions": disp["compactions"],
                                 "steps": disp["steps"]},
                  "identical_top10_and_ndc_frac": same,
                  "persistent_fields_equal_fused": True})
            require(abs(f_rec - d_rec) <= 0.01,
                    f"quant {precision} {name}: fused recall {f_rec} vs "
                    f"dense {d_rec}")
            require(same >= 0.95, f"quant {precision} {name}: only "
                    f"{same:.3f} of lanes identical to dense")
            require(0.0 < f_rec <= 1.0 and (f_cnt > 1).all(),
                    f"quant {precision} {name}: recall {f_rec}, min NDC "
                    f"{f_cnt.min()}")
        emit({"phase": "quant_path", "precision": precision,
              "query_batches": len(cells), "batch": EVAL_LANES,
              "launches": {"fused": f_counts, "persistent": p_counts}})
        profile_e2e(qeng, est, evals["contain"], probe, "persistent",
                    pers_ms[cells[0]])
        if precision == "pq":
            launches["serve:pq"], _ = run_serve(
                qeng, est, {"contain": (evals["contain"],
                                        pers[("contain", 1.0)][0])},
                probe, precision, ("direct",), k5_ms[precision],
                (f"persistent_multi_step_{precision}", "gbdt_predict"))
            run_serve_narrow(qeng, est, evals["contain"],
                             pers[("contain", 1.0)][0], probe)
        del fused, pers, dense
        launches.update(run_plan_quant(ds, qeng, precision, probe,
                                       plan_evals, plan_gts))
        del qeng
        torch.cuda.empty_cache()
    return launches


PLAN_TRAIN_QUANT = 128  # "mixed" planner training queries per codec


def run_plan_quant(ds, qeng, precision, probe, evals, gts):
    """The planner on a quantized engine (int8: K3, PQ: K4 at R'=160 in
    pre and widen; K6q rows for the scan): trained on PLAN_TRAIN_QUANT
    "mixed" queries with the compressed convergence target; forced plans
    against `run_plan` (scan, traverse, widen; fused) and widen on
    persistent against fused; `planned_search` on the "and" and "mixed"
    batches with the fused and persistent backends (every field equal),
    recall@10 after the rerank against the exact oracle; on each batch's
    scan lanes, `scan_search` alone ≡ `compressed_filtered_topk` bit for
    bit with cnt = σ·N; a `mode="pre"` traverse cell on "and" (persistent
    ≡ fused); a profile of the planned "mixed" batch. Returns the K3/K4
    launches at R'=160 (forced widen, persistent) and K6q's in the main
    path's run (the planned "mixed" batch, fused), which must be > 0."""
    import torch

    from repro_torch.core import (PLANS, fit_planner,
                                  generate_plan_training_data, planned_search,
                                  run_plan, scan_search, scan_stats)
    from repro_torch.core.planner import PLAN_SCAN, PLAN_WIDEN
    from repro_torch.data.synthetic import make_composite_workload
    from repro_torch.index.bruteforce import recall_at_k, valid_mask
    from repro_torch.quant import compressed_filtered_topk, index_nbytes

    head, qrows = f"fused_step_{precision}", f"sqdist_rows_quant_{precision}"
    wl_train = make_composite_workload(ds, batch=PLAN_TRAIN_QUANT,
                                       structure="mixed", seed=10)
    secs = {}
    t = time.perf_counter()
    data = generate_plan_training_data(
        qeng, ds, wl_train, plan_cfg("persistent"), probe_budget=probe,
        chunk=PLAN_CHUNK, n_probes=2, seconds=secs)
    label_s = time.perf_counter() - t
    t = time.perf_counter()
    planner = fit_planner(data, probe_budget=probe)
    emit({"phase": "plan_quant_training", "precision": precision,
          "label_seconds": label_s, "stage_seconds": secs,
          "fit_seconds": time.perf_counter() - t,
          "queries": int(data.w_traverse.shape[0]),
          "converged_t": float(data.converged_t.mean()),
          "converged_w": float(data.converged_w.mean()),
          "w_traverse_median": float(np.median(data.w_traverse)),
          "w_widen_median": float(np.median(data.w_widen)),
          "sigma_median": float(np.median(data.sigma))})

    # ---- forced plans ("mixed" batch): planned_search ≡ run_plan ----
    kw = dict(probe_budget=probe, n_probes=2)
    wl = evals["mixed"]
    reset_counts()
    forced = {}
    for p in PLANS:
        f = planned_search(qeng, planner, plan_cfg("fused"), wl.queries,
                           wl.exprs, force_plan=p, **kw)
        direct = run_plan(qeng, planner, p, plan_cfg("fused"), wl.queries,
                          wl.exprs, **kw)
        differ = fields_differ(f.state, direct)
        require(not differ, f"quant {precision}: planned_search(force_plan="
                f"{p!r}) differs from run_plan in {differ}")
        forced[p] = f.state
    forced_counts = read_counts()
    require(all(forced_counts[n] > 0 for n in (qrows, head, "gbdt_predict")),
            f"quant {precision} forced plans: a kernel of the path was never "
            f"launched: {forced_counts}")
    reset_counts()
    widen_p = run_plan(qeng, planner, "widen", plan_cfg("persistent"),
                       wl.queries, wl.exprs, **kw)
    widen_counts = read_counts()
    differ = fields_differ(widen_p, forced["widen"])
    require(not differ, f"quant {precision}: widen on persistent differs "
            f"from fused: {differ}")
    require(all(widen_counts[n] > 0 for n in (
        f"persistent_multi_step_{precision}", head, "gbdt_predict")),
            f"quant {precision} widen on persistent: a kernel of the path "
            f"was never launched: {widen_counts}")
    gi = gts["mixed"][0]
    emit({"phase": "plan_quant_forced", "precision": precision,
          "workload": "mixed", "batch": EVAL_LANES,
          "forced_equals_run_plan": {p: True for p in PLANS},
          "widen_persistent_equals_fused": True,
          "recall@10": {p: float(recall_at_k(st.res_idx.cpu().numpy(),
                                             gi).mean())
                        for p, st in forced.items()},
          "mean_ndc": {p: float(st.cnt.float().mean())
                       for p, st in forced.items()},
          "wide_launches": {"widen_persistent": widen_counts[head]},
          "launches": {"forced_fused": forced_counts,
                       "widen_persistent": widen_counts}})

    # ---- planned_search end to end ----
    plan_counts, plan_ms, scanned_lanes = {}, {}, 0
    for name, wl in evals.items():
        gi = gts[name][0]
        res, ms = {}, {}
        for backend in ("fused", "persistent"):
            reset_counts()
            res[backend], first = wall_ms(lambda: planned_search(
                qeng, planner, plan_cfg(backend), wl.queries, wl.exprs,
                **kw))
            plan_counts[(name, backend)] = read_counts()
            ms[backend] = float(np.median([first, *(
                wall_ms(lambda: planned_search(
                    qeng, planner, plan_cfg(backend), wl.queries, wl.exprs,
                    **kw))[1] for _ in range(REPEATS - 1))]))
        plan_ms[name] = ms["persistent"]
        fr, pr = res["fused"], res["persistent"]
        differ = fields_differ(pr.state, fr.state)
        require(not differ, f"quant {precision} planned {name}: persistent "
                f"differs from fused in {differ}")
        require(np.array_equal(pr.plan, fr.plan),
                f"quant {precision} planned {name}: plans differ")
        lanes = np.flatnonzero(fr.plan == PLAN_SCAN)
        widened = bool((fr.plan == PLAN_WIDEN).any())
        for backend, need in (("fused", (head, "gbdt_predict")),
                              ("persistent", (
                                  f"persistent_multi_step_{precision}",
                                  "gbdt_predict"))):
            need = need + ((qrows,) if lanes.size else ()) + (
                (head,) if widened else ())
            c = plan_counts[(name, backend)]
            require(all(c[n] > 0 for n in need),
                    f"quant {precision} planned {name} {backend}: a kernel "
                    f"of the path was never launched: {c}")
        scan_check = {}
        if lanes.size:
            # the scan lanes alone, before any rerank: the compressed oracle
            exprs = [wl.exprs[i] for i in lanes]
            direct = scan_search(qeng, plan_cfg("fused"), wl.queries[lanes],
                                 exprs)
            stats = scan_stats(qeng, qeng.compile(exprs))
            ok = valid_mask(exprs, ds.labels_packed, ds.value_matrix)
            od, oi = compressed_filtered_topk(precision, qeng.quant,
                                              wl.queries[lanes], ok, 10)
            require(np.array_equal(direct.res_idx.cpu().numpy(), oi)
                    and np.array_equal(
                        direct.res_dist.cpu().numpy().view(np.uint32),
                        od.view(np.uint32)),
                    f"quant {precision} {name}: the scan differs from "
                    "compressed_filtered_topk")
            require(np.array_equal(direct.cnt.cpu().numpy(), stats.counts),
                    f"quant {precision} {name}: scan cnt is not σ·N")
            scanned_lanes += int(lanes.size)
            scan_check = {"scan_lanes": int(lanes.size),
                          "scan_equals_compressed_oracle_bitwise": True,
                          "scan_cnt_equals_sigma_n": True}
        row = {"phase": "plan_quant_e2e", "precision": precision,
               "workload": name, "batch": EVAL_LANES,
               "plan_share": {p: float((fr.plan == i).mean())
                              for i, p in enumerate(PLANS)},
               "stage0_share": float(fr.pre_probe.mean()),
               "recall@10": float(recall_at_k(fr.state.res_idx.cpu().numpy(),
                                              gi).mean()),
               "mean_ndc": float(fr.state.cnt.float().mean()),
               "index_nbytes": index_nbytes(qeng.quant),
               "e2e_ms": ms, "persistent_fields_equal_fused": True,
               **scan_check,
               "wide_launches": plan_counts[(name, "persistent")][head],
               "launches": {b: plan_counts[(name, b)]
                            for b in ("fused", "persistent")}}
        if name == "and":
            reset_counts()
            pp = run_plan(qeng, planner, "traverse",
                          plan_cfg("persistent", mode="pre"), wl.queries,
                          wl.exprs, **kw)
            pre_counts = read_counts()
            pf = run_plan(qeng, planner, "traverse",
                          plan_cfg("fused", mode="pre"), wl.queries,
                          wl.exprs, **kw)
            differ = fields_differ(pp, pf)
            require(not differ, f"quant {precision} pre: persistent differs "
                    f"from fused in {differ}")
            require(pre_counts[head] > 0, f"quant {precision} pre: "
                    f"{head} never launched at R'=160: {pre_counts}")
            row.update(pre_recall=float(recall_at_k(
                           pp.res_idx.cpu().numpy(), gi).mean()),
                       pre_mean_ndc=float(pp.cnt.float().mean()),
                       pre_persistent_equals_fused=True,
                       pre_wide_launches=pre_counts[head])
        emit(row)
    require(scanned_lanes > 0, f"quant {precision}: no planned batch had a "
            "scan lane")
    main = plan_counts[("mixed", "fused")]
    require(main[qrows] > 0, f"quant {precision} planned mixed: {qrows} "
            f"never launched: {main}")
    profile_planned(qeng, planner, evals["mixed"], probe,
                    plan_ms["mixed"])
    del planner, data
    torch.cuda.empty_cache()
    # the main path's run, as the float32 rows report it: one planned
    # "mixed" batch on the fused backend
    return {f"{head}_wide": widen_counts[head], qrows: main[qrows]}


def quant_convergence_check(eng, ds, wl, td, probe, chunk):
    """On the first training chunk of a quantized engine: re-run the probe
    and the exhaustive resume (persistent backend) against the compressed
    target, then the rerank. Lanes whose top-10 ids equal the compressed
    top-10 (recall 10/10 before the rerank) beside those whose reranked
    top-10 equal the exact one."""
    import torch

    from repro_torch.core import SearchConfig, probe_and_features
    from repro_torch.core.engine import BIG_BUDGET
    from repro_torch.index.bruteforce import recall_at_k, valid_mask
    from repro_torch.quant import compressed_filtered_topk

    c = SearchConfig(k=10, queue_size=512, backend="persistent")
    n = min(chunk, wl.batch)
    q = wl.queries[:n]
    filt = wl.filter_slice(0, n)
    ok = valid_mask(filt, ds.labels_packed, ds.value_matrix)
    conv_dist, conv_idx = compressed_filtered_topk(eng.precision, eng.quant,
                                                   q, ok, 10)
    conv_dev = torch.from_numpy(conv_dist).to(eng.device)
    prog = eng.compile(filt)
    st, _ = probe_and_features(eng, c, q, prog, probe, 2, gt_dist=conv_dev)
    st = eng.search(c, q, prog, BIG_BUDGET, state=st, gt_dist=conv_dev)
    conv = st.conv_cnt.cpu().numpy() > 0
    require(np.array_equal(conv, td.converged[:n]),
            "re-run quantized training lanes converge differently")
    comp_full = recall_at_k(st.res_idx.cpu().numpy(), conv_idx) == 1.0
    rr = eng.rerank(c, q, st)
    rec = recall_at_k(rr.res_idx.cpu().numpy(), td.gt_idx[:n])
    return {"diag_lanes": n,
            "compressed_recall10_full_frac": float(comp_full.mean()),
            "reranked_recall10_full_frac": float((rec == 1.0).mean()),
            "mean_reranked_recall_at_exhaustion": float(rec.mean()),
            "converged_not_compressed_full": int((conv & ~comp_full).sum())}


def convergence_check(eng, wl, td, probe, chunk):
    """Why W_q labels converge or not, on the first training chunk.

    Re-runs the fused probe and exhaustive resume of those lanes, and sets
    the lanes whose final top-10 ids equal the exact ones (recall 10/10)
    beside those the reference's test `res_dist <= gt_dist + 1e-6`
    accepts. An absolute 1e-6 is below one float32 ulp of a squared
    distance above 8, so at d=768 a lane with the exact ids can still fail
    it when its distances (K1's sums) round above the ground truth's (a
    matmul); `rel_excess_max` is that gap, relative to gt_dist.
    """
    import torch

    from repro_torch.core import SearchConfig, probe_and_features
    from repro_torch.core.engine import BIG_BUDGET
    from repro_torch.index.bruteforce import recall_at_k

    c = SearchConfig(k=10, queue_size=512, backend="fused")
    n = min(chunk, wl.batch)
    gt_idx, gt_dist = td.gt_idx[:n], td.gt_dist[:n]
    gt_dev = torch.from_numpy(gt_dist).to(eng.device)
    prog = eng.compile(wl.filter_slice(0, n))
    q = wl.queries[:n]
    st, _ = probe_and_features(eng, c, q, prog, probe, 2, gt_dist=gt_dev)
    st = eng.search(c, q, prog, BIG_BUDGET, state=st, gt_dist=gt_dev)
    res_idx = st.res_idx.cpu().numpy()
    res_dist = st.res_dist.cpu().numpy()
    conv = st.conv_cnt.cpu().numpy() > 0
    require(np.array_equal(conv, td.converged[:n]),
            "re-run training lanes converge differently")
    full = recall_at_k(res_idx, gt_idx) == 1.0
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = (res_dist - gt_dist) / np.abs(gt_dist)
    return {"diag_lanes": n,
            "recall10_full_frac": float(full.mean()),
            "converged_frac_diag": float(conv.mean()),
            "full_recall_not_converged": int((full & ~conv).sum()),
            "converged_not_full_recall": int((conv & ~full).sum()),
            "rel_excess_max": (float(np.nanmax(rel[full])) if full.any()
                               else None),
            "mean_recall_at_exhaustion": float(
                recall_at_k(res_idx, gt_idx).mean()),
            "gt_dist_median": float(np.median(gt_dist))}


def profile_e2e(eng, est, wl, probe, backend, wall_unprofiled_ms,
                phase="profile"):
    """Where one e2e batch spends its time: device-busy time (kernels
    only, from torch.profiler / CUPTI), the idle share against the same
    cell's unprofiled median wall time, kernel launches per lockstep step,
    and the top kernels by device time. Only the card's activity is
    traced: every number here is a device event's, and the host's op
    events of the fused batch (≈66,500 launches) took 20–28 s more to
    gather."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SearchConfig, dispatch_counters, e2e_search

    c = SearchConfig(k=10, queue_size=512, backend=backend)
    torch.cuda.synchronize()
    u0 = FOREST_UPLOADS[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        d0 = dispatch_counters()
        t = time.perf_counter()
        res = e2e_search(eng, est, c, wl.queries, wl.spec, probe_budget=probe)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        d1 = dispatch_counters()
    uploads = FOREST_UPLOADS[0] - u0
    require(uploads == 0, f"an e2e batch uploaded {uploads} forests")

    evs = _kernel_events(prof)
    busy = sum(us for _, us in evs) / 1e3
    launches = sum(e.count for e, _ in evs)
    # steps of the batch: the launch loop's count (persistent), or the largest
    # lane's expansions (single-step backends step every lane in lockstep)
    steps = (d1["steps"] - d0["steps"] if backend == "persistent"
             else int(res.state.hops.max()))
    top = sorted(evs, key=lambda x: x[1], reverse=True)[:10]
    emit({"phase": phase, "backend": backend,
          "precision": eng.precision, "workload": "contain",
          "alpha": 1.0, "wall_ms_profiled": wall,
          "wall_ms": wall_unprofiled_ms,
          "device_busy_ms": busy if evs else "not measured",
          "device_idle_share": ((1.0 - busy / wall_unprofiled_ms) if evs
                                else "not measured"),
          "kernel_launches": launches, "lockstep_steps": steps,
          "kernel_launches_per_step": launches / max(steps, 1),
          "htod_copies": sum(e.count for e, _ in evs if "HtoD" in e.key),
          "forest_uploads": uploads,
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "device_ms": us / 1e3} for e, us in top]})


# ---------------------------------------------- observability, serving ----
def search_split(tr, wall_ms_total: float, k5_ms: float) -> dict:
    """Split a traced persistent batch's wall time by its spans: the
    launch spans (each a K5 launch, or a group of K1 steps in widen mode,
    plus the `hops` / `active` readback that waits for it), the rest of
    the engine's search calls ("probe" / "resume" / "scan" spans: the
    launch loop's compactions, its Python and the per-call set-up), and
    everything outside them (features, K2, the rerank, the caller's
    Python). `k5_device_ms` is K5's device time for a 64-lane 8-step
    launch (`k5_check`), beside the launch span it sits in."""
    launches = tr.spans(name="launch")
    launch_ms = sum(s.duration for s in launches) * 1e3
    calls = [s for s in tr.spans() if s.name in ("probe", "resume", "scan")]
    search_ms = sum(s.duration for s in calls) * 1e3
    n = max(len(launches), 1)
    return {"wall_ms": wall_ms_total, "launches": len(launches),
            "launch_spans_ms": launch_ms,
            "launch_span_mean_ms": launch_ms / n,
            "k5_device_ms": k5_ms,
            "search_calls_ms": search_ms,
            "loop_other_ms": search_ms - launch_ms,
            "loop_other_per_launch_ms": (search_ms - launch_ms) / n,
            "outside_search_ms": wall_ms_total - search_ms,
            "launch_share_of_wall": launch_ms / max(wall_ms_total, 1e-9)}


def run_obs_e2e(eng, est, wl, probe, k5_ms) -> dict:
    """obs_e2e: `e2e_search` on the persistent backend (contain α=1, 64
    lanes) plain and with a tracer and explain=True: every SearchState
    field equal, equal dispatch_counters deltas, one launch span per
    launch, every report's probe NDC + resume NDC = cnt. Medians of 3 on
    the host clock, and the launch-span split of the traced batch."""
    from repro_torch.core import SearchConfig, dispatch_counters, e2e_search
    from repro_torch.obs import Tracer

    c = SearchConfig(k=10, queue_size=512, backend="persistent")

    def call(tracer=None):
        d0 = dispatch_counters()
        res, ms = wall_ms(lambda: e2e_search(
            eng, est, c, wl.queries, wl.spec, probe_budget=probe, alpha=1.0,
            n_probes=2, tracer=tracer, explain=tracer is not None))
        d1 = dispatch_counters()
        return res, ms, {k: d1[k] - d0[k] for k in d0}

    plain, plain_ms, d_plain = call()
    tr = Tracer()
    traced, traced_ms, d_traced = call(tr)
    differ = fields_differ(traced.state, plain.state)
    require(not differ, f"obs_e2e: tracing changed SearchState {differ}")
    require(np.array_equal(traced.predicted_budget, plain.predicted_budget),
            "obs_e2e: tracing changed the budgets")
    require(d_traced == d_plain, f"obs_e2e: dispatch deltas {d_traced} "
            f"traced vs {d_plain} plain")
    spans = tr.spans(name="launch")
    require(len(spans) == d_traced["launches"] > 0,
            f"obs_e2e: {len(spans)} launch spans, {d_traced} dispatches")
    require(sum(s.attrs["steps"] for s in spans) == d_traced["steps"],
            "obs_e2e: launch spans' steps differ from the loop's")
    cnt = traced.state.cnt.cpu().numpy()
    for i, r in enumerate(traced.reports):
        probe_st, resume_st = r.stages[0], r.stages[2]
        require(probe_st.ndc + resume_st.ndc == r.actual_ndc == int(cnt[i]),
                f"obs_e2e: lane {i} report NDC {probe_st.ndc} + "
                f"{resume_st.ndc} vs cnt {cnt[i]}")
    plain_med = float(np.median([plain_ms, *(call()[1]
                                             for _ in range(REPEATS - 1))]))
    traced_med = float(np.median([traced_ms, *(call(Tracer())[1]
                                               for _ in range(REPEATS - 1))]))
    split = search_split(tr, traced_ms, k5_ms)
    emit({"phase": "obs_e2e", "path": "e2e_search", "backend": "persistent",
          "workload": "contain", "alpha": 1.0, "batch": wl.batch,
          "fields_equal_traced_vs_plain": True,
          "dispatch_deltas": d_traced, "launch_spans": len(spans),
          "spans_by_name": span_counts(tr),
          "terminations": _term_counts(traced.reports),
          "e2e_ms_plain_median": plain_med,
          "e2e_ms_traced_median": traced_med})
    return split


def span_counts(tr) -> dict:
    out = {}
    for s in tr.spans():
        out[s.name] = out.get(s.name, 0) + 1
    return out


def _term_counts(reports) -> dict:
    out = {}
    for r in reports:
        out[r.termination] = out.get(r.termination, 0) + 1
    return out


def run_obs_planned(eng, planner, wl, probe) -> None:
    """obs_e2e (planned): `planned_search` on "mixed", persistent, plain
    and traced with explain: every field equal, equal dispatch deltas,
    launch spans = launches, each report's stage NDCs add up to cnt; span
    counts by name."""
    from repro_torch.core import dispatch_counters, planned_search
    from repro_torch.obs import Tracer

    def call(tracer=None):
        d0 = dispatch_counters()
        res, ms = wall_ms(lambda: planned_search(
            eng, planner, plan_cfg("persistent"), wl.queries, wl.exprs,
            probe_budget=probe, n_probes=2, tracer=tracer,
            explain=tracer is not None))
        d1 = dispatch_counters()
        return res, ms, {k: d1[k] - d0[k] for k in d0}

    plain, plain_ms, d_plain = call()
    tr = Tracer()
    traced, traced_ms, d_traced = call(tr)
    differ = fields_differ(traced.state, plain.state)
    require(not differ, f"obs planned: tracing changed SearchState {differ}")
    require(np.array_equal(traced.plan, plain.plan),
            "obs planned: tracing changed the plans")
    require(d_traced == d_plain, f"obs planned: dispatch deltas {d_traced} "
            f"traced vs {d_plain} plain")
    spans = tr.spans(name="launch")
    require(len(spans) == d_traced["launches"],
            f"obs planned: {len(spans)} launch spans, {d_traced}")
    cnt = traced.state.cnt.cpu().numpy()
    for i, r in enumerate(traced.reports):
        require(sum(st.ndc for st in r.stages) == r.actual_ndc == int(cnt[i]),
                f"obs planned: lane {i} stage NDCs do not add up to cnt")
    emit({"phase": "obs_e2e", "path": "planned_search",
          "backend": "persistent", "workload": "mixed", "batch": wl.batch,
          "fields_equal_traced_vs_plain": True,
          "dispatch_deltas": d_traced, "launch_spans": len(spans),
          "spans_by_name": span_counts(tr),
          "terminations": _term_counts(traced.reports),
          "e2e_ms_plain": plain_ms, "e2e_ms_traced": traced_ms})


def serve_equals_oneshot(reqs, one, what: str) -> None:
    """Each request's ids, distance bits, NDC and budget against its lane
    of the one-shot batch (both run the same device code)."""
    reqs = sorted(reqs, key=lambda r: r.rid)
    ri = np.stack([r.res_idx for r in reqs])
    rd = np.stack([r.res_dist for r in reqs])
    require(np.array_equal(ri, one.state.res_idx.cpu().numpy()),
            f"{what}: scheduled ids differ from one-shot")
    require(np.array_equal(rd.view(np.uint32),
                           one.state.res_dist.cpu().numpy().view(np.uint32)),
            f"{what}: scheduled distances differ from one-shot")
    require(np.array_equal(np.asarray([r.ndc for r in reqs]),
                           one.state.cnt.cpu().numpy()),
            f"{what}: scheduled NDC differs from one-shot")
    require(np.array_equal(np.asarray([r.budget for r in reqs]),
                           one.predicted_budget),
            f"{what}: scheduled budgets differ from one-shot")


def serve_run(sched, reqs) -> float:
    """Submit every request at once and drain; wall seconds (the scheduler
    synchronizes the card at the end of each batch)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for r in reqs:
        require(sched.submit(r, time.perf_counter() - t) == "queued",
                f"request {r.rid} was not admitted")
    sched.run_until_idle(time.perf_counter() - t)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def serve_report(sched, reqs, wall_s: float) -> dict:
    s = sched.summary()
    return {"requests": len(reqs), "wall_s": wall_s,
            "requests_per_s": len(reqs) / wall_s,
            "latency_ms": {k: v * 1e3 for k, v in s["latency"].items()},
            "n_batches": s["n_batches"], "n_requeues": s["n_requeues"],
            "launches_total": s["launches_total"],
            "steps_total": s["steps_total"],
            "batches_by_phase": s["batches_by_phase"],
            "max_slices": max(r.n_slices for r in reqs)}


def run_serve(eng, est, cases, probe, precision, policies, k5_ms,
              need) -> dict:
    """serve: the cost-aware scheduler on the persistent backend,
    `ServeConfig(lane_width=16, probe_budget=probe, n_probes=2, alpha=1.0,
    cache_capacity=0)`, over every case's 64 requests at once (`cases`:
    name → (workload, its one-shot `e2e_search` result)). Under each
    policy every request equals its lane of the one-shot batch bit for
    bit; launches_total equals the dispatch_counters delta; no batch
    uploads a forest; under escalate some request takes ≥ 2 slices.
    Returns the kernel counts of the first policy's run and each policy's
    launch-span split of the batches' busy time."""
    from repro_torch.core import SearchConfig, dispatch_counters
    from repro_torch.obs import Tracer
    from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                                   requests_from_workload)

    cfg = SearchConfig(k=10, queue_size=512, backend="persistent")
    first, splits = None, {}
    for policy in policies:
        scfg = ServeConfig(lane_width=16, probe_budget=probe, n_probes=2,
                           alpha=1.0, cache_capacity=0, policy=policy)
        tr = Tracer()
        sched = CostAwareScheduler(eng, est, cfg, scfg, tracer=tr)
        groups = {name: requests_from_workload(wl, start_rid=1000 * i)
                  for i, (name, (wl, _)) in enumerate(cases.items())}
        reqs = [r for lane in zip(*groups.values()) for r in lane]
        reset_counts()
        d0 = dispatch_counters()["launches"]
        u0 = FOREST_UPLOADS[0]
        wall = serve_run(sched, reqs)
        counts = read_counts()
        launches = dispatch_counters()["launches"] - d0
        uploads = FOREST_UPLOADS[0] - u0
        for name, (_, one) in cases.items():
            serve_equals_oneshot(groups[name], one,
                                 f"serve {precision} {policy} {name}")
        s = sched.summary()
        require(s["n_completed"] == len(reqs), "serve: requests lost")
        require(s["launches_total"] == launches > 0,
                f"serve: launches_total {s['launches_total']} vs "
                f"dispatch delta {launches}")
        require(uploads == 0, f"serve: {uploads} forest uploads")
        require(all(counts[n] > 0 for n in need),
                f"serve {precision} {policy}: a kernel of the path was "
                f"never launched: {counts}")
        if policy == "escalate":
            require(any(r.n_slices >= 2 for r in reqs),
                    "serve escalate: no request took two slices")
        splits[policy] = search_split(tr, s["busy_time"] * 1e3, k5_ms)
        first = counts if first is None else first
        emit({"phase": "serve", "precision": precision, "policy": policy,
              "backend": "persistent", "workloads": list(cases),
              "equals_oneshot_bitwise": True, "forest_uploads": uploads,
              **serve_report(sched, reqs, wall), "launches": counts})
    return first, splits


def lane_agreement(got_idx, got_dist, got_cnt, got_bud, one) -> dict:
    """Share of lanes whose ids, distance bits, NDC and budget equal the
    one-shot batch's."""
    idx = got_idx == one.state.res_idx.cpu().numpy()
    dist = (got_dist.view(np.uint32)
            == one.state.res_dist.cpu().numpy().view(np.uint32))
    cnt = got_cnt == one.state.cnt.cpu().numpy()
    bud = got_bud == one.predicted_budget
    return {"ids": float(idx.all(axis=1).mean()),
            "distance_bits": float(dist.all(axis=1).mean()),
            "ndc": float(cnt.mean()), "budget": float(bud.mean()),
            "all": float((idx.all(axis=1) & dist.all(axis=1) & cnt
                          & bud).mean())}


def run_serve_narrow(eng, est, wl, one, probe) -> None:
    """serve_narrow: the 64 contain requests through schedulers of lane
    width 4 (batches of 1, 2 or 4 lanes; the probe batches take 4) and 1
    (every batch one lane), and `e2e_search` on lanes 0..b−1 alone for b ∈
    {1, 4, 8, 16}, each against the 64-lane one-shot batch: every lane's
    ids, distance bits, NDC and budget, its probe features and its entry
    distance (`d_start`) must be equal bit for bit. It holds because the
    entry distance and the rerank come from K6 / K6q rows and the codecs'
    query norms and PQ tables are summed elementwise in a fixed order, so
    no value depends on the batch width."""
    from repro_torch.core import SearchConfig, e2e_search, probe_and_features
    from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                                   requests_from_workload)

    cfg = SearchConfig(k=10, queue_size=512, backend="persistent")
    served = {}
    for width in (4, 1):
        sched = CostAwareScheduler(eng, est, cfg, ServeConfig(
            lane_width=width, probe_budget=probe, n_probes=2, alpha=1.0,
            cache_capacity=0))
        reqs = requests_from_workload(wl)
        serve_run(sched, reqs)
        reqs.sort(key=lambda r: r.rid)
        served[width] = lane_agreement(
            np.stack([r.res_idx for r in reqs]),
            np.stack([r.res_dist for r in reqs]),
            np.asarray([r.ndc for r in reqs]),
            np.asarray([r.budget for r in reqs]), one)
    full, _ = probe_and_features(eng, cfg, wl.queries, wl.spec, probe, 2)
    first = {}
    for b in (1, 4, 8, 16):
        part = e2e_search(eng, est, cfg, wl.queries[:b], wl.spec.slice(
            slice(0, b)), probe_budget=probe, alpha=1.0, n_probes=2)
        st, _ = probe_and_features(eng, cfg, wl.queries[:b],
                                   wl.spec.slice(slice(0, b)), probe, 2)
        first[b] = {
            "features_bits_equal": float(np.mean(
                part.probe_features.view(np.uint32)
                == one.probe_features[:b].view(np.uint32))),
            "d_start_bits_equal": float(np.mean(
                st.d_start.cpu().numpy().view(np.uint32)
                == full.d_start[:b].cpu().numpy().view(np.uint32))),
            **{f"lanes_{k}": v for k, v in lane_agreement(
                part.state.res_idx.cpu().numpy(),
                part.state.res_dist.cpu().numpy(),
                part.state.cnt.cpu().numpy(), part.predicted_budget,
                _first_lanes(one, b)).items()}}
    moved = {}
    if eng.precision == "float32":
        # the share of the 64 lanes whose entry distance K6 gives the same
        # bits as the torch reduction it replaced (`sqdist_bdrd`)
        import torch

        from repro_torch.kernels.distance import sqdist_bdrd

        q = torch.as_tensor(wl.queries).to(eng.device, torch.float32)
        row = eng.base_vectors[eng.entry_point][None, None, :].expand(
            q.shape[0], 1, -1)
        moved["d_start_bits_equal_torch_reduction_64_lanes"] = float(
            np.mean(sqdist_bdrd(q, row)[:, 0].cpu().numpy().view(np.uint32)
                    == full.d_start.cpu().numpy().view(np.uint32)))
    emit({"phase": "serve_narrow", "precision": eng.precision,
          "workload": "contain",
          "served_vs_oneshot_lane_share": served,
          "e2e_first_lanes_vs_batch": first, **moved})
    for width, share in served.items():
        require(all(v == 1.0 for v in share.values()),
                f"serve_narrow {eng.precision}: lane width {width} differs "
                f"from the one-shot batch: {share}")
    for b, share in first.items():
        require(all(v == 1.0 for v in share.values()),
                f"serve_narrow {eng.precision}: lanes 0..{b - 1} alone "
                f"differ from the 64-lane batch: {share}")


def _first_lanes(one, b):
    """The first b lanes of an E2EResult (for `lane_agreement`)."""
    import types

    from repro_torch.core import take_lanes

    return types.SimpleNamespace(state=take_lanes(one.state, list(range(b))),
                                 predicted_budget=one.predicted_budget[:b])


def run_serve_auto(eng, est, planner, wl, planned, probe) -> dict:
    """serve (auto): plan="auto" over the 64 "mixed" requests with the
    planner: every request completes; a second scheduler gives identical
    results; resubmitted, every request hits the cache under auto with
    identical results. Reports the plan mix, and the share of lanes equal
    to the one-shot planned_search (persistent) in ids and NDC."""
    from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                                   requests_from_workload)

    scfg = ServeConfig(lane_width=16, probe_budget=probe, n_probes=2,
                       alpha=1.0, plan="auto")
    runs = []
    for _ in range(2):
        sched = CostAwareScheduler(eng, est, plan_cfg("persistent"), scfg,
                                   planner=planner)
        reqs = requests_from_workload(wl)
        reset_counts()
        wall = serve_run(sched, reqs)
        runs.append((sched, reqs, read_counts(), wall))
    (s1, r1, counts, wall), (_, r2, _, _) = runs
    require(all(r.res_idx is not None for r in r1 + r2),
            "serve auto: a request did not complete")
    for a, b in zip(r1, r2):
        require(np.array_equal(a.res_idx, b.res_idx)
                and np.array_equal(a.res_dist.view(np.uint32),
                                   b.res_dist.view(np.uint32))
                and (a.ndc, a.plan) == (b.ndc, b.plan),
                f"serve auto: request {a.rid} differs between two runs")
    again = requests_from_workload(wl)
    for r in again:
        require(s1.submit(r, 0.0) == "hit", "serve auto: no cache hit")
    for a, b in zip(r1, again):
        require(b.cache_hit and np.array_equal(a.res_idx, b.res_idx)
                and np.array_equal(a.res_dist.view(np.uint32),
                                   b.res_dist.view(np.uint32))
                and a.ndc == b.ndc, f"serve auto: request {a.rid}'s cache "
                "hit differs")
    need = ("persistent_multi_step", "gbdt_predict")
    if any(r.plan == "scan" for r in r1):
        need += ("sqdist_rows",)
    if any(r.plan == "widen" for r in r1):
        need += ("fused_step",)
    require(all(counts[n] > 0 for n in need),
            f"serve auto: a kernel of the path was never launched: {counts}")
    r_sorted = sorted(r1, key=lambda r: r.rid)
    same = ((np.stack([r.res_idx for r in r_sorted])
             == planned.state.res_idx.cpu().numpy()).all(axis=1)
            & (np.asarray([r.ndc for r in r_sorted])
               == planned.state.cnt.cpu().numpy()))
    mix = {}
    for r in r1:
        mix[r.plan] = mix.get(r.plan, 0) + 1
    emit({"phase": "serve", "precision": "float32", "plan": "auto",
          "backend": "persistent", "workload": "mixed",
          "two_runs_identical": True, "cache_hits_identical": True,
          "plan_mix": mix,
          "late_scans": sum(1 for r in r1 if r.plan == "scan"
                            and not r.plan_pure),
          "equal_planned_search_frac": float(same.mean()),
          "cache": s1.summary()["cache"],
          **serve_report(s1, r1, wall), "launches": counts})
    return counts


def run_launchers(*runs) -> None:
    """launcher: `python -m repro_torch.launch.serve --status --prometheus`
    on the card at its default corpus, one child process per (S, N,
    arch) of `runs`, all started together: `--shards S` (an
    index-sharded engine, the corpus rounded up to a multiple of S),
    `--gen-len N` (the RAG tail, the tiny config of `--arch` decoding N
    tokens over the served ids). The children reuse
    the kernels built above. Each must exit 0 and its scrape validate
    (with S > 1, carry `shard_ndc_total`; with N > 0, print its
    `generation:` line, which names the arch). A line's `seconds` is the
    wall time since the previous line, so the lines add up to the
    phase's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t = time.perf_counter()
    procs = [(run, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--status",
         "--prometheus", "--shards", str(run[0]), "--gen-len", str(run[1]),
         "--arch", run[2]], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for run in runs]
    try:
        for run, proc in procs:
            out, err = proc.communicate(timeout=600)
            launcher_check(*run, proc.returncode, out, err,
                           time.perf_counter() - t)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def launcher_check(shards: int, gen_len: int, arch: str, returncode: int,
                   out: str, err: str, wall_s: float) -> None:
    """One launcher child's checks and its `launcher` line."""
    from repro_torch.obs import validate_prometheus

    require(returncode == 0, f"launcher exited {returncode}: {err[-2000:]}")
    require("== prometheus scrape\n" in out, "launcher printed no scrape")
    head, scrape = out.split("== prometheus scrape\n", 1)
    gen = [ln for ln in scrape.splitlines() if ln.startswith("generation:")]
    require(len(gen) == (1 if gen_len else 0)
            and all(f"{arch} tiny" in ln for ln in gen),
            f"launcher --gen-len {gen_len} --arch {arch}: generation lines "
            f"{gen}")
    scrape = "\n".join(ln for ln in scrape.splitlines()
                       if not ln.startswith("generation:")) + "\n"
    names = validate_prometheus(scrape)
    health = json.loads(head.split("== serving health\n", 1)[1])
    lines = [ln for ln in head.splitlines()
             if ln.startswith(("retrieval:", "batches=", "calibration:",
                               "   device=", "   index-axis"))]
    if shards > 1:
        require(names.get("repro_shard_ndc_total") == shards
                and health["summary"]["n_shards"] == shards,
                f"launcher --shards {shards}: no per-shard counters")
    emit({"phase": "launcher", "since_start_s": wall_s,
          "shards": shards, "gen_len": gen_len, "arch": arch,
          "generation": gen, "returncode": returncode, "scrape_valid": True,
          "metrics": len(names),
          "n_completed": health["summary"]["n_completed"],
          "healthy": health["healthy"], "report": lines})


GRAPH_RECALL_ROWS = 1024
ALL_ROWS_FILTER = "Range(-1.0, 2.0, attr=0)"  # channel 0 lies in [0, 1]


def run_graph_recall(ds, eng, graph, wl, device) -> None:
    """graph_recall: (1) the graph's neighbour recall — the share of each
    of 1024 sampled rows' true 32-NN (`index.knn_exact`, the row itself
    left out) among its graph neighbours; (2) recall@10 of an exhaustive
    search (persistent, queue 512, no budget) of the 64 contain queries
    under a filter every row passes, against `knn_exact`'s top-10.
    Measures only."""
    import torch

    from repro_torch.core import SearchConfig
    from repro_torch.core.engine import BIG_BUDGET
    from repro_torch.filters import Range
    from repro_torch.index.bruteforce import knn_exact, recall_at_k, valid_mask

    t = time.perf_counter()
    rows = np.sort(np.random.default_rng(0).choice(
        ds.n, GRAPH_RECALL_ROWS, replace=False))
    nn_idx, _ = knn_exact(ds.vectors[rows], eng.base_vectors, 33,
                          device=device)
    true32 = np.stack([ids[ids != row][:32] for ids, row in zip(nn_idx, rows)])
    nbrs = graph.neighbors[torch.from_numpy(rows).to(
        graph.neighbors.device)].cpu().numpy()
    hit = [np.isin(t32, nb[nb >= 0]).mean() for t32, nb in zip(true32, nbrs)]
    expr = Range(-1.0, 2.0, attr=0)
    n_valid = int(valid_mask([expr], ds.labels_packed,
                             ds.value_matrix).sum())
    require(n_valid == ds.n, f"{ALL_ROWS_FILTER} passes {n_valid} rows")
    gi, _ = knn_exact(wl.queries, eng.base_vectors, 10, device=device)
    c = SearchConfig(k=10, queue_size=512, backend="persistent")
    st, ms = wall_ms(lambda: eng.search(c, wl.queries, [expr] * wl.batch,
                                        BIG_BUDGET))
    rec = recall_at_k(st.res_idx.cpu().numpy(), gi)
    emit({"phase": "graph_recall", "rows": GRAPH_RECALL_ROWS,
          "degree": graph.degree,
          "neighbour_recall@32_mean": float(np.mean(hit)),
          "neighbour_recall@32_p10": float(np.percentile(hit, 10)),
          "neighbour_recall@32_min": float(np.min(hit)),
          "filter": ALL_ROWS_FILTER, "queries": wl.batch,
          "exhaustive_recall@10": float(rec.mean()),
          "exhaustive_full_recall_frac": float((rec == 1.0).mean()),
          "exhaustive_mean_ndc": float(st.cnt.float().mean()),
          "exhaustive_ms": ms, "seconds": time.perf_counter() - t})


# ------------------------------------------------ the LM of the RAG tail ----
LM_ARCH = "olmo-1b"   # the reference launcher's default --arch, full width
LM_SEED = 0           # the torch.Generator the weights are drawn from
LM_BATCH = 16         # the rag phase's requests, one LM row each
LM_PROMPT = 8         # prompt tokens after a request's 10 retrieved ids
LM_DECODE = 32        # greedy tokens decoded after the prefill
LM_TOL = 2e-3         # logits: decode step vs a fresh prefill, on the card
LM_XDEV_TOL = 2e-3    # logits: the card vs the CPU, same weights
LM_XDEV_LAYERS = 2    # depth of the card-vs-CPU model (full width)
LM_XDEV_STEPS = 4     # its decode steps


def greedy_agreement(got, want, tol: float) -> tuple[float, int]:
    """(share of positions whose top-2 margin in `want` exceeds `tol` where
    the argmaxes agree, the number of such positions)."""
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol
    same = got.argmax(-1) == want.argmax(-1)
    n = int(sure.sum())
    return (float((same & sure).sum()) / max(n, 1), n)


def lm_bounds(cfg, n_params: int, param_bytes: int, b: int, s: int,
              ctx: int) -> dict:
    """Least times on the card: a decode step (every weight read once —
    the tied embedding as the head —, its KV cache read at `ctx` slots)
    and a prefill of [b, s] (the weights once; its matmuls' float32
    operations, logits at the last position only)."""
    d, v = cfg.d_model, cfg.vocab_size
    body = n_params - v * d                    # weights outside the embedding
    kv = 2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.hd * 4
    attn_ops = 4 * cfg.n_layers * cfg.n_heads * cfg.hd
    dec_ops = 2 * (body + v * d) * b + attn_ops * b * ctx
    pre_ops = 2 * body * b * s + 2 * v * d * b + attn_ops * b * s * s / 2
    return {"decode_weight_bound_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
            "decode_bound_ms": max((param_bytes + kv * ctx) / HBM_BYTES_PER_S,
                                   dec_ops / FP32_FLOP_PER_S) * 1e3,
            "decode_bound_by": ("bytes" if (param_bytes + kv * ctx)
                                / HBM_BYTES_PER_S >= dec_ops / FP32_FLOP_PER_S
                                else "operations"),
            "prefill_bound_ms": max(param_bytes / HBM_BYTES_PER_S,
                                    pre_ops / FP32_FLOP_PER_S) * 1e3,
            "prefill_bound_by": ("bytes" if param_bytes / HBM_BYTES_PER_S
                                 >= pre_ops / FP32_FLOP_PER_S
                                 else "operations")}


def run_lm_full_width(device):
    """lm_full_width: olmo-1b at full width (16 layers, d 2048, 16 heads,
    d_ff 8192, vocab 50304, float32, TF32 off) built on the card by
    `build_model` from a seeded torch.Generator. A [16, 18] token batch is
    prefilled and 32 tokens greedy-decoded with the KV cache; each decode
    step's logits must equal the last-position logits of a fresh prefill
    over the same prefix (teacher-forced) within LM_TOL, and the greedy
    ids agree wherever the prefill's top-2 margin exceeds LM_TOL. Then the
    same check across devices: a 2-layer model at full width on the CPU,
    moved to the card, fed the CPU's greedy ids, within LM_XDEV_TOL.
    Prefill ms (CUDA events) and decode ms a token at batch 16 (host clock
    around the loop) beside their bounds. Returns the model (the rag
    phase reuses it)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train import generate

    t = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    lm = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in lm.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    s = 10 + LM_PROMPT
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, s)).astype(np.int32)).to(device)

    generate(lm, tokens, 2)                                    # warm-up
    run = generate(lm, tokens, LM_DECODE)
    logits = run["logits"]
    require(tuple(logits.shape) == (LM_BATCH, LM_DECODE + 1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"lm_full_width: logits {tuple(logits.shape)} not finite")
    seq = torch.cat([tokens, run["fed"]], dim=1)               # [B, 18+32]
    errs, want = [], []
    for step in range(LM_DECODE):
        ref, _ = lm.prefill(seq[:, :s + step + 1])
        want.append(ref[:, -1])
        errs.append(float((logits[:, step + 1] - ref[:, -1]).abs().max()))
    want = torch.stack(want, dim=1)
    agree, n_sure = greedy_agreement(logits[:, 1:], want, LM_TOL)
    decode_err = max(errs)
    require(decode_err <= LM_TOL, f"lm_full_width: decode vs teacher-forced "
            f"prefill differ by {decode_err} > {LM_TOL}")
    require(agree == 1.0, f"lm_full_width: greedy ids differ from the "
            f"teacher-forced prefill's on {1 - agree} of {n_sure} positions")
    prefill_ms = time_cuda(lambda: lm.prefill(tokens), iters=10, warmup=2)
    decode_ms = float(np.median([generate(lm, tokens, LM_DECODE)["decode_ms"]
                                 for _ in range(3)])) / LM_DECODE
    # where a decode step's time goes: device ms by kernel (torch.profiler)
    cache = lm.init_cache(LM_BATCH, s + 1)
    by_kernel = kernel_breakdown(lambda: lm.decode_step(cache, tokens[:, :1],
                                                        s))
    del cache
    busy_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])

    t1 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=LM_XDEV_LAYERS)
    small = build_model(cfg2, device="cpu", generator=torch.Generator(
        ).manual_seed(LM_SEED))
    cpu = generate(small, tokens.cpu(), LM_XDEV_STEPS)
    small.to(device)
    card = generate(small, tokens, LM_XDEV_STEPS,
                    forced=cpu["fed"].to(device))
    xdev_err = float((card["logits"].cpu() - cpu["logits"]).abs().max())
    xagree, x_sure = greedy_agreement(card["logits"].cpu(), cpu["logits"],
                                      LM_XDEV_TOL)
    del small
    require(xdev_err <= LM_XDEV_TOL, f"lm_full_width: card vs CPU logits "
            f"differ by {xdev_err} > {LM_XDEV_TOL}")
    require(xagree == 1.0, f"lm_full_width: card vs CPU greedy ids differ on "
            f"{1 - xagree} of {x_sure} positions")
    bounds = lm_bounds(cfg, n_params, param_bytes, LM_BATCH, s, s + LM_DECODE)
    emit({"phase": "lm_full_width", "arch": LM_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "params": n_params,
          "param_bytes": param_bytes, "build_s": build_s,
          "batch": LM_BATCH, "prompt_tokens": s, "decoded": LM_DECODE,
          "decode_vs_prefill_max_abs_err": decode_err,
          "decode_vs_prefill_tol": LM_TOL,
          "greedy_agree_where_margin_gt_tol": agree,
          "greedy_positions_checked": n_sure,
          "card_vs_cpu_layers": LM_XDEV_LAYERS,
          "card_vs_cpu_steps": LM_XDEV_STEPS,
          "card_vs_cpu_max_abs_err": xdev_err,
          "card_vs_cpu_tol": LM_XDEV_TOL,
          "card_vs_cpu_greedy_agree": xagree,
          "card_vs_cpu_positions_checked": x_sure,
          "card_vs_cpu_s": time.perf_counter() - t1,
          "prefill_ms": prefill_ms,
          "decode_ms_per_token": decode_ms,
          "decode_ms_per_token_per_request": decode_ms / LM_BATCH,
          **bounds,
          "decode_share_of_weight_bound": (bounds["decode_weight_bound_ms"]
                                           / decode_ms),
          "decode_step_device_busy_ms": busy_ms,
          "decode_step_idle_share": 1.0 - busy_ms / decode_ms,
          "decode_step_kernel_names": len(by_kernel),
          "decode_step_top_kernels_ms": top,
          "seconds": time.perf_counter() - t})
    return lm


def run_rag(eng, est, wl, one, probe, lm):
    """rag: the first 16 contain requests through `CostAwareScheduler`
    (persistent, lane width 16, on the serving phases' float32 engine and
    estimator), each bit for bit its lane of the one-shot batch, with
    K5, K2 and K6 launched (counts set to 0 just before); each request's
    10 retrieved ids (|id| mod vocab) and 8 prompt tokens
    (`examples/serve_rag.py:72-75`) condition the full-width olmo-1b:
    prefill, then 32 greedy KV-cache decode steps. Retrieval p50 / p99,
    prefill ms and decode ms a token a request. Returns the requests'
    retrieved ids [16, 10] (`lm_moe` serves them again)."""
    import torch

    from repro_torch.core import SearchConfig
    from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                                   requests_from_workload)
    from repro_torch.train import generate

    t = time.perf_counter()
    cfg = SearchConfig(k=10, queue_size=512, backend="persistent")
    sched = CostAwareScheduler(eng, est, cfg, ServeConfig(
        lane_width=16, probe_budget=probe, n_probes=2, alpha=1.0,
        cache_capacity=0))
    reqs = requests_from_workload(wl)[:LM_BATCH]
    reset_counts()
    wall = serve_run(sched, reqs)
    counts = read_counts()
    serve_equals_oneshot(reqs, _first_lanes(one, LM_BATCH), "rag")
    need = ("persistent_multi_step", "gbdt_predict", "sqdist_masked")
    require(all(counts[n] > 0 for n in need),
            f"rag: a kernel of the path was never launched: {counts}")
    vocab = lm.cfg.vocab_size
    doc_ids = np.stack([r.res_idx for r in sorted(reqs,
                                                  key=lambda r: r.rid)])
    prompts = np.random.default_rng(3).integers(0, vocab,
                                                (LM_BATCH, LM_PROMPT))
    ctx = np.concatenate([np.abs(doc_ids) % vocab, prompts], axis=1)
    tokens = torch.from_numpy(ctx.astype(np.int32)).to(eng.device)
    run = generate(lm, tokens, LM_DECODE)
    require(bool(torch.isfinite(run["logits"]).all()),
            "rag: the LM's logits are not finite")
    gen = run["ids"].cpu().numpy()
    require(gen.shape == (LM_BATCH, LM_DECODE + 1)
            and ((gen >= 0) & (gen < vocab)).all(),
            f"rag: generated ids {gen.shape} out of range")
    lat = sched.summary()["latency"]
    emit({"phase": "rag", "requests": len(reqs), "lane_width": 16,
          "backend": "persistent", "equals_oneshot_bitwise": True,
          "launches": counts, "context_tokens": int(tokens.shape[1]),
          "retrieval_p50_ms": lat["p50"] * 1e3,
          "retrieval_p99_ms": lat["p99"] * 1e3,
          "retrieval_wall_s": wall, "lm": LM_ARCH,
          "prefill_ms": run["prefill_ms"], "decoded": LM_DECODE,
          "decode_ms_per_token": run["decode_ms"] / LM_DECODE,
          "decode_ms_per_token_per_request": (run["decode_ms"] / LM_DECODE
                                              / LM_BATCH),
          "sample": {"docs": doc_ids[0].tolist(),
                     "generated": gen[0, :8].tolist()},
          "seconds": time.perf_counter() - t})
    return doc_ids


# ------------------------------------------------------- LM training ----
TRAIN_BATCH, TRAIN_SEQ = 8, 64  # the reference launcher's --batch, --seq
TRAIN_ACCUM = 2                 # microbatches a step
TRAIN_STEPS = 6                 # steps of the full-width run
# card vs CPU after one step of a 2-layer full-width model, same weights
# and batch: loss (relative), each gradient and moment leaf (× its max
# |.|), parameters (× lr) where the CPU's |g| exceeds 10× the gradient
# tolerance (the step's sign is sure there) and everywhere (a first
# AdamW step moves a parameter by lr·(±1 + wd·p), so a sign that ulps
# flip moves it by at most 2·lr)
LM_TRAIN_XDEV_TOL = {"loss": 1e-5, "grad": 1e-4, "moment": 1e-4,
                     "param_sure": 1e-3, "param": 2.0}
# resume vs uninterrupted, steps 3–4 (max |Δ| over every state leaf);
# 0: bit for bit
LM_TRAIN_RESUME_TOL = 0.0


def state_leaves(tree, prefix: str = "") -> dict:
    """{path: tensor} of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(state_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in state_leaves(tree).values())


def max_abs_diff(a: dict, b: dict) -> float:
    la, lb = state_leaves(a), state_leaves(b)
    require(la.keys() == lb.keys(), "lm_train: state trees differ")
    return max(float((la[k].detach().double()
                      - lb[k].detach().to(la[k].device).double())
                     .abs().max()) for k in la)


def train_card_vs_cpu(cfg, tokens, device) -> dict:
    """One AdamW step (float32 moments, grad_accum 1) of a full-width
    model cut to LM_XDEV_LAYERS layers, on the CPU and on the card from
    the same weights and batch; the largest differences, against
    LM_TRAIN_XDEV_TOL."""
    import dataclasses

    import torch

    from repro_torch.models import build_model
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_update,
                                   loss_and_grads, make_init_state)

    t = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=LM_XDEV_LAYERS)
    cpu = build_model(cfg2, device="cpu", generator=torch.Generator(
        ).manual_seed(LM_SEED))
    card = DecoderLM(cfg2, device=device)
    card.load_state_dict(cpu.state_dict())
    tc = TrainConfig(opt=AdamWConfig(), grad_accum=1)
    out = {}
    for name, m in (("cpu", cpu), ("card", card)):
        st = make_init_state(m, tc)
        loss, _, grads = loss_and_grads(m, st["params"],
                                        {"tokens": tokens.to(m.device)})
        adamw_update(st["params"], grads, st["opt"], tc.opt)
        out[name] = (float(loss), grads, st)
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out["card"]
    tol, lr = LM_TRAIN_XDEV_TOL, tc.opt.lr
    loss_err = abs(lg - lc) / abs(lc)
    grad_err = moment_err = param_sure = param_all = 0.0
    unsure = 0
    for k, g in gc.items():
        gmax = float(g.abs().max())
        grad_err = max(grad_err, float((gg[k].cpu() - g).abs().max()) / gmax)
        for which in ("m", "v"):
            a, b = sc["opt"][which][k], sg["opt"][which][k].cpu()
            moment_err = max(moment_err, float((b - a).abs().max())
                             / float(a.abs().max()))
        d = (sg["params"][k].detach().cpu() - sc["params"][k].detach()).abs()
        sure = g.abs() > 10 * tol["grad"] * gmax
        unsure += int((~sure).sum())
        param_all = max(param_all, float(d.max()) / lr)
        if bool(sure.any()):
            param_sure = max(param_sure, float(d[sure].max()) / lr)
    res = {"layers": LM_XDEV_LAYERS,
           "params": sum(p.numel() for p in cpu.parameters()),
           "loss_cpu": lc, "loss_card": lg, "loss_rel_err": loss_err,
           "grad_err_of_max": grad_err, "moment_err_of_max": moment_err,
           "param_err_sure_of_lr": param_sure, "param_err_of_lr": param_all,
           "unsure_elements": unsure, "tol": tol,
           "seconds": time.perf_counter() - t}
    require(loss_err <= tol["loss"] and grad_err <= tol["grad"]
            and moment_err <= tol["moment"] and param_sure <= tol["param_sure"]
            and param_all <= tol["param"],
            f"lm_train: card vs CPU beyond LM_TRAIN_XDEV_TOL: {res}")
    return res


def train_resume(cfg, batches, device) -> dict:
    """Resume ≡ uninterrupted on a full-width model cut to
    LM_XDEV_LAYERS layers: 4 steps straight; 2 steps, save, restore into
    the state of a model drawn from another seed (every leaf must come
    back bit for bit), 2 more steps; steps 3–4 against the straight run
    within LM_TRAIN_RESUME_TOL. The checkpoint goes under a git-ignored
    temporary directory, removed afterwards."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, CheckpointManager,
                                   TrainConfig, load_state_, make_init_state,
                                   make_train_step)

    t = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=LM_XDEV_LAYERS)
    tc = TrainConfig(opt=AdamWConfig(), grad_accum=TRAIN_ACCUM)

    def fresh(seed):
        m = build_model(cfg2, device=device, generator=torch.Generator(
            device=device).manual_seed(seed))
        return m, make_init_state(m, tc), make_train_step(m, tc)

    _, full, step = fresh(LM_SEED)
    straight = []
    for b in batches:
        full, met = step(full, b)
        straight.append(met["loss"])
    _, state, step = fresh(LM_SEED)
    for b in batches[:2]:
        state, _ = step(state, b)
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lm_train_ckpt_", dir=root)
    try:
        mgr = CheckpointManager(tmp)
        t1 = time.perf_counter()
        path = mgr.save(2, state)
        save_s = time.perf_counter() - t1
        disk = os.path.getsize(os.path.join(path, "arrays.npz"))
        _, state2, step2 = fresh(LM_SEED + 1)
        t1 = time.perf_counter()
        restored, manifest = mgr.restore_latest(state2)
        load_state_(state2, restored)
        restore_s = time.perf_counter() - t1
        del restored
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    restored_err = max_abs_diff(state, state2)
    require(restored_err == 0.0 and manifest["step"] == 2,
            f"lm_train: restored state differs from the saved one by "
            f"{restored_err}")
    resumed = []
    for b in batches[2:]:
        state2, met = step2(state2, b)
        resumed.append(met["loss"])
    err = max_abs_diff(full, state2)
    loss_err = max(abs(float(a) - float(b))
                   for a, b in zip(straight[2:], resumed))
    res = {"layers": LM_XDEV_LAYERS, "checkpoint_bytes": disk,
           "save_s": save_s, "restore_s": restore_s,
           "restored_bitwise": True, "steps_3_4_max_abs_diff": err,
           "steps_3_4_loss_abs_diff": loss_err,
           "steps_3_4_bitwise": err == 0.0 and loss_err == 0.0,
           "tol": LM_TRAIN_RESUME_TOL,
           "losses": [float(x) for x in straight],
           "seconds": time.perf_counter() - t}
    require(err <= LM_TRAIN_RESUME_TOL and loss_err <= LM_TRAIN_RESUME_TOL,
            f"lm_train: resumed steps 3-4 differ from the uninterrupted "
            f"run: {res}")
    return res


def train_launcher(ckpt_dir: str, *extra: str) -> subprocess.Popen:
    """`python -m repro_torch.launch.train` (the tiny olmo-1b on the card,
    a checkpoint every 2 steps under `ckpt_dir`) started as a child
    process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--ckpt-every",
         "2", "--ckpt-dir", ckpt_dir, *extra], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def launcher_output(proc: subprocess.Popen) -> list:
    """The child's stdout lines once it has exited 0."""
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0, f"train launcher {proc.args[3:]} exited "
            f"{proc.returncode}: {err[-2000:]}")
    return out.splitlines()


def without_host_sync(fn):
    """fn() with torch's sync debug mode at "error": any call that makes
    the host wait for the card raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def run_lm_train(device) -> None:
    """lm_train: olmo-1b at full width (float32, TF32 off) built on the
    card from a seeded torch.Generator; TRAIN_STEPS AdamW steps (float32
    moments at the AdamWConfig default lr 3e-4, grad_accum TRAIN_ACCUM,
    remat) on one seeded [TRAIN_BATCH, TRAIN_SEQ] batch: every loss
    finite and the last below the first; step ms (host clock,
    synchronised, median of steps 2–6) and tokens/s beside the step's
    bound — operations 6 · (non-embedding parameters + the tied head's
    V·d) · tokens at FP32_FLOP_PER_S, and the optimizer's bytes (p, g, m,
    v read, p, m, v written: 28 B a parameter) at HBM_BYTES_PER_S, the
    larger; remat's recompute is not counted —; a step that makes no host
    sync (`without_host_sync`); one step's device time by kernel and its
    idle share; the state's bytes and the card's peak. Then 2 steps with
    int8 moments and int8_ef (the first without a host sync); card ≡ CPU;
    resume ≡ uninterrupted; the train launcher (its first run and then
    its --resume run, on a thread beside those two checks)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   make_init_state, make_train_step)

    t = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    rng = np.random.default_rng(LM_SEED)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(
        device)} for _ in range(4)]
    batch = batches[0]
    model = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    tc = TrainConfig(opt=AdamWConfig(), grad_accum=TRAIN_ACCUM)
    require(cfg.remat, "lm_train: remat is off")
    state = make_init_state(model, tc)
    step = make_train_step(model, tc)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        (state, met), ms = wall_ms(lambda: step(state, batch))
        losses.append(met["loss"])
        step_ms.append(ms)
    losses = [float(x) for x in torch.stack(losses).cpu()]
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"lm_train: losses {losses} not finite or not falling")
    ms = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ops = 6 * n_params * tokens   # non-embedding + the tied head's V·d
    opt_bytes = 28 * n_params
    bound_ms = max(ops / FP32_FLOP_PER_S, opt_bytes / HBM_BYTES_PER_S) * 1e3
    state, _ = without_host_sync(lambda: step(state, batch))
    by_kernel = kernel_breakdown(lambda: step(state, batch), iters=1)
    busy_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    moment_bytes = tree_bytes(state["opt"]["m"]) + tree_bytes(
        state["opt"]["v"])
    del state, step

    # int8 moments and int8 error feedback at full width, 2 steps
    tc8 = TrainConfig(opt=AdamWConfig(moment_dtype="int8"),
                      grad_accum=TRAIN_ACCUM, grad_compression="int8_ef")
    state8 = make_init_state(model, tc8)
    step8 = make_train_step(model, tc8)
    state8, met = without_host_sync(lambda: step8(state8, batch))
    int8_losses = [met["loss"]]
    state8, met = step8(state8, batch)
    int8_losses.append(met["loss"])
    int8_losses = [float(x) for x in torch.stack(int8_losses).cpu()]
    require(all(np.isfinite(int8_losses)),
            f"lm_train: int8 moments gave losses {int8_losses}")
    int8_moment_bytes = tree_bytes(state8["opt"]["m"]) + tree_bytes(
        state8["opt"]["v"])
    peak = torch.cuda.max_memory_allocated()
    del state8, step8, model
    torch.cuda.empty_cache()

    # the launcher, 4 steps with a checkpoint every 2, then --resume
    # --steps 6, both beside the next two checks
    t1 = time.perf_counter()
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="lm_train_launcher_", dir=root)
    def both_runs():
        return [launcher_output(train_launcher(ckpt, "--steps", "4")),
                launcher_output(train_launcher(ckpt, "--steps", "6",
                                               "--resume"))]

    try:
        with ThreadPoolExecutor(1) as pool:   # the runs beside the checks
            runs = pool.submit(both_runs)
            xdev = train_card_vs_cpu(cfg, batch["tokens"], device)
            torch.cuda.empty_cache()
            resume = train_resume(cfg, batches, device)
            torch.cuda.empty_cache()
            runs = runs.result()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resumed = [ln for ln in runs[1] if ln.startswith("resumed from step")]
    require(resumed == ["resumed from step 4"]
            and not any("resumed" in ln for ln in runs[0]),
            f"train launcher: resume lines {resumed}")
    launcher = {"first": runs[0], "resumed": runs[1],
                "seconds": time.perf_counter() - t1}
    emit({"phase": "lm_train", "arch": LM_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "grad_accum": TRAIN_ACCUM, "remat": cfg.remat, "lr": tc.opt.lr,
          "losses": losses, "step_ms": step_ms, "step_ms_median_2_6": ms,
          "step_host_syncs": 0,
          "tokens_per_s": tokens / ms * 1e3,
          "bound_ms": bound_ms, "bound_ops": ops, "bound_bytes": opt_bytes,
          "bound_by": ("operations" if ops / FP32_FLOP_PER_S
                       >= opt_bytes / HBM_BYTES_PER_S else "bytes"),
          "share_of_bound": bound_ms / ms,
          "step_device_busy_ms": busy_ms,
          "step_idle_share": 1.0 - busy_ms / ms,
          "step_kernel_names": len(by_kernel),
          "step_top_kernels_ms": top,
          "state_bytes_p_g_m_v": 2 * param_bytes + moment_bytes,
          "moment_bytes_float32": moment_bytes,
          "moment_bytes_int8": int8_moment_bytes,
          "int8_ef_losses": int8_losses,
          "torch_max_allocated_mib": peak / 2**20,
          "card_vs_cpu": xdev, "resume": resume, "launcher": launcher,
          "seconds": time.perf_counter() - t})


# ------------------------------------------------------------ the MoE ----
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# depth cuts at full width, float32: a layer is 1,300,307,968 parameters,
# embed and head 262,668,288; 8 layers are 42.66 GB (all 32: 168 GB, more
# than the card); 2 layers train in ≈20 B a parameter (p, the float32
# gradient accumulator, m, v, and AdamW's temporaries)
MOE_SERVE_LAYERS = 8
MOE_TRAIN_LAYERS = 2
# resume ≡ uninterrupted on 1 layer (1.56 B parameters): its p, m, v
# (18.8 GB) and their copy fit on the card beside a step; 2 layers' 34 GB
# took 46 s to the host and back on an H100 machine
MOE_RESUME_LAYERS = 1
MOE_XDEV_SHAPE = (2, 32)   # one full-width layer's input, card vs CPU (cap 8)
MOE_ROUTE_MARGIN = 1e-6    # ids / keep compared where routing gaps exceed it
# card vs CPU on that layer: out and each gradient leaf × their CPU max |.|,
# aux relative (float32 both, TF32 off; the sums' orders differ)
MOE_XDEV_TOL = {"out": 1e-4, "aux": 1e-5, "grad": 1e-4}
MOE_MIN_ROWS = 8           # of LM_BATCH rows, compared decode vs prefill
MOE_NO_DROP_STEPS = 8      # decode steps of the no-drop capacity's check


def moe_work(cfg, lm, b: int, s: int) -> dict:
    """Operations of one forward of `lm` over [b, s] tokens, per-row
    dispatch: the expert products over the padded [b, E, cap, d] buffers
    (as `ffn._moe` computes them), the same products over the b·s·k
    assignments alone, and the attention and router projections
    (attention scores and the head are the caller's)."""
    from repro_torch.models.ffn import capacity

    layers = len(lm.block_types)
    d, f, e, k = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s, 8)
    attn = sum(p.numel() for p in lm.layers[0]["attn"].parameters())
    slot_ops = 2 * 3 * d * f
    return {"cap": cap, "slot_rows_per_layer": b * e * cap,
            "assignments_per_layer": b * s * k,
            "expert_ops": layers * slot_ops * b * e * cap,
            "useful_expert_ops": layers * slot_ops * b * s * k,
            "dense_ops": layers * 2 * (attn + d * e) * b * s}


def moe_serve_bounds(cfg, lm, param_bytes: int, b: int, s: int,
                     ctx: int) -> dict:
    """Least times of a decode step (one token a row, `ctx` cached slots)
    and of a prefill of [b, s]: every weight read once (each expert is
    read for its padded slots) at HBM_BYTES_PER_S, and the operations of
    the function as `moe_work` counts them at FP32_FLOP_PER_S; beside
    them the operations of the useful work (the b·s·k assignments)."""
    layers = len(lm.block_types)
    head = 2 * cfg.d_model * cfg.vocab_size * b
    score = 4 * layers * cfg.n_heads * cfg.hd * b
    kv = 2 * layers * b * cfg.n_kv_heads * cfg.hd * 4 * ctx
    out = {}
    for name, ss, attn_ops, extra in (("decode", 1, score * ctx, kv),
                                      ("prefill", s, score * s * s / 2, 0)):
        w = moe_work(cfg, lm, b, ss)
        ops = w["expert_ops"] + w["dense_ops"] + attn_ops + head
        useful = w["useful_expert_ops"] + w["dense_ops"] + attn_ops + head
        out[name] = {
            "cap": w["cap"], "slot_rows_per_layer": w["slot_rows_per_layer"],
            "assignments_per_layer": w["assignments_per_layer"],
            "weight_bound_ms": (param_bytes + extra) / HBM_BYTES_PER_S * 1e3,
            "ops": ops, "work_bound_ms": ops / FP32_FLOP_PER_S * 1e3,
            "useful_ops": useful,
            "useful_work_bound_ms": useful / FP32_FLOP_PER_S * 1e3,
            "padded_expert_work_x": w["expert_ops"] / w["useful_expert_ops"]}
    return out


def decode_vs_prefill(lm, tokens, steps: int, what: str, enc=None
                      ) -> tuple[dict, dict]:
    """`generate` over tokens [B, S] for `steps` greedy steps, every
    logit finite; then each step's logits against a fresh prefill over
    the same prefix (teacher-forced), on the rows whose prefill dropped no
    MoE assignment in any layer — a decode step drops none, and where
    that prefill dropped none, neither did the first (its prefix, under
    the same capacity: phi3.5-moe's while S ≤ 51, deepseek-v3's while S ≤
    179); a model without MoE blocks drops nothing, so every row is
    compared. A model that cross-attends reads the memory `enc` in the
    run and in every prefill. Returns (the comparison, the run); `what`
    names the phase in a failure."""
    import torch

    from repro_torch.train import generate

    b, s = tokens.shape
    run = generate(lm, tokens, steps, enc=enc)
    logits = run["logits"]
    require(tuple(logits.shape) == (b, steps + 1, lm.cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"{what}: logits {tuple(logits.shape)} not finite")
    def by_row(dr):
        return (torch.stack(dr).sum(0) if dr else
                torch.zeros(b, dtype=torch.int64, device=tokens.device))

    first = []
    lm.prefill(tokens, drops=first, enc=enc)
    seq = torch.cat([tokens, run["fed"]], dim=1)
    errs = torch.zeros((b, steps), device=tokens.device)
    clean = torch.zeros((b, steps), dtype=torch.bool, device=tokens.device)
    drops, want = [], []
    for step in range(steps):
        dr = []
        ref, _ = lm.prefill(seq[:, :s + step + 1], drops=dr, enc=enc)
        per_row = by_row(dr)
        clean[:, step] = per_row == 0
        drops.append(per_row)
        errs[:, step] = (logits[:, step + 1] - ref[:, -1]).abs().amax(-1)
        want.append(ref[:, -1])
    want = torch.stack(want, dim=1)
    n_pairs = int(clean.sum())
    agree, n_sure = greedy_agreement(logits[:, 1:][clean], want[clean],
                                     LM_TOL)
    return {"capacity_factor": lm.cfg.capacity_factor, "steps": steps,
            "first_prefill_drops_by_row": by_row(first).tolist(),
            "teacher_forced_drops_by_step": torch.stack(drops, 1).sum(
                0).tolist(),
            "rows_compared_any_step": int(clean.any(1).sum()),
            "rows_compared_first_step": int(clean[:, 0].sum()),
            "rows_compared_every_step": int(clean.all(1).sum()),
            "pairs_compared": n_pairs, "pairs": b * steps,
            "decode_vs_prefill_max_abs_err": (float(errs[clean].max())
                                              if n_pairs else None),
            "greedy_agree_where_margin_gt_tol": agree,
            "greedy_positions_checked": n_sure}, run


def rag_tokens(doc_ids, vocab: int, device):
    """[LM_BATCH, 10 + LM_PROMPT] int32 on `device`: the rag phase's
    requests' retrieved ids (|id| mod vocab), then LM_PROMPT seeded prompt
    tokens a row."""
    import torch

    prompts = np.random.default_rng(3).integers(0, vocab,
                                                (LM_BATCH, LM_PROMPT))
    ctx = np.concatenate([np.abs(doc_ids) % vocab, prompts], axis=1)
    return torch.from_numpy(ctx.astype(np.int32)).to(device)


def serve_decode_checks(published, tokens, device, no_drop_steps: int,
                        steps: int, what: str):
    """`decode_vs_prefill` on the model of `published` built on the card
    from LM_SEED: first, same weights, at capacity factor E/k (capacity S
    + 1 a row: no assignment can drop) for `no_drop_steps` steps — every
    decode step ≡ its teacher-forced prefill within LM_TOL on at least
    MOE_MIN_ROWS rows, greedy ids equal past that margin —, then at the
    published capacity factor for `steps` steps (drops a row; its
    drop-free rows, however few, compared too). Returns (both checks, the
    published model, its run)."""
    import dataclasses

    import torch

    from repro_torch.models import build_model
    from repro_torch.train import generate

    no_drop = dataclasses.replace(
        published, capacity_factor=published.n_experts / published.top_k)
    checks = {}
    for name, cfg, n in (("no_drop", no_drop, no_drop_steps),
                         ("published", published, steps)):
        t1 = time.perf_counter()
        lm = build_model(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(LM_SEED))
        generate(lm, tokens, 2)                                # warm-up
        checks[name], run = decode_vs_prefill(lm, tokens, n, what)
        checks[name]["seconds"] = time.perf_counter() - t1
        if name == "no_drop":
            del lm, run
            torch.cuda.empty_cache()
    nd, pub = checks["no_drop"], checks["published"]
    require(not any(nd["teacher_forced_drops_by_step"])
            and not any(nd["first_prefill_drops_by_row"]),
            f"{what}: capacity factor E/k dropped assignments: {nd}")
    require(nd["rows_compared_every_step"] >= MOE_MIN_ROWS,
            f"{what}: only {nd['rows_compared_every_step']} rows compared")
    for c in (nd, pub):
        err = c["decode_vs_prefill_max_abs_err"]
        require(err is None or err <= LM_TOL,
                f"{what}: decode vs teacher-forced prefill differ by {err} "
                f"> {LM_TOL} (capacity factor {c['capacity_factor']})")
        require(c["greedy_positions_checked"] == 0
                or c["greedy_agree_where_margin_gt_tol"] == 1.0,
                f"{what}: greedy ids differ from the teacher-forced "
                f"prefill's: {c}")
    return checks, lm, run


def serve_timing(lm, tokens, run, steps: int, launches: list | None = None,
                 enc=None):
    """(prefill ms of tokens [B, S] (over the memory `enc` of a model that
    cross-attends) by CUDA events, mean of 5; decode ms a token on the
    host clock, the median of `run`'s `steps` and 2 more such `generate`
    runs; a decode step's device ms by kernel, at position S of a fresh
    cache, its launches into `launches` where given)."""
    from repro_torch.train import generate

    b, s = tokens.shape
    prefill_ms = time_cuda(lambda: lm.prefill(tokens, enc=enc), iters=5,
                           warmup=1)
    decode_ms = float(np.median([run["decode_ms"]] + [
        generate(lm, tokens, steps, enc=enc)["decode_ms"]
        for _ in range(2)])) / steps
    cache = lm.init_cache(b, s + 1)
    by_kernel = kernel_breakdown(lambda: lm.decode_step(cache, tokens[:, :1],
                                                        s), launches=launches)
    return prefill_ms, decode_ms, by_kernel


def moe_serve(device, doc_ids) -> dict:
    """lm_moe (a): MOE_ARCH at full width cut to MOE_SERVE_LAYERS layers,
    built on the card from a seeded torch.Generator; the rag phase's 16
    requests' retrieved ids (|id| mod vocab) and 8 prompt tokens
    prefilled, then greedy KV-cache decode steps (`decode_vs_prefill`):
    LM_DECODE at its published capacity factor (1.25) and, same weights,
    MOE_NO_DROP_STEPS at capacity factor E/k (capacity S + 1 a row: no
    assignment can drop; its teacher-forced prefills pad every expert to
    S + 1 slots, ≈5× a decode step's work, hence fewer steps). Seeded
    random weights route a prompt's tokens alike (the causal attention's
    average dominates the residual stream from the first layer), so at
    1.25 the prefills drop in every row, and the decode ≡ prefill check
    (within LM_TOL, greedy ids equal past the margin) needs the no-drop
    run, on at least MOE_MIN_ROWS rows; the published run's drop-free
    rows are compared too, however few. Prefill ms (CUDA events) and
    decode ms a token (host clock, median of 3 runs) of the published
    run beside their bounds; a decode step's device time by kernel."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    t = time.perf_counter()
    published = dataclasses.replace(get_arch(MOE_ARCH),
                                    n_layers=MOE_SERVE_LAYERS)
    vocab = published.vocab_size
    tokens = rag_tokens(doc_ids, vocab, device)
    b, s = tokens.shape
    checks, lm, run = serve_decode_checks(published, tokens, device,
                                          MOE_NO_DROP_STEPS, LM_DECODE,
                                          "lm_moe")
    cfg = published
    n_params = sum(p.numel() for p in lm.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    prefill_ms, decode_ms, by_kernel = serve_timing(lm, tokens, run,
                                                    LM_DECODE)
    bounds = moe_serve_bounds(cfg, lm, param_bytes, b, s, s + LM_DECODE)
    del lm, run
    torch.cuda.empty_cache()
    busy_ms = sum(by_kernel.values())
    dec, pre = bounds["decode"], bounds["prefill"]
    return {"layers": cfg.n_layers, "of_layers": get_arch(MOE_ARCH).n_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "experts": cfg.n_experts,
            "top_k": cfg.top_k, "moe_d_ff": cfg.moe_d_ff, "vocab": vocab,
            "params": n_params, "param_bytes": param_bytes,
            "batch": b, "prompt_tokens": s, "decoded": LM_DECODE,
            "decode_vs_prefill_tol": LM_TOL,
            "decode_vs_prefill": checks,
            "prefill_ms": prefill_ms,
            "prefill_weight_bound_ms": pre["weight_bound_ms"],
            "prefill_work_bound_ms": pre["work_bound_ms"],
            "decode_ms_per_token": decode_ms,
            "decode_ms_per_token_per_request": decode_ms / b,
            "decode_weight_bound_ms": dec["weight_bound_ms"],
            "decode_work_bound_ms": dec["work_bound_ms"],
            "decode_share_of_bound": max(dec["weight_bound_ms"],
                                         dec["work_bound_ms"]) / decode_ms,
            "bounds": bounds,
            "decode_step_device_busy_ms": busy_ms,
            "decode_step_idle_share": 1.0 - busy_ms / decode_ms,
            "decode_step_kernel_names": len(by_kernel),
            "decode_step_top_kernels_ms": dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:8]),
            "seconds": time.perf_counter() - t}


def moe_layer_card_vs_cpu(device) -> dict:
    """lm_moe (b): one MoE layer of MOE_ARCH at full width (1.26 B
    parameters), weights drawn on the card from a seeded generator and
    copied to the CPU; a seeded hidden state MOE_XDEV_SHAPE and cotangent
    r. Forward with the aux loss, then the gradients of Σ out·r + aux
    (every weight and the input), on both devices. The expert ids equal
    wherever a token's routing gaps (between its first k + 1 sorted
    probabilities, on the CPU) exceed MOE_ROUTE_MARGIN, the keep mask on
    every row whose tokens all do; out, aux and each gradient leaf within
    MOE_XDEV_TOL."""
    import torch
    from torch import nn

    from repro_torch.configs import get_arch
    from repro_torch.models import ffn

    t = time.perf_counter()
    cfg = get_arch(MOE_ARCH)
    g = torch.Generator(device=device).manual_seed(LM_SEED)
    card = ffn.init_moe(cfg, g, device)
    b, s = MOE_XDEV_SHAPE
    x = torch.randn((b, s, cfg.d_model), generator=g, device=device)
    r = torch.randn((b, s, cfg.d_model), generator=g, device=device)
    cpu = nn.ParameterDict({k: nn.Parameter(v.detach().cpu())
                            for k, v in card.items()})
    cap = ffn.capacity(cfg, s, 8)
    res = {}
    for name, p in (("card", card), ("cpu", cpu)):
        t1 = time.perf_counter()
        xx = x.to(p["router"].device).requires_grad_()
        out, aux = ffn.moe_forward(cfg, p, xx, return_aux=True)
        leaves = list(p.values()) + [xx]
        grads = torch.autograd.grad(
            (out * r.to(xx.device)).sum() + aux, leaves)
        with torch.no_grad():
            route = ffn.route(cfg, p, xx, cap)
        res[name] = {"out": out.detach().cpu(), "aux": float(aux.detach()),
                     "grads": dict(zip(list(p) + ["x"],
                                       (gg.cpu() for gg in grads))),
                     "route": route, "s": time.perf_counter() - t1}
        del out, grads, leaves
    c, k = res["cpu"], cfg.top_k
    top = torch.sort(c["route"].probs, dim=-1, descending=True).values
    gaps = (top[..., :k] - top[..., 1:k + 1]).amin(-1)           # [b, s]
    sure = gaps > MOE_ROUTE_MARGIN
    ids = [res[n]["route"].expert.cpu().reshape(b, s, k) for n in res]
    keeps = [res[n]["route"].keep.cpu() for n in res]
    rows = sure.all(1)
    ids_equal = bool((ids[0] == ids[1])[sure].all())
    keep_equal = bool((keeps[0] == keeps[1])[rows].all())
    out_err = float((res["card"]["out"] - c["out"]).abs().max()
                    / c["out"].abs().max())
    aux_err = abs(res["card"]["aux"] - c["aux"]) / abs(c["aux"])
    grad_err = {n: float((res["card"]["grads"][n] - gc).abs().max()
                         / gc.abs().max())
                for n, gc in c["grads"].items()}
    drops = [int(res[n]["route"].drops.sum()) for n in res]
    aux = [res[n]["aux"] for n in res]
    secs = {f"{n}_s": res[n]["s"] for n in res}
    del card, cpu, res, x, r
    torch.cuda.empty_cache()
    out = {"shape": [b, s], "cap": cap, "params": cfg.d_model * cfg.n_experts
           + 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff,
           "tokens_routing_sure": int(sure.sum()), "tokens": b * s,
           "rows_all_sure": int(rows.sum()), "min_routing_gap": float(
               gaps.min()), "ids_equal_where_sure": ids_equal,
           "keep_equal_on_sure_rows": keep_equal,
           "drops_card_cpu": drops, "out_err_of_max": out_err,
           "aux_card_cpu": aux, "aux_rel_err": aux_err,
           "grad_err_of_max": grad_err, "tol": MOE_XDEV_TOL, **secs,
           "seconds": time.perf_counter() - t}
    require(ids_equal and keep_equal and int(rows.sum()) > 0,
            f"lm_moe: card vs CPU routing differs: {out}")
    require(out_err <= MOE_XDEV_TOL["out"] and aux_err <= MOE_XDEV_TOL["aux"]
            and max(grad_err.values()) <= MOE_XDEV_TOL["grad"],
            f"lm_moe: card vs CPU beyond MOE_XDEV_TOL: {out}")
    return out


def moe_train_bound(cfg, lm, n_params: int, tokens: int) -> dict:
    """Least time of a training step over TRAIN_ACCUM microbatches of
    `tokens` tokens in all: operations 3 × a forward's (`moe_work` at the
    microbatch's shape, the untied head over every position; remat's
    recompute not counted) at FP32_FLOP_PER_S, and the optimizer's bytes
    (p, g, m, v read, p, m, v written: 28 B a parameter) at
    HBM_BYTES_PER_S, the larger; and the same over the useful work."""
    b = TRAIN_BATCH // TRAIN_ACCUM
    w = moe_work(cfg, lm, b, TRAIN_SEQ)
    head = 2 * cfg.d_model * cfg.vocab_size * b * TRAIN_SEQ
    layers = len(lm.block_types)
    score = 4 * layers * cfg.n_heads * cfg.hd * b * TRAIN_SEQ ** 2 / 2
    ops = 3 * TRAIN_ACCUM * (w["expert_ops"] + w["dense_ops"] + head + score)
    useful = 3 * TRAIN_ACCUM * (w["useful_expert_ops"] + w["dense_ops"]
                                + head + score)
    opt_bytes = 28 * n_params
    ms = max(ops / FP32_FLOP_PER_S, opt_bytes / HBM_BYTES_PER_S) * 1e3
    return {"bound_ms": ms, "bound_ops": ops, "bound_bytes": opt_bytes,
            "bound_by": ("operations" if ops / FP32_FLOP_PER_S
                         >= opt_bytes / HBM_BYTES_PER_S else "bytes"),
            "useful_ops": useful,
            "useful_bound_ms": max(useful / FP32_FLOP_PER_S,
                                   opt_bytes / HBM_BYTES_PER_S) * 1e3,
            "cap": w["cap"], "slot_rows_per_layer": w["slot_rows_per_layer"],
            "assignments_per_layer": w["assignments_per_layer"]}


def moe_resume(batches, device) -> dict:
    """Resume ≡ uninterrupted on MOE_ARCH at full width cut to
    MOE_RESUME_LAYERS layers (float32 moments, grad_accum TRAIN_ACCUM):
    `resume_on_card`."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.train import AdamWConfig, TrainConfig

    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_RESUME_LAYERS)
    tc = TrainConfig(opt=AdamWConfig(), grad_accum=TRAIN_ACCUM)
    return resume_on_card(cfg, tc, batches, device, "lm_moe")


def resume_on_card(cfg, tc, batches, device, what: str,
                   prepare=None) -> dict:
    """Resume ≡ uninterrupted on the model of `cfg` built on the card from
    LM_SEED (then `prepare(model)`, where given), trained under `tc` on 4
    `batches`: 2 steps, a copy of every
    state leaf on the card (the checkpoint; the file path is
    `lm_train`'s), 2 more steps (the uninterrupted run); then the copy
    restored into the live state — the uninterrupted state taking its
    place, leaf by leaf — and the same 2 steps again. Both runs' steps
    3–4: every state leaf and loss bit for bit (LM_TRAIN_RESUME_TOL)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.train import make_init_state, make_train_step

    t = time.perf_counter()
    model = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    if prepare is not None:
        prepare(model)
    state = make_init_state(model, tc)
    step = make_train_step(model, tc)
    for b in batches[:2]:
        state, _ = step(state, b)
    leaves = state_leaves(state)
    saved = {k: v.detach().clone() for k, v in leaves.items()}
    straight = []
    for b in batches[2:]:
        state, met = step(state, b)
        straight.append(met["loss"])
    with torch.no_grad():
        for k, v in leaves.items():
            done = v.detach().clone()
            v.copy_(saved[k])
            saved[k] = done
    resumed = []
    for b in batches[2:]:
        state, met = step(state, b)
        resumed.append(met["loss"])
    with torch.no_grad():
        err = max(float((v.float() - saved[k].float()).abs().max())
                  for k, v in leaves.items())
        same = all(torch.equal(v, saved[k]) for k, v in leaves.items())
    loss_err = max(abs(float(a) - float(b))
                   for a, b in zip(straight, resumed))
    state_bytes = tree_bytes(state)
    del state, step, model, leaves, saved
    torch.cuda.empty_cache()
    res = {"layers": cfg.n_layers, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "mtp": cfg.mtp,
           "moments": tc.opt.moment_dtype, "grad_accum": tc.grad_accum,
           "state_bytes_p_m_v": state_bytes,
           "steps_3_4_max_abs_diff": err, "steps_3_4_loss_abs_diff": loss_err,
           "steps_3_4_bitwise": same and loss_err == 0.0,
           "tol": LM_TRAIN_RESUME_TOL,
           "losses_3_4": [float(x) for x in straight],
           "seconds": time.perf_counter() - t}
    require(same and err <= LM_TRAIN_RESUME_TOL
            and loss_err <= LM_TRAIN_RESUME_TOL,
            f"{what}: resumed steps 3-4 differ from the uninterrupted run: "
            f"{res}")
    return res


TORCH_PEAKS = {"allocated": [0], "reserved": [0]}  # before each reset


def reset_peak() -> None:
    """Start a phase's own torch peak (`torch.cuda.max_memory_allocated`),
    keeping the run's so far in TORCH_PEAKS for the `memory` line."""
    import torch

    TORCH_PEAKS["allocated"].append(torch.cuda.max_memory_allocated())
    TORCH_PEAKS["reserved"].append(torch.cuda.max_memory_reserved())
    torch.cuda.reset_peak_memory_stats()


def train_run(cfg, tc, bound_fn, device, what: str, steps: int = TRAIN_STEPS,
              prepare=None, inspect=None, profile: bool = True):
    """`steps` steps under `tc` of the model of `cfg` (float32, TF32 off,
    remat) built on `device` from LM_SEED (then `prepare(model)`, where
    given), on one seeded [TRAIN_BATCH, TRAIN_SEQ] batch (with, for a
    model that cross-attends, one seeded stub memory `cross_memory` that
    every batch shares): every metric
    (loss, ce, aux and, with an MTP head, mtp_ce) finite, the last loss
    below the first; step ms (median of steps 2 on) and tokens/s beside
    the step's bound (`bound_fn(model, n_params)`); a step under torch's
    sync debug mode "error"; with `profile`, one step's device time by
    kernel and idle share; the state's bytes and the run's peak
    allocation; where given,
    `inspect(model, state)`'s checks of the state after the steps, merged
    into the record. Returns (the record, 4 seeded batches for a resume
    check)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.train import make_init_state, make_train_step

    require(cfg.remat, f"{what}: remat is off")
    reset_peak()
    rng = np.random.default_rng(LM_SEED)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(
        device)} for _ in range(4)]
    batch = batches[0]
    model = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    if model.has_cross:
        enc = cross_memory(cfg, TRAIN_BATCH, device)
        for b in batches:
            b["enc"] = enc
    if prepare is not None:
        prepare(model)
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    state = make_init_state(model, tc)
    step = make_train_step(model, tc)
    mets, step_ms = {}, []
    for _ in range(steps):
        (state, met), ms = wall_ms(lambda: step(state, batch))
        for k, v in met.items():
            mets.setdefault(k, []).append(v)
        step_ms.append(ms)
    mets = {k: [float(x) for x in torch.stack(v).cpu()]
            for k, v in mets.items()}
    losses = mets["loss"]
    require(all(np.isfinite(sum(mets.values(), [])))
            and losses[-1] < losses[0],
            f"{what}: metrics {mets} not finite or the loss not falling")
    ms = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound = bound_fn(model, n_params)
    checked = {} if inspect is None else inspect(model, state)
    t_prof = time.perf_counter()
    state, _ = without_host_sync(lambda: step(state, batch))
    by_kernel = (kernel_breakdown(lambda: step(state, batch), iters=1,
                                  warm=True) if profile else {})
    prof_s = time.perf_counter() - t_prof
    busy_ms = sum(by_kernel.values()) if profile else "not measured"
    moment_bytes = tree_bytes(state["opt"]["m"]) + tree_bytes(
        state["opt"]["v"])
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    del state, step, model
    torch.cuda.empty_cache()
    extra = {k: v for k, v in mets.items() if k not in ("loss", "aux")}
    return {"layers": cfg.n_layers, "params": n_params, "steps": steps,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "grad_accum": tc.grad_accum, "remat": cfg.remat,
            "lr": tc.opt.lr, "moments": tc.opt.moment_dtype,
            "losses": losses, "aux": mets["aux"], **extra,
            "step_ms": step_ms,
            "step_ms_median_2_on": ms, "tokens_per_s": tokens / ms * 1e3,
            **bound, "share_of_bound": bound["bound_ms"] / ms,
            "step_host_syncs": 0, "sync_debug_and_profile_s": prof_s,
            "step_device_busy_ms": busy_ms,
            "step_idle_share": (1.0 - busy_ms / ms if profile
                                else "not measured"),
            "step_kernel_names": len(by_kernel),
            "step_top_kernels_ms": dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:8]),
            "state_bytes_p_g_m_v": 2 * param_bytes + moment_bytes,
            "torch_max_allocated_mib": peak / 2**20,
            "torch_max_reserved_mib": reserved / 2**20, **checked}, batches


def moe_train(device) -> dict:
    """lm_moe (c): MOE_ARCH at full width cut to MOE_TRAIN_LAYERS layers,
    `train_run` with float32 moments, lr 3e-4 and grad_accum TRAIN_ACCUM
    (cap 16 an expert a row), its bound `moe_train_bound`; then
    `moe_resume` (MOE_RESUME_LAYERS layers)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.train import AdamWConfig, TrainConfig

    t = time.perf_counter()
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    tc = TrainConfig(opt=AdamWConfig(), grad_accum=TRAIN_ACCUM)
    res, batches = train_run(
        cfg, tc, lambda model, n: moe_train_bound(
            cfg, model, n, TRAIN_BATCH * TRAIN_SEQ), device, "lm_moe")
    res["resume"] = moe_resume(batches, device)
    res["seconds"] = time.perf_counter() - t
    return res


def run_lm_moe(device, doc_ids) -> None:
    """lm_moe, last (TF32 off): `moe_serve`, `moe_layer_card_vs_cpu` and
    `moe_train`, each on a card holding none of the earlier phases'
    models."""
    import torch

    t = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    serve = moe_serve(device, doc_ids)
    layer = moe_layer_card_vs_cpu(device)
    train = moe_train(device)
    emit({"phase": "lm_moe", "arch": MOE_ARCH,
          "allocated_at_start_mib": held / 2**20, "serve": serve,
          "layer_card_vs_cpu": layer, "train": train,
          "seconds": time.perf_counter() - t})


MLA_ARCH = "deepseek-v3-671b"
# cuts at full width, float32, by layers and experts only (the registry's
# widths): an MLA block is 187,107,328 parameters, a dense-prefix block
# 583,483,392, a 256-expert MoE block 11,507,286,016 (46.0 GB), the untied
# embedding and head 1,853,358,080. Serving: the 3 dense-prefix layers and
# the first MoE layer of 61, without the MTP block (prefill and decode never
# read it): 15,111,101,440 parameters, 60.4 GB.
MLA_SERVE_LAYERS = 4
MLA_DECODE = 8             # greedy tokens after the rag phase's 18 a row
# training: 1 dense and 1 MoE layer plus the MTP block, 16 of 256 experts
# (top-8 and the shared expert kept): 4,411,455,488 parameters; float32
# moments would peak ≈ 93 GB, int8 ones ≈ 62 GB
MLA_TRAIN_LAYERS = 2
MLA_TRAIN_EXPERTS = 16
MLA_MOMENTS = "int8"
# resume ≡ uninterrupted at the smallest cut with a top-8 MoE block and the
# MTP block: 1 MoE layer and the MTP block, 16 experts (3,827,972,096
# parameters); its state and the state's copy (23.2 GB each) fit beside a
# step at grad_accum 1, not at 2 (another 15.3 GB accumulator)
MLA_RESUME_LAYERS = 1
MLA_RESUME_ACCUM = 1
MLA_XDEV_SHAPE = (2, 32)   # one full-width MLA + dense block's input
# card vs CPU on that block, each × its CPU max |.| (float32 both, TF32 off):
# the prefill's output and latent cache, the absorbed decode's output and
# cache, every gradient leaf of Σ out·r in train mode
MLA_XDEV_TOL = {"prefill": 1e-4, "decode": 1e-4, "grad": 1e-4}
# AdamW's bytes a parameter under int8 moments: p read and written, the
# float32 gradient read, m and v read and written at 1 B and their float32
# scale a block of 128 (4 · 4/128 B)
INT8_OPT_BYTES = 4 + 4 + 4 + 4 * 1 + 4 * 4 / 128


def mla_work(cfg, blocks, b: int, s: int) -> dict:
    """Operations of one forward over [b, s] tokens through `blocks`
    ((block type, block) pairs, MLA mixers), per-row dispatch: the
    projections (every block weight but the routed experts', 2 operations
    a weight a token), the expert products over the padded [b, E, cap, d]
    buffers (as `ffn._moe` computes them) and over the b·s·k assignments
    alone, and the causal attention over materialised K/V (q·k width nope
    + rope, v width v_head_dim: a prefill's or a training step's; a decode
    step's, over the latent cache, is the caller's)."""
    from repro_torch.models.ffn import capacity

    d, f, e, k = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s, 8)
    routed = 3 * e * d * f
    proj = sum(sum(p.numel() for p in bp.parameters())
               - (routed if bt.ffn == "moe" else 0) for bt, bp in blocks)
    n_moe = sum(bt.ffn == "moe" for bt, _ in blocks)
    slot_ops = 2 * 3 * d * f
    qk, vd = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return {"cap": cap, "slot_rows_per_moe_layer": b * e * cap,
            "assignments_per_moe_layer": b * s * k,
            "dense_ops": 2 * proj * b * s,
            "expert_ops": n_moe * slot_ops * b * e * cap,
            "useful_expert_ops": n_moe * slot_ops * b * s * k,
            "attn_ops": (len(blocks) * b * cfg.n_heads * 2 * (qk + vd)
                         * s * s / 2)}


def mla_cache_bytes(cfg, layers: int) -> dict:
    """Cache bytes a token: MLA's latent (kv_lora + rope values a layer)
    against gqa K/V at the same heads of 128."""
    lat = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4
    gqa = 2 * cfg.n_heads * 128 * 4
    return {"mla_cache_bytes_per_token_layer": lat,
            "mla_cache_bytes_per_token": lat * layers,
            "gqa_kv_bytes_per_token_layer": gqa,
            "gqa_kv_bytes_per_token": gqa * layers,
            "gqa_over_mla": gqa / lat}


def mla_serve_bounds(cfg, lm, param_bytes: int, b: int, s: int,
                     ctx: int) -> dict:
    """Least times of an absorbed decode step (one token a row, `ctx`
    cached slots) and of a prefill of [b, s]: every weight read once (each
    expert for its padded slots) and, in decode, the latent cache, at
    HBM_BYTES_PER_S; the operations of the function (`mla_work`, the head
    at the last position, decode's scores and values over the latent) at
    FP32_FLOP_PER_S; beside them the useful work's (the b·s·k
    assignments)."""
    blocks = list(zip(lm.block_types, lm.layers))
    lat = cfg.kv_lora_rank + cfg.qk_rope_dim
    head = 2 * cfg.d_model * cfg.vocab_size * b
    out = {}
    for name, ss in (("decode", 1), ("prefill", s)):
        w = mla_work(cfg, blocks, b, ss)
        if name == "decode":
            attn = (len(blocks) * b * cfg.n_heads * ctx
                    * 2 * (lat + cfg.kv_lora_rank))
            extra = len(blocks) * b * ctx * lat * 4
        else:
            attn, extra = w["attn_ops"], 0
        ops = w["expert_ops"] + w["dense_ops"] + attn + head
        useful = w["useful_expert_ops"] + w["dense_ops"] + attn + head
        out[name] = {
            "cap": w["cap"],
            "slot_rows_per_moe_layer": w["slot_rows_per_moe_layer"],
            "assignments_per_moe_layer": w["assignments_per_moe_layer"],
            "weight_bound_ms": (param_bytes + extra) / HBM_BYTES_PER_S * 1e3,
            "ops": ops, "work_bound_ms": ops / FP32_FLOP_PER_S * 1e3,
            "expert_ops": w["expert_ops"], "useful_ops": useful,
            "useful_work_bound_ms": useful / FP32_FLOP_PER_S * 1e3,
            "padded_expert_work_x": w["expert_ops"] / w["useful_expert_ops"]}
    return out


def mla_serve(device, doc_ids) -> dict:
    """lm_mla (a): MLA_ARCH at full width cut to MLA_SERVE_LAYERS layers
    and built without the MTP block (15.10 B parameters, 60.4 GB), on the
    card from a seeded generator; the rag phase's 16 requests' ids and 8
    prompt tokens prefilled, MLA_DECODE greedy decode steps over the
    latent cache (absorbed): `serve_decode_checks` — decode ≡ the
    teacher-forced prefill within LM_TOL at capacity factor E/k (32: no
    drop possible), drops a row at the published 1.25. Prefill ms (CUDA
    events) and decode ms a token (host clock, median of 3 runs) beside
    the weight-read and padded-work bounds; a decode step's device time by
    kernel; the latent cache's bytes a token beside gqa K/V's."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    t = time.perf_counter()
    reset_peak()
    published = dataclasses.replace(get_arch(MLA_ARCH),
                                    n_layers=MLA_SERVE_LAYERS, mtp=False)
    tokens = rag_tokens(doc_ids, published.vocab_size, device)
    b, s = tokens.shape
    checks, lm, run = serve_decode_checks(published, tokens, device,
                                          MLA_DECODE, MLA_DECODE, "lm_mla")
    cfg = published
    require(not hasattr(lm, "mtp_block")
            and all(bt.mixer == "mla" for bt in lm.block_types),
            "lm_mla: the serving model is not MLA without an MTP block")
    n_params = sum(p.numel() for p in lm.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    cache_shapes = {n: list(c.shape) for n, c in
                    lm.init_cache(1, 1)[0].items()}
    prefill_ms, decode_ms, by_kernel = serve_timing(lm, tokens, run,
                                                    MLA_DECODE)
    bounds = mla_serve_bounds(cfg, lm, param_bytes, b, s, s + MLA_DECODE)
    peak = torch.cuda.max_memory_allocated()
    del lm, run
    torch.cuda.empty_cache()
    busy_ms = sum(by_kernel.values())
    dec, pre = bounds["decode"], bounds["prefill"]
    return {"layers": cfg.n_layers, "of_layers": get_arch(MLA_ARCH).n_layers,
            "dense_prefix_layers": cfg.first_dense_layers, "mtp": cfg.mtp,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "q_lora": cfg.q_lora_rank, "kv_lora": cfg.kv_lora_rank,
            "rope": cfg.qk_rope_dim, "nope": cfg.qk_nope_dim,
            "v_head": cfg.v_head_dim, "d_ff": cfg.d_ff,
            "experts": cfg.n_experts, "top_k": cfg.top_k,
            "shared_experts": cfg.n_shared_experts,
            "moe_d_ff": cfg.moe_d_ff, "vocab": cfg.vocab_size,
            "params": n_params, "param_bytes": param_bytes,
            "cache_leaf_shapes_b1_s1": cache_shapes,
            **mla_cache_bytes(cfg, cfg.n_layers),
            "batch": b, "prompt_tokens": s, "decoded": MLA_DECODE,
            "decode_vs_prefill_tol": LM_TOL,
            "decode_vs_prefill": checks,
            "prefill_ms": prefill_ms,
            "prefill_weight_bound_ms": pre["weight_bound_ms"],
            "prefill_work_bound_ms": pre["work_bound_ms"],
            "decode_ms_per_token": decode_ms,
            "decode_ms_per_token_per_request": decode_ms / b,
            "decode_weight_bound_ms": dec["weight_bound_ms"],
            "decode_work_bound_ms": dec["work_bound_ms"],
            "decode_share_of_bound": max(dec["weight_bound_ms"],
                                         dec["work_bound_ms"]) / decode_ms,
            "bounds": bounds,
            "decode_step_device_busy_ms": busy_ms,
            "decode_step_idle_share": 1.0 - busy_ms / decode_ms,
            "decode_step_kernel_names": len(by_kernel),
            "decode_step_top_kernels_ms": dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:8]),
            "torch_max_allocated_mib": peak / 2**20,
            "seconds": time.perf_counter() - t}


def rel_err(got, want) -> float:
    """max |got − want| over max |want| (want on the CPU)."""
    return float((got.cpu() - want).abs().max() / want.abs().max())


def mla_block_card_vs_cpu(device) -> dict:
    """lm_mla (b): one MLA + dense block of MLA_ARCH at full width
    (583,483,392 parameters), weights drawn on the card from a seeded
    generator and copied to the CPU; a seeded hidden state MLA_XDEV_SHAPE
    [B, S], one more token and a cotangent r. On both devices: the
    prefill (output, latent cache), an absorbed decode of the next token
    at position S into a cache of capacity S + 1 (output, both cache
    leaves), and in train mode the gradients of Σ out·r with respect to
    every weight and the input; each within MLA_XDEV_TOL of the CPU's max
    |.|."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import (BlockApplier, BlockType, Ctx,
                                                _init_block)

    t = time.perf_counter()
    cfg = get_arch(MLA_ARCH)
    bt = BlockType("mla")
    g = torch.Generator(device=device).manual_seed(LM_SEED)
    card = _init_block(cfg, bt, g, device)
    cpu = _init_block(cfg, bt, None, "cpu")
    cpu.load_state_dict(card.state_dict())
    b, s = MLA_XDEV_SHAPE
    x = torch.randn((b, s + 1, cfg.d_model), generator=g, device=device)
    r = torch.randn((b, s, cfg.d_model), generator=g, device=device)
    applier = BlockApplier(cfg)
    res = {}
    for name, blk in (("card", card), ("cpu", cpu)):
        t1 = time.perf_counter()
        dev = next(blk.parameters()).device
        xx = x.to(dev)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        with torch.no_grad():
            out, part, _ = applier(bt, blk, xx[:, :s],
                                   Ctx("prefill", positions=positions))
            cache = {n: torch.zeros((b, s + 1) + c.shape[2:], device=dev)
                     for n, c in part.items()}
            for n, c in part.items():
                cache[n][:, :s] = c
            pos = torch.full((b,), s, dtype=torch.int32, device=dev)
            dec, cache, _ = applier(bt, blk, xx[:, s:], Ctx("decode", pos=pos),
                                    cache)
        xg = xx[:, :s].clone().requires_grad_()
        out_t, _, _ = applier(bt, blk, xg, Ctx("train", positions=positions))
        names = [n for n, _ in blk.named_parameters()] + ["x"]
        grads = torch.autograd.grad((out_t * r.to(dev)).sum(),
                                    list(blk.parameters()) + [xg])
        res[name] = {"prefill": {"out": out, **part},
                     "decode": {"out": dec, **cache},
                     "grad": dict(zip(names, grads)),
                     "s": time.perf_counter() - t1}
        del out_t, grads
    c = res["cpu"]
    err = {what: {n: rel_err(res["card"][what][n], want)
                  for n, want in c[what].items()}
           for what in ("prefill", "decode", "grad")}
    secs = {f"{n}_s": res[n]["s"] for n in res}
    n_params = sum(p.numel() for p in card.parameters())
    del card, cpu, res, x, r
    torch.cuda.empty_cache()
    out = {"shape": [b, s], "params": n_params,
           "err_of_max": err, "tol": MLA_XDEV_TOL, **secs,
           "seconds": time.perf_counter() - t}
    require(all(max(err[w].values()) <= MLA_XDEV_TOL[w] for w in err),
            f"lm_mla: card vs CPU beyond MLA_XDEV_TOL: {out}")
    return out


def mla_train_bound(cfg, model, n_params: int) -> dict:
    """Least time of a training step with the MTP head over TRAIN_ACCUM
    microbatches: operations 3 × a forward's (`mla_work` over the layers
    and the MTP block at the microbatch's shape, mtp_proj, the head over
    every position twice — ce and mtp_ce —; remat's recompute not
    counted) at FP32_FLOP_PER_S, and AdamW's bytes (INT8_OPT_BYTES a
    parameter) at HBM_BYTES_PER_S, the larger; and the same over the
    useful work."""
    b = TRAIN_BATCH // TRAIN_ACCUM
    tok = b * TRAIN_SEQ
    blocks = list(zip(model.block_types, model.layers)) + [
        (model.mtp_type, model.mtp_block)]
    w = mla_work(cfg, blocks, b, TRAIN_SEQ)
    rest = (w["dense_ops"] + w["attn_ops"] + 2 * model.mtp_proj.numel() * tok
            + 2 * 2 * cfg.d_model * cfg.vocab_size * tok)
    ops = 3 * TRAIN_ACCUM * (w["expert_ops"] + rest)
    useful = 3 * TRAIN_ACCUM * (w["useful_expert_ops"] + rest)
    opt_bytes = INT8_OPT_BYTES * n_params
    t_ops, t_bytes = ops / FP32_FLOP_PER_S, opt_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3, "bound_ops": ops,
            "bound_bytes": opt_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "useful_ops": useful,
            "useful_bound_ms": max(useful / FP32_FLOP_PER_S, t_bytes) * 1e3,
            "cap": w["cap"],
            "slot_rows_per_moe_layer": w["slot_rows_per_moe_layer"],
            "assignments_per_moe_layer": w["assignments_per_moe_layer"]}


def mla_train(device) -> dict:
    """lm_mla (c): MLA_ARCH at full width cut to MLA_TRAIN_LAYERS layers
    (one dense, one MoE) with the MTP block, MLA_TRAIN_EXPERTS experts
    (top-8, the shared expert kept); `train_run` with MLA_MOMENTS moments,
    lr 3e-4, grad_accum TRAIN_ACCUM (cap 48 an expert a row), its bound
    `mla_train_bound`; then resume ≡ uninterrupted bit for bit at
    MLA_RESUME_LAYERS (one MoE layer and the MTP block, grad_accum
    MLA_RESUME_ACCUM): the check the MoE dispatch's deterministic backward
    exists for, a token's 8 dispatch gradients summed in slot order."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.train import AdamWConfig, TrainConfig

    t = time.perf_counter()
    arch = get_arch(MLA_ARCH)
    cfg = dataclasses.replace(arch, n_layers=MLA_TRAIN_LAYERS,
                              first_dense_layers=1,
                              n_experts=MLA_TRAIN_EXPERTS)
    require(cfg.mtp and cfg.top_k == 8 and cfg.n_shared_experts == 1,
            "lm_mla: the training cut lost MTP, top-8 or the shared expert")
    opt = AdamWConfig(moment_dtype=MLA_MOMENTS)
    res, batches = train_run(
        cfg, TrainConfig(opt=opt, grad_accum=TRAIN_ACCUM),
        lambda model, n: mla_train_bound(cfg, model, n), device, "lm_mla")
    res.update(dense_prefix_layers=cfg.first_dense_layers,
               experts=cfg.n_experts, of_experts=arch.n_experts,
               top_k=cfg.top_k, mtp=cfg.mtp)
    rcfg = dataclasses.replace(arch, n_layers=MLA_RESUME_LAYERS,
                               first_dense_layers=0,
                               n_experts=MLA_TRAIN_EXPERTS)
    res["resume"] = resume_on_card(
        rcfg, TrainConfig(opt=opt, grad_accum=MLA_RESUME_ACCUM), batches,
        device, "lm_mla")
    res["seconds"] = time.perf_counter() - t
    return res


def run_lm_mla(device, doc_ids) -> None:
    """lm_mla, last (TF32 off): `mla_serve`, `mla_block_card_vs_cpu` and
    `mla_train`, each on a card holding none of the earlier phases'
    models."""
    import torch

    t = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    serve = mla_serve(device, doc_ids)
    block = mla_block_card_vs_cpu(device)
    train = mla_train(device)
    emit({"phase": "lm_mla", "arch": MLA_ARCH,
          "allocated_at_start_mib": held / 2**20, "serve": serve,
          "block_card_vs_cpu": block, "train": train,
          "seconds": time.perf_counter() - t})


SSM_ARCH = "mamba2-2.7b"
HYB_ARCH = "zamba2-2.7b"
# full width and full depth, float32: mamba2-2.7b 2,830,951,936 parameters
# (11.32 GB), zamba2-2.7b 3,130,219,168 (12.52 GB; 707,811,840 of them the
# never-read norm2 / FFN of its 9 shared_attn positions)
SSM_DECODE = 8             # greedy tokens after the rag phase's 18 a row
SSM_XDEV_SHAPE = (2, 512)  # one full-width Mamba2 block's input: 2 chunks
SSM_XDEV_STEPS = 3         # decode steps from that block's prefill state
HYB_XDEV_SHAPE = (2, 64)   # one full-width zamba2 group's tokens
# card vs CPU, each × its CPU max |.| (float32 both, TF32 off): the block's
# prefill output and state {h, conv}, its decode steps' outputs and state,
# every gradient leaf of Σ out·r; the group's loss (relative) and every
# gradient leaf
SSM_XDEV_TOL = {"prefill": 1e-4, "decode": 1e-4, "grad": 1e-4,
                "loss": 1e-5}
# exp overflows float32 past ln(FLT_MAX): where the reference's SSD takes
# exp of the whole [Q, Q] square, an exponent above it above the diagonal
# is inf and its backward NaN
FLT_MAX_LOG = 88.72283935546875
# a profile of one full-depth mamba2 training step took 19 s of
# torch.profiler's own time on an H100 machine (the card busy 0.25 of the
# step); zamba2's 2-group step, the same kernels, is profiled instead
SSM_TRAIN_PROFILE = False
HYB_TRAIN_GROUPS = 2       # the shared block's gradient sums two uses
HYB_TRAIN_STEPS = 4
HYB_RESUME_GROUPS = 1      # one group holds both mixers


def ssm_redraw(model, generator) -> None:
    """Mamba2's published initialisation of the leaves the reference
    draws as constants (arXiv:2405.21060; its reference code's defaults),
    in place from `generator`, in every SSM mixer of `model`: the
    depthwise convolutions uniform in ±1/√k (a convolution's default),
    A = exp(a_log) uniform in [1, 16], dt_bias the inverse softplus of a
    dt log-uniform in [1e-3, 0.1]; d_skip 1 and the gated norm's scale 0
    stay. The reference's zero convolutions make every mixer output 0, so
    a serving or training check on them would pass whatever the SSD
    computes."""
    import torch

    with torch.no_grad():
        for name, mod in model.named_modules():
            if not name.endswith("mixer"):
                continue
            k = mod["conv_x"].shape[0]
            for leaf in ("conv_x", "conv_B", "conv_C"):
                w = mod[leaf]
                w.copy_((torch.rand(w.shape, generator=generator,
                                    device=w.device) * 2 - 1) * k ** -0.5)
            h = mod["a_log"].shape[0]
            a = 1 + 15 * torch.rand(h, generator=generator,
                                    device=mod["a_log"].device)
            mod["a_log"].copy_(torch.log(a))
            dt = torch.exp(np.log(1e-3) + (np.log(0.1) - np.log(1e-3))
                           * torch.rand(h, generator=generator,
                                        device=a.device))
            mod["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))


def ssm_model(cfg, device):
    """The model of `cfg` on `device` from LM_SEED, `ssm_redraw`n from the
    same generator."""
    import torch

    from repro_torch.models import build_model

    g = torch.Generator(device=device).manual_seed(LM_SEED)
    lm = build_model(cfg, device=device, generator=g)
    ssm_redraw(lm, g)
    return lm


def applied_weights(lm) -> int:
    """The weights a token passes through in the layers: each layer's
    block, the shared block at each shared_attn position (in place of the
    position's own leaves)."""
    return sum(sum(p.numel() for p in (
        lm.shared if bt.mixer == "shared_attn" else blk).parameters())
        for bt, blk in zip(lm.block_types, lm.layers))


def unread_leaves(lm) -> list:
    """The names of the hybrid's never-read leaves: the norm2 and FFN of
    every shared_attn position (the shared block's are read in their
    place)."""
    return [n for n, _ in lm.named_parameters()
            if n.startswith("layers.") and int(n.split(".")[1]) in {
                i for i, bt in enumerate(lm.block_types)
                if bt.mixer == "shared_attn"}
            and n.split(".")[2] in ("norm2", "ffn")]


def ssm_work(cfg, lm, b: int, s: int, ctx: int) -> dict:
    """Bytes and operations of a forward of `lm` over [b, s] tokens (s =
    1: a decode step at `ctx` cached slots). Bytes: every weight the
    function reads, once (the shared block once, however often it is
    applied; the never-read leaves not), and in decode the SSM state read
    and written and the K/V read. Operations: 2 a weight a token through
    each applied block (the shared block at each application), the head
    at the last position only; the SSD's intra-chunk products over one
    chunk of s (cb, cb·L, L·x), its inter-chunk read and state update (a
    decode step: the state's decay, outer product and read-out), and the
    shared attention's scores and values."""
    d, v = cfg.d_model, cfg.vocab_size
    di = cfg.ssm_expand * d
    h, p, n = di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    unread = set(unread_leaves(lm))
    read = sum(t.numel() * t.element_size()
               for k, t in lm.named_parameters() if k not in unread)
    body = applied_weights(lm)
    n_ssm = sum(bt.mixer == "ssm" for bt in lm.block_types)
    n_att = len(lm.block_types) - n_ssm
    state = (h * p * n * 4 + (cfg.ssm_conv - 1) * (di + 2 * n) * 4) * b
    kv = 2 * cfg.n_kv_heads * cfg.hd * 4 * b * ctx
    if s == 1:
        ssd = 6 * b * h * p * n
        att = 4 * cfg.n_heads * cfg.hd * b * ctx
        moved = read + n_ssm * 2 * state + n_att * kv
    else:
        ssd = (2 * b * s * s * n + b * s * s * h + 2 * b * s * s * h * p
               + 4 * b * s * h * p * n)
        att = 4 * cfg.n_heads * cfg.hd * b * s * s / 2
        moved = read
    ops = 2 * body * b * s + 2 * d * v * b + n_ssm * ssd + n_att * att
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": moved, "ops": ops,
            "byte_bound_ms": t_bytes * 1e3, "op_bound_ms": t_ops * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "read_param_bytes": read,
            "state_bytes_per_row_layer": state // b}


def ssm_cache_bytes(lm) -> dict:
    """The cache's bytes a row: the SSM layers' {h, conv} (whatever the
    length) and the attention layers' K/V a token; against olmo-1b's K/V
    a token, and the length at which olmo-1b's row passes this one's."""
    from repro_torch.configs import get_arch

    one = lm.init_cache(1, 1)
    state = sum(t.numel() * t.element_size() for c in one
                for k, t in c.items() if k in ("h", "conv"))
    kv = sum(t.numel() * t.element_size() for c in one
             for k, t in c.items() if k in ("k", "v"))
    olmo = get_arch(LM_ARCH)
    olmo_kv = 2 * olmo.n_layers * olmo.n_kv_heads * olmo.hd * 4
    return {"state_bytes_per_row": state, "kv_bytes_per_token": kv,
            "olmo_kv_bytes_per_token": olmo_kv,
            "olmo_passes_at_tokens": -(-state // olmo_kv)}


def ssm_serve(arch: str, device, doc_ids) -> dict:
    """lm_ssm (a): `arch` at full width and full depth (`ssm_model`); the
    rag phase's 16 requests' ids and 8 prompt tokens prefilled (one chunk
    of 18), SSM_DECODE greedy decode steps over the recurrent state (and
    zamba2's shared-block K/V): every step ≡ a teacher-forced prefill over
    the same prefix within LM_TOL on all 16 rows, greedy ids equal past
    that margin (`decode_vs_prefill`; no MoE, nothing drops). Prefill ms
    (CUDA events) and decode ms a token (host clock, median of 3 runs)
    beside their bounds (`ssm_work`); a decode step's device time by
    kernel and its launches; the cache's bytes a row."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.train import generate

    t = time.perf_counter()
    reset_peak()
    cfg = get_arch(arch)
    tokens = rag_tokens(doc_ids, cfg.vocab_size, device)
    b, s = tokens.shape
    lm = ssm_model(cfg, device)
    generate(lm, tokens, 2)                                    # warm-up
    torch.cuda.synchronize()
    stages = {"build_and_warm_up_s": time.perf_counter() - t}
    check, run = decode_vs_prefill(lm, tokens, SSM_DECODE, "lm_ssm")
    stages["decode_vs_prefill_s"] = time.perf_counter() - t - sum(
        stages.values())
    err = check["decode_vs_prefill_max_abs_err"]
    require(check["rows_compared_every_step"] == b
            and err is not None and err <= LM_TOL
            and check["greedy_agree_where_margin_gt_tol"] == 1.0,
            f"lm_ssm: {arch} decode vs teacher-forced prefill: {check}")
    n_params = sum(p.numel() for p in lm.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    launches = []
    prefill_ms, decode_ms, by_kernel = serve_timing(lm, tokens, run,
                                                    SSM_DECODE, launches)
    stages["timing_and_profiles_s"] = time.perf_counter() - t - sum(
        stages.values())
    dec = ssm_work(cfg, lm, b, 1, s + SSM_DECODE)
    pre = ssm_work(cfg, lm, b, s, s)
    peak = torch.cuda.max_memory_allocated()
    out = {"arch": arch, "layers": cfg.n_layers,
           "mixers": {m: sum(bt.mixer == m for bt in lm.block_types)
                      for m in ("ssm", "shared_attn")},
           "d_model": cfg.d_model, "d_inner": cfg.ssm_expand * cfg.d_model,
           "ssm_heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
           "head_dim": cfg.ssm_head_dim, "state": cfg.ssm_state,
           "conv": cfg.ssm_conv, "chunk": cfg.ssm_chunk,
           "vocab": cfg.vocab_size, "params": n_params,
           "param_bytes": param_bytes,
           "never_read_params": sum(
               p.numel() for n, p in lm.named_parameters()
               if n in set(unread_leaves(lm))),
           **ssm_cache_bytes(lm),
           "batch": b, "prompt_tokens": s, "decoded": SSM_DECODE,
           "decode_vs_prefill_tol": LM_TOL, "decode_vs_prefill": check,
           "prefill_ms": prefill_ms,
           "prefill_byte_bound_ms": pre["byte_bound_ms"],
           "prefill_op_bound_ms": pre["op_bound_ms"],
           "prefill_bound_by": pre["bound_by"],
           "decode_ms_per_token": decode_ms,
           "decode_ms_per_token_per_request": decode_ms / b,
           "decode_byte_bound_ms": dec["byte_bound_ms"],
           "decode_op_bound_ms": dec["op_bound_ms"],
           "decode_bound_by": dec["bound_by"],
           "decode_share_of_bound": dec["bound_ms"] / decode_ms,
           "decode_step_kernel_launches": launches[0],
           "decode_step_device_busy_ms": sum(by_kernel.values()),
           "decode_step_idle_share": 1.0 - sum(by_kernel.values()) / decode_ms,
           "decode_step_top_kernels_ms": dict(sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:8]),
           "torch_max_allocated_mib": peak / 2**20,
           "torch_max_reserved_mib": torch.cuda.max_memory_reserved() / 2**20,
           "stages": stages, "seconds": time.perf_counter() - t}
    del lm, run
    torch.cuda.empty_cache()
    return out


def ssm_block_card_vs_cpu(device) -> dict:
    """lm_ssm (b): one Mamba2 block of SSM_ARCH at full width (norm1 and
    the mixer, 40.21 M parameters), drawn on the card from a seeded
    generator (`ssm_redraw`n) and copied to the CPU; a seeded hidden state
    SSM_XDEV_SHAPE [B, S] (two chunks of 256), SSM_XDEV_STEPS more tokens
    and a cotangent r. On both devices: the prefill (output and state
    {h, conv}), SSM_XDEV_STEPS decode steps from that state (each
    output, the state after them), and in train mode the gradients of Σ
    out·r with respect to every weight and the input — all finite, each
    within SSM_XDEV_TOL of the CPU's max |.|. The largest exponent the
    reference's SSD would exponentiate above the diagonal (the decay
    summed over a chunk but its first step) is printed and must pass
    ln(FLT_MAX): there the reference's backward is NaN (departure (a) of
    `models/mamba2.py`)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.models.common import apply_norm
    from repro_torch.models.transformer import (BlockApplier, BlockType, Ctx,
                                                _init_block)

    t = time.perf_counter()
    cfg = get_arch(SSM_ARCH)
    bt = BlockType("ssm", ffn="none")
    g = torch.Generator(device=device).manual_seed(LM_SEED)
    card = _init_block(cfg, bt, g, device)
    ssm_redraw(card, g)
    cpu = _init_block(cfg, bt, None, "cpu")
    cpu.load_state_dict(card.state_dict())
    b, s = SSM_XDEV_SHAPE
    x = torch.randn((b, s + SSM_XDEV_STEPS, cfg.d_model), generator=g,
                    device=device)
    r = torch.randn((b, s, cfg.d_model), generator=g, device=device)
    applier = BlockApplier(cfg)
    res = {}
    for name, blk in (("card", card), ("cpu", cpu)):
        t1 = time.perf_counter()
        dev = next(blk.parameters()).device
        xx = x.to(dev)
        with torch.no_grad():
            out, state, _ = applier(bt, blk, xx[:, :s], Ctx("prefill"))
            cache = {k: v.clone() for k, v in state.items()}
            outs = []
            for i in range(SSM_XDEV_STEPS):
                dec, cache, _ = applier(bt, blk, xx[:, s + i:s + i + 1],
                                        Ctx("decode"), cache)
                outs.append(dec)
            mx = blk["mixer"]
            dt = F.softplus(apply_norm(cfg, blk["norm1"], xx[:, :s])
                            @ mx["wdt"] + mx["dt_bias"])
            decay = (dt * torch.exp(mx["a_log"])).reshape(
                b, s // cfg.ssm_chunk, cfg.ssm_chunk, -1)
            upper = float(decay[:, :, 1:].sum(2).max())
        xg = xx[:, :s].clone().requires_grad_()
        out_t, _, _ = applier(bt, blk, xg, Ctx("train"))
        names = [n for n, _ in blk.named_parameters()] + ["x"]
        grads = torch.autograd.grad((out_t * r.to(dev)).sum(),
                                    list(blk.parameters()) + [xg])
        res[name] = {"prefill": {"out": out, **state},
                     "decode": {"out": torch.cat(outs, 1), **cache},
                     "grad": dict(zip(names, grads)),
                     "finite": all(bool(torch.isfinite(gg).all())
                                   for gg in grads),
                     "upper_exponent_max": upper,
                     "s": time.perf_counter() - t1}
        del out_t, grads
    c = res["cpu"]
    err = {what: {n: rel_err(res["card"][what][n], want)
                  for n, want in c[what].items()}
           for what in ("prefill", "decode", "grad")}
    upper = [res[n]["upper_exponent_max"] for n in res]
    finite = [res[n]["finite"] for n in res]
    secs = {f"{n}_s": res[n]["s"] for n in res}
    n_params = sum(p.numel() for p in card.parameters())
    del card, cpu, res, x, r
    torch.cuda.empty_cache()
    out = {"shape": [b, s], "chunk": cfg.ssm_chunk, "params": n_params,
           "decode_steps": SSM_XDEV_STEPS,
           "gradients_finite_card_cpu": finite,
           "upper_exponent_max_card_cpu": upper,
           "flt_max_log": FLT_MAX_LOG,
           "err_of_max": err, "tol": SSM_XDEV_TOL, **secs,
           "seconds": time.perf_counter() - t}
    require(all(finite), f"lm_ssm: a gradient is not finite: {out}")
    require(min(upper) > FLT_MAX_LOG,
            f"lm_ssm: the input does not reach the reference's overflow: "
            f"{out}")
    require(all(max(err[w].values()) <= SSM_XDEV_TOL[w] for w in err),
            f"lm_ssm: card vs CPU beyond SSM_XDEV_TOL: {out}")
    return out


def hyb_group_card_vs_cpu(device) -> dict:
    """lm_ssm (c): zamba2 at full width cut to one group (6 Mamba2 layers
    and the shared attention + MLP block, with the embedding and head),
    drawn on the card (`ssm_model`) and copied to the CPU; `loss` and
    every gradient over seeded HYB_XDEV_SHAPE tokens on both devices: the
    loss within SSM_XDEV_TOL["loss"] relative, each gradient leaf within
    SSM_XDEV_TOL["grad"] of the CPU's max |.|, the never-read leaves'
    gradients exactly 0 on both."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import DecoderLM
    from repro_torch.train import loss_and_grads

    t = time.perf_counter()
    arch = get_arch(HYB_ARCH)
    cfg = dataclasses.replace(arch, n_layers=arch.hybrid_period)
    card = ssm_model(cfg, device)
    cpu = DecoderLM(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    unread = unread_leaves(card)
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, HYB_XDEV_SHAPE).astype(np.int32))
    res = {}
    for name, lm in (("card", card), ("cpu", cpu)):
        t1 = time.perf_counter()
        loss, _, grads = loss_and_grads(lm, dict(lm.named_parameters()),
                                        {"tokens": tokens.to(lm.device)})
        res[name] = {"loss": float(loss), "s": time.perf_counter() - t1,
                     "grads": {k: v.cpu() for k, v in grads.items()}}
        del grads
    c = res["cpu"]
    grad_err = {k: rel_err(res["card"]["grads"][k], want)
                for k, want in c["grads"].items() if k not in unread}
    zero = all(not res[n]["grads"][k].any() for n in res for k in unread)
    loss_err = abs(res["card"]["loss"] - c["loss"]) / abs(c["loss"])
    out = {"shape": list(HYB_XDEV_SHAPE), "layers": cfg.n_layers,
           "params": sum(p.numel() for p in card.parameters()),
           "never_read_leaves": len(unread),
           "never_read_grads_zero_card_cpu": zero,
           "loss_card_cpu": [res[n]["loss"] for n in res],
           "loss_rel_err": loss_err,
           "grad_err_of_max_worst": dict(sorted(
               grad_err.items(), key=lambda kv: -kv[1])[:6]),
           "shared_grad_err_of_max": max(v for k, v in grad_err.items()
                                         if k.startswith("shared.")),
           "tol": SSM_XDEV_TOL, "card_s": res["card"]["s"],
           "cpu_s": res["cpu"]["s"], "seconds": time.perf_counter() - t}
    del card, cpu, res
    torch.cuda.empty_cache()
    require(zero and unread, f"lm_ssm: never-read gradients not 0: {out}")
    require(loss_err <= SSM_XDEV_TOL["loss"]
            and max(grad_err.values()) <= SSM_XDEV_TOL["grad"],
            f"lm_ssm: zamba2 group card vs CPU beyond SSM_XDEV_TOL: {out}")
    return out


def ssm_train_bound(cfg, model, n_params: int) -> dict:
    """Least time of a training step over TRAIN_ACCUM microbatches: 6 · N ·
    tokens (N the weights a token passes through, the shared block at
    each application, the head at every position; the SSD's and the
    attention's own products not counted) at FP32_FLOP_PER_S, against
    AdamW's 28 B a parameter (every leaf, the never-read ones too) at
    HBM_BYTES_PER_S, the larger."""
    n = applied_weights(model) + cfg.d_model * cfg.vocab_size
    ops = 6 * n * TRAIN_BATCH * TRAIN_SEQ
    opt_bytes = 28 * n_params
    t_ops, t_bytes = ops / FP32_FLOP_PER_S, opt_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3, "bound_ops": ops,
            "bound_bytes": opt_bytes, "weights_a_token": n,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def unread_moments_zero(model, state) -> dict:
    """The never-read leaves' first and second moments after the steps
    (float32), exactly zero: every gradient they were given was 0."""
    unread = unread_leaves(model)
    zero = all(not state["opt"][w][k].any() for w in ("m", "v")
               for k in unread)
    require(zero, "lm_ssm: a never-read leaf was given a gradient")
    return {"never_read_leaves": len(unread),
            "never_read_moments_zero": zero}


def ssm_train(device) -> dict:
    """lm_ssm (d): `train_run` (float32 moments, lr 3e-4, grad_accum
    TRAIN_ACCUM, remat) on SSM_ARCH at full depth (TRAIN_STEPS steps,
    profiled where SSM_TRAIN_PROFILE) and
    on HYB_ARCH cut to HYB_TRAIN_GROUPS groups (HYB_TRAIN_STEPS steps; its
    never-read leaves' moments stay 0); then resume ≡ uninterrupted bit
    for bit on HYB_ARCH at HYB_RESUME_GROUPS group. Every model
    `ssm_redraw`n."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.train import AdamWConfig, TrainConfig

    t = time.perf_counter()
    tc = TrainConfig(opt=AdamWConfig(), grad_accum=TRAIN_ACCUM)

    def prepare(model):
        ssm_redraw(model, torch.Generator(device=device).manual_seed(
            LM_SEED + 1))

    res = {}
    cfg = get_arch(SSM_ARCH)
    res[SSM_ARCH], _ = train_run(
        cfg, tc, lambda model, n: ssm_train_bound(cfg, model, n), device,
        "lm_ssm", prepare=prepare, profile=SSM_TRAIN_PROFILE)
    arch = get_arch(HYB_ARCH)
    hcfg = dataclasses.replace(
        arch, n_layers=HYB_TRAIN_GROUPS * arch.hybrid_period)
    res[HYB_ARCH], batches = train_run(
        hcfg, tc, lambda model, n: ssm_train_bound(hcfg, model, n), device,
        "lm_ssm", steps=HYB_TRAIN_STEPS, prepare=prepare,
        inspect=unread_moments_zero)
    rcfg = dataclasses.replace(
        arch, n_layers=HYB_RESUME_GROUPS * arch.hybrid_period)
    res["resume"] = resume_on_card(rcfg, tc, batches, device, "lm_ssm",
                                   prepare=prepare)
    res["seconds"] = time.perf_counter() - t
    return res


def run_lm_ssm(device, doc_ids) -> None:
    """lm_ssm, last (TF32 off): `ssm_serve` on SSM_ARCH and HYB_ARCH,
    `ssm_block_card_vs_cpu`, `hyb_group_card_vs_cpu` and `ssm_train`,
    each on a card holding none of the earlier phases' models."""
    import torch

    t = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    serve = {arch: ssm_serve(arch, device, doc_ids)
             for arch in (SSM_ARCH, HYB_ARCH)}
    block = ssm_block_card_vs_cpu(device)
    group = hyb_group_card_vs_cpu(device)
    train = ssm_train(device)
    emit({"phase": "lm_ssm", "archs": [SSM_ARCH, HYB_ARCH],
          "allocated_at_start_mib": held / 2**20, "serve": serve,
          "block_card_vs_cpu": block, "group_card_vs_cpu": group,
          "train": train, "seconds": time.perf_counter() - t})


# ---------------------------------------------------- cross-attention ----
VLM_ARCH = "llama-3.2-vision-90b"
ENC_ARCH = "whisper-small"
# full width, float32: a VLM period (4 gqa blocks of 855,654,400 parameters,
# then a gqa + cross block of 1,006,657,536) is 4,429,275,136, the untied
# embedding and head 2,101,354,496; serving at 3 periods of 20 (15 of 100
# layers): 15,389,179,904 parameters, 61.56 GB (2 periods: 43.84 GB).
# whisper-small at full depth (12 + 12 layers): 277,940,736 (1.11 GB).
VLM_SERVE_PERIODS = 3
CROSS_DECODE = 8           # greedy tokens after the rag phase's 18 a row
MEMORY_SCALE = 0.02        # the launchers' stub memory: 0.02 · N(0, 1)
CROSS_XDEV_SHAPE = (2, 64)  # tokens of the card-vs-CPU checks
# card vs CPU, each × its CPU max |.| (float32 both, TF32 off): the VLM
# cross block's prefill output and caches, a decode step's output and
# self K/V, every gradient leaf of Σ out·r (the memory's too); whisper's
# 1 + 1 layers' loss (relative) and every gradient leaf
CROSS_XDEV_TOL = {"prefill": 1e-4, "decode": 1e-4, "grad": 1e-4,
                  "loss": 1e-5}
# training: whisper at full depth (float32 moments, grad_accum
# TRAIN_ACCUM); the VLM at 1 period (6,530,629,632 parameters: p 26.12 GB,
# gradients 26.12 GB, int8 moments 13.06 GB) at grad_accum 1 (a float32
# accumulator would add 26.12 GB)
VLM_TRAIN_PERIODS = 1
VLM_MOMENTS = "int8"
VLM_TRAIN_ACCUM = 1


def cross_memory(cfg, b: int, device, seed: int = LM_SEED + 2):
    """A stub memory [b, Se, d] on `device` (the VLM's patch embeddings,
    whisper's frames): MEMORY_SCALE · N(0, 1) from a seeded generator."""
    import torch

    from repro_torch.models.transformer import cross_len

    g = torch.Generator(device=device).manual_seed(seed)
    return MEMORY_SCALE * torch.randn((b, cross_len(cfg), cfg.d_model),
                                      generator=g, device=device)


def cross_work(cfg, lm, b: int, s: int, ctx: int) -> dict:
    """Bytes and operations of a forward of `lm` over [b, s] tokens and its
    memory of Se rows (s = 1: a decode step at `ctx` cached slots over the
    static cross cache). Bytes: every weight the function reads, once — a
    decode step reads neither the cross blocks' wk / wv (their K/V are
    cached) nor the encoder, and of an untied embedding table only the
    rows it gathers —; a decode step's self K/V (ctx slots) and cross K/V
    (Se rows) read; a prefill's memory read and its caches written.
    Operations: 2 a weight a token through the decoder (the head at the
    last position only), the cross K/V projections over the Se memory
    rows, the causal self-attention's scores and values (half the
    square; a decode step's over ctx slots), the cross scores and values
    over Se rows; an enc-dec's prefill adds its encoder (2 a weight a
    frame, bidirectional attention over the whole square)."""
    from repro_torch.models.transformer import cross_len

    d, v, f = cfg.d_model, cfg.vocab_size, 4
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    se = cross_len(cfg)
    n_layers = len(lm.block_types)
    n_cross = sum(bt.cross for bt in lm.block_types)
    body = sum(p.numel() for p in lm.layers.parameters()) + sum(
        p.numel() for p in lm.final_norm.parameters())
    cross_kv_w = n_cross * 2 * d * hkv
    head = d * v
    enc_w = sum(p.numel() for n, p in lm.named_parameters()
                if n.startswith("enc_"))
    gather = 0 if cfg.tie_embeddings else b * s * d
    kv_row = 2 * hkv * f            # K/V bytes a token (or memory row) a layer
    if s == 1:
        moved = ((body - cross_kv_w + head + gather) * f
                 + n_layers * b * ctx * kv_row + n_cross * b * se * kv_row)
        ops = (2 * (body - cross_kv_w + head) * b
               + 4 * hq * b * (n_layers * ctx + n_cross * se))
    else:
        moved = ((body + head + enc_w + gather) * f + b * se * d * f
                 + (n_layers * b * s + n_cross * b * se) * kv_row)
        ops = (2 * (body - cross_kv_w) * b * s + 2 * cross_kv_w * b * se
               + 2 * head * b
               + 4 * hq * b * (n_layers * s * s / 2 + n_cross * s * se))
        if enc_w:
            ops += (2 * enc_w * b * se
                    + 4 * hq * b * se * se * len(lm.enc_layers))
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": moved, "ops": ops,
            "byte_bound_ms": t_bytes * 1e3, "op_bound_ms": t_ops * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cross_serve(cfg, device, doc_ids) -> dict:
    """lm_cross (a): the model of `cfg` (published widths) built on the
    card from LM_SEED; the rag phase's 16 requests' ids and 8 prompt
    tokens prefilled over a stub memory (`cross_memory`; whisper's frames
    through its encoder first), then CROSS_DECODE greedy decode steps over
    the self K/V and the static cross K/V: every step ≡ a teacher-forced
    prefill over the same prefix and memory within LM_TOL on all 16 rows,
    greedy ids equal past that margin (`decode_vs_prefill`). Prefill ms
    (CUDA events; whisper's encode also alone) and decode ms a token (host
    clock, median of 3 runs) beside their bounds (`cross_work`), a decode
    step's kernels, launches and idle share, the cross cache's bytes a row
    a layer, the peak allocation."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.transformer import cross_len
    from repro_torch.train import generate

    t = time.perf_counter()
    reset_peak()
    tokens = rag_tokens(doc_ids, cfg.vocab_size, device)
    b, s = tokens.shape
    enc = cross_memory(cfg, b, device)
    lm = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    generate(lm, tokens, 2, enc=enc)                           # warm-up
    torch.cuda.synchronize()
    stages = {"build_and_warm_up_s": time.perf_counter() - t}
    check, run = decode_vs_prefill(lm, tokens, CROSS_DECODE, "lm_cross",
                                   enc=enc)
    stages["decode_vs_prefill_s"] = time.perf_counter() - t - sum(
        stages.values())
    err = check["decode_vs_prefill_max_abs_err"]
    require(check["rows_compared_every_step"] == b
            and err is not None and err <= LM_TOL
            and check["greedy_agree_where_margin_gt_tol"] == 1.0,
            f"lm_cross: {cfg.name} decode vs teacher-forced prefill: {check}")
    launches = []
    prefill_ms, decode_ms, by_kernel = serve_timing(
        lm, tokens, run, CROSS_DECODE, launches, enc=enc)
    encode_ms = None
    if hasattr(lm, "encode"):
        with torch.no_grad():
            encode_ms = time_cuda(lambda: lm.encode(enc), iters=5, warmup=1)
    stages["timing_and_profiles_s"] = time.perf_counter() - t - sum(
        stages.values())
    dec = cross_work(cfg, lm, b, 1, s + CROSS_DECODE)
    pre = cross_work(cfg, lm, b, s, s)
    cache = lm.init_cache(1, 1)
    row = {n: c[n].numel() * c[n].element_size()
           for c in cache if "ck" in c for n in ("ck", "cv")}
    n_cross = sum(bt.cross for bt in lm.block_types)
    busy_ms = sum(by_kernel.values())
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "encoder_layers": len(getattr(lm, "enc_layers", [])),
           "cross_layers": n_cross, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "memory_rows": cross_len(cfg), "memory_shape": list(enc.shape),
           "params": sum(p.numel() for p in lm.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in lm.parameters()),
           "cross_cache_bytes_per_row_layer": sum(row.values()),
           "cross_cache_bytes": sum(row.values()) * b * n_cross,
           "batch": b, "prompt_tokens": s, "decoded": CROSS_DECODE,
           "decode_vs_prefill_tol": LM_TOL, "decode_vs_prefill": check,
           "prefill_ms": prefill_ms, "encode_ms": encode_ms,
           "prefill_bytes": pre["bytes"], "prefill_ops": pre["ops"],
           "prefill_byte_bound_ms": pre["byte_bound_ms"],
           "prefill_op_bound_ms": pre["op_bound_ms"],
           "prefill_bound_by": pre["bound_by"],
           "prefill_share_of_bound": pre["bound_ms"] / prefill_ms,
           "decode_ms_per_token": decode_ms,
           "decode_ms_per_token_per_request": decode_ms / b,
           "decode_bytes": dec["bytes"], "decode_ops": dec["ops"],
           "decode_byte_bound_ms": dec["byte_bound_ms"],
           "decode_op_bound_ms": dec["op_bound_ms"],
           "decode_bound_by": dec["bound_by"],
           "decode_share_of_bound": dec["bound_ms"] / decode_ms,
           "decode_step_kernel_launches": launches[0],
           "decode_step_device_busy_ms": busy_ms,
           "decode_step_idle_share": 1.0 - busy_ms / decode_ms,
           "decode_step_top_kernels_ms": dict(sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:8]),
           "torch_max_allocated_mib": torch.cuda.max_memory_allocated()
           / 2**20,
           "torch_max_reserved_mib": torch.cuda.max_memory_reserved() / 2**20,
           "stages": stages}
    del lm, run, enc, cache
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    return out


def vlm_block_card_vs_cpu(device) -> dict:
    """lm_cross (b): the VLM's cross block (period position 4: gqa + cross,
    1,006,657,536 parameters) at full width, drawn on the card from a
    seeded generator and copied to the CPU; seeded CROSS_XDEV_SHAPE [B, S]
    hidden states, one more token, a unit-normal memory of vision_seq rows
    (the cross scores far from uniform) and a cotangent r. On both
    devices: the prefill (output, self K/V, ck / cv), a decode step at
    position S (output, self K/V), and in train mode the gradients of Σ
    out·r with respect to every weight, the input and the memory; each
    within CROSS_XDEV_TOL of the CPU's max |.|."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import (BlockApplier, Ctx,
                                                _init_block, layer_plan)

    t = time.perf_counter()
    cfg = get_arch(VLM_ARCH)
    bt = layer_plan(cfg)[0][0].period[-1]
    require(bt.cross, f"lm_cross: period position 4 is {bt}")
    g = torch.Generator(device=device).manual_seed(LM_SEED)
    card = _init_block(cfg, bt, g, device)
    cpu = _init_block(cfg, bt, None, "cpu")
    cpu.load_state_dict(card.state_dict())
    b, s = CROSS_XDEV_SHAPE
    x = torch.randn((b, s + 1, cfg.d_model), generator=g, device=device)
    enc = torch.randn((b, cfg.vision_seq, cfg.d_model), generator=g,
                      device=device)
    r = torch.randn((b, s, cfg.d_model), generator=g, device=device)
    applier = BlockApplier(cfg)
    res = {}
    for name, blk in (("card", card), ("cpu", cpu)):
        t1 = time.perf_counter()
        dev = next(blk.parameters()).device
        xx, ee = x.to(dev), enc.to(dev)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        with torch.no_grad():
            out, part, _ = applier(bt, blk, xx[:, :s], Ctx(
                "prefill", positions=positions, enc=ee))
            cache = {n: torch.zeros((b, s + 1) + part[n].shape[2:],
                                    device=dev) for n in ("k", "v")}
            for n in ("k", "v"):
                cache[n][:, :s] = part[n]
            cache.update(ck=part["ck"], cv=part["cv"])
            pos = torch.full((b,), s, dtype=torch.int32, device=dev)
            dec, cache, _ = applier(bt, blk, xx[:, s:], Ctx("decode", pos=pos),
                                    cache)
        xg = xx[:, :s].clone().requires_grad_()
        eg = ee.clone().requires_grad_()
        out_t, _, _ = applier(bt, blk, xg, Ctx("train", positions=positions,
                                               enc=eg))
        names = [n for n, _ in blk.named_parameters()] + ["x", "enc"]
        grads = torch.autograd.grad((out_t * r.to(dev)).sum(),
                                    list(blk.parameters()) + [xg, eg])
        res[name] = {"prefill": {"out": out, **part},
                     "decode": {"out": dec, "k": cache["k"],
                                "v": cache["v"]},
                     "grad": dict(zip(names, grads)),
                     "s": time.perf_counter() - t1}
        del out_t, grads
    c = res["cpu"]
    err = {what: {n: rel_err(res["card"][what][n], want)
                  for n, want in c[what].items()}
           for what in ("prefill", "decode", "grad")}
    secs = {f"{n}_s": res[n]["s"] for n in res}
    n_params = sum(p.numel() for p in card.parameters())
    del card, cpu, res, x, r, enc
    torch.cuda.empty_cache()
    out = {"shape": [b, s], "memory_rows": cfg.vision_seq,
           "params": n_params, "err_of_max": err, "tol": CROSS_XDEV_TOL,
           **secs, "seconds": time.perf_counter() - t}
    require(all(max(err[w].values()) <= CROSS_XDEV_TOL[w] for w in err),
            f"lm_cross: VLM cross block card vs CPU beyond CROSS_XDEV_TOL: "
            f"{out}")
    return out


def whisper_card_vs_cpu(device) -> dict:
    """lm_cross (c): whisper-small at full width cut to 1 encoder and 1
    decoder layer (96,190,464 parameters), drawn on the card and copied
    to the CPU; `loss` and every gradient over seeded CROSS_XDEV_SHAPE
    tokens and a stub frame batch [B, 1500, d] on both devices: the loss
    within CROSS_XDEV_TOL["loss"] relative, each gradient leaf within
    CROSS_XDEV_TOL["grad"] of the CPU's max |.|."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import EncDecLM, build_model
    from repro_torch.train import loss_and_grads

    t = time.perf_counter()
    cfg = dataclasses.replace(get_arch(ENC_ARCH), n_layers=1,
                              n_encoder_layers=1)
    card = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    cpu = EncDecLM(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    b = CROSS_XDEV_SHAPE[0]
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, CROSS_XDEV_SHAPE).astype(np.int32))
    frames = cross_memory(cfg, b, device).cpu()
    res = {}
    for name, lm in (("card", card), ("cpu", cpu)):
        t1 = time.perf_counter()
        batch = {"tokens": tokens.to(lm.device), "enc": frames.to(lm.device)}
        loss, _, grads = loss_and_grads(lm, dict(lm.named_parameters()),
                                        batch)
        res[name] = {"loss": float(loss), "s": time.perf_counter() - t1,
                     "grads": {k: v.cpu() for k, v in grads.items()}}
        del grads
    c = res["cpu"]
    grad_err = {k: rel_err(res["card"]["grads"][k], want)
                for k, want in c["grads"].items()}
    loss_err = abs(res["card"]["loss"] - c["loss"]) / abs(c["loss"])
    out = {"shape": list(CROSS_XDEV_SHAPE), "frames": list(frames.shape),
           "params": sum(p.numel() for p in card.parameters()),
           "loss_card_cpu": [res[n]["loss"] for n in res],
           "loss_rel_err": loss_err,
           "grad_err_of_max_worst": dict(sorted(
               grad_err.items(), key=lambda kv: -kv[1])[:6]),
           "tol": CROSS_XDEV_TOL, "card_s": res["card"]["s"],
           "cpu_s": res["cpu"]["s"], "seconds": time.perf_counter() - t}
    del card, cpu, res
    torch.cuda.empty_cache()
    require(loss_err <= CROSS_XDEV_TOL["loss"]
            and max(grad_err.values()) <= CROSS_XDEV_TOL["grad"],
            f"lm_cross: whisper layers card vs CPU beyond CROSS_XDEV_TOL: "
            f"{out}")
    return out


def cross_train_bound(cfg, model, n_params: int, opt_bytes: float) -> dict:
    """Least time of a training step over [TRAIN_BATCH, TRAIN_SEQ] tokens
    and their memory: 3 × a forward's operations (`cross_work`, the head
    at every position; remat's recompute not counted) at FP32_FLOP_PER_S,
    against AdamW's `opt_bytes` a parameter at HBM_BYTES_PER_S, the
    larger."""
    w = cross_work(cfg, model, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ)
    ops = 3 * (w["ops"] + 2 * cfg.d_model * cfg.vocab_size * TRAIN_BATCH
               * (TRAIN_SEQ - 1))
    moved = opt_bytes * n_params
    t_ops, t_bytes = ops / FP32_FLOP_PER_S, moved / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3, "bound_ops": ops,
            "bound_bytes": moved,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def cross_train(device) -> dict:
    """lm_cross (d): `train_run` (lr 3e-4, remat, a stub memory a batch) on
    ENC_ARCH at full depth (float32 moments, grad_accum TRAIN_ACCUM: the
    microbatches split the frames with the tokens), then resume ≡
    uninterrupted bit for bit on it; and on VLM_ARCH at VLM_TRAIN_PERIODS
    period (VLM_MOMENTS moments, grad_accum VLM_TRAIN_ACCUM), its peak
    allocation printed."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.train import AdamWConfig, TrainConfig

    t = time.perf_counter()
    res = {}
    cfg = get_arch(ENC_ARCH)
    tc = TrainConfig(opt=AdamWConfig(), grad_accum=TRAIN_ACCUM)
    res[ENC_ARCH], batches = train_run(
        cfg, tc, lambda model, n: cross_train_bound(cfg, model, n, 28),
        device, "lm_cross")
    res["resume"] = resume_on_card(cfg, tc, batches, device, "lm_cross")
    del batches
    arch = get_arch(VLM_ARCH)
    vcfg = dataclasses.replace(
        arch, n_layers=VLM_TRAIN_PERIODS * arch.cross_attn_period)
    vtc = TrainConfig(opt=AdamWConfig(moment_dtype=VLM_MOMENTS),
                      grad_accum=VLM_TRAIN_ACCUM)
    res[VLM_ARCH], _ = train_run(
        vcfg, vtc, lambda model, n: cross_train_bound(vcfg, model, n,
                                                      INT8_OPT_BYTES),
        device, "lm_cross")
    res["seconds"] = time.perf_counter() - t
    return res


def run_lm_cross(device, doc_ids) -> None:
    """lm_cross, last (TF32 off): `cross_serve` on VLM_ARCH (cut to
    VLM_SERVE_PERIODS periods) and ENC_ARCH, `vlm_block_card_vs_cpu`,
    `whisper_card_vs_cpu` and `cross_train`, each on a card holding none
    of the earlier phases' models."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    t = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    arch = get_arch(VLM_ARCH)
    vcfg = dataclasses.replace(
        arch, n_layers=VLM_SERVE_PERIODS * arch.cross_attn_period)
    serve = {VLM_ARCH: cross_serve(vcfg, device, doc_ids),
             ENC_ARCH: cross_serve(get_arch(ENC_ARCH), device, doc_ids)}
    serve[VLM_ARCH]["of_layers"] = arch.n_layers
    block = vlm_block_card_vs_cpu(device)
    layers = whisper_card_vs_cpu(device)
    train = cross_train(device)
    emit({"phase": "lm_cross", "archs": [VLM_ARCH, ENC_ARCH],
          "allocated_at_start_mib": held / 2**20, "serve": serve,
          "vlm_block_card_vs_cpu": block, "whisper_card_vs_cpu": layers,
          "train": train, "seconds": time.perf_counter() - t})


def run_phases(args, device, world, vectors_path) -> list:
    """Run every phase on the built kernels and return the `kernels`
    line's entries. `world` is the dataset's pending result (`make_world`
    in a child process, its vectors to come through `vectors_path`)."""
    count_forest_uploads()

    k1 = check_step_kernel(device)
    k3 = check_step_kernel(device, "int8")
    k4 = check_step_kernel(device, "pq")
    k1w = check_step_kernel(device, r=160)
    k3w = check_step_kernel(device, "int8", r=160)
    k4w = check_step_kernel(device, "pq", r=160)
    k2 = check_k2(device)
    k6 = check_k6(device)
    check_k6_scan(device)
    for layout in ("scan", "oracle"):
        time_k6_rows(device, layout)
    k6q = {}
    for precision in ("int8", "pq"):
        k6q_rows_check(device, precision)
        k6q[precision] = time_k6q_rows(device, precision)
    k7 = check_k7(device)
    k5 = check_k5(device)
    k5q = {p: check_k5_codec(device, p) for p in ("int8", "pq")}
    launches, k6r, rag_ids = run_pipeline(
        args, device, {"float32": k5["ms"], "pq": k5q["pq"]["ms"]}, world,
        vectors_path)
    run_launchers((1, 8, "olmo-1b"), (SHARDS, 8, MOE_ARCH), (1, 8, MLA_ARCH),
                  (1, 8, HYB_ARCH))
    run_lm_train(device)
    run_lm_moe(device, rag_ids)
    run_lm_mla(device, rag_ids)
    run_lm_ssm(device, rag_ids)
    run_lm_cross(device, rag_ids)
    serve = {path: launches.pop(f"serve:{path}")
             for path in ("float32", "pq", "auto")}
    sharded = launches.pop("sharded")
    mesh = sharded.pop("mesh")
    k6_paths = {**launches.pop("k6_paths"),
                f"sharded S={SHARDS} persistent float32 (1 batch)":
                sharded["sqdist_masked"]}
    k6q_paths = {}
    for p in ("int8", "pq"):
        for path, n in launches.pop(f"k6_paths:{p}").items():
            if path.startswith("entry: "):
                k6q_paths[p] = {path[len("entry: "):]: n}
            else:
                k6_paths[path + ", rerank"] = n

    def entry(name, source, replaces, chk, launches_of, why, status=None,
              note=None):
        out = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{source}",
               "replaces": (replaces if replaces.startswith("src/")
                            else f"src/repro/kernels/{replaces}"),
               "launches": launches[launches_of],
               "max_abs_err": chk["max_abs_err"], "ms": chk["ms"],
               "plain_ms": chk["plain_ms"], "bound_ms": chk["bound_ms"],
               "bound_by": chk["bound_by"],
               "library_ms": chk.get("library_ms"),
               "call_ms": chk["call_ms"],
               "plain_call_ms": chk["plain_call_ms"]}
        if why:
            out["library_none_because"] = why
        else:
            out["library"] = "torch.sort(stable=True) + torch.gather"
        if status:
            out.update(status=status, floor_ms=chk["floor_ms"],
                       floor_call_ms=chk["floor_call_ms"])
        if note:
            out["note"] = note
        if launches_of == "sqdist_masked":
            out["launches_by_path"] = k6_paths   # entry distance, rerank
        elif launches_of.startswith("sqdist_rows_quant_"):
            out["entry_launches_by_path"] = k6q_paths[
                launches_of.rsplit("_", 1)[1]]
        # launches on the serving paths (`serve` lines: float32 and PQ
        # direct, auto); serving runs K1 only at R'=160 (auto's widen)
        name_of = {"fused_step": None,
                   "fused_step_wide": "fused_step"}.get(launches_of,
                                                        launches_of)
        served = {path: c[name_of] for path, c in serve.items()
                  if name_of and c.get(name_of)}
        if served:
            out["serve_launches"] = served
        if mesh.get(launches_of):  # the `mesh` phase's runs (K1, K3, K6, K2)
            out["mesh_launches"] = mesh[launches_of]
        return out

    step_why = "no single PyTorch call runs a traversal step"
    steps_why = "no single PyTorch call runs traversal steps"
    return [
        entry("fused_step", "fused_step.cu", "fused_step.py:182", k1,
              "fused_step", step_why),
        entry("fused_step (R'=160, pre/widen)", "fused_step.cu",
              "fused_step.py:182", k1w, "fused_step_wide", step_why),
        entry("gbdt_predict", "gbdt.cu", "gbdt.py:22", k2, "gbdt_predict",
              "no single PyTorch call walks a tree ensemble",
              K2_STATUS),
        entry("fused_step_int8", "fused_step.cu", "fused_step.py:209", k3,
              "fused_step_int8", step_why),
        entry("fused_step_pq", "fused_step.cu", "fused_step.py:243", k4,
              "fused_step_pq", step_why),
        entry("fused_step_int8 (R'=160, pre/widen)", "fused_step.cu",
              "fused_step.py:209", k3w, "fused_step_int8_wide", step_why),
        entry("fused_step_pq (R'=160, pre/widen)", "fused_step.cu",
              "fused_step.py:243", k4w, "fused_step_pq_wide", step_why),
        entry("persistent_multi_step", "persistent_step.cu",
              "persistent_step.py:127", k5, "persistent_multi_step",
              steps_why),
        entry("persistent_multi_step_int8", "persistent_step.cu",
              "persistent_step.py:293", k5q["int8"],
              "persistent_multi_step_int8", steps_why),
        entry("persistent_multi_step_pq", "persistent_step.cu",
              "persistent_step.py:301", k5q["pq"],
              "persistent_multi_step_pq", steps_why),
        entry("sqdist_masked", "sqdist.cu", "distance.py:76", k6,
              "sqdist_masked", "no single PyTorch call computes a masked "
              "batched squared L2 (torch.cdist gives unsquared, unmasked "
              "distances)"),
        entry("sqdist_rows (K6 row ids: scan, oracle)", "sqdist.cu",
              "distance.py:76", k6r, "sqdist_rows",
              "no single PyTorch call computes masked squared L2 to rows "
              "given by id (torch.cdist gives unsquared, unmasked distances "
              "of a gathered block)"),
        *(entry(f"sqdist_rows_quant_{p} (K6q rows: quantized scan, "
                "compressed oracle)", "quant_rows.cu",
                "src/repro/core/plans.py:152", k6q[p],
                f"sqdist_rows_quant_{p}",
                "no single PyTorch call computes ADC distances to rows given "
                "by id (the reference computes them in jnp over a gathered "
                "block of codes, no Pallas kernel)",
                note=None if p == "int8" else K6Q_PQ_NOTE)
          for p in ("int8", "pq")),
        entry("topm_merge", "topk.cu", "topk.py:63", k7, "topm_merge",
              None, K7_STATUS),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus size (Tripclick: 1,000,000)")
    ap.add_argument("--train-queries", type=int, default=512)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 references
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # the dataset generator (one host thread) runs in a child process
    # beside the kernel build and checks; the pool's exit stops it and the
    # temporary directory of its vectors goes with the `finally`
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="world_", dir=os.path.join(ROOT, "build"))
    vectors_path = os.path.join(tmp, "vectors.f32")
    try:
        with multiprocessing.get_context("spawn").Pool(1) as pool:
            world = pool.apply_async(make_world, (args.n, args.train_queries,
                                                  vectors_path))
            t = time.perf_counter()
            _build.build_all()
            emit({"phase": "build", "seconds": time.perf_counter() - t})
            with CardMemoryPeak() as mem:
                kernels = run_phases(args, device, world, vectors_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mib = 2**20
    emit({"phase": "memory", "peak_used_mib": mem.peak_mib,
          "samples": mem.samples,
          "torch_max_allocated_mib": max(
              TORCH_PEAKS["allocated"]
              + [torch.cuda.max_memory_allocated()]) / mib,
          "torch_max_reserved_mib": max(
              TORCH_PEAKS["reserved"]
              + [torch.cuda.max_memory_reserved()]) / mib})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Pre-filter scan plan: bitmap-compile the filter, scan only passing rows.

Counterpart of `repro/core/plans.py`. Three stages, all per-lane
deterministic:

  bitmap    `filters.compile.eval_program_matrix` evaluates the compiled
            program against the whole attribute store on the device — a
            [B, N] bool candidate bitmap, exact per-query selectivity σ_q
            and per-clause global selectivities. Boolean work only: 0 NDC.
  gather    per lane, the σ_q·N passing row ids in ascending order (a
            stable argsort of ~valid), padded to a shared power-of-two
            width V, a multiple of SCAN_ALIGN.
  distance  `kernels.ops.masked_scan_dist` over those ids — K6's row-id
            variant on the card, which reads each passing row from the
            store (the reference's gathered [B, V, d] block would need
            103 GB at N=1M, B=64, V=2^19, d=768), the per-lane plain path
            on the CPU — then one stable top-M selection.

On a quantized engine (int8, PQ) the distance stage is the compressed
one: `kernels.ops.masked_scan_dist_quant` over the same ids (K6q rows on
the card, which reads each passing row's codes by id, as the traversal's
K3 / K4 compute them; the per-lane plain path on the CPU), and the masked
reconstruction errors go into `q_err_sum`. The candidate queue then holds
the top-M compressed candidates, which the planner's terminal exact rerank
scores in float32 (`SearchEngine.rerank`), as after a traversal.

Cost is exactly σ_q·N distance computations per lane (`state.cnt`). The
result equals the exact oracle `index.bruteforce.filtered_knn_exact` bit
for bit at float32, and the compressed oracle
`index.bruteforce.compressed_filtered_topk` on a quantized engine: same
distance source, same stable tie order. The returned SearchState is
terminal (`active` all False, the pool fully expanded): scan states are
read or merged, never resumed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import SearchEngine
from repro_torch.core.state import INF, SearchConfig, SearchState
from repro_torch.core.step import tree_sum
from repro_torch.filters.compile import (CLAUSE_FEATURE_SLOTS, FilterProgram,
                                         eval_program_matrix)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.distance import SCAN_ALIGN
from repro_torch.quant.codecs import prepare_query


class ScanStats(NamedTuple):
    """Bitmap-stage output: the scan plan's input and the planner's exact
    pre-probe statistics (σ_q and global per-clause selectivities)."""

    valid: torch.Tensor      # [B, N] bool candidate bitmap (engine device)
    counts: np.ndarray       # [B] i64 — σ_q·N, exact
    clause_frac: np.ndarray  # [B, CLAUSE_FEATURE_SLOTS] f32 global clause σ
    n: int                   # corpus size N

    @property
    def sigma(self) -> np.ndarray:
        return self.counts.astype(np.float64) / max(self.n, 1)

    def rows(self, idx) -> "ScanStats":
        """Lane subset (planner partition)."""
        idx = np.asarray(idx)
        sel = torch.as_tensor(idx, dtype=torch.long, device=self.valid.device)
        return ScanStats(valid=self.valid.index_select(0, sel),
                         counts=self.counts[idx],
                         clause_frac=self.clause_frac[idx], n=self.n)


def scan_stats(engine: SearchEngine, prog: FilterProgram) -> ScanStats:
    """Compile the candidate bitmap and exact selectivity statistics."""
    valid, frac = eval_program_matrix(engine.compile(prog),
                                      engine.label_attrs, engine.value_attrs)
    return ScanStats(valid=valid,
                     counts=valid.sum(dim=1).cpu().numpy().astype(np.int64),
                     clause_frac=frac, n=int(valid.shape[1]))


def _aligned_width(max_count: int, n: int) -> int:
    """Smallest power of two ≥ max(count, SCAN_ALIGN), capped at ⌈N⌉₆₄ —
    the reference's width rule; every candidate is a SCAN_ALIGN multiple,
    so the width a batch lands on cannot change a distance."""
    v = max(SCAN_ALIGN, 1 << max(0, int(max_count - 1).bit_length()))
    cap = -(-n // SCAN_ALIGN) * SCAN_ALIGN
    return min(v, cap)


def scan_rows(stats: ScanStats) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan's row ids and mask: per lane, the passing row ids in
    ascending order (a stable argsort of ~valid, as the oracle's tie
    order needs), padded with row 0 to the shared width V =
    `_aligned_width`, and the mask of the σ_q·N real entries → (ids [B, V]
    i32, mask [B, V] bool) on the bitmap's device."""
    dev = stats.valid.device
    b, n = stats.valid.shape
    v = _aligned_width(int(stats.counts.max(initial=0)), n)
    take = min(v, n)
    order = torch.argsort((~stats.valid).to(torch.uint8), dim=1,
                          stable=True)[:, :take]
    idx = torch.zeros((b, v), dtype=torch.int32, device=dev)
    idx[:, :take] = order.to(torch.int32)
    counts = torch.from_numpy(stats.counts).to(dev)
    mask = torch.arange(v, device=dev)[None, :] < counts[:, None]
    return idx, mask


def scan_search(
    engine: SearchEngine,
    cfg: SearchConfig,
    queries,
    filt,                                # FilterSpec | Expr(s) | FilterProgram
    stats: ScanStats | None = None,
    base_state: SearchState | None = None,
) -> SearchState:
    """Execute the pre-filter scan plan; returns a terminal SearchState.

    `stats` reuses a bitmap the planner already compiled for routing.
    `base_state` carries a probed lane's counters into the scan (the
    planner's late scan): counters accumulate on the probe's, d_start is
    kept, and the result and queue buffers are replaced — the scan covers
    the whole valid set.
    """
    precision = engine.effective_precision(cfg)
    if precision != "float32" and engine.quant is None:
        raise ValueError(
            f"scan at precision {precision!r} on an engine without a quant "
            "index — build with precision=...")
    dev = engine.device
    prog = engine.compile(filt)
    if stats is None:
        stats = scan_stats(engine, prog)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
    b = q.shape[0]
    n = stats.n
    m, k = cfg.queue_size, cfg.k

    counts = torch.from_numpy(stats.counts.astype(np.int32)).to(dev)
    idx, mask = scan_rows(stats)
    v = idx.shape[1]
    err_add = None
    if precision == "float32":
        dd = kops.masked_scan_dist(q, engine.base_vectors, idx, mask)
    else:
        quant = engine.quant
        dd = kops.masked_scan_dist_quant(prepare_query(precision, quant, q),
                                         quant, idx, mask)
        # the lane's errors in position (row id) order, zeros past its
        # count: tree_sum's value is then the same at any padded width V
        # and whatever lanes share the batch
        err_add = tree_sum(torch.where(mask, quant.err[idx.long()], 0.0))

    # one stable ascending selection serves both buffers: results are the
    # first k columns of the top-M candidate pool
    p = min(v, m)
    top_d, sel = torch.sort(dd, dim=1, stable=True)
    top_d, sel = top_d[:, :p], sel[:, :p]
    top_i = torch.where(torch.isfinite(top_d), torch.gather(idx, 1, sel), -1)
    pad = m - p
    cand_dist = torch.nn.functional.pad(top_d, (0, pad), value=INF)
    cand_idx = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    in_pool = cand_idx >= 0
    res_dist = cand_dist[:, :k].contiguous()
    res_idx = cand_idx[:, :k].contiguous()

    i32 = torch.int32
    zeros = lambda: torch.zeros((b,), dtype=i32, device=dev)  # noqa: E731
    if base_state is None:
        carry = SearchState(
            cand_dist=cand_dist, cand_idx=cand_idx, cand_exp=in_pool,
            cand_valid=in_pool, res_dist=res_dist, res_idx=res_idx,
            visited=torch.zeros((b, (n + 31) // 32), dtype=i32, device=dev),
            cnt=zeros(), n_inspected=zeros(), n_valid_visited=zeros(),
            n_clause_valid=torch.zeros((b, CLAUSE_FEATURE_SLOTS), dtype=i32,
                                       device=dev),
            n_pop_valid=zeros(),
            q_err_sum=torch.zeros((b,), dtype=torch.float32, device=dev),
            hops=zeros(),
            active=torch.zeros((b,), dtype=torch.bool, device=dev),
            d_start=torch.zeros((b,), dtype=torch.float32, device=dev),
            conv_cnt=torch.full((b,), -1, dtype=i32, device=dev),
            res_full_cnt=torch.full((b,), -1, dtype=i32, device=dev),
        )
    else:
        carry = base_state._replace(
            cand_dist=cand_dist, cand_idx=cand_idx, cand_exp=in_pool,
            cand_valid=in_pool, res_dist=res_dist, res_idx=res_idx,
            active=torch.zeros((b,), dtype=torch.bool, device=dev))
    clause_add = torch.from_numpy(
        np.rint(stats.clause_frac * n).astype(np.int32)).to(dev)
    cnt = carry.cnt + counts
    if err_add is not None:
        carry = carry._replace(q_err_sum=carry.q_err_sum + err_add)
    return carry._replace(
        cnt=cnt,
        n_inspected=carry.n_inspected + n,
        n_valid_visited=carry.n_valid_visited + counts,
        n_clause_valid=carry.n_clause_valid + clause_add,
        res_full_cnt=torch.where(torch.isfinite(res_dist[:, -1]), cnt,
                                 carry.res_full_cnt),
    )

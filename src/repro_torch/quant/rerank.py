"""Exact float32 rerank of a finished compressed-domain traversal.

Counterpart of `repro/quant/rerank.py`. Compressed distances
decide which nodes the traversal keeps; the rerank re-scores the final
pool — result set ∪ predicate-valid candidate queue, deduplicated — with
exact float32 squared L2 against the full-precision vectors and
re-selects the top-k. It costs ≤ M + K distances per query, not counted
into `cnt`. It is terminal: the result buffers then hold exact distances
while the queue keeps compressed ones, so a reranked state is never
resumed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.distance import sqdist_masked

INF = float("inf")


def rerank_pool(cand_idx, cand_valid, res_idx):
    """Deduplicated candidate pool [B, K + M]: invalid and repeated ids
    become -1 (a node can sit in both buffers)."""
    pool = torch.cat([res_idx, torch.where(cand_valid, cand_idx, -1)], dim=1)
    order = torch.argsort(pool, dim=1, stable=True)
    s = torch.gather(pool, 1, order)
    dup_sorted = torch.cat(
        [torch.zeros_like(s[:, :1], dtype=torch.bool), s[:, 1:] == s[:, :-1]],
        dim=1)
    inv = torch.argsort(order, dim=1, stable=True)
    dup = torch.gather(dup_sorted, 1, inv)
    return torch.where(dup, -1, pool)


def score_pool(queries, pool, xv, k: int):
    """Exact distances to the gathered pool rows xv [B, P, d] → the stable
    ascending top-k (res_dist [B, k], res_idx [B, k]); missing entries are
    +inf / -1. The distances come from K6 under the mask `pool >= 0`, so a
    (query, row) pair's value does not depend on the batch width."""
    dd = sqdist_masked(queries, xv.contiguous(), (pool >= 0).contiguous())
    sel = torch.argsort(dd, dim=1, stable=True)[:, :k]
    rd = torch.gather(dd, 1, sel)
    ri = torch.gather(pool, 1, sel)
    return rd, torch.where(torch.isfinite(rd), ri, -1).to(torch.int32)


def exact_rerank(queries, base_vectors, cand_idx, cand_valid, res_idx,
                 k: int):
    """queries [B, d], base_vectors [N, d] f32, cand_idx/cand_valid [B, M],
    res_idx [B, K0] → (res_dist [B, k] ascending, res_idx [B, k])."""
    pool = rerank_pool(cand_idx, cand_valid, res_idx)
    xv = base_vectors[pool.clamp(min=0).long()]                # [B, P, d]
    return score_pool(queries.to(torch.float32), pool, xv, k)


def exact_rerank_store(queries, store, cand_idx, cand_valid, res_idx,
                       k: int):
    """`exact_rerank` against a tiered vector store (`quant.tiering`): the
    same dedup and scoring, the rows gathered by `store.gather`, which on
    the host tier streams only the ≤ M + K pool rows a query. The rows are
    the same bytes, so the result is bit for bit the device tier's."""
    pool = rerank_pool(cand_idx, cand_valid, res_idx)
    xv = store.gather(pool)
    return score_pool(queries.to(torch.float32), pool, xv, k)

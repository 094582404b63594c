"""Exact filtered KNN oracle — ground truth for recall and for W_q labels.

Counterpart of `repro/index/bruteforce.py`. Validity comes from the naive
host oracle `filters.predicates.filter_matrix`. Distances come from the
scan plan's distance source, `kernels.distance.sqdist_rows` (K6's row-id
variant on the card, the per-lane plain path on the CPU), as the
reference routes them through its scan path: the pre-filter scan plan
(`core/plans.py::scan_search`) must equal this oracle bit for bit. The
top-k is a stable sort over rows in id order, so distance ties fall to
the smaller id, as in the scan's stable selection. `knn_exact` is the
unfiltered top-k on the same distances, and `compressed_filtered_topk`
the filtered top-k on the compressed scan's (K6q rows'). The three share
one blocked loop.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.filters.predicates import filter_matrix, slice_filter
from repro_torch.kernels.distance import oracle_block, sqdist_rows
from repro_torch.kernels.ops import masked_scan_dist_quant
from repro_torch.quant.codecs import _int8_dot_check, prepare_query

INF = float("inf")


def valid_mask(filt, labels_packed: np.ndarray,
               values: np.ndarray) -> np.ndarray:
    """[B, N] bool validity of every base item for every query filter
    (host; callers with large B or N take it a query chunk at a time)."""
    return filter_matrix(filt, labels_packed, values)


def _blocked_topk(b: int, n: int, k: int, valid_of, dist_of, q_chunk: int,
                  n_block: int) -> tuple[np.ndarray, np.ndarray]:
    """The loop of the three oracles: top-k over the rows that
    `valid_of(s, e)` ([e − s, N] bool on the device) passes for queries
    s..e−1, whose distances `dist_of(s, e)` ((ids, mask) → [e − s, V] f32)
    gives `n_block` rows a call in the oracles' layout (`oracle_block`),
    `q_chunk` queries at a time → host (idx [B, k] i32, dist f32)
    ascending, ties by ascending id, -1 / +inf where fewer rows pass."""
    kk = min(k, n)
    out_i = np.full((b, k), -1, np.int32)
    out_d = np.full((b, k), np.inf, np.float32)
    for s in range(0, b, q_chunk):
        e = min(s + q_chunk, b)
        ok = valid_of(s, e)
        dist = dist_of(s, e)
        d2 = torch.empty((e - s, n), dtype=torch.float32, device=ok.device)
        for c in range(0, n, n_block):
            ce = min(c + n_block, n)
            ids, mask = oracle_block(ok, c, ce)
            d2[:, c:ce] = dist(ids, mask)[:, :ce - c]
        dd, idx = torch.sort(d2, dim=1, stable=True)
        dd, idx = dd[:, :kk], idx[:, :kk]
        idx = torch.where(torch.isinf(dd), -1, idx)
        out_i[s:e, :kk] = idx.to(torch.int32).cpu().numpy()
        out_d[s:e, :kk] = dd.cpu().numpy()
    return out_i, out_d


def filtered_knn_exact(
    queries: np.ndarray,
    base,                      # [N, d] numpy or torch
    filt,                      # FilterSpec batch | sequence of expressions
    labels_packed: np.ndarray,
    values: np.ndarray,
    k: int,
    device=None,
    q_chunk: int = 64,
    n_block: int = 1 << 18,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact filtered top-k (paper Def. 2.5).

    Returns host (idx[B,k] i32, dist[B,k] f32) ascending, ties by
    ascending id; rows with fewer than k valid items are padded with
    idx=-1, dist=+inf. Only valid rows' distances are computed, `n_block`
    rows per call, each block padded to a SCAN_ALIGN multiple (the padding
    cannot change a value).
    """
    dev = resolve_device(device)
    base_t = torch.as_tensor(base).to(dev, torch.float32)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
    return _blocked_topk(
        q.shape[0], base_t.shape[0], k,
        lambda s, e: torch.from_numpy(filter_matrix(
            slice_filter(filt, s, e), labels_packed, values)).to(dev),
        lambda s, e: functools.partial(sqdist_rows, q[s:e], base_t),
        q_chunk, n_block)


def knn_exact(queries: np.ndarray, base, k: int, device=None,
              q_chunk: int = 64, n_block: int = 1 << 18,
              ) -> tuple[np.ndarray, np.ndarray]:
    """Unfiltered exact top-k → host (idx [B, min(k, N)] i32, dist f32)
    ascending, as the reference's `knn_exact` returns them. Every row's
    distance comes from K6's row-id variant (the oracles' layout, every
    row passing); ties by ascending id, where the reference's
    `np.argpartition` leaves their order arbitrary."""
    dev = resolve_device(device)
    base_t = torch.as_tensor(base).to(dev, torch.float32)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
    n = base_t.shape[0]
    gi, gd = _blocked_topk(
        q.shape[0], n, k,
        lambda s, e: torch.ones((e - s, n), dtype=torch.bool, device=dev),
        lambda s, e: functools.partial(sqdist_rows, q[s:e], base_t),
        q_chunk, n_block)
    return gi[:, :n], gd[:, :n]


def compressed_filtered_topk(precision: str, index, queries, valid_mask,
                             k: int, chunk: int = 128,
                             n_block: int = 1 << 18):
    """Brute-force compressed-domain filtered top-k → host (dist [B, k],
    idx [B, k]), ascending; rows with fewer than k valid items pad with
    +inf / -1.

    The compressed analogue of `filtered_knn_exact`: the convergence
    target of training on a quantized engine. `valid_mask` [B, N] bool
    (numpy or torch) moves to the device one query chunk at a time. The
    distances come from the compressed scan's own source,
    `kernels.ops.masked_scan_dist_quant` (K6q rows on the card, its plain
    version on the CPU), so the quantized scan plan equals this oracle bit
    for bit. Ties order by node id (a stable sort), as `jax.lax.top_k`
    does. `quant.codecs.compressed_filtered_topk`, the reference's name,
    is this function.
    """
    if precision == "int8":
        _int8_dot_check(int(index.codes.shape[1]))
    dev = index.codes.device
    q = torch.as_tensor(queries).to(dev, torch.float32)
    gi, gd = _blocked_topk(
        q.shape[0], index.codes.shape[0], k,
        lambda s, e: torch.as_tensor(valid_mask[s:e]).to(dev, torch.bool),
        lambda s, e: functools.partial(
            masked_scan_dist_quant,
            prepare_query(precision, index, q[s:e]), index),
        chunk, n_block)
    return gd, gi


def recall_at_k(found_idx: np.ndarray, gt_idx: np.ndarray) -> np.ndarray:
    """Recall@k per query; -1 padding in gt shrinks the denominator."""
    b, k = gt_idx.shape
    rec = np.zeros(b, dtype=np.float64)
    for i in range(b):
        gt = set(int(x) for x in gt_idx[i] if x >= 0)
        if not gt:
            rec[i] = 1.0
            continue
        got = set(int(x) for x in found_idx[i] if x >= 0)
        rec[i] = len(gt & got) / len(gt)
    return rec

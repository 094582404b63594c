"""Exact filtered KNN oracle — ground truth for recall and for W_q labels.

Counterpart of `repro/index/bruteforce.py`. Validity comes from the naive
host oracle `filters.predicates.filter_matrix`. Distances come from the
scan plan's distance source, `kernels.distance.sqdist_rows` (K6's row-id
variant on the card, the per-lane plain path on the CPU), as the
reference routes them through its scan path: the pre-filter scan plan
(`core/plans.py::scan_search`) must equal this oracle bit for bit. The
top-k is a stable sort over rows in id order, so distance ties fall to
the smaller id, as in the scan's stable selection.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.filters.predicates import filter_matrix, slice_filter
from repro_torch.kernels.distance import SCAN_ALIGN, sqdist_rows

INF = float("inf")


def valid_mask(filt, labels_packed: np.ndarray,
               values: np.ndarray) -> np.ndarray:
    """[B, N] bool validity of every base item for every query filter
    (host; callers with large B or N take it a query chunk at a time)."""
    return filter_matrix(filt, labels_packed, values)


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
    n = base_t.shape[0]
    b = queries.shape[0]
    kk = min(k, n)
    out_i = np.full((b, k), -1, np.int32)
    out_d = np.full((b, k), np.inf, np.float32)
    for s in range(0, b, q_chunk):
        e = min(s + q_chunk, b)
        q = torch.as_tensor(np.asarray(queries[s:e], np.float32)).to(dev)
        ok = torch.from_numpy(filter_matrix(
            slice_filter(filt, s, e), labels_packed, values)).to(dev)
        d2 = torch.empty((e - s, n), dtype=torch.float32, device=dev)
        for c in range(0, n, n_block):
            ce = min(c + n_block, n)
            v = ce - c + (c - ce) % SCAN_ALIGN
            ids = torch.arange(c, c + v, dtype=torch.int32,
                               device=dev).clamp_(max=n - 1)
            ids = ids[None].expand(e - s, v).contiguous()  # one row per lane
            mask = torch.nn.functional.pad(ok[:, c:ce],
                                           (0, v - (ce - c))).contiguous()
            d2[:, c:ce] = sqdist_rows(q, base_t, ids, mask)[:, :ce - c]
        dd, idx = torch.sort(d2, dim=1, stable=True)
        dd, idx = dd[:, :kk], idx[:, :kk]
        idx = torch.where(torch.isinf(dd), -1, idx)
        out_i[s:e, :kk] = idx.to(torch.int32).cpu().numpy()
        out_d[s:e, :kk] = dd.cpu().numpy()
    return out_i, out_d


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

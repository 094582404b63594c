"""Exact filtered KNN oracle — ground truth for recall and for W_q labels.

Counterpart of `repro/index/bruteforce.py`. Validity comes from the naive
host oracle `filters.predicates.filter_matrix`; distances are a blocked
matrix product on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.filters.predicates import filter_matrix

INF = float("inf")


def valid_mask(filt, labels_packed: np.ndarray,
               values: np.ndarray) -> np.ndarray:
    """[B, N] bool validity of every base item for every query filter
    (host; callers with large B or N take it a query chunk at a time)."""
    return filter_matrix(filt, labels_packed, values)


def filtered_knn_exact(
    queries: np.ndarray,
    base,                      # [N, d] numpy or torch
    filt,                      # FilterSpec batch
    labels_packed: np.ndarray,
    values: np.ndarray,
    k: int,
    device=None,
    q_chunk: int = 64,
    n_block: int = 1 << 18,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact filtered top-k (paper Def. 2.5).

    Returns host (idx[B,k] i32, dist[B,k] f32) ascending; rows with fewer
    than k valid items are padded with idx=-1, dist=+inf.
    """
    dev = resolve_device(device)
    base_t = torch.as_tensor(base).to(dev, torch.float32)
    n = base_t.shape[0]
    bn = (base_t * base_t).sum(dim=1)
    b = queries.shape[0]
    out_i = np.empty((b, k), np.int32)
    out_d = np.empty((b, k), np.float32)
    for s in range(0, b, q_chunk):
        e = min(s + q_chunk, b)
        q = torch.as_tensor(np.asarray(queries[s:e], np.float32)).to(dev)
        ok = torch.from_numpy(filter_matrix(filt.slice(slice(s, e)),
                                            labels_packed, values)).to(dev)
        qn = (q * q).sum(dim=1)[:, None]
        d2 = torch.empty((e - s, n), dtype=torch.float32, device=dev)
        for c in range(0, n, n_block):
            ce = min(c + n_block, n)
            d2[:, c:ce] = torch.clamp(
                qn + bn[c:ce] - 2.0 * (q @ base_t[c:ce].T), min=0.0)
        d2 = torch.where(ok, d2, INF)
        dd, idx = torch.topk(d2, min(k, n), dim=1, largest=False, sorted=True)
        idx = torch.where(torch.isinf(dd), -1, idx)
        out_i[s:e] = idx.to(torch.int32).cpu().numpy()
        out_d[s:e] = dd.cpu().numpy()
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

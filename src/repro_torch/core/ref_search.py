"""Sequential numpy reference of the lockstep engine (oracle for tests).

Counterpart of `repro/core/ref_search.py`, the same code: it mirrors
`core.search`'s post-mode semantics exactly (same stable-sort merge order,
same NDC accounting, same termination rules) but written as the obvious
per-query CPU loop — the shape of the paper's own Algorithm 1. Host numpy
only; the predicate kinds are `filters.predicates`'.
"""
from __future__ import annotations

import numpy as np

from repro_torch.filters.predicates import PRED_CONTAIN, PRED_EQUAL, PRED_RANGE


def _pred_one(kind, attrs, q_attr, ids):
    ids = np.asarray(ids)
    if kind == PRED_RANGE:
        lo, hi = q_attr
        v = attrs[ids]
        return (v >= lo) & (v <= hi)
    masks = attrs[ids]
    if kind == PRED_CONTAIN:
        return ((masks & q_attr) == q_attr).all(axis=-1)
    if kind == PRED_EQUAL:
        return (masks == q_attr).all(axis=-1)
    raise ValueError(kind)


def ref_search_single(
    query: np.ndarray,
    q_attr,
    base: np.ndarray,
    attrs,
    neighbors: np.ndarray,
    entry: int,
    k: int,
    queue_size: int,
    budget: int,
    pred_kind: int,
    gt_dist: np.ndarray | None = None,
):
    """Returns dict with res_idx/res_dist/cnt/hops/counters/conv_cnt."""
    m = queue_size
    d0 = float(((query - base[entry]) ** 2).sum())
    v0 = bool(_pred_one(pred_kind, attrs, q_attr, np.array([entry]))[0])

    cand_d = np.full(m, np.inf, np.float32)
    cand_i = np.full(m, -1, np.int64)
    cand_e = np.zeros(m, bool)
    cand_v = np.zeros(m, bool)
    cand_d[0], cand_i[0], cand_v[0] = d0, entry, v0

    res_d = np.full(k, np.inf, np.float32)
    res_i = np.full(k, -1, np.int64)
    if v0:
        res_d[0], res_i[0] = d0, entry

    visited = {entry}
    cnt, insp, nvv, npop, hops = 1, 1, int(v0), 0, 0
    conv = -1
    res_full = 1 if (v0 and k == 1) else -1

    def covered():
        return gt_dist is not None and np.all(res_d <= gt_dist + 1e-6)

    while True:
        pk = np.where(~cand_e & (cand_i >= 0), cand_d, np.inf)
        p = int(np.argmin(pk))
        if not np.isfinite(pk[p]):
            break
        if cnt >= budget:
            break
        u = int(cand_i[p])
        cand_e[p] = True
        npop += int(cand_v[p])
        hops += 1

        nb = neighbors[u]
        nb = nb[nb >= 0]
        new = np.array([x for x in nb if x not in visited], dtype=np.int64)
        visited.update(int(x) for x in new)
        if new.size:
            dd = ((base[new] - query) ** 2).sum(axis=1).astype(np.float32)
            vv = _pred_one(pred_kind, attrs, q_attr, new)
            cnt += new.size
            insp += new.size
            nvv += int(vv.sum())
            # queue merge — identical stable order to lockstep concat
            md = np.concatenate([cand_d, dd])
            mi = np.concatenate([cand_i, new])
            me = np.concatenate([cand_e, np.zeros(new.size, bool)])
            mv = np.concatenate([cand_v, vv])
            order = np.argsort(md, kind="stable")[:m]
            cand_d, cand_i, cand_e, cand_v = md[order], mi[order], me[order], mv[order]
            # result merge
            rd = np.concatenate([res_d, np.where(vv, dd, np.inf)])
            ri = np.concatenate([res_i, np.where(vv, new, -1)])
            order = np.argsort(rd, kind="stable")[:k]
            res_d, res_i = rd[order], ri[order]
        if conv < 0 and covered():
            conv = cnt
        if res_full < 0 and np.isfinite(res_d[-1]):
            res_full = cnt

    return dict(
        res_idx=res_i,
        res_dist=res_d,
        cnt=cnt,
        n_inspected=insp,
        n_valid_visited=nvv,
        n_pop_valid=npop,
        hops=hops,
        conv_cnt=conv,
        res_full_cnt=res_full,
    )

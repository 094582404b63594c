"""Batched proximity-graph construction on the device: NN-descent + α-prune.

Counterpart of `repro/index/builder.py::build_graph_index`, the same
algorithm (random R-regular init → NN-descent rounds over forward ∪
reverse ∪ full two-hop candidates → Vamana α-prune → reverse-edge fill →
medoid entry), written as tensor operations so it runs on the card:

  * blockwise candidate distances are gathered rows × a batched product
    (`torch.bmm`) — plain large products, as `repro` left them to numpy;
  * the reverse adjacency (`_symmetrize`) and the reverse fill, per-node
    Python loops in `repro`, are sorts, cumulative sums and scatters here
    (at 1M nodes the loops would take hours);
  * the join block is sized from the device's free memory, not from
    `repro`'s 2^26-element host heuristic.

The random init draws with numpy `default_rng(seed)` as `repro` does.
Float summation order differs from numpy's, so the graph is not
bit-identical to `repro`'s; the tests hold its search recall to it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.graph import GraphIndex, ShardedGraphIndex

INF = float("inf")


def _rows_per_block(per_row_elems: int, device: torch.device) -> int:
    """Rows of a [rows, per_row_elems] f32 temporary that fit the budget."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = min(free // 8, 4 << 30) // 4  # elements; leaves headroom
    else:
        budget = 1 << 26
    return int(max(64, budget // max(per_row_elems, 1)))


def _block_sqdist(x, y, xn, yn):
    """x[B,d], y[B,C,d] (norms xn[B], yn[B,C]) -> [B,C] squared L2."""
    xy = torch.bmm(y, x[:, :, None])[..., 0]
    return torch.clamp(xn[:, None] + yn - 2.0 * xy, min=0.0)


def _cand_sqdist(vectors, norms, s, e, cand):
    """Squared L2 from rows [s, e) to their candidates cand[e-s, C]
    (+inf on -1 slots)."""
    safe = cand.clamp(min=0).long()
    d = _block_sqdist(vectors[s:e], vectors[safe], norms[s:e], norms[safe])
    return torch.where(cand < 0, INF, d)


def _best_r_distinct(cand, dist, r, self_ids):
    """Per-row: drop duplicate / self candidates, keep the r nearest."""
    dist = torch.where(cand == self_ids[:, None], INF, dist)
    dist = torch.where(cand < 0, INF, dist)
    cs, order = torch.sort(cand, dim=1, stable=True)
    ds = torch.gather(dist, 1, order)
    dup = torch.zeros_like(cs, dtype=torch.bool)
    dup[:, 1:] = cs[:, 1:] == cs[:, :-1]
    ds = torch.where(dup, INF, ds)
    out_d, sel = torch.sort(ds, dim=1, stable=True)
    out_d, sel = out_d[:, :r], sel[:, :r]
    out_c = torch.gather(cs, 1, sel)
    out_c = torch.where(torch.isinf(out_d), -1, out_c)
    return out_c.to(torch.int32), out_d


def _alpha_prune_block(cand, cand_dist, vectors, norms, r, alpha):
    """Vamana robust-prune for a block of nodes (vectorized over the block).

    cand[blk, C] sorted ascending by cand_dist. Greedily keep candidate j
    unless some already-kept u dominates it: alpha * d(u, j) <= d(p, j).
    """
    blk, c = cand.shape
    safe = cand.clamp(min=0).long()
    cv = vectors[safe]                                   # [blk, C, d]
    nrm = norms[safe]
    cc = nrm[:, :, None] + nrm[:, None, :] - 2.0 * torch.bmm(
        cv, cv.transpose(1, 2))
    cc = torch.clamp(cc, min=0.0)

    keep = torch.zeros((blk, c), dtype=torch.bool, device=cand.device)
    pruned = ~torch.isfinite(cand_dist) | (cand < 0)
    kept_count = torch.zeros(blk, dtype=torch.int64, device=cand.device)
    a2 = float(np.float32(alpha * alpha))  # squared-distance domain
    for j in range(c):
        sel = (~pruned[:, j]) & (kept_count < r)
        keep[:, j] |= sel
        kept_count += sel
        dom = a2 * cc[:, j, :] <= cand_dist
        dom[:, : j + 1] = False
        pruned |= dom & sel[:, None]
    out = torch.where(keep, cand, -1)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return torch.gather(out, 1, order)[:, :r].to(torch.int32)


def _symmetrize(neighbors, r_cap: int):
    """Reverse adjacency [N, 2*r_cap]: for each node, the first 2*r_cap
    sources (in ascending id order) of edges pointing at it, -1 padded."""
    n, r = neighbors.shape
    dev = neighbors.device
    src = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(r)
    dst = neighbors.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok].long()
    rdst, order = torch.sort(dst, stable=True)
    rsrc = src[order]
    counts = torch.bincount(rdst, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(rdst.shape[0], device=dev) - starts[rdst]
    cap = 2 * r_cap
    keep = rank < cap
    rev = torch.full((n, cap), -1, dtype=torch.int32, device=dev)
    rev[rdst[keep], rank[keep]] = rsrc[keep]
    return rev


def _reverse_fill(blk_nb, cb, db, r):
    """Fill the empty slots of blk_nb[b, r] with the nearest reverse
    candidates cb[b, C] (distances db, already +inf on slots that may not
    be used), skipping ids already taken — `repro`'s per-row loop."""
    have = (blk_nb >= 0).sum(dim=1)
    db, order = torch.sort(db, dim=1, stable=True)
    cb = torch.gather(cb, 1, order)
    # an id repeated later in the nearest-first row is not taken twice
    cs, by_id = torch.sort(cb, dim=1, stable=True)
    rep_sorted = torch.zeros_like(cs, dtype=torch.bool)
    rep_sorted[:, 1:] = cs[:, 1:] == cs[:, :-1]
    rep = torch.zeros_like(rep_sorted).scatter_(1, by_id, rep_sorted)
    ok = torch.isfinite(db) & ~rep
    rank = torch.cumsum(ok.to(torch.int64), dim=1) - 1
    take = ok & (rank < (r - have)[:, None])
    fills = torch.full((cb.shape[0], r + 1), -1, dtype=torch.int32,
                       device=cb.device)
    fills.scatter_(1, torch.where(take, rank, r), cb)
    n_fill = take.sum(dim=1)
    empty = blk_nb < 0
    slot_rank = torch.cumsum(empty.to(torch.int64), dim=1) - 1
    put = empty & (slot_rank < n_fill[:, None])
    got = torch.gather(fills, 1, slot_rank.clamp(0, r - 1))
    return torch.where(put, got, blk_nb)


def build_graph_index(
    vectors,
    degree: int = 32,
    n_iters: int = 10,
    alpha: float = 1.2,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> GraphIndex:
    """NN-descent + α-prune graph over `vectors` [N, d] (numpy or torch),
    built on `device` (the card unless `device="cpu"`)."""
    dev = resolve_device(device)
    vectors = torch.as_tensor(np.asarray(vectors, np.float32)
                              if not isinstance(vectors, torch.Tensor)
                              else vectors).to(dev, torch.float32).contiguous()
    n, dim = vectors.shape
    r = min(degree, n - 1)
    rng = np.random.default_rng(seed)
    norms = (vectors * vectors).sum(dim=1)
    rows = torch.arange(n, device=dev, dtype=torch.int32)

    # --- init: random r-regular (host draw, as in repro) ---
    nb = torch.from_numpy(
        rng.integers(0, n - 1, size=(n, r)).astype(np.int32)).to(dev)
    nb = torch.where(nb >= rows[:, None], nb + 1, nb)
    block = _rows_per_block(r * dim, dev)
    nb_dist = torch.empty((n, r), dtype=torch.float32, device=dev)
    for s in range(0, n, block):
        e = min(s + block, n)
        nb_dist[s:e] = _cand_sqdist(vectors, norms, s, e, nb[s:e])

    # --- NN-descent rounds (full 2-hop join) ---
    cand_width = r + 2 * r + r * r
    join_block = _rows_per_block(cand_width * dim, dev)
    for it in range(n_iters):
        rev = _symmetrize(nb, r_cap=r)
        new_nb = torch.empty_like(nb)
        new_d = torch.empty_like(nb_dist)
        for s in range(0, n, join_block):
            e = min(s + join_block, n)
            blk = nb[s:e]
            hop2 = nb[blk.clamp(min=0).long()].reshape(e - s, r * r)
            hop2 = torch.where((blk >= 0).repeat_interleave(r, dim=1), hop2, -1)
            cb = torch.cat([blk, rev[s:e, : 2 * r], hop2], dim=1)
            db = _cand_sqdist(vectors, norms, s, e, cb)
            new_nb[s:e], new_d[s:e] = _best_r_distinct(cb, db, r, rows[s:e])
        changed = float((new_nb != nb).to(torch.float32).mean())
        nb, nb_dist = new_nb, new_d
        if verbose:
            print(f"[nn-descent] iter {it}: changed={changed:.3f}")
        if changed < 0.01:
            break

    # --- alpha prune for navigability (keeps some long edges) ---
    pruned = torch.empty_like(nb)
    block = _rows_per_block(r * dim, dev)
    for s in range(0, n, block):
        e = min(s + block, n)
        pruned[s:e] = _alpha_prune_block(nb[s:e], nb_dist[s:e], vectors,
                                         norms, r, alpha)

    # --- fill spare slots with reverse edges, nearest first ---
    rev = _symmetrize(pruned, r_cap=r)
    final = pruned.clone()
    block = _rows_per_block(2 * r * dim, dev)
    for s in range(0, n, block):
        e = min(s + block, n)
        blk = final[s:e]
        cb = rev[s:e]
        db = _cand_sqdist(vectors, norms, s, e, cb)
        dup = (cb[:, :, None] == blk[:, None, :]).any(dim=2)
        db = torch.where(dup | (cb == rows[s:e, None]), INF, db)
        final[s:e] = _reverse_fill(blk, cb, db, r)

    # --- medoid entry ---
    mean = vectors.mean(dim=0)
    sq = torch.empty(n, dtype=torch.float32, device=dev)
    for s in range(0, n, block):
        e = min(s + block, n)
        sq[s:e] = ((vectors[s:e] - mean) ** 2).sum(dim=1)
    entry = int(torch.argmin(sq))

    g = GraphIndex(neighbors=final.contiguous(), entry_point=entry, dim=dim)
    g.validate()
    return g


def build_sharded_graph_index(
    vectors,
    n_shards: int,
    degree: int = 32,
    **build_kw,
) -> ShardedGraphIndex:
    """Cut the corpus into S contiguous equal slices and build one
    independent graph per slice (shard-local node ids) with
    `build_graph_index` on the same device (`build_kw`: n_iters, alpha,
    seed, device, ...). Counterpart of
    `repro/index/builder.py::build_sharded_graph_index`: a query then
    probes every shard (⌈W/S⌉ of its budget each) and the global result
    set comes from the cross-shard merge."""
    n = vectors.shape[0]
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n % n_shards != 0:
        raise ValueError(
            f"N={n} not divisible by n_shards={n_shards} — pad the corpus "
            f"to a multiple of {n_shards} (the shards are equal slices)")
    ns = n // n_shards
    shards = []
    for s in range(n_shards):
        g = build_graph_index(vectors[s * ns:(s + 1) * ns], degree=degree,
                              **build_kw)
        g.shard = s
        g.offset = s * ns
        shards.append(g)
    out = ShardedGraphIndex(shards=shards)
    out.validate()
    return out

"""Cross-shard top-k merge for index-axis-sharded search.

Counterpart of `repro/distributed/merge.py`'s single-device part. Each
index shard finishes a traversal holding sorted per-shard pools (result
set [B, K], candidate queue [B, M]); `merge_stacked` combines S such pools
into the global top-m.

Every pool entry carries a position — its slot in the virtual
concatenation of the S pools (pos = shard·W + slot), unique across the
union. The reference keeps the best m under the total order (dist, pos)
by a pairwise bitonic merge tree; under a total order any merge gives the
same answer, the first m entries of the stable sort of the union by
distance, ties included. On one device that is one stable sort of the
concatenated pools, which is what `merge_stacked` runs. Distances are
moved, never recomputed, so no rounding enters through the merge. The
tree's pairwise merge comes with the mesh path (`butterfly_merge`), where
pools meet one pair at a time across devices.
"""
from __future__ import annotations

import torch

#: pos of width padding in the reference's merge tree — sorts after every
#: real entry (real positions are small non-negative slot indices)
PAD_POS = 2**31 - 1


def merge_plan(n_shards: int) -> tuple[int, int]:
    """(pairwise merges, tree depth) of an S-way cross-shard reduction:
    S − 1 pairwise pool merges over ⌈log2 S⌉ rounds, the numbers EXPLAIN
    attributes to the merge. S ≤ 1 merges nothing: (0, 0)."""
    if n_shards <= 1:
        return 0, 0
    return n_shards - 1, (n_shards - 1).bit_length()


def merge_stacked(dists, pays, m: int, shard0: int = 0):
    """Merge stacked per-shard pools [B, S, W] (each sorted ascending by
    distance) → the global best m [B, min(m, S·W)] under (dist, pos), by
    one stable sort of the union in shard order. `shard0` offsets the
    positions (a contiguous slice of shards). Returns (dist, payload,
    pos int32)."""
    b, s, w = dists.shape
    flat = dists.reshape(b, s * w)
    order = torch.sort(flat, dim=1, stable=True).indices[:, :m]
    return (torch.gather(flat, 1, order),
            torch.gather(pays.reshape(b, s * w), 1, order),
            (order + shard0 * w).to(torch.int32))

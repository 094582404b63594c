"""Cross-shard top-k merge for index-axis-sharded search.

Counterpart of `repro/distributed/merge.py`. Each index shard finishes a
traversal holding sorted per-shard pools (result set [B, K], candidate
queue [B, M]); this module combines S such pools into the global top-m,
the operation both paths of the sharded engine share:

  * the loop path, and each mesh position's local shards:
    `merge_stacked` over the stacked [B, S, W] pools;
  * across a mesh's index axis: `butterfly_merge` — XOR-butterfly rounds
    of the pairwise `merge_sorted_pools` (a power-of-two axis) or one
    gather of every position's pool and `merge_stacked` (any other size).

Every pool entry carries a position — its slot in the virtual
concatenation of the S pools (pos = global shard · W + slot,
`pool_positions`), unique across the union. The merges keep the best m
under the total order (dist, pos). A top-m under a total order is
associative and commutative, so any merge tree — one stable sort of the
union, the reference's pairwise tree, the butterfly — gives the same
answer: the first m entries of the stable sort of the union by distance,
ties included. That is what holds the mesh path to the loop path bit for
bit. Distances are moved, never recomputed, so no rounding enters
through the merge.

The mesh is single-controller (`distributed.sharding`): a butterfly
round fetches the partner's pool with `.to(device)` where the reference
runs `ppermute`, and the gather is a `.to(device)` of every pool where
the reference runs `all_gather`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk import bitonic_merge_phase

#: pos of width padding in the pairwise merge — sorts after every real
#: entry (real positions are small non-negative slot indices)
PAD_POS = 2**31 - 1


def merge_plan(n_shards: int) -> tuple[int, int]:
    """(pairwise merges, tree depth) of an S-way cross-shard reduction:
    S − 1 pairwise pool merges over ⌈log2 S⌉ rounds, the numbers EXPLAIN
    attributes to the merge. S ≤ 1 merges nothing: (0, 0)."""
    if n_shards <= 1:
        return 0, 0
    return n_shards - 1, (n_shards - 1).bit_length()


def pool_positions(width: int, shard0: int, n_shards: int, b: int,
                   device=None) -> torch.Tensor:
    """Position lanes [B, n_shards, width] int32 for the pools of global
    shards shard0 … shard0 + n_shards − 1: pos = global shard · width +
    slot."""
    s = torch.arange(n_shards, dtype=torch.int32, device=device) + shard0
    pos = s[:, None] * width + torch.arange(width, dtype=torch.int32,
                                            device=device)
    return pos[None].expand(b, n_shards, width)


def merge_sorted_pools(d_a, p_a, o_a, d_b, p_b, o_b, m: int):
    """Merge two pools sorted ascending by (dist, pos); keep the best m.

    d_* [B, W*] f32, p_* int32 payloads, o_* int32 positions (unique
    across both pools). `A ++ pads ++ reversed(B)` is bitonic under (dist,
    pos) — pads carry (inf, PAD_POS, −1), after every real entry — so one
    bitonic merge phase sorts it. Returns (dist, payload, pos) [B, m]."""
    b, wa = d_a.shape
    wb = d_b.shape[1]
    w = 1 << (wa + wb - 1).bit_length()
    pad = w - wa - wb

    def cat(a, fill, bb):
        return torch.cat([a, a.new_full((b, pad), fill), bb.flip(1)], dim=1)

    keys, pos, (pay,) = bitonic_merge_phase(
        cat(d_a, float("inf"), d_b), cat(o_a, PAD_POS, o_b),
        (cat(p_a, -1, p_b),))
    return keys[:, :m], pay[:, :m], pos[:, :m]


def merge_stacked(dists, pays, m: int, shard0: int = 0, pos=None):
    """Merge stacked per-shard pools [B, S, W] → the global best m
    [B, min(m, S·W)] under (dist, pos).

    Without `pos` the positions are `pool_positions(W, shard0, S, B)`:
    they rise with the flat index, so one stable sort of the union by
    distance is the (dist, pos) order. With `pos` [B, S, W] (the
    butterfly's gather) the union is sorted by position first, then
    stably by distance. Returns (dist, payload, pos int32)."""
    b, s, w = dists.shape
    flat = dists.reshape(b, s * w)
    if pos is None:
        order = torch.sort(flat, dim=1, stable=True).indices[:, :m]
        out_pos = (order + shard0 * w).to(torch.int32)
    else:
        fpos = pos.reshape(b, s * w)
        by_pos = torch.sort(fpos, dim=1, stable=True).indices
        order = torch.gather(by_pos, 1, torch.sort(
            torch.gather(flat, 1, by_pos), dim=1,
            stable=True).indices[:, :m])
        out_pos = torch.gather(fpos, 1, order)
    return (torch.gather(flat, 1, order),
            torch.gather(pays.reshape(b, s * w), 1, order), out_pos)


def butterfly_merge(pools: list, m: int, devices: list | None = None
                    ) -> list:
    """The merge across a mesh's index axis: `pools[i]` = (d, p, o) [B, m']
    of position i, on `devices[i]` (each pool's own device by default),
    already merged over that position's shards and sorted by (dist, pos)
    with globally unique positions. Returns every position's global top-m
    (identical values, each on its position's device).

    A power-of-two axis runs log2(D) XOR-butterfly rounds: in round r
    position i fetches partner i ^ 2^r's pool and runs
    `merge_sorted_pools` (both partners compute the same pool: the merge
    is the unique top-m of the union, whatever the operand order). Any
    other size gathers every pool on each device and runs
    `merge_stacked(pos=)`. D = 1 returns the pool unchanged."""
    n = len(pools)
    if devices is None:
        devices = [p[0].device for p in pools]
    if n == 1:
        return list(pools)
    if n & (n - 1) == 0:
        for r in range(n.bit_length() - 1):
            pools = [merge_sorted_pools(
                *pools[i], *(x.to(devices[i]) for x in pools[i ^ (1 << r)]),
                m) for i in range(n)]
        return pools
    out = []
    for dev in devices:
        d, p, o = (torch.stack([pl[j].to(dev) for pl in pools], dim=1)
                   for j in range(3))
        out.append(merge_stacked(d, p, m, pos=o))
    return out

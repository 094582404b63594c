"""Per-shard EXPLAIN attribution for index-axis-sharded searches.

Counterpart of `repro/obs/shard.py`. A `ShardedSearchState`
(`core/sharded.py`) carries two views of every query: the merged global
view every consumer reads, and the per-shard carries `state.shard`
([B, S, ...] leaves) it was reduced from. The merged counters are exact
integer sums over that stacked axis, so the attribution built here is
exact by construction: for every lane

    Σ_s section[s].ndc               == merged cnt
    Σ_s section[s].hops              == merged hops
    Σ_s section[s].n_inspected       == merged n_inspected
    Σ_s section[s].n_clause_valid[c] == merged n_clause_valid[c]

— the sections read the same stacked tensors the merge summed, brought
to the host in one transfer (`obs.explain.host_leaves`) after the search.

Per-shard termination reuses `obs.explain.termination_reasons` on each
shard's slice of the carry, judged against the slice ⌈W/S⌉ of the budget
the shard ran under. The merge topology comes from `distributed.merge`:
S pools reduce through S − 1 pairwise merges in ⌈log2 S⌉ rounds.

The work-balance index, total NDC / (S · max_s shard NDC) ∈ (0, 1], is
1.0 when every shard spent the same; a filter whose valid rows sit in
one shard drives it toward 1/S.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np

from repro_torch.distributed.merge import merge_plan
from repro_torch.obs.explain import host_leaves, termination_reasons

_SHARD_LEAVES = ("cnt", "hops", "n_inspected", "n_clause_valid", "cand_dist",
                 "cand_idx", "cand_exp", "res_dist")


@dataclasses.dataclass
class ShardSection:
    """One shard's slice of one query's execution."""

    shard: int                 # shard index (global row offset order)
    budget: int                # the ⌈W/S⌉ slice this shard ran under
    ndc: int                   # per-shard NDC (sums exactly to merged cnt)
    hops: int                  # per-shard expansions
    n_inspected: int           # per-shard neighbor inspections
    termination: str           # obs.explain reason, judged at `budget`
    n_clause_valid: list = dataclasses.field(default_factory=list)


def shard_budgets(budgets, n_shards: int) -> np.ndarray:
    """Per-shard budget slices ⌈W/S⌉ [B], as `core.sharded` cuts them."""
    b = np.asarray(budgets, np.int64)
    return (b + n_shards - 1) // n_shards


def work_balance(shard_ndc: np.ndarray) -> np.ndarray:
    """[B] balance index from per-shard NDC [B, S]: total / (S · max), 1.0
    for lanes that spent nothing anywhere."""
    shard_ndc = np.asarray(shard_ndc, np.float64)
    s = shard_ndc.shape[1]
    mx = shard_ndc.max(axis=1)
    tot = shard_ndc.sum(axis=1)
    return np.where(mx > 0, tot / np.maximum(s * mx, 1.0), 1.0)


def build_shard_sections(cfg, state, budgets) -> list[list[ShardSection]]:
    """[B][S] sections from a ShardedSearchState's per-shard carries.

    `budgets` is the *global* per-lane budget [B] (or a scalar) the
    sharded search ran with; sections judge termination at its ⌈W/S⌉
    slice."""
    h = host_leaves(state.shard, _SHARD_LEAVES)
    cnt = h["cnt"]                                           # [B, S]
    b, s = cnt.shape
    sbud = np.broadcast_to(shard_budgets(budgets, s), (b,))

    sections: list[list[ShardSection]] = [[] for _ in range(b)]
    for j in range(s):
        # a per-shard slice of the carry, on the host: the five leaves
        # termination_reasons reads
        sub = SimpleNamespace(cand_dist=h["cand_dist"][:, j],
                              cand_idx=h["cand_idx"][:, j],
                              cand_exp=h["cand_exp"][:, j],
                              res_dist=h["res_dist"][:, j], cnt=cnt[:, j])
        terms = termination_reasons(cfg, sub, sbud)
        for i in range(b):
            sections[i].append(ShardSection(
                shard=j, budget=int(sbud[i]), ndc=int(cnt[i, j]),
                hops=int(h["hops"][i, j]),
                n_inspected=int(h["n_inspected"][i, j]),
                termination=terms[i],
                n_clause_valid=[int(v) for v in h["n_clause_valid"][i, j]]))
    return sections


def attach_shard_sections(reports, cfg, state, budgets) -> list:
    """Give each of `reports` (obs.explain.QueryReport) its per-shard
    sections, the merge topology and the work-balance index. Returns the
    reports untouched when `state` has no per-shard carries."""
    sh = getattr(state, "shard", None)
    if sh is None:
        return reports
    sections = build_shard_sections(cfg, state, budgets)
    bal = work_balance([[sec.ndc for sec in lane] for lane in sections])
    pairwise, depth = merge_plan(len(sections[0]) if sections else 1)
    for i, r in enumerate(reports):
        r.shards = sections[i]
        r.work_balance = float(bal[i])
        r.merge_pairwise = pairwise
        r.merge_depth = depth
    return reports

"""Search-state layer: configuration, the lockstep carry, init and resume.

Counterpart of `repro/core/state.py`, with the same `SearchConfig` fields
and the same 18 `SearchState` leaves, as torch tensors:

  candidate queue   sorted ascending [B, M]  (dist, idx, expanded, valid)
  result set        sorted ascending [B, K]  (valid nodes only)
  visited set       packed bitset    [B, ceil(N/32)] — int32 holding the
                    reference's uint32 bit patterns (see `word_bit`)
  counters          cnt (NDC), n_inspected, n_valid_visited, n_pop_valid,
                    n_clause_valid (per clause slot), hops, q_err_sum

Lane surgery (`take_lanes`, `put_lanes`) serves the persistent loop's
lane compaction, `concat_lanes` the planner's merge of its per-plan
parts, `pad_lanes` inert lane padding, and `slice_lanes` / `tree_to` a
mesh position's slice of the batch on its device. Shard surgery
(`stack_shards`, `take_shard`) moves between per-shard states and the
sharded engine's stacked carry, whose leaves hold the shard axis second
([B, S, ...]), so the lane helpers keep working on axis 0. Under a compressed precision ("int8",
"pq") the entry distance, and every distance after it, is the codec's
ADC distance (`repro_torch.quant`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.filters.compile import clause_counts, eval_program_gathered
from repro_torch.filters.predicates import PRED_CONTAIN
from repro_torch.kernels.distance import SCAN_ALIGN, sqdist_masked
from repro_torch.kernels.quant_rows import sqdist_rows_quant

INF = float("inf")
INT32_MIN = -(1 << 31)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    k: int = 10                # result set size
    queue_size: int = 128      # M — beam width / ef analogue
    degree: int = 32           # graph out-degree R (static)
    pred_kind: int = PRED_CONTAIN  # legacy tag; traversal ignores it
    mode: str = "post"         # "post" | "pre" | "widen"
    two_hop_stride: int = 8    # pre/widen: sample every s-th 2-hop neighbor
    max_steps: int = 100000
    greedy_stop: bool = False  # optional: stop when best cand > worst result
    backend: str | None = None # TraversalBackend name; None → engine default
    steps_per_launch: int = 8  # persistent backends: steps per K5 launch
    use_pallas: bool = False   # dense backend: distances through kernel K6
    precision: str | None = None  # "float32" | "int8" | "pq"; None
                               # inherits the engine's ("float32" alone)


class SearchState(NamedTuple):
    cand_dist: torch.Tensor       # [B, M] f32 sorted ascending, inf padded
    cand_idx: torch.Tensor        # [B, M] i32, -1 padded
    cand_exp: torch.Tensor        # [B, M] bool — already expanded
    cand_valid: torch.Tensor      # [B, M] bool — predicate validity
    res_dist: torch.Tensor        # [B, K] f32 sorted ascending, inf padded
    res_idx: torch.Tensor         # [B, K] i32, -1 padded
    visited: torch.Tensor         # [B, NW] i32 bitset (uint32 bit patterns)
    cnt: torch.Tensor             # [B] i32 — NDC (paper's W_q unit)
    n_inspected: torch.Tensor     # [B] i32 — predicate evaluations
    n_valid_visited: torch.Tensor # [B] i32 — valid among inspected
    n_clause_valid: torch.Tensor  # [B, C] i32 — per-clause-slot hits
    n_pop_valid: torch.Tensor     # [B] i32 — valid among popped/expanded
    q_err_sum: torch.Tensor       # [B] f32 — Σ ‖x − x̂‖² over inspected
                                  # nodes (0 in float32 mode)
    hops: torch.Tensor            # [B] i32 — expansions (search hops)
    active: torch.Tensor          # [B] bool
    d_start: torch.Tensor         # [B] f32 — entry-point distance
    conv_cnt: torch.Tensor        # [B] i32 — NDC at first full recall, -1
    res_full_cnt: torch.Tensor    # [B] i32 — NDC when the k-th valid was found, -1


def word_bit(ids: torch.Tensor) -> torch.Tensor:
    """The visited-bitset word bit of node ids >= 0, as int32 bit patterns.

    Bit 31 is INT32_MIN; shifting into the sign bit is avoided so the
    value does not depend on signed-overflow behaviour.
    """
    sh = ids & 31
    one = torch.ones_like(sh)
    return torch.where(sh == 31, INT32_MIN, one << sh.clamp(max=30))


def init_state(
    cfg: SearchConfig,
    queries: torch.Tensor,       # [B, d]
    prog,                        # FilterProgram (leaves [B, S, ...])
    base_vectors: torch.Tensor,  # [N, d]
    attrs,                       # (labels [N, W] i32, values [N, V] f32)
    entry_point: int,
    quant=None,                  # Int8Index | PQIndex (compressed mode)
    qprep=None,                  # its prepared per-query ADC state
) -> SearchState:
    dev = queries.device
    b = queries.shape[0]
    n = base_vectors.shape[0]
    nw = (n + 31) // 32
    m, k = cfg.queue_size, cfg.k
    labels, values = attrs
    i32 = torch.int32

    ep = torch.full((b, 1), entry_point, dtype=i32, device=dev)
    if (cfg.precision or "float32") != "float32":
        # the entry distance in the compressed domain: the whole traversal,
        # d_start included, lives in one metric. K6q rows (the entry id in
        # position 0 of a SCAN_ALIGN-wide row, the rest masked) computes it
        # as K3 / K4 compute that pair, whatever the batch width
        ids = torch.full((b, SCAN_ALIGN), entry_point, dtype=i32, device=dev)
        on = torch.zeros((b, SCAN_ALIGN), dtype=torch.bool, device=dev)
        on[:, 0] = True
        d0 = sqdist_rows_quant(qprep, quant.codes, quant.norms, ids,
                               on)[:, :1]
        err0 = quant.err[entry_point].expand(b).clone()
    else:
        # K6 over the one entry row: K1's bits for the pair, whatever the
        # batch width (a torch reduction's rounding depends on it)
        row = base_vectors[entry_point][None, None, :].expand(b, 1, -1)
        d0 = sqdist_masked(queries, row.contiguous(),
                           torch.ones((b, 1), dtype=torch.bool, device=dev))
        err0 = torch.zeros((b,), dtype=torch.float32, device=dev)
    val0, csat0 = eval_program_gathered(
        prog, labels[entry_point][None, None, :].expand(b, 1, -1),
        values[entry_point][None, None, :].expand(b, 1, -1))
    cadd0 = clause_counts(csat0, torch.ones_like(val0))
    v0 = val0[:, 0]

    cand_dist = torch.full((b, m), INF, device=dev)
    cand_dist[:, 0] = d0[:, 0]
    cand_idx = torch.full((b, m), -1, dtype=i32, device=dev)
    cand_idx[:, 0] = entry_point
    cand_exp = torch.zeros((b, m), dtype=torch.bool, device=dev)
    cand_valid = torch.zeros((b, m), dtype=torch.bool, device=dev)
    cand_valid[:, 0] = v0

    res_dist = torch.full((b, k), INF, device=dev)
    res_dist[:, 0] = torch.where(v0, d0[:, 0], INF)
    res_idx = torch.full((b, k), -1, dtype=i32, device=dev)
    res_idx[:, 0] = torch.where(v0, ep[:, 0], -1)

    visited = torch.zeros((b, nw), dtype=i32, device=dev)
    visited[:, entry_point // 32] = word_bit(ep[:, 0])

    ones = torch.ones((b,), dtype=i32, device=dev)
    zeros = torch.zeros((b,), dtype=i32, device=dev)
    return SearchState(
        cand_dist=cand_dist,
        cand_idx=cand_idx,
        cand_exp=cand_exp,
        cand_valid=cand_valid,
        res_dist=res_dist,
        res_idx=res_idx,
        visited=visited,
        cnt=ones,
        n_inspected=ones.clone(),
        n_valid_visited=v0.to(i32),
        n_clause_valid=cadd0,
        n_pop_valid=zeros,
        q_err_sum=err0,
        hops=zeros.clone(),
        active=torch.ones((b,), dtype=torch.bool, device=dev),
        d_start=d0[:, 0].contiguous(),
        conv_cnt=torch.full((b,), -1, dtype=i32, device=dev),
        res_full_cnt=torch.where(v0 & (k == 1), 1, -1).to(i32),
    )


def prepare_resume(state: SearchState) -> SearchState:
    """Reactivate lanes that stopped purely on budget (probe → resume)."""
    return state._replace(active=torch.ones_like(state.active))


def _lane_index(idx, device) -> torch.Tensor:
    """`idx` as an int64 tensor on `device` (no copy when it is one)."""
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def _like(tree, parts):
    """A tuple or NamedTuple of `tree`'s type holding `parts`."""
    if hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*parts)
    return type(tree)(parts)


def take_lanes(tree, idx):
    """Select lanes `idx` along axis 0 of every tensor of `tree`: a
    tensor, a SearchState, a FilterProgram or a tuple of them (None passes
    through). Counterpart of `repro/core/state.py::take_lanes`."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, _lane_index(idx, tree.device))
    return _like(tree, [take_lanes(a, idx) for a in tree])


def concat_lanes(trees):
    """Stack trees of the same structure ([b_i, ...] tensor leaves; None
    passes through) into one batch along axis 0."""
    if len(trees) == 1:
        return trees[0]
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat(list(trees), dim=0)
    return _like(first, [concat_lanes([t[i] for t in trees])
                         for i in range(len(first))])


def pad_lanes(tree, pad: int):
    """Zero-pad every tensor leaf along axis 0 by `pad` lanes. Padded lanes
    are inert: the caller gives them a 0 NDC budget, so they stop on their
    first step and the zeros never reach a real lane."""
    if pad == 0 or tree is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return torch.cat([tree, tree.new_zeros((pad, *tree.shape[1:]))])
    return _like(tree, [pad_lanes(a, pad) for a in tree])


def slice_lanes(tree, lo: int, hi: int):
    """Lanes lo … hi − 1 of every tensor of `tree`, each a fresh copy (a
    search updates its carry in place and must write no other lane; a
    kernel's buffers start where the allocator aligns them). None passes
    through."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[lo:hi].clone()
    return _like(tree, [slice_lanes(a, lo, hi) for a in tree])


def tree_to(tree, device):
    """Every tensor of `tree` on `device` (no copy for a tensor already
    there; None passes through)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return _like(tree, [tree_to(a, device) for a in tree])


def put_lanes(tree, sub, idx):
    """Scatter `sub`'s lanes back into `tree` at rows `idx` (the inverse of
    `take_lanes`), in place — the reference donates `tree` — and return
    `tree`. Duplicate rows in `idx` must carry identical values (the
    persistent launch loop pads its selection by repeating a lane)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.index_copy_(0, _lane_index(idx, tree.device), sub)
    for a, s in zip(tree, sub):
        put_lanes(a, s, idx)
    return tree


# ---- shard surgery (index-axis-sharded engines, `core/sharded.py`) ----


def stack_shards(states):
    """Stack per-shard trees ([B, ...] tensor leaves) along a new shard
    axis 1 → [B, S, ...] leaves (None passes through)."""
    first = states[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(list(states), dim=1)
    return _like(first, [stack_shards([t[i] for t in states])
                         for i in range(len(first))])


def take_shard(tree, s: int):
    """Shard `s` of a shard-stacked tree ([B, S, ...] leaves) as [B, ...]
    leaves, each a contiguous copy: a per-shard search updates its carry
    in place and must not write through to the stacked state."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[:, s].contiguous()
    return _like(tree, [take_shard(a, s) for a in tree])


def topk_results(state: SearchState) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (idx, dist) of the result set."""
    return state.res_idx.cpu().numpy(), state.res_dist.cpu().numpy()

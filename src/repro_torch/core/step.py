"""Traversal-step layer: the backend-agnostic per-step logic.

Counterpart of `repro/core/step.py::make_step`: pop → gather the frontier
→ visited test and set → (backend: filter program + distances +
queue/result merge) → counters, convergence and lane masking.

Three traversal modes, as in the reference:
  post   the 1-hop frontier; every new node gets a distance (NDC).
  pre    the 1-hop list plus the strided 2-hop list, deduplicated
         (`gather_frontier`); only predicate-valid new nodes get a
         distance and enter the queue, and only they count as NDC.
  widen  the pre frontier with post accounting and scoring (the
         planner's filtered-expansion plan).

Under a compressed precision ("int8", "pq") the step gathers the quant
index's codes, norms and reconstruction errors instead of the float
vectors, in every mode (the codes [B, R', d | S·L] at R'=160 in pre and
widen), and hands the backend a `QuantGather`.
"""
from __future__ import annotations

import torch

from repro_torch.core.state import INF, SearchConfig, SearchState, word_bit
from repro_torch.quant.codecs import QuantGather


def tree_sum(e: torch.Tensor) -> torch.Tensor:
    """Row sums of [B, R] by halving: pad with zeros to a power of 2, then
    add the second half onto the first until one column is left. Kernel K5
    sums each step's reconstruction errors in this order, so `q_err_sum`
    is bitwise the same on the single-step and the persistent path. Zero
    padding adds exact zeros, so a row's sum does not depend on how far it
    is padded (the compressed scan relies on that)."""
    r = e.shape[1]
    e = torch.nn.functional.pad(e, (0, (1 << (r - 1).bit_length()) - r))
    while e.shape[1] > 1:
        h = e.shape[1] // 2
        e = e[:, :h] + e[:, h:]
    return e[:, 0]


def gather_frontier(cfg: SearchConfig, neighbors: torch.Tensor,
                    u_safe: torch.Tensor) -> torch.Tensor:
    """Neighbor ids to inspect for the popped nodes u_safe [B] (>= 0).

    post: the 1-hop list [B, R]. pre/widen: the 1-hop list followed by the
    2-hop lists of its nodes, every `two_hop_stride`-th entry, [B, R + R·⌈R
    / stride⌉]; an id met again later in the row is blanked to -1, so the
    first occurrence in `[1-hop | 2-hop]` survives (the reference's stable
    argsort and its inverse, `repro/core/step.py:33-60`).
    """
    nb = neighbors[u_safe.long()]                            # [B, R]
    if cfg.mode not in ("pre", "widen"):
        return nb
    b, r = nb.shape
    hop2 = neighbors[nb.clamp(min=0).long()]                 # [B, R, R]
    hop2 = hop2[:, :, ::cfg.two_hop_stride].reshape(b, -1)
    hop2 = torch.where(
        torch.repeat_interleave(nb >= 0, hop2.shape[1] // r, dim=1), hop2, -1)
    nb = torch.cat([nb, hop2], dim=1)
    s, order = torch.sort(nb, dim=1, stable=True)
    dup_sorted = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                        device=nb.device),
                            s[:, 1:] == s[:, :-1]], dim=1)
    dup = torch.empty_like(dup_sorted).scatter_(1, order, dup_sorted)
    return torch.where(dup, -1, nb)


def make_step(cfg: SearchConfig, backend, queries, prog, base_vectors, attrs,
              neighbors, budgets, gt_dist, quant=None, qprep=None):
    """Build the step function closed over static data and per-lane budgets.

    The returned `step(state)` consumes `state`: its visited bitset is
    updated in place (the reference donates the carry the same way). In
    compressed mode `quant` is the Int8Index / PQIndex and `qprep` its
    per-query ADC state; the float vectors are not read.
    """
    if cfg.mode not in ("post", "pre", "widen"):
        raise ValueError(f"unknown traversal mode {cfg.mode!r}")
    label_attrs, value_attrs = attrs
    compressed = (cfg.precision or "float32") != "float32"

    def step(state: SearchState) -> SearchState:
        # ---- pop best unexpanded candidate per lane ----
        unexp = (~state.cand_exp) & (state.cand_idx >= 0)
        pop_key = torch.where(unexp, state.cand_dist, INF)
        p = torch.argmin(pop_key, dim=1)[:, None]            # first minimum
        best_d = torch.gather(pop_key, 1, p)[:, 0]
        has_cand = torch.isfinite(best_d)
        u = torch.gather(state.cand_idx, 1, p)[:, 0]
        u_valid = torch.gather(state.cand_valid, 1, p)[:, 0]

        stop_budget = state.cnt >= budgets
        act = state.active & has_cand & (~stop_budget)
        if cfg.greedy_stop:
            worst_res = state.res_dist[:, -1]
            act = act & ~(torch.isfinite(worst_res) & (best_d > worst_res))

        # ---- mark popped slot expanded (active lanes only) ----
        cand_exp = state.cand_exp.scatter(
            1, p, torch.gather(state.cand_exp, 1, p) | act[:, None])

        # ---- gather frontier neighbor ids ----
        nb = gather_frontier(cfg, neighbors, u.clamp(min=0))  # [B, R']
        nb_ok = (nb >= 0) & act[:, None]
        nb_safe = nb.clamp(min=0)
        nb_long = nb_safe.long()

        # ---- visited-set test (packed bitset) ----
        word_idx = (nb_safe >> 5).long()
        bit = word_bit(nb_safe)
        words = torch.gather(state.visited, 1, word_idx)
        seen = (words & bit) != 0
        is_new = nb_ok & (~seen)

        # ---- visited bits: wrapping int32 add, as the reference's uint32
        # add — an id repeated within a row carries into the next bit.
        # Not-new entries (inactive lanes included) add 0, so clamping
        # their index is exact and the in-place update needs no lane mask.
        visited = state.visited.scatter_add_(
            1, word_idx, torch.where(is_new, bit, 0))

        # ---- backend hot path: filter program + distances + merges ----
        labels_g = label_attrs[nb_long]                       # [B, R, W]
        values_g = value_attrs[nb_long]                       # [B, R, V]
        if compressed:
            xv = None  # the float vectors stay out of the loop
            qg = QuantGather(prep=qprep, codes=quant.codes[nb_long],
                             norms=quant.norms[nb_long])
            # every new row's error, in pre mode too (the reference's
            # order). tree_sum pads R'=160 to 256; only post mode meets K5,
            # whose order it is, and it equals the reference's
            # `.sum(axis=1)` bit for bit only where every sum is exact (the
            # tests' grid data)
            err_add = tree_sum(torch.where(is_new, quant.err[nb_long], 0.0))
        else:
            xv = base_vectors[nb_long]                        # [B, R, d]
            qg = err_add = None
        (cand_dist, cand_idx, cand_exp2, cand_valid, res_dist, res_idx,
         valid, clause_add) = backend.merge_step(
            cfg, queries, xv, nb, is_new, prog, labels_g, values_g,
            state.cand_dist, state.cand_idx, cand_exp, state.cand_valid,
            state.res_dist, state.res_idx, quant=qg)

        # ---- counters (post/widen: every new node gets a distance; pre:
        # the valid ones) ----
        zero = torch.zeros_like(state.cnt)
        dist_mask = valid if cfg.mode == "pre" else is_new
        ndc_add = dist_mask.sum(dim=1).to(torch.int32)
        insp_add = is_new.sum(dim=1).to(torch.int32)
        valid_add = valid.sum(dim=1).to(torch.int32)
        cnt = state.cnt + torch.where(act, ndc_add, zero)
        n_inspected = state.n_inspected + torch.where(act, insp_add, zero)
        n_valid_visited = state.n_valid_visited + torch.where(act, valid_add,
                                                              zero)
        n_clause_valid = state.n_clause_valid + torch.where(
            act[:, None], clause_add, 0)
        n_pop_valid = state.n_pop_valid + (act & u_valid).to(torch.int32)
        hops = state.hops + act.to(torch.int32)
        q_err_sum = state.q_err_sum if err_add is None else (
            state.q_err_sum + torch.where(act, err_add, 0.0))

        # ---- convergence tracking for W_q ground truth ----
        if gt_dist is not None:
            covered = (res_dist <= gt_dist + 1e-6).all(dim=1)
            first = (state.conv_cnt < 0) & covered
            conv_cnt = torch.where(first, cnt, state.conv_cnt)
        else:
            conv_cnt = state.conv_cnt

        # ---- NDC at which the result set filled (feature) ----
        now_full = torch.isfinite(res_dist[:, -1]) & act
        first_full = (state.res_full_cnt < 0) & now_full
        res_full_cnt = torch.where(first_full, cnt, state.res_full_cnt)

        # ---- lane masking: inactive lanes keep their old arrays ----
        am = act[:, None]
        return SearchState(
            cand_dist=torch.where(am, cand_dist, state.cand_dist),
            cand_idx=torch.where(am, cand_idx, state.cand_idx),
            cand_exp=torch.where(am, cand_exp2, cand_exp),
            cand_valid=torch.where(am, cand_valid, state.cand_valid),
            res_dist=torch.where(am, res_dist, state.res_dist),
            res_idx=torch.where(am, res_idx, state.res_idx),
            visited=visited,
            cnt=cnt,
            n_inspected=n_inspected,
            n_valid_visited=n_valid_visited,
            n_clause_valid=n_clause_valid,
            n_pop_valid=n_pop_valid,
            q_err_sum=q_err_sum,
            hops=hops,
            active=act,
            d_start=state.d_start,
            conv_cnt=conv_cnt,
            res_full_cnt=res_full_cnt,
        )

    return step

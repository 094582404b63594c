"""Runtime feature extraction (paper Table 1) from a `SearchState`.

Counterpart of `repro/core/features.py`: the same 34 features in the same
order, computed from the sorted fixed-size buffers on the device. The
arithmetic stays in float32 as in the reference — `qq * (count - 1)` for
the percentile ranks and every ratio — and `torch.round` rounds half to
even like `jnp.round`.
"""
from __future__ import annotations

import torch

from repro_torch.core.state import SearchState
from repro_torch.filters.compile import CLAUSE_FEATURE_SLOTS

FEATURE_NAMES: tuple[str, ...] = (
    # --- Global ---
    "d_start", "n_hops", "log_cnt",
    # --- Filter ---
    "rho_pilot", "rho_queue", "rho_pop",
    # --- Queue ---
    "d_queue_head", "d_queue_tail", "r_queue_head", "r_queue_tail",
    "avg_queue", "var_queue", "perc25_queue", "perc50_queue",
    "perc75_queue", "queue_fill",
    # --- Result set ---
    "d_nn_first", "d_nn_last", "r_nn_first", "r_nn_last", "avg_nn",
    "var_nn", "perc25_nn", "perc50_nn", "perc75_nn", "res_fill",
    # --- progression ---
    "log_res_full_cnt", "gap_queue_nn",
    # --- compressed-distance bias (0 at float32) ---
    "quant_err_mean", "quant_err_head",
    # --- per-clause probe selectivities ---
    "rho_clause_0", "rho_clause_1", "rho_clause_2", "rho_clause_3",
)

N_FEATURES = len(FEATURE_NAMES)

if FEATURE_NAMES[-CLAUSE_FEATURE_SLOTS:] != tuple(
        f"rho_clause_{c}" for c in range(CLAUSE_FEATURE_SLOTS)):
    raise ImportError("rho_clause_* names must track CLAUSE_FEATURE_SLOTS")

# The paper's filter-aware group, zeroed by the "w/o filter" ablation.
FILTER_FEATURE_IDX = tuple(
    FEATURE_NAMES.index(n)
    for n in ("rho_pilot", "rho_queue", "rho_pop", "log_res_full_cnt",
              "gap_queue_nn", "rho_clause_0", "rho_clause_1", "rho_clause_2",
              "rho_clause_3"))


def _stats_sorted(dist: torch.Tensor, d_start: torch.Tensor):
    """Stats over the finite prefix of an ascending-sorted [B, M] buffer."""
    m = dist.shape[1]
    finite = torch.isfinite(dist)
    count = finite.sum(dim=1)                                 # [B]
    has = count > 0
    safe_count = count.clamp(min=1)

    head = torch.where(has, dist[:, 0], d_start)
    tail_ix = (count - 1).clamp(0, m - 1)
    tail = torch.gather(dist, 1, tail_ix[:, None])[:, 0]
    tail = torch.where(has, tail, d_start)

    dz = torch.where(finite, dist, 0.0)
    s1 = dz.sum(dim=1)
    s2 = (dz * dz).sum(dim=1)
    mean = s1 / safe_count
    var = torch.clamp(s2 / safe_count - mean * mean, min=0.0)
    mean = torch.where(has, mean, d_start)
    var = torch.where(has, var, 0.0)

    percs = []
    for qq in (0.25, 0.5, 0.75):
        rank = torch.round(qq * (count - 1).to(torch.float32))
        ix = rank.to(torch.int64).clamp(0, m - 1)
        pv = torch.gather(dist, 1, ix[:, None])[:, 0]
        percs.append(torch.where(has, pv, d_start))
    fill = count.to(torch.float32) / m
    return head, tail, mean, var, percs, fill


def extract_features(state: SearchState) -> torch.Tensor:
    """SearchState -> [B, N_FEATURES] float32 feature matrix z_q."""
    ds = torch.clamp(state.d_start, min=1e-12)
    qh, qt, qm, qv, qp, qfill = _stats_sorted(state.cand_dist, state.d_start)
    rh, rt, rm, rv, rp, rfill = _stats_sorted(state.res_dist, state.d_start)

    in_q = state.cand_idx >= 0
    nq = in_q.sum(dim=1).clamp(min=1).to(torch.float32)
    rho_queue = (state.cand_valid & in_q).sum(dim=1).to(torch.float32) / nq
    f32 = torch.float32
    n_insp = state.n_inspected.clamp(min=1).to(f32)
    rho_pilot = state.n_valid_visited.to(f32) / n_insp
    rho_pop = state.n_pop_valid.to(f32) / state.hops.clamp(min=1).to(f32)
    rho_clause = state.n_clause_valid.to(f32) / n_insp[:, None]
    err_mean = state.q_err_sum / n_insp
    res_full = torch.where(state.res_full_cnt >= 0, state.res_full_cnt,
                           2 * state.cnt)

    feats = torch.stack(
        [state.d_start, state.hops.to(f32),
         torch.log1p(state.cnt.to(f32)),
         rho_pilot, rho_queue, rho_pop,
         qh, qt, qh / ds, qt / ds, qm, qv, qp[0], qp[1], qp[2], qfill,
         rh, rt, rh / ds, rt / ds, rm, rv, rp[0], rp[1], rp[2], rfill,
         torch.log1p(res_full.to(f32)),
         (qt - rt) / ds,
         err_mean / ds,
         err_mean / torch.clamp(qh, min=1e-12)]
        + [rho_clause[:, c] for c in range(rho_clause.shape[1])],
        dim=1)
    return feats.to(f32)


def ablate_filter_features(feats: torch.Tensor) -> torch.Tensor:
    """Zero the paper's filter-aware features in every [z, Δz] block."""
    out = feats.clone()
    for b in range(feats.shape[1] // N_FEATURES):
        for ix in FILTER_FEATURE_IDX:
            out[:, b * N_FEATURES + ix] = 0.0
    return out


def feature_names(n_probes: int = 2) -> list[str]:
    if n_probes <= 1:
        return list(FEATURE_NAMES)
    return list(FEATURE_NAMES) + [f"d_{n}" for n in FEATURE_NAMES]

"""E2E: probe → estimate → resume (paper Algorithm 1).

Counterpart of `repro/core/e2e.py` (tracing and EXPLAIN reports wait for
the observability slice):

  1. Early Probe   — run the lockstep search with per-lane budget f; the
                     probe is the first f NDCs of the real traversal.
  2. Cost Estimate — extract z_q from the live SearchState and run the
                     GBDT (kernel K2 on the card): Ŵ_q = α·exp(M(z_q)).
  3. Adaptive Term — resume the same carry with budget Ŵ_q.
  4. Rerank        — on a quantized engine, the terminal exact float32
                     rerank of the final pool (after the last resume; a
                     reranked state is never resumed).

`repredict_every` > 0 gives the DARTH-style iterative variant.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import BIG_BUDGET, SearchEngine
from repro_torch.core.estimator import CostEstimator
from repro_torch.core.features import ablate_filter_features, extract_features
from repro_torch.core.state import SearchConfig, SearchState


@dataclasses.dataclass
class E2EResult:
    state: SearchState
    predicted_budget: np.ndarray  # [B]
    probe_features: np.ndarray    # [B, F]


def probe_and_features(engine: SearchEngine, cfg: SearchConfig, queries,
                       filt, probe_budget: int, n_probes: int = 2,
                       gt_dist=None):
    """Run the early probe and extract trajectory features.

    With n_probes=2 the features are taken at budgets f/2 and f and
    concatenated as [z_f, z_f − z_{f/2}]; n_probes=1 is the paper's single
    snapshot. Both snapshots are prefixes of the same traversal carry.
    """
    filt = engine.compile(filt)
    if n_probes <= 1:
        state = engine.search(cfg, queries, filt, probe_budget,
                              gt_dist=gt_dist)
        return state, extract_features(state)
    state = engine.search(cfg, queries, filt, probe_budget // 2,
                          gt_dist=gt_dist)
    z1 = extract_features(state)
    state = engine.search(cfg, queries, filt, probe_budget, state=state,
                          gt_dist=gt_dist)
    z2 = extract_features(state)
    return state, torch.cat([z2, z2 - z1], dim=1)


def predict_budgets(estimator: CostEstimator, feats: torch.Tensor,
                    alpha: float, min_budget: int = 32,
                    max_budget: int = BIG_BUDGET,
                    ablate_filter: bool = False, packed=None):
    """Stage 2: features → clipped per-lane budgets Ŵ_q.

    Returns (budgets [B] i32, feats-as-predicted).
    """
    if ablate_filter:
        feats = ablate_filter_features(feats)
    budgets = estimator.predict_budget(feats, alpha, min_budget, max_budget,
                                       packed=packed)
    return budgets, feats


def e2e_search(
    engine: SearchEngine,
    estimator: CostEstimator,
    cfg: SearchConfig,
    queries,
    filt,                          # FilterSpec | FilterProgram
    probe_budget: int = 64,
    alpha: float = 1.0,
    min_budget: int = 32,
    max_budget: int = BIG_BUDGET,
    ablate_filter: bool = False,
    repredict_every: int = 0,
    max_repredict: int = 8,
    n_probes: int = 2,
) -> E2EResult:
    # --- stage 1: early probe (zero overhead — same traversal carry) ---
    filt = engine.compile(filt)
    state, feats = probe_and_features(engine, cfg, queries, filt,
                                      probe_budget, n_probes)

    # --- stage 2: cost estimation ---
    packed = estimator.packed(engine.device)
    budgets, feats = predict_budgets(estimator, feats, alpha, min_budget,
                                     max_budget, ablate_filter, packed=packed)

    # --- stage 3: adaptive termination (resume with predicted budget) ---
    if repredict_every <= 0:
        state = engine.search(cfg, queries, filt, budgets, state=state)
    else:
        # DARTH-style stepwise: advance Δ NDCs, re-predict, stop when the
        # model says the spent budget suffices.
        prev = extract_features(state)
        for _ in range(max_repredict):
            cur = state.cnt.cpu().numpy()
            tgt = budgets.cpu().numpy()
            if np.all(tgt <= cur):
                break
            step_budget = np.minimum(tgt, cur + repredict_every)
            state = engine.search(cfg, queries, filt, step_budget,
                                  state=state)
            znow = extract_features(state)
            f2 = torch.cat([znow, znow - prev], dim=1) if n_probes > 1 \
                else znow
            prev = znow
            if ablate_filter:
                f2 = ablate_filter_features(f2)
            budgets = estimator.predict_budget(f2, alpha, min_budget,
                                               max_budget, packed=packed)

    # --- stage 4 (quantized engines): terminal exact float32 rerank ---
    state = engine.rerank(cfg, queries, state)
    return E2EResult(state=state,
                     predicted_budget=budgets.cpu().numpy(),
                     probe_features=feats.cpu().numpy())

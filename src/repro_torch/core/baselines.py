"""Baselines the paper compares against (§5, Figs. 5-7).

Counterpart of `repro/core/baselines.py`, with its signatures:

  naive_search         naive HNSW-style: a static beam (queue_size = ef, the
                       efsearch analogue) swept over a grid, no budget
                       termination (`BIG_BUDGET`). The paper's primary
                       baseline; at a wide beam, the recall at exhaustion.
  fixed_budget_search  one static global NDC budget (worst-case
                       provisioning).
  laet_search          LAET-style learned termination: the same probe →
                       predict → resume pipeline with the filter feature
                       group removed (`e2e_search(ablate_filter=True)`).
  oracle_search        the lower bound: stop exactly at the ground-truth
                       W_q.

Each runs through `SearchEngine.search` (or `e2e_search`), so on a
quantized engine it searches in the compressed domain; only `laet_search`
ends in the engine's exact rerank, as `e2e_search` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.e2e import E2EResult, e2e_search
from repro_torch.core.engine import BIG_BUDGET, SearchEngine
from repro_torch.core.estimator import CostEstimator
from repro_torch.core.state import SearchConfig, SearchState


def naive_search(engine: SearchEngine, cfg: SearchConfig, queries, spec,
                 ef: int) -> SearchState:
    """Static beam (efsearch) sweep point: queue_size=ef, unlimited budget."""
    c = dataclasses.replace(cfg, queue_size=ef)
    return engine.search(c, queries, spec, BIG_BUDGET)


def fixed_budget_search(engine: SearchEngine, cfg: SearchConfig, queries,
                        spec, budget: int) -> SearchState:
    """One NDC budget for every lane."""
    return engine.search(cfg, queries, spec, budget)


def laet_search(engine: SearchEngine, estimator_nofilter: CostEstimator,
                cfg: SearchConfig, queries, spec, probe_budget: int = 64,
                alpha: float = 1.0) -> E2EResult:
    """Distance-feature-only adaptive termination (filter group ablated)."""
    return e2e_search(engine, estimator_nofilter, cfg, queries, spec,
                      probe_budget=probe_budget, alpha=alpha,
                      ablate_filter=True)


def oracle_search(engine: SearchEngine, cfg: SearchConfig, queries, spec,
                  w_q: np.ndarray, alpha: float = 1.0) -> SearchState:
    """Per-lane budgets max(int(α·W_q), 1)."""
    budgets = np.maximum((alpha * w_q).astype(np.int64), 1)
    return engine.search(cfg, queries, spec, budgets)

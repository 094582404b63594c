"""Batched lockstep filtered beam search — the resumable search loop.

Counterpart of `repro/core/search.py::run_search` (single-step backends;
the persistent driver waits for its own slice). The `lax.while_loop`
becomes a host loop over `step`: it stops when no lane is active or at
`cfg.max_steps`. Reading `active` costs a host sync, so the loop reads it
every `CHECK_EVERY` steps; the steps in between are exact no-ops once
every lane has stopped (inactive lanes keep their arrays, and the
convergence update is idempotent), so the result is the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.state import (SearchConfig, SearchState, init_state,
                                    prepare_resume)
from repro_torch.core.step import make_step

CHECK_EVERY = 8  # steps between host reads of `active`


def run_search(
    cfg: SearchConfig,
    queries: torch.Tensor,           # [B, d] f32
    prog,                            # FilterProgram (torch leaves [B, S, ...])
    base_vectors: torch.Tensor,      # [N, d] f32
    attrs,                           # (labels [N, W] i32, values [N, V] f32)
    neighbors: torch.Tensor,         # [N, R] i32
    budgets: torch.Tensor,           # [B] i32 NDC budgets
    entry_point: int,
    state: SearchState | None = None,
    gt_dist: torch.Tensor | None = None,
) -> SearchState:
    """Run (or resume) the lockstep search until all lanes terminate.

    Termination per lane: queue exhausted, NDC ≥ budget, or (optional)
    greedy result-bound stop. Resuming with a larger budget continues
    exactly where the previous phase stopped (the paper's zero-overhead
    probe reuse).

    A passed-in `state` is consumed: its buffers may be updated in place
    (the reference donates it), so callers must not reuse it afterwards.
    """
    backend = get_backend(cfg.backend or "dense")
    if state is None:
        state = init_state(cfg, queries, prog, base_vectors, attrs,
                           entry_point)
    else:
        state = prepare_resume(state)
    step = make_step(cfg, backend, queries, prog, base_vectors, attrs,
                     neighbors, budgets, gt_dist)
    it = 0
    while it < cfg.max_steps:
        n = min(CHECK_EVERY, cfg.max_steps - it)
        for _ in range(n):
            state = step(state)
        it += n
        if not bool(state.active.any()):
            break
    return state

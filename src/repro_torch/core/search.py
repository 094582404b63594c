"""Batched lockstep filtered beam search — the resumable search loops.

Counterpart of `repro/core/search.py`. Two loops over one carry:

  `run_search`             single-step backends (dense, fused). The
                           `lax.while_loop` becomes a host loop over
                           `step`: it stops when no lane is active or at
                           `cfg.max_steps`. Reading `active` costs a host
                           sync, so the loop reads it every `CHECK_EVERY`
                           steps; the steps in between are exact no-ops
                           once every lane has stopped (inactive lanes keep
                           their arrays, and the convergence update is
                           idempotent), so the result is the reference's.
  `run_search_persistent`  persistent backends. Each launch advances the
                           state by up to `cfg.steps_per_launch` steps —
                           one launch of kernel K5 in post mode, a group
                           of fused steps (kernel K1; K3 / K4 under a
                           codec) in pre and widen mode, as the reference
                           does (`use_kernel` only in post mode); between
                           launches the loop reads
                           back `hops` and `active` only, and compacts to
                           the active lanes on the reference's
                           power-of-two width ladder. Every launch boundary
                           is a step boundary, so the returned state
                           equals `run_search`'s bit for bit.

Under `cfg.precision` "int8" or "pq" both loops take the quant index
(`quant`); the per-query ADC state is prepared once per call
(`_make_qprep`) and its lanes are compacted with the state's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.state import (SearchConfig, SearchState, init_state,
                                    prepare_resume, put_lanes, take_lanes)
from repro_torch.core.step import make_step
from repro_torch.kernels.persistent_step import persistent_multi_step
from repro_torch.quant.codecs import prepare_query

CHECK_EVERY = 8  # steps between host reads of `active`


def _make_qprep(cfg: SearchConfig, queries, quant):
    """Per-query ADC state for compressed-domain traversal (None at f32)."""
    precision = cfg.precision or "float32"
    if precision == "float32":
        return None
    if quant is None:
        raise ValueError(
            f"cfg.precision={precision!r} needs a quant index — build "
            "the engine with precision=... or pass quant= explicitly")
    return prepare_query(precision, quant, queries)


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
    quant=None,                      # Int8Index | PQIndex (compressed mode)
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
    qprep = _make_qprep(cfg, queries, quant)
    if state is None:
        state = init_state(cfg, queries, prog, base_vectors, attrs,
                           entry_point, quant=quant, qprep=qprep)
    else:
        state = prepare_resume(state)
    step = make_step(cfg, backend, queries, prog, base_vectors, attrs,
                     neighbors, budgets, gt_dist, quant=quant, qprep=qprep)
    it = 0
    while it < cfg.max_steps:
        n = min(CHECK_EVERY, cfg.max_steps - it)
        for _ in range(n):
            state = step(state)
        it += n
        if not bool(state.active.any()):
            break
    return state


# Dispatch accounting of the launch loop, as in the reference: `launches`
# (K5 launches), `compactions` (launches at reduced lane width), `steps`
# (lockstep steps advanced). Lifetime counters, read via deltas.
_DISPATCH_COUNTERS = {"launches": 0, "compactions": 0, "steps": 0}


def dispatch_counters() -> dict:
    """Snapshot of the persistent launch loop's lifetime dispatch counters."""
    return dict(_DISPATCH_COUNTERS)


def _persistent_launch(cfg, queries, prog, base_vectors, attrs, neighbors,
                       budgets, entry_point, state, gt_dist, quant, qprep,
                       rem: int, *, mode: str) -> SearchState:
    """One dispatch: advance by up to cfg.steps_per_launch steps.

    mode  "init"    no incoming state — build it (first launch of a search)
          "resume"  incoming probe carry — reactivate budget-stopped lanes
          "cont"    mid-search launch — lanes that stopped in an earlier
                    launch of the same search stay stopped

    Post mode is one launch of kernel K5. Pre and widen mode step the
    backend's fused per-step merge (kernel K1 per step, K3 / K4 under a
    codec, over the R'=160 frontier) up to
    min(steps_per_launch, rem) times, none once no lane is active: the
    reference runs its multi-step kernel in post mode only and its launch
    body elsewhere (`repro/core/search.py:318`), and K5 keeps the same
    post-only guard.
    """
    if mode == "init":
        state = init_state(cfg, queries, prog, base_vectors, attrs,
                           entry_point, quant=quant, qprep=qprep)
    elif mode == "resume":
        state = prepare_resume(state)
    spl = max(1, cfg.steps_per_launch)
    if cfg.mode == "post":
        return persistent_multi_step(
            cfg, queries, prog, base_vectors, attrs, neighbors, budgets,
            state, rem, gt_dist, steps=spl, quant=quant, qprep=qprep)
    step = make_step(cfg, get_backend(cfg.backend or "persistent"), queries,
                     prog, base_vectors, attrs, neighbors, budgets, gt_dist,
                     quant=quant, qprep=qprep)
    for _ in range(max(0, min(spl, int(rem)))):
        if not bool(state.active.any()):
            break
        state = step(state)
    return state


def _hops_active(state: SearchState) -> tuple[np.ndarray, np.ndarray]:
    """Host copies of `hops` and `active`, in one transfer."""
    both = torch.stack([state.hops, state.active.to(torch.int32)]).cpu()
    return both[0].numpy(), both[1].numpy().astype(bool)


def run_search_persistent(
    cfg: SearchConfig,
    queries: torch.Tensor,
    prog,
    base_vectors: torch.Tensor,
    attrs,
    neighbors: torch.Tensor,
    budgets: torch.Tensor,
    entry_point: int,
    state: SearchState | None = None,
    gt_dist: torch.Tensor | None = None,
    quant=None,
    tracer=None,
    trace_id: str = "",
) -> SearchState:
    """The launch loop for persistent backends (single device).

    Same signature and results as `run_search`. Each trip runs one
    `_persistent_launch` of up to cfg.steps_per_launch steps, then reads
    back `hops` and `active`. Lanes that stopped are compacted away between
    launches: the active lanes are gathered (`take_lanes`) into the next
    power-of-two width (floor `min(8, B)`), advanced, and scattered back
    (`put_lanes`); when the ladder gives no smaller width the launch runs
    at full width. The selection pad repeats the first active lane, which
    follows the same deterministic trajectory and scatters back the same
    values. `it` advances by the largest `hops` delta of a launch, and a
    launch may take `cfg.max_steps - it` steps at most — the reference's
    launch, readback and compaction decisions, so `dispatch_counters`
    deltas equal the reference's for the same search.

    `tracer` / `trace_id` emit one "launch" span per launch (`mode`,
    `width`, `steps`; `active` and `compacted` after the first) and one
    "compact" event per compaction, with the reference's names and
    attributes. A span covers the launch and the `hops` / `active`
    readback the loop makes anyway, so on the card it holds the device
    time of the launch; tracing adds no synchronization and the state
    stream is untouched.

    `state`, when passed, is consumed (same contract as `run_search`).
    """
    from repro_torch.obs.trace import as_tracer

    tr = as_tracer(tracer)
    b = int(queries.shape[0])
    qprep = _make_qprep(cfg, queries, quant)
    mode = "init" if state is None else "resume"
    hops0 = 0 if state is None else state.hops.cpu().numpy().copy()
    with tr.span("launch", trace_id, mode=mode, width=b) as sp:
        state = _persistent_launch(cfg, queries, prog, base_vectors, attrs,
                                   neighbors, budgets, entry_point, state,
                                   gt_dist, quant, qprep, cfg.max_steps,
                                   mode=mode)
        hops, active = _hops_active(state)
        it = int((hops - hops0).max(initial=0))
        sp.set(steps=it)
    _DISPATCH_COUNTERS["launches"] += 1
    _DISPATCH_COUNTERS["steps"] += it

    min_w = min(8, b)  # ladder floor
    while it < cfg.max_steps:
        sel = np.flatnonzero(active)
        if sel.size == 0:
            break
        n_active = int(sel.size)
        w = min(b, max(min_w, 1 << (n_active - 1).bit_length()))
        compact = w < b  # else no compaction win: relaunch at full width
        if compact:  # pad by repeating the first active lane
            tr.emit("compact", trace_id, from_width=b, to_width=w,
                    active=n_active, pad=w - n_active)
            sel = np.concatenate([sel, np.full(w - sel.size, sel[0])])
            idx = torch.from_numpy(sel).to(queries.device)
            sub = take_lanes((state, queries, prog, budgets, gt_dist, qprep),
                             idx)
            attrs_sp = dict(mode="cont", width=w, active=n_active,
                            compacted=True)
        else:
            sel = np.arange(b)
            sub = (state, queries, prog, budgets, gt_dist, qprep)
            attrs_sp = dict(mode="cont", width=b, active=n_active)
        sub_state, sub_q, sub_prog, sub_bud, sub_gt, sub_qp = sub
        with tr.span("launch", trace_id, **attrs_sp) as sp:
            out = _persistent_launch(cfg, sub_q, sub_prog, base_vectors,
                                     attrs, neighbors, sub_bud, entry_point,
                                     sub_state, sub_gt, quant, sub_qp,
                                     cfg.max_steps - it, mode="cont")
            sub_hops, sub_active = _hops_active(out)
            d = int((sub_hops - hops[sel]).max(initial=0))
            sp.set(steps=d)
        it += d
        _DISPATCH_COUNTERS["launches"] += 1
        _DISPATCH_COUNTERS["compactions"] += int(compact)
        _DISPATCH_COUNTERS["steps"] += d
        state = put_lanes(state, out, idx) if compact else out
        hops[sel] = sub_hops
        active[sel] = sub_active
    return state

"""E2E: probe → estimate → resume (paper Algorithm 1).

Counterpart of `repro/core/e2e.py`:

  1. Early Probe   — run the lockstep search with per-lane budget f; the
                     probe is the first f NDCs of the real traversal.
  2. Cost Estimate — extract z_q from the live SearchState and run the
                     GBDT (kernel K2 on the card): Ŵ_q = α·exp(M(z_q)).
  3. Adaptive Term — resume the same carry with budget Ŵ_q.
  4. Rerank        — on a quantized engine, the terminal exact float32
                     rerank of the final pool (after the last resume; a
                     reranked state is never resumed).

`repredict_every` > 0 gives the DARTH-style iterative variant. A `tracer`
(`repro_torch.obs.Tracer`) gets the reference's lifecycle spans at the
host dispatch boundaries; `explain=True` builds one `obs.QueryReport` per
lane.
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
    reports: list | None = None   # explain=True: [B] obs.QueryReport


def probe_and_features(engine: SearchEngine, cfg: SearchConfig, queries,
                       filt, probe_budget, n_probes: int = 2,
                       gt_dist=None, tracer=None, trace_id: str = ""):
    """Run the early probe and extract trajectory features.

    With n_probes=2 the features are taken at budgets f/2 and f and
    concatenated as [z_f, z_f − z_{f/2}]; n_probes=1 is the paper's single
    snapshot. Both snapshots are prefixes of the same traversal carry.
    `probe_budget` is a scalar or a per-lane host array (the scheduler
    gives pad lanes 0).

    `tracer` wraps each probe dispatch in a "probe" span and the feature
    extraction in a "feature-extract" span, as the reference does; they
    read no device value.
    """
    from repro_torch.obs.trace import as_tracer

    tr = as_tracer(tracer)
    # span attrs are host scalars: a per-lane budget reports its lane max
    bud = (int(probe_budget) if np.ndim(probe_budget) == 0
           else int(np.asarray(probe_budget).max(initial=0)))
    filt = engine.compile(filt)
    if n_probes <= 1:
        with tr.span("probe", trace_id, budget=bud, snapshot=1,
                     n_probes=1):
            state = engine.search(cfg, queries, filt, probe_budget,
                                  gt_dist=gt_dist, tracer=tracer,
                                  trace_id=trace_id)
        with tr.span("feature-extract", trace_id, n_probes=1):
            z = extract_features(state)
        return state, z
    with tr.span("probe", trace_id, budget=bud // 2, snapshot=1,
                 n_probes=int(n_probes)):
        state = engine.search(cfg, queries, filt, probe_budget // 2,
                              gt_dist=gt_dist, tracer=tracer,
                              trace_id=trace_id)
    z1 = extract_features(state)
    with tr.span("probe", trace_id, budget=bud, snapshot=2,
                 n_probes=int(n_probes)):
        state = engine.search(cfg, queries, filt, probe_budget, state=state,
                              gt_dist=gt_dist, tracer=tracer,
                              trace_id=trace_id)
    with tr.span("feature-extract", trace_id, n_probes=int(n_probes)):
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
    tracer=None,
    trace_id: str = "",
    explain: bool = False,
) -> E2EResult:
    """`tracer` emits the lifecycle spans (probe / feature-extract /
    estimate / resume / rerank) at the host dispatch boundaries — results
    are bit for bit the same with tracing on and off. `explain=True` also
    builds one `obs.QueryReport` per lane in `E2EResult.reports`; it reads
    the probe's counters back after the probe, its documented cost."""
    from repro_torch.core.search import dispatch_counters
    from repro_torch.obs.trace import as_tracer

    tr = as_tracer(tracer)
    if tracer is not None and not trace_id:
        trace_id = tr.new_trace("e2e")

    # --- stage 1: early probe (zero overhead — same traversal carry) ---
    filt = engine.compile(filt)
    d0 = dispatch_counters()
    state, feats = probe_and_features(engine, cfg, queries, filt,
                                      probe_budget, n_probes, tracer=tracer,
                                      trace_id=trace_id)
    d1 = dispatch_counters()
    probe_cnt = state.cnt.cpu().numpy() if explain else None

    # --- stage 2: cost estimation ---
    packed = estimator.packed(engine.device)
    with tr.span("estimate", trace_id, alpha=float(alpha)):
        budgets, feats = predict_budgets(estimator, feats, alpha, min_budget,
                                         max_budget, ablate_filter,
                                         packed=packed)

    # --- stage 3: adaptive termination (resume with predicted budget) ---
    n_resume_calls = 0
    if repredict_every <= 0:
        with tr.span("resume", trace_id):
            state = engine.search(cfg, queries, filt, budgets, state=state,
                                  tracer=tracer, trace_id=trace_id)
        n_resume_calls = 1
    else:
        # DARTH-style stepwise: advance Δ NDCs, re-predict, stop when the
        # model says the spent budget suffices.
        prev = extract_features(state)
        for rp in range(max_repredict):
            cur = state.cnt.cpu().numpy()
            tgt = budgets.cpu().numpy()
            if np.all(tgt <= cur):
                break
            step_budget = np.minimum(tgt, cur + repredict_every)
            with tr.span("resume", trace_id, repredict=rp):
                state = engine.search(cfg, queries, filt, step_budget,
                                      state=state, tracer=tracer,
                                      trace_id=trace_id)
            n_resume_calls += 1
            znow = extract_features(state)
            f2 = torch.cat([znow, znow - prev], dim=1) if n_probes > 1 \
                else znow
            prev = znow
            if ablate_filter:
                f2 = ablate_filter_features(f2)
            budgets = estimator.predict_budget(f2, alpha, min_budget,
                                               max_budget, packed=packed)
    d2 = dispatch_counters()

    # --- stage 4 (quantized engines): terminal exact float32 rerank ---
    precision = engine.effective_precision(cfg)
    with tr.span("rerank", trace_id, precision=precision):
        state = engine.rerank(cfg, queries, state)

    bud = budgets.cpu().numpy()
    feats_h = feats.cpu().numpy()
    reports = None
    if explain:
        from repro_torch.core.backends import get_backend
        from repro_torch.obs.explain import StageReport, build_reports

        backend_name = cfg.backend or engine.backend or "dense"
        if getattr(get_backend(backend_name), "persistent", False):
            probe_l = d1["launches"] - d0["launches"]
            resume_l = d2["launches"] - d1["launches"]
        else:
            # single-dispatch backends: one per search call
            probe_l = 1 if n_probes <= 1 else 2
            resume_l = n_resume_calls
        final_cnt = state.cnt.cpu().numpy()
        stages = [
            [StageReport("probe", ndc=int(probe_cnt[i]), launches=probe_l,
                         attrs=dict(budget=int(probe_budget),
                                    n_probes=int(n_probes))),
             StageReport("estimate", attrs=dict(alpha=float(alpha))),
             StageReport("resume", ndc=int(final_cnt[i] - probe_cnt[i]),
                         launches=resume_l),
             StageReport("rerank", attrs=dict(precision=precision))]
            for i in range(final_cnt.shape[0])
        ]
        reports = build_reports(
            cfg, state, bud, backend=backend_name, probe_ndc=probe_cnt,
            features=feats_h,
            trace_ids=[f"{trace_id or 'e2e'}:{i}"
                       for i in range(final_cnt.shape[0])],
            stages=stages)
        if getattr(state, "shard", None) is not None:
            from repro_torch.obs.shard import attach_shard_sections

            attach_shard_sections(reports, cfg, state, bud)
    return E2EResult(state=state, predicted_budget=bud,
                     probe_features=feats_h, reports=reports)

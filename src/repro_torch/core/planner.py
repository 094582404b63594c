"""Adaptive per-query planning across filter-execution strategies.

Counterpart of `repro/core/planner.py`, on float32, int8 and PQ engines,
with the reference's tracer spans and EXPLAIN reports. Per lane, one of
three plans:

  scan      pre-filter: bitmap + exact distances over the σ_q·N passing
            rows (`core.plans`); closed-form cost σ_q·N·c, recall 1.0.
  traverse  the E2E pipeline: probe → GBDT Ŵ_q → resume.
  widen     the same pipeline resumed with the widened frontier
            (`SearchConfig(mode="widen")`), for lanes whose valid subgraph
            the 1-hop frontier cuts apart.

Routing in two stages: stage 0 compiles the bitmap (0 NDC), so σ_q is
exact, and a static GBDT head on bitmap/program features sends lanes with
σ_q·N·c ≤ Ŵ_static (or σ_q·N ≤ scan_floor) straight to scan; stage 1 runs
one shared probe for the rest and takes, per lane, argmin{probe_cnt +
σ_q·N·c, Ŵ_traverse, Ŵ_widen} from two heads on the same probe features.
The three heads run through kernel K2 on the card.

`force_plan` pins every lane to one plan through the same machinery;
`planned_search(force_plan=p)` equals `run_plan(p)` in every state field.
On a quantized engine every plan searches in the compressed domain (the
scan through K6q rows, traverse and widen through K3 / K4, K5 in post
mode) and both entry points end in the engine's exact float32 rerank of
the final pool.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.e2e import predict_budgets, probe_and_features
from repro_torch.core.engine import BIG_BUDGET, SearchEngine
from repro_torch.core.estimator import CostEstimator
from repro_torch.core.plans import ScanStats, scan_search, scan_stats
from repro_torch.core.state import (SearchConfig, SearchState, concat_lanes,
                                    take_lanes)
from repro_torch.core.training import oracle_quant, oracle_vectors
from repro_torch.data.synthetic import AttributedDataset, QueryWorkload
from repro_torch.index.bruteforce import (compressed_filtered_topk,
                                         filtered_knn_exact, valid_mask)

PLANS = ("scan", "traverse", "widen")
PLAN_SCAN, PLAN_TRAVERSE, PLAN_WIDEN = range(3)

STATIC_FEATURE_NAMES = [
    "sigma", "log_sigma_n",
    "clause_frac_0", "clause_frac_1", "clause_frac_2", "clause_frac_3",
    "n_slots", "n_terms",
]


def static_features(stats: ScanStats, prog) -> np.ndarray:
    """Pre-probe features [B, 8] (numpy f32): exact bitmap selectivity and
    program shape — only what costs 0 NDC. Same arithmetic as the
    reference's."""
    sig = stats.sigma.astype(np.float32)
    return np.stack([
        sig,
        np.log1p(sig * stats.n).astype(np.float32),
        *[stats.clause_frac[:, i] for i in range(stats.clause_frac.shape[1])],
        np.asarray(prog.active.cpu()).sum(axis=1).astype(np.float32),
        np.asarray(prog.term_active.cpu()).sum(axis=1).astype(np.float32),
    ], axis=1)


@dataclasses.dataclass
class Planner:
    """Per-plan cost heads + the scan plan's closed-form cost model."""

    traverse: CostEstimator          # probe features → W_traverse
    widen: CostEstimator             # probe features → W_widen
    static: CostEstimator            # static_features → W_traverse (stage 0)
    scan_dist_cost: float = 1.0      # c: scan-NDC ≡ traversal-NDC exchange rate
    scan_floor: int = 128            # σ·N at/below which scan always wins


@dataclasses.dataclass
class PlanTrainingData:
    """Dual-exhaustion labels from one shared probe per query."""

    features: np.ndarray         # [n, F] probe trajectory features
    static_feats: np.ndarray     # [n, 8]
    w_traverse: np.ndarray       # [n] exhaustion/convergence NDC, post mode
    w_widen: np.ndarray          # [n] same, widen-mode resume
    converged_t: np.ndarray      # [n] bool
    converged_w: np.ndarray      # [n] bool
    sigma: np.ndarray            # [n] exact bitmap selectivity
    gt_idx: np.ndarray           # [n, k]
    gt_dist: np.ndarray          # [n, k]


def _copy_state(state):
    """A copy of every tensor of a SearchState (or ShardedSearchState)."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    return type(state)(*(_copy_state(a) for a in state))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate_plan_training_data(
    engine: SearchEngine,
    ds: AttributedDataset,
    workload: QueryWorkload,
    cfg: SearchConfig,
    probe_budget: int = 64,
    chunk: int = 64,
    n_probes: int = 2,
    seconds: dict | None = None,
) -> PlanTrainingData:
    """Per query: one probe, two exhaustion resumes (post + widen) of the
    same probe carry, so each label is the total NDC of "probe prefix +
    that plan's continuation". Convergence is judged against the exact
    oracle on a float32 engine, and against the compressed-domain filtered
    top-k (`quant.compressed_filtered_topk`) on a quantized one, whose
    traversal distances are compressed; `gt_idx` / `gt_dist` stay the
    exact oracle's either way (what recall after the rerank is measured
    against).

    `seconds`, when given, accumulates the wall seconds of each stage
    ("oracle" — both oracles —, "probe", "traverse", "widen"),
    synchronised.
    """
    precision = engine.effective_precision(cfg)
    cfg_w = dataclasses.replace(cfg, mode="widen")
    dev = engine.device
    n = workload.batch
    out = {f.name: [] for f in dataclasses.fields(PlanTrainingData)}

    def timed(key, fn):
        t = time.perf_counter()
        res = fn()
        _sync(dev)
        if seconds is not None:
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t
        return res

    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        q = workload.queries[s:e]
        filt = workload.filter_slice(s, e)
        gt_idx, gt_dist = timed("oracle", lambda: filtered_knn_exact(
            q, oracle_vectors(engine, ds), filt,
            np.asarray(ds.labels_packed), np.asarray(ds.value_matrix), cfg.k,
            device=dev))
        if precision != "float32":
            # convergence in the metric the traversal searches in
            ok = valid_mask(filt, np.asarray(ds.labels_packed),
                            np.asarray(ds.value_matrix))
            conv_dist, _ = timed("oracle", lambda: compressed_filtered_topk(
                precision, oracle_quant(engine), q, ok, cfg.k))
        else:
            conv_dist = gt_dist
        conv_dev = torch.from_numpy(conv_dist).to(dev)
        prog = engine.compile(filt)
        stats = scan_stats(engine, prog)
        st, z = timed("probe", lambda: probe_and_features(
            engine, cfg, q, prog, probe_budget, n_probes, gt_dist=conv_dev))
        labels = {}
        for key, c in (("traverse", cfg), ("widen", cfg_w)):
            # a resume consumes its carry: each plan gets its own copy
            fin = timed(key, lambda: engine.search(
                c, q, prog, BIG_BUDGET, state=_copy_state(st),
                gt_dist=conv_dev))
            cc = fin.conv_cnt.cpu().numpy()
            conv = cc > 0
            labels[key] = (np.where(conv, cc, fin.cnt.cpu().numpy())
                           .astype(np.int64), conv)
        out["features"].append(z.cpu().numpy())
        out["static_feats"].append(static_features(stats, prog))
        out["w_traverse"].append(labels["traverse"][0])
        out["converged_t"].append(labels["traverse"][1])
        out["w_widen"].append(labels["widen"][0])
        out["converged_w"].append(labels["widen"][1])
        out["sigma"].append(stats.sigma)
        out["gt_idx"].append(gt_idx)
        out["gt_dist"].append(gt_dist)
    return PlanTrainingData(**{k: np.concatenate(v) for k, v in out.items()})


def fit_planner(data: PlanTrainingData, probe_budget: int = 64,
                scan_dist_cost: float = 1.0, **gbdt_kwargs) -> Planner:
    """Fit the three cost heads; the static head regresses the traverse
    label from pre-probe features only."""
    tr = CostEstimator.fit(data.features, data.w_traverse, **gbdt_kwargs)
    wd = CostEstimator.fit(data.features, data.w_widen, **gbdt_kwargs)
    st = CostEstimator.fit(data.static_feats, data.w_traverse, **gbdt_kwargs)
    return Planner(traverse=tr, widen=wd, static=st,
                   scan_dist_cost=scan_dist_cost,
                   scan_floor=2 * probe_budget)


# ---- routing ---------------------------------------------------------------

def stage0_scan_mask(planner: Planner, stats: ScanStats, prog, alpha: float,
                     min_budget: int, max_budget: int, device) -> np.ndarray:
    """[B] bool — lanes routed to scan before (instead of) the probe."""
    sf = torch.from_numpy(static_features(stats, prog)).to(device)
    w_static, _ = predict_budgets(planner.static, sf, alpha, min_budget,
                                  max_budget)
    scan_cost = stats.counts.astype(np.float64) * planner.scan_dist_cost
    return ((scan_cost <= w_static.cpu().numpy()) |
            (stats.counts <= planner.scan_floor))


def choose_plans(planner: Planner, feats: torch.Tensor, probe_cnt: np.ndarray,
                 counts: np.ndarray, alpha: float, min_budget: int,
                 max_budget: int):
    """Post-probe per-lane argmin over predicted total NDC → (plan_ids [B]
    i32, w_traverse [B] i64, w_widen [B] i64); ties go to the earlier plan
    in PLANS (scan first: exact recall at equal predicted cost)."""
    w_t, _ = predict_budgets(planner.traverse, feats, alpha, min_budget,
                             max_budget)
    w_w, _ = predict_budgets(planner.widen, feats, alpha, min_budget,
                             max_budget)
    w_t = w_t.cpu().numpy().astype(np.int64)
    w_w = w_w.cpu().numpy().astype(np.int64)
    scan_total = probe_cnt.astype(np.int64) + np.ceil(
        counts * planner.scan_dist_cost).astype(np.int64)
    table = np.stack([scan_total, w_t, w_w], axis=1)
    return np.argmin(table, axis=1).astype(np.int32), w_t, w_w


@dataclasses.dataclass
class PlanResult:
    state: SearchState
    plan: np.ndarray              # [B] i32 — index into PLANS
    sigma: np.ndarray             # [B] exact bitmap selectivity
    pre_probe: np.ndarray         # [B] bool — routed at stage 0 (no probe)
    predicted_budget: np.ndarray  # [B] — chosen plan's predicted/closed-form
                                  # total NDC (σ·N·c for scan lanes)
    reports: list | None = None   # explain=True: [B] obs.QueryReport

    def plan_names(self) -> list[str]:
        return [PLANS[p] for p in self.plan]


def _scan_part(engine, cfg, queries, prog, stats, lanes, base_state=None):
    return scan_search(engine, cfg, queries[lanes], take_lanes(prog, lanes),
                       stats=stats.rows(lanes), base_state=base_state)


def planned_search(
    engine: SearchEngine,
    planner: Planner,
    cfg: SearchConfig,
    queries,
    filt,
    probe_budget: int = 64,
    n_probes: int = 2,
    alpha: float = 1.0,
    min_budget: int = 32,
    max_budget: int = BIG_BUDGET,
    force_plan: str | None = None,
    stats: ScanStats | None = None,
    tracer=None,
    trace_id: str = "",
    explain: bool = False,
) -> PlanResult:
    """Route each lane to its cheapest plan and execute; terminal state in
    the original lane order. `force_plan` pins all lanes to one plan —
    equal, every field, to `run_plan` with the same arguments.

    `tracer` spans the router's stages (plan-stage0, the shared probe via
    `probe_and_features`, plan-select, scan / resume per plan, rerank) at
    host dispatch boundaries only; `explain=True` builds one
    `obs.QueryReport` per lane in `PlanResult.reports` with the route each
    lane took."""
    from repro_torch.core.search import dispatch_counters
    from repro_torch.obs.trace import as_tracer

    tr = as_tracer(tracer)
    if tracer is not None and not trace_id:
        trace_id = tr.new_trace("plan")
    dev = engine.device
    prog = engine.compile(filt)
    if stats is None:
        stats = scan_stats(engine, prog)
    queries = np.asarray(queries, np.float32)
    b = queries.shape[0]
    counts = stats.counts
    d0 = dispatch_counters()
    n_exec_calls = 0

    plan = np.full(b, -1, np.int32)
    pre_probe = np.zeros(b, bool)
    pred = np.zeros(b, np.int64)

    if force_plan is not None:
        if force_plan not in PLANS:
            raise ValueError(f"force_plan must be one of {PLANS}, "
                             f"got {force_plan!r}")
        plan[:] = PLANS.index(force_plan)

    # ---- stage 0: pre-probe routing (exact σ + static cost head) ----
    if force_plan is None:
        with tr.span("plan-stage0", trace_id, lanes=b):
            s0 = stage0_scan_mask(planner, stats, prog, alpha, min_budget,
                                  max_budget, dev)
        plan[s0] = PLAN_SCAN
        pre_probe[:] = s0
    elif force_plan == "scan":
        pre_probe[:] = True
    scan_now = pre_probe.nonzero()[0]

    parts: list[tuple[np.ndarray, SearchState]] = []
    if scan_now.size:
        with tr.span("scan", trace_id, lanes=int(scan_now.size), late=False):
            sub = _scan_part(engine, cfg, queries, prog, stats, scan_now)
        n_exec_calls += 1
        pred[scan_now] = np.ceil(
            counts[scan_now] * planner.scan_dist_cost).astype(np.int64)
        parts.append((scan_now, sub))

    # ---- stage 1: shared probe + per-plan heads on the survivors ----
    rest = (~pre_probe).nonzero()[0]
    probe_ndc = np.zeros(b, np.int64)
    if rest.size:
        q_r = queries[rest]
        prog_r = take_lanes(prog, rest)
        carry, feats = probe_and_features(engine, cfg, q_r, prog_r,
                                          probe_budget, n_probes,
                                          tracer=tracer, trace_id=trace_id)
        probe_cnt = carry.cnt.cpu().numpy()
        probe_ndc[rest] = probe_cnt
        with tr.span("plan-select", trace_id, lanes=int(rest.size),
                     forced=force_plan or ""):
            if force_plan is None:
                ids, w_t, w_w = choose_plans(planner, feats, probe_cnt,
                                             counts[rest], alpha, min_budget,
                                             max_budget)
            else:
                ids = np.full(rest.size, PLANS.index(force_plan), np.int32)
                head = (planner.traverse if force_plan == "traverse"
                        else planner.widen)
                w, _ = predict_budgets(head, feats, alpha, min_budget,
                                       max_budget)
                w_t = w_w = w.cpu().numpy().astype(np.int64)
        plan[rest] = ids

        late = rest[ids == PLAN_SCAN]
        if late.size:
            sel = (ids == PLAN_SCAN).nonzero()[0]
            with tr.span("scan", trace_id, lanes=int(late.size), late=True):
                sub = _scan_part(engine, cfg, queries, prog, stats, late,
                                 base_state=take_lanes(carry, sel))
            n_exec_calls += 1
            pred[late] = (probe_cnt[sel] + np.ceil(
                counts[late] * planner.scan_dist_cost)).astype(np.int64)
            parts.append((late, sub))
        for pid, mode, w in ((PLAN_TRAVERSE, cfg.mode, w_t),
                             (PLAN_WIDEN, "widen", w_w)):
            lanes = rest[ids == pid]
            if not lanes.size:
                continue
            sel = (ids == pid).nonzero()[0]
            c = cfg if mode == cfg.mode else dataclasses.replace(cfg,
                                                                 mode=mode)
            with tr.span("resume", trace_id, plan=PLANS[pid],
                         lanes=int(lanes.size)):
                sub = engine.search(c, q_r[sel], take_lanes(prog_r, sel),
                                    w[sel], state=take_lanes(carry, sel),
                                    tracer=tracer, trace_id=trace_id)
            n_exec_calls += 1
            pred[lanes] = w[sel]
            parts.append((lanes, sub))

    # ---- merge back into the original lane order ----
    perm = np.concatenate([idx for idx, _ in parts])
    inv = np.argsort(perm, kind="stable")
    state = take_lanes(concat_lanes([st for _, st in parts]), inv)
    with tr.span("rerank", trace_id,
                 precision=engine.effective_precision(cfg)):
        state = engine.rerank(cfg, queries, state)

    reports = None
    if explain:
        reports = _plan_reports(engine, cfg, state, plan, pred, pre_probe,
                                probe_ndc, trace_id, d0, n_exec_calls,
                                n_probes, probe_budget)
    return PlanResult(state=state, plan=plan, sigma=stats.sigma,
                      pre_probe=pre_probe, predicted_budget=pred,
                      reports=reports)


def _plan_reports(engine, cfg, state, plan, pred, pre_probe, probe_ndc,
                  trace_id, d0, n_exec_calls, n_probes, probe_budget):
    """Per-lane EXPLAIN reports for `planned_search` (host post-processing
    of the final counters, read back once — explain mode's cost). Launches
    keep the reference's definition (`obs.explain`)."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.search import dispatch_counters
    from repro_torch.obs.explain import StageReport, build_reports

    backend_name = cfg.backend or engine.backend or "dense"
    if getattr(get_backend(backend_name), "persistent", False):
        total_l = dispatch_counters()["launches"] - d0["launches"]
    else:
        probe_calls = 0 if not (~pre_probe).any() else (
            1 if n_probes <= 1 else 2)
        total_l = probe_calls + n_exec_calls
    final_cnt = state.cnt.cpu().numpy()
    names = [PLANS[p] for p in plan]
    precision = engine.effective_precision(cfg)
    stages = []
    for i in range(final_cnt.shape[0]):
        st = [StageReport("plan-stage0",
                          attrs=dict(pre_probe=bool(pre_probe[i])))]
        if not pre_probe[i]:
            st.append(StageReport("probe", ndc=int(probe_ndc[i]),
                                  attrs=dict(budget=int(probe_budget),
                                             n_probes=int(n_probes))))
            st.append(StageReport("plan-select",
                                  attrs=dict(plan=names[i])))
        exec_name = "scan" if plan[i] == PLAN_SCAN else "resume"
        st.append(StageReport(exec_name,
                              ndc=int(final_cnt[i] - probe_ndc[i]),
                              launches=total_l,
                              attrs=dict(plan=names[i])))
        st.append(StageReport("rerank", attrs=dict(precision=precision)))
        stages.append(st)
    reports = build_reports(
        cfg, state, pred, backend=backend_name, plans=names,
        probe_ndc=probe_ndc, trace_ids=[f"{trace_id or 'plan'}:{i}"
                                        for i in range(len(names))],
        stages=stages)
    if getattr(state, "shard", None) is not None:
        from repro_torch.obs.shard import attach_shard_sections

        attach_shard_sections(reports, cfg, state, pred)
    # scan lanes terminate by construction (the masked scan is exhaustive
    # over the σ·N valid rows), not by any traversal stop condition —
    # globally and on every shard's slice of the bitmap
    for i, r in enumerate(reports):
        if plan[i] == PLAN_SCAN:
            r.termination = "scan-exhaustive"
            for sec in r.shards:
                sec.termination = "scan-exhaustive"
    return reports


def run_plan(
    engine: SearchEngine,
    planner: Planner,
    plan: str,
    cfg: SearchConfig,
    queries,
    filt,
    probe_budget: int = 64,
    n_probes: int = 2,
    alpha: float = 1.0,
    min_budget: int = 32,
    max_budget: int = BIG_BUDGET,
) -> SearchState:
    """Execute one plan directly, bypassing the router — the structural
    reference `planned_search(force_plan=...)` is held to."""
    prog = engine.compile(filt)
    queries = np.asarray(queries, np.float32)
    if plan == "scan":
        state = scan_search(engine, cfg, queries, prog)
    elif plan in ("traverse", "widen"):
        carry, feats = probe_and_features(engine, cfg, queries, prog,
                                          probe_budget, n_probes)
        head = planner.traverse if plan == "traverse" else planner.widen
        w, _ = predict_budgets(head, feats, alpha, min_budget, max_budget)
        c = cfg if plan == "traverse" else dataclasses.replace(cfg,
                                                               mode="widen")
        state = engine.search(c, queries, prog, w, state=carry)
    else:
        raise ValueError(f"unknown plan {plan!r} (one of {PLANS})")
    return engine.rerank(cfg, queries, state)

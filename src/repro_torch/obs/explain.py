"""EXPLAIN: per-query lifecycle reports for `e2e_search`/`planned_search`.

Counterpart of `repro/obs/explain.py`. The paper's cost model reasons in
per-query quantities — probe features z_q, predicted budget
Ŵ_q = α·exp(M(z_q)), actual NDC W_q — but the search APIs return only the
final `SearchState`. `explain=True` additionally returns one `QueryReport`
per lane: the features the prediction was made from, the predicted cost,
the plan the router chose, per-stage NDC and launch counts, and *why* the
traversal stopped.

Termination-reason semantics (derived from the final carry, priority
order — a lane can satisfy several conditions; we report the one the step
function would act on first):

  queue-drained  no unexpanded finite candidate remains — the valid
                 sub-graph reachable from the entry was exhausted before
                 the budget; the estimator's prediction was irrelevant.
  budget         cnt ≥ budget — the paper's adaptive termination fired;
                 the predicted Ŵ_q is what stopped the search.
  greedy         (cfg.greedy_stop only) best remaining candidate is worse
                 than the current k-th result — classic HNSW convergence.
  active         none of the above: the lane was still runnable when the
                 search loop stopped stepping (max_steps, or an external
                 pause).

A stage's `launches` keeps the reference's definition, so that reports
match across the packages: on a persistent backend it is the launch
loop's `dispatch_counters` delta (K5 launches in post mode, grouped K1 /
K3 / K4 steps in pre and widen mode); on a single-dispatch backend it is
one per search call. On the port's fused backend a search call launches
K1 once a lockstep step (and a dense one launches many small kernels),
so there it is not a count of kernel launches.

Building reports reads the final state once: the leaves it needs come to
the host in one device-to-host transfer (`host_leaves`), after the
search. On a sharded engine `obs.shard.attach_shard_sections` fills the
report's per-shard fields, whose counters sum exactly to the merged ones.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.features import FEATURE_NAMES
from repro_torch.core.state import SearchConfig, SearchState

TERM_QUEUE_DRAINED = "queue-drained"
TERM_BUDGET = "budget"
TERM_GREEDY = "greedy"
TERM_ACTIVE = "active"

_REPORT_LEAVES = ("cand_dist", "cand_idx", "cand_exp", "res_dist", "res_idx",
                  "cnt", "hops")


def host_leaves(state, names=_REPORT_LEAVES) -> dict:
    """{name: numpy array} for the named leaves of `state`.

    Tensor leaves travel in one device-to-host copy: each is widened to
    float64 (exact for int32, float32 and bool), the flat pieces are
    concatenated on the device, copied once and cut apart on the host.
    Leaves that are already host arrays pass through."""
    leaves = {n: getattr(state, n) for n in names}
    dev = [n for n, a in leaves.items() if isinstance(a, torch.Tensor)]
    out = {n: np.asarray(a) for n, a in leaves.items() if n not in dev}
    if dev:
        flat = torch.cat([leaves[n].reshape(-1).to(torch.float64)
                          for n in dev]).cpu().numpy()
        at = 0
        for n in dev:
            t = leaves[n]
            size = t.numel()
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            out[n] = flat[at:at + size].astype(dtype).reshape(tuple(t.shape))
            at += size
    return out


def termination_reasons(cfg: SearchConfig, state: SearchState,
                        budgets) -> list[str]:
    """Per-lane stop reason from the final carry (see module docstring for
    the priority order). `budgets` is scalar or [B]."""
    h = host_leaves(state, ("cand_dist", "cand_idx", "cand_exp", "res_dist",
                            "cnt"))
    return _reasons(cfg, h, budgets)


def _reasons(cfg: SearchConfig, h: dict, budgets) -> list[str]:
    cand_dist, cand_idx, cand_exp = h["cand_dist"], h["cand_idx"], h["cand_exp"]
    res_dist, cnt = h["res_dist"], h["cnt"]
    b = cnt.shape[0]
    budgets = np.broadcast_to(np.asarray(budgets), (b,))

    unexp = (~cand_exp) & (cand_idx >= 0) & np.isfinite(cand_dist)
    has_cand = unexp.any(axis=1)
    best_d = np.where(unexp, cand_dist, np.inf).min(axis=1)
    over_budget = cnt >= budgets
    worst_res = res_dist[:, -1]
    greedy = (bool(cfg.greedy_stop) & np.isfinite(worst_res)
              & np.isfinite(best_d) & (best_d > worst_res))

    out = []
    for i in range(b):
        if not has_cand[i]:
            out.append(TERM_QUEUE_DRAINED)
        elif over_budget[i]:
            out.append(TERM_BUDGET)
        elif greedy[i]:
            out.append(TERM_GREEDY)
        else:
            out.append(TERM_ACTIVE)
    return out


def feature_dict(feats: np.ndarray) -> dict:
    """Name one lane's probe feature vector. Width F = n_probes×N_FEATURES:
    the first block is z_f (names from FEATURE_NAMES); with n_probes=2 the
    second block is the convergence-speed delta z_f − z_{f/2} (d_*)."""
    feats = np.asarray(feats).ravel()
    n = len(FEATURE_NAMES)
    out = {}
    for i, v in enumerate(feats):
        if i < n:
            out[FEATURE_NAMES[i]] = float(v)
        elif i < 2 * n:
            out[f"d_{FEATURE_NAMES[i - n]}"] = float(v)
        else:
            out[f"f{i}"] = float(v)
    return out


@dataclasses.dataclass
class StageReport:
    """One lifecycle stage of one query's execution.

    `ndc` is the NDC *delta* spent inside the stage (state.cnt is
    cumulative; stages partition it). `launches` is the batch's dispatch
    count for the stage (see the module docstring) — a batch-level
    quantity (lanes in a lockstep batch share dispatches), reported per
    query so a report is self-contained."""

    name: str
    ndc: int = 0
    launches: int = 0
    duration: float = 0.0
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class QueryReport:
    """The complete EXPLAIN record for one query."""

    trace_id: str
    backend: str
    plan: str                     # "traverse" | "scan" | "widen"
    predicted_budget: int         # Ŵ_q (scan lanes: closed-form σ·N·c)
    actual_ndc: int               # W_q actually spent (state.cnt)
    probe_ndc: int                # NDC of the probe prefix (0 if no probe)
    termination: str              # see termination_reasons
    k_found: int                  # valid results delivered (≤ k)
    hops: int                     # expansions performed
    features: dict = dataclasses.field(default_factory=dict)
    stages: list[StageReport] = dataclasses.field(default_factory=list)
    # sharded engines only (obs.shard.attach_shard_sections): per-shard
    # attribution whose counters sum exactly to the merged ones above
    shards: list = dataclasses.field(default_factory=list)
    work_balance: float = 1.0     # total NDC / (S · max shard NDC)
    merge_pairwise: int = 0       # pairwise top-k merges performed (S−1)
    merge_depth: int = 0          # merge tree depth (⌈log2 S⌉)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def format(self, features: bool = False) -> str:
        """Human-readable lifecycle, one query."""
        ratio = self.predicted_budget / max(self.actual_ndc, 1)
        lines = [
            f"query {self.trace_id or '?'} [{self.backend}] "
            f"plan={self.plan} terminated={self.termination}",
            f"  predicted Ŵ_q={self.predicted_budget}  "
            f"actual NDC={self.actual_ndc}  (pred/actual={ratio:.2f})  "
            f"probe={self.probe_ndc}  hops={self.hops}  "
            f"k_found={self.k_found}",
        ]
        for st in self.stages:
            extras = "".join(f"  {k}={v}" for k, v in st.attrs.items())
            t = (f" t={st.duration * 1e3:8.3f}ms" if st.duration > 0 else "")
            lines.append(
                f"    {st.name:<12} ndc=+{st.ndc:<8} "
                f"launches={st.launches:<4}{t}{extras}")
        if self.shards:
            lines.append(
                f"  shards={len(self.shards)}  "
                f"balance={self.work_balance:.3f}  "
                f"merge={self.merge_pairwise}x pairwise "
                f"depth={self.merge_depth}")
            for sec in self.shards:
                lines.append(
                    f"    shard {sec.shard:<3} ndc={sec.ndc:<8} "
                    f"budget={sec.budget:<8} hops={sec.hops:<6} "
                    f"inspected={sec.n_inspected:<8} "
                    f"terminated={sec.termination}")
        if features and self.features:
            top = sorted(self.features.items(),
                         key=lambda kv: -abs(kv[1]))[:8]
            lines.append("    features     " + "  ".join(
                f"{k}={v:.3g}" for k, v in top))
        return "\n".join(lines)


def format_reports(reports: list[QueryReport],
                   features: bool = False) -> str:
    return "\n".join(r.format(features=features) for r in reports)


def build_reports(
    cfg: SearchConfig,
    state: SearchState,
    budgets,
    *,
    backend: str = "",
    plans=None,                    # [B] plan names, or None → "traverse"
    probe_ndc=None,                # [B] NDC after the probe prefix
    features=None,                 # [B, F] probe feature matrix
    trace_ids=None,                # [B] trace ids
    stages=None,                   # [B] list of per-lane StageReport lists
) -> list[QueryReport]:
    """Assemble per-lane reports from the final carry + pipeline context.

    The array arguments are host arrays the pipeline already holds; the
    state's leaves come over in one transfer (`host_leaves`)."""
    h = host_leaves(state)
    cnt, hops, res_idx = h["cnt"], h["hops"], h["res_idx"]
    b = cnt.shape[0]
    budgets = np.broadcast_to(np.asarray(budgets), (b,))
    terms = _reasons(cfg, h, budgets)
    probe_ndc = (np.zeros(b, np.int64) if probe_ndc is None
                 else np.asarray(probe_ndc))
    reports = []
    for i in range(b):
        reports.append(QueryReport(
            trace_id="" if trace_ids is None else str(trace_ids[i]),
            backend=backend,
            plan="traverse" if plans is None else str(plans[i]),
            predicted_budget=int(budgets[i]),
            actual_ndc=int(cnt[i]),
            probe_ndc=int(probe_ndc[i]),
            termination=terms[i],
            k_found=int((res_idx[i] >= 0).sum()),
            hops=int(hops[i]),
            features={} if features is None else feature_dict(features[i]),
            stages=[] if stages is None else list(stages[i]),
        ))
    return reports

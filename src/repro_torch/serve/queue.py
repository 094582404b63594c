"""Request model + admission layer (serving lifecycle stage 1).

Counterpart of `repro/serve/queue.py` (host code). A `Request` is one (query vector, filter expression) pair with an arrival
timestamp and an optional latency deadline. Filters are filter-algebra
expressions (`repro_torch.filters.expr`) — arbitrary And/Or/Not compositions; the
legacy (kind, label_mask / range) fields remain as constructor sugar and are
lowered to an expression on construction. Because the engine compiles any
batch of expressions into one fixed-shape predicate program, the scheduler
batches requests of *different boolean structure* into the same lanes —
there is no same-kind batching restriction anywhere in the serving path.

The `AdmissionQueue` is the system's only *bounded* queue: it sheds load
when full (backpressure — the caller gets a `False` and is expected to
retry/degrade upstream) and rejects requests whose deadline already expired
on arrival. Everything behind admission (bucket queues) is unbounded:
admitted work is always finished.

Timestamps are plain floats in caller-defined units. The scheduler never
reads a wall clock itself — `launch/serve.py` feeds `time.perf_counter()`
deltas, while a simulation may feed an open-loop clock driven by measured
service times. Both exercise identical scheduling code.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.filters.expr import (Contain, Equal, Expr, Range,
                                     labels_from_mask)
from repro_torch.filters.predicates import (PRED_CONTAIN, PRED_EQUAL,
                                           PRED_RANGE)


@dataclasses.dataclass
class Request:
    """One filtered-AKNN request plus its scheduling lifecycle state."""

    rid: int
    query: np.ndarray                 # [d] float32
    kind: int | None = None           # legacy predicate tag (sugar)
    label_mask: np.ndarray | None = None   # [W] uint32 (legacy label sugar)
    range_lo: float | None = None          # (legacy range sugar)
    range_hi: float | None = None
    expr: Expr | None = None          # the filter; derived from the legacy
                                      # fields when not given directly
    arrival: float | None = None      # stamped at submit() when unset
    deadline: float | None = None     # absolute time; None = best-effort

    # -- lifecycle, owned by the scheduler --
    state: tuple | None = None        # carried traversal state: a (batch
                                      # SearchState, lane index) reference
                                      # into the micro-batch it last rode in
                                      # (on the engine's device)
    program: object | None = None     # compiled single-query FilterProgram
                                      # (stamped by the scheduler at submit)
    cache_key: str | None = None      # memoized result-cache key (valid for
                                      # one scheduler's parameter set)
    budget: int | None = None         # Ŵ_q once estimated
    plan: str | None = None           # chosen execution plan (planner mode):
                                      # "scan" | "traverse" | "widen"; None
                                      # until routed (legacy = traverse)
    plan_pure: bool = False           # the executed path is bitwise the
                                      # forced-plan path (no probe carry
                                      # leaked into a scan) — gates the
                                      # cache dual-put under the forced key
    executed: int = 0                 # budget target reached so far
    n_slices: int = 0                 # resume batches this request rode in
    probe_done: float | None = None
    completed: float | None = None
    cache_hit: bool = False
    trace_id: str = ""                # obs lifecycle trace id (stamped at
                                      # submit when the scheduler traces)
    features: np.ndarray | None = None  # [F] probe feature vector the budget
                                      # prediction was made from (calibration)
    probe_ndc: int = 0                # NDC spent by the probe prefix
    res_idx: np.ndarray | None = None  # [k] final top-k ids
    res_dist: np.ndarray | None = None
    ndc: int | None = None

    def __post_init__(self):
        if self.expr is None and (self.label_mask is not None
                                  or self.range_lo is not None):
            self.expr = self._legacy_expr()

    def get_expr(self) -> Expr:
        """The filter expression, deriving from legacy fields on demand
        (callers may populate label_mask / range bounds post-construction)."""
        if self.expr is None:
            self.expr = self._legacy_expr()
        return self.expr

    def _legacy_expr(self) -> Expr:
        if self.kind == PRED_RANGE:
            return Range(float(self.range_lo), float(self.range_hi))
        if self.kind in (PRED_CONTAIN, PRED_EQUAL):
            leaf = Contain if self.kind == PRED_CONTAIN else Equal
            return leaf(labels_from_mask(self.label_mask))
        raise ValueError(
            f"request {self.rid}: provide expr= or a legacy predicate kind")


def requests_from_workload(wl, start_rid: int = 0, arrivals=None,
                           deadline: float | None = None) -> list[Request]:
    """Explode a batched QueryWorkload into per-request objects."""
    out = []
    exprs = getattr(wl, "exprs", None)
    for i in range(wl.batch):
        if exprs is not None:
            req = Request(rid=start_rid + i, query=wl.queries[i],
                          expr=exprs[i])
        else:
            kind = wl.spec.kind
            if kind == PRED_RANGE:
                req = Request(rid=start_rid + i, query=wl.queries[i],
                              kind=kind,
                              range_lo=float(wl.spec.range_lo[i]),
                              range_hi=float(wl.spec.range_hi[i]))
            else:
                req = Request(rid=start_rid + i, query=wl.queries[i],
                              kind=kind,
                              label_mask=np.asarray(wl.spec.label_masks[i]))
        if arrivals is not None:
            req.arrival = float(arrivals[i])
        if deadline is not None:
            if arrivals is None:
                raise ValueError("a relative deadline requires explicit "
                                 "arrivals")
            req.deadline = float(arrivals[i]) + deadline
        out.append(req)
    return out


def take_requests(q: deque, limit: int, pred=None) -> list[Request]:
    """Pop up to `limit` requests from a deque in FIFO order; `pred`
    optionally restricts eligibility (ineligible requests keep their
    position). Shared by the admission queue and the bucket batcher.

    Compiled predicate programs make micro-batches structure-agnostic, so
    unlike the pre-algebra serving path there is no same-kind constraint —
    any FIFO prefix batches together.
    """
    taken, kept = [], deque()
    while q:
        r = q.popleft()
        if len(taken) < limit and (pred is None or pred(r)):
            taken.append(r)
        else:
            kept.append(r)
    q.extend(kept)
    return taken


class AdmissionQueue:
    """Bounded FIFO ingress with deadline-aware admission control."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._q: deque[Request] = deque()
        self.n_shed = 0        # rejected: queue full (backpressure)
        self.n_expired = 0     # rejected: deadline already passed

    def __len__(self) -> int:
        return len(self._q)

    def head_arrival(self) -> float | None:
        return self._q[0].arrival if self._q else None

    def offer(self, req: Request, now: float) -> bool:
        if req.deadline is not None and now > req.deadline:
            self.n_expired += 1
            return False
        if len(self._q) >= self.capacity:
            self.n_shed += 1
            return False
        self._q.append(req)
        return True

    def take_group(self, limit: int) -> list[Request]:
        """Pop up to `limit` requests (any filter structure) FIFO."""
        return take_requests(self._q, limit)

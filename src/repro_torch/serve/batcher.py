"""Micro-batcher: fixed-shape lanes + budget-bucketed batch formation.

Counterpart of `repro/serve/batcher.py`. The queues and the batch
formation are host code, as in the reference; the padded queries,
budgets, programs and carried states go to the engine's device
(`device`), where the states also stay between slices: a request's
carried state is a lane of a batch state on the card, gathered with
`take_lanes` / `concat_lanes` / `pad_lanes`.

Two jobs, both about feeding the lockstep engine from a ragged request
stream:

**Fixed-shape lanes.** Every micro-batch is padded to a width from a short
ladder (lane_width / 4, / 2, lane_width), so the engine sees a bounded set
of batch shapes. Pad lanes carry all-zero queries/filters/states and a 0
NDC budget, so they deactivate on their first step.

**Budget buckets.** After the shared probe phase every request owns a
predicted budget Ŵ_q. In a lockstep batch the wall time is set by the
*largest* lane budget — mixing a Ŵ=8000 request into a batch of Ŵ=150
requests makes the easy lanes pay 50× their own cost (the batch-tail
misalignment of paper Fig. 3, recreated at serving level). The batcher
therefore keeps one FIFO queue per budget bucket (ascending NDC caps, last
unbounded) and forms batches within a bucket, so batchmates always have
comparable remaining work. A request whose Ŵ_q exceeds its bucket's cap
runs a bounded time slice and is requeued one bucket up with its carried
`SearchState` (the scheduler's preemption path) — no batch ever runs past
its bucket's budget.

Opportunistic fill: when a bucket batch has spare lanes, requests waiting in
*higher* buckets may ride along for a time slice capped at this bucket's
budget. They make bounded progress without extending the batch (their lane
budget is clamped to the cap) and are requeued upward afterwards.

Since filters are compiled predicate programs, batches mix requests of any
boolean structure — FIFO order alone decides who shares a batch. Program
rows are padded to a shared (slot, term) shape per batch, rounded up to a
power of two so the batch shapes stay few.

**Plan-keyed queues.** Under the planner (serve plan "auto"/"widen") a
probed request carries a chosen execution plan. Traverse and widen lanes
resume under *different* SearchConfigs (the widened frontier changes the
gather), so a resume batch must be plan-homogeneous: the bucket queues are
keyed by (plan, bucket) and opportunistic riders are drawn only from the
same plan's higher buckets. Scan-routed lanes never enter the batcher at
all — the scan plan is terminal and executes inside the ingress pump.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core.state import concat_lanes, pad_lanes, take_lanes
from repro_torch.device import resolve_device
from repro_torch.filters.compile import program_to, stack_programs
from repro_torch.serve.queue import Request, take_requests


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class MicroBatcher:
    def __init__(self, lane_width: int = 16,
                 buckets: tuple = (256, 1024, 4096, None),
                 fill: bool = True, n_words: int | None = None,
                 n_values: int | None = None, device=None):
        if buckets[-1] is not None:
            buckets = tuple(buckets) + (None,)
        caps = [c for c in buckets[:-1]]
        if any(b >= a for a, b in zip(caps[1:], caps[:-1])):
            raise ValueError(f"bucket caps must be ascending: {buckets}")
        self.lane_width = lane_width
        # Engine attribute shapes for program compilation (the scheduler
        # passes them). They MUST match the engine: a mask compiled with
        # fewer words than the engine's label array broadcasts its word-0
        # bits across every word — silent false negatives, not a shape
        # error — so pad_program refuses to guess when they are unset.
        self.n_words = n_words
        self.n_values = n_values
        # where the padded batches go: the engine's device (the scheduler
        # passes it); None is the card, resolved at the first batch
        self._device = device
        # A short ladder of lane widths bounds the batch shapes while
        # letting a partial batch run at its natural width: the lockstep
        # per-step cost grows with lane count, so an 8-wide survivor batch
        # costs less than a 16-wide one — which is what makes budget
        # buckets cheaper than one tail-bound batch, not free lanes.
        self.lane_widths = tuple(sorted({max(1, lane_width // 4),
                                         max(1, lane_width // 2),
                                         lane_width}))
        self.buckets = tuple(buckets)
        self.fill = fill
        # (plan → bucket ladder); legacy requests (plan None) resume as
        # "traverse", so a planner-free deployment only ever populates one
        self.plans = ("traverse", "widen")
        self._queues: dict[str, list[deque[Request]]] = {
            p: [deque() for _ in buckets] for p in self.plans}

    def width_for(self, n: int) -> int:
        """Smallest configured lane width that fits `n` requests."""
        for w in self.lane_widths:
            if n <= w:
                return w
        return self.lane_width

    # ------------------------------------------------------------- routing ----
    def bucket_of(self, budget: int) -> int:
        """Smallest bucket whose cap covers `budget` (deterministic)."""
        for i, cap in enumerate(self.buckets):
            if cap is None or budget <= cap:
                return i
        raise AssertionError("unreachable: last bucket is unbounded")

    def enqueue(self, req: Request, bucket: int | None = None) -> int:
        """Queue a probed request; default routing is by its predicted
        budget, an explicit index supports the escalate policy's requeues.
        The queue ladder is the one for the request's chosen plan (None =
        legacy traverse).

        Queues are kept ordered by arrival: a requeued request (rider or
        escalated slice) carries its original arrival and must sit ahead of
        newer work, or the oldest-head dispatch rule and the batch_wait gate
        would under-serve exactly the hard-tail requests being time-sliced.
        Fresh submissions arrive in order, so the scan is O(1) for them."""
        plan = req.plan or "traverse"
        if plan not in self.plans:
            raise ValueError(f"plan {plan!r} cannot be bucketed "
                             f"(resumable plans: {self.plans})")
        i = self.bucket_of(req.budget) if bucket is None else bucket
        q = self._queues[plan][i]
        if q and q[-1].arrival > req.arrival:
            pos = len(q)
            while pos > 0 and q[pos - 1].arrival > req.arrival:
                pos -= 1
            q.insert(pos, req)
        else:
            q.append(req)
        return i

    def depth(self) -> int:
        return sum(len(q) for ladder in self._queues.values() for q in ladder)

    def head_arrival(self) -> float | None:
        heads = [q[0].arrival
                 for ladder in self._queues.values() for q in ladder if q]
        return min(heads) if heads else None

    def bucket_heads(self) -> list[tuple[float, tuple[str, int], int]]:
        """(head arrival, (plan, bucket index), batchable count) per
        non-empty bucket — the scheduler's dispatch-gating view. Any
        *structure* batches together (count = queue depth), but plans do
        not: each (plan, bucket) queue dispatches alone."""
        return [(q[0].arrival, (p, i), len(q))
                for p, ladder in self._queues.items()
                for i, q in enumerate(ladder) if q]

    # ------------------------------------------------------- batch forming ----
    def form_batch(self, bucket: tuple[str, int] | None = None,
                   ) -> tuple[tuple[str, int], list[Request], int | None]:
        """Pop a batch of up to lane_width requests from `bucket` — a
        (plan, index) pair (default: the non-empty bucket with the oldest
        head — FIFO-fair across plans and buckets). Compiled programs make
        batches structure-agnostic, so the FIFO prefix is taken as-is.
        Returns ((plan, bucket index), requests, cap); requests is [] when
        idle."""
        live = [(p, i) for p, ladder in self._queues.items()
                for i, q in enumerate(ladder) if q]
        if not live:
            return ("traverse", -1), [], None
        p, i = (min(live, key=lambda pi: self._queues[pi[0]][pi[1]][0].arrival)
                if bucket is None else bucket)
        ladder = self._queues[p]
        reqs = take_requests(ladder[i], self.lane_width)
        cap = self.buckets[i]
        if not reqs:                  # explicitly-named bucket was empty
            return (p, i), [], cap
        fill_to = self.width_for(len(reqs))
        if self.fill and len(reqs) < fill_to and cap is not None:
            # Riders take only the PAD lanes of the batch's natural ladder
            # width — widening the batch would make the resident requests
            # pay the riders' per-step cost (per-step cost scales with lane
            # width). Within the natural width they are free, resume-exact
            # progress, clamped to this bucket's cap. Eligibility requires
            # executed < cap: a rider that already reached this cap in an
            # earlier slice would be a no-op lane (dispatch cost, no
            # progress). Riders come from the SAME plan's higher buckets
            # only — a widen lane cannot ride a traverse batch (different
            # SearchConfig).
            for j in range(i + 1, len(ladder)):
                if len(reqs) == fill_to:
                    break
                reqs += take_requests(ladder[j],
                                      fill_to - len(reqs),
                                      pred=lambda r: r.executed < cap)
        return (p, i), reqs, cap

    # ----------------------------------------------------------- assembly ----
    # `width=None` pads to the full lane_width; the scheduler passes
    # width_for(len(requests)) so partial batches run at their natural
    # (cheaper) shape.

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def pad_queries(self, requests: list[Request],
                    width: int | None = None) -> torch.Tensor:
        width = self.lane_width if width is None else width
        q = np.stack([r.query for r in requests]).astype(np.float32)
        q = np.pad(q, ((0, width - len(requests)), (0, 0)))
        return torch.from_numpy(q).to(self.device)

    def pad_program(self, requests: list[Request], width: int | None = None):
        """Stack per-request compiled programs into one [width, S, ...]
        batch program on the device. Slot/term counts pad to the batch max
        rounded up to a power of two (bounded shapes across heterogeneous
        batches); pad lanes get match-nothing rows — inert under their 0
        NDC budget.
        """
        from repro_torch.filters.compile import compile_query

        progs = []
        for r in requests:
            if r.program is None:  # scheduler stamps this at submit
                if self.n_words is None or self.n_values is None:
                    raise ValueError(
                        "MicroBatcher needs n_words/n_values matching the "
                        "engine to compile filter programs — construct it "
                        "with the engine's attribute shapes")
                r.program = compile_query(r.get_expr(), self.n_words,
                                          self.n_values)
            progs.append(r.program)
        s = _pow2(max(p.n_slots for p in progs))
        t = _pow2(max(p.n_terms for p in progs))
        prog = stack_programs(progs, n_slots=s, n_terms=t,
                              pad_to=self.lane_width if width is None
                              else width)
        return program_to(prog, self.device)

    def budget_targets(self, requests: list[Request], cap: int | None,
                       width: int | None = None) -> np.ndarray:
        """Per-lane budget targets on the host: Ŵ_q clamped to the bucket
        cap; pad lanes get 0 and deactivate immediately."""
        b = np.zeros(self.lane_width if width is None else width, np.int32)
        for i, r in enumerate(requests):
            b[i] = r.budget if cap is None else min(r.budget, cap)
        return b

    def pad_budgets(self, requests: list[Request], cap: int | None,
                    width: int | None = None) -> torch.Tensor:
        """`budget_targets` on the device."""
        return torch.from_numpy(self.budget_targets(requests, cap, width)).to(
            self.device)

    def pad_states(self, requests: list[Request],
                   width: int | None = None):
        """Assemble the carried states into one [width, ...] batch state
        on the device (zero states on pad lanes are inert under 0 budget).

        A request's `state` is a (batch SearchState, lane index) reference
        into the batch it last rode in — lanes are gathered here *per source
        batch* rather than sliced per request, which keeps the device-op
        count per assembled batch at a few× the leaf count instead of
        lanes× the leaf count. The gathers copy, so the source batches are
        never written: the engine consumes only the assembled state."""
        groups: dict[int, list] = {}
        for pos, r in enumerate(requests):
            st, lane = r.state
            groups.setdefault(id(st), [st, [], []])
            groups[id(st)][1].append(lane)
            groups[id(st)][2].append(pos)
        parts = [take_lanes(st, lanes) for st, lanes, _ in groups.values()]
        merged = parts[0] if len(parts) == 1 else concat_lanes(parts)
        order = [p for _, _, ps in groups.values() for p in ps]
        if order != list(range(len(order))):
            inv = np.empty(len(order), np.int64)
            inv[order] = np.arange(len(order), dtype=np.int64)
            merged = take_lanes(merged, inv)
        width = self.lane_width if width is None else width
        return pad_lanes(merged, width - len(requests))

"""Cost-aware scheduler: probe → estimate → bucket → resume/requeue.

Counterpart of `repro/serve/scheduler.py` on one device (a plain engine or
an index-sharded one, whose per-shard NDC and bitmap counts the summary
reports). The queues, routing and
accounting are host code, as in the reference; every batch runs on the
engine's device through the same `probe_and_features`, `predict_budgets`,
`engine.search`, `scan_search` and planner routing as the one-shot
pipeline, and the carried per-lane states stay on the device between
slices. Where the reference blocks on a JAX result before reading the
timer, the port synchronizes the engine's device, so the injected timer
measures device work. The estimator's forests stay on the device
(`CostEstimator.packed(device)`): a batch uploads none after the first.

Turns the paper's per-query cost signal Ŵ_q into *system* behavior. The
request lifecycle:

  admit      bounded AdmissionQueue (backpressure + deadline checks), with a
             result-cache lookup in front; the filter expression is
             compiled to its canonical predicate program here, once
  probe      micro-batch of requests — *any* mix of filter structures, the
             compiled programs are batch-uniform — runs the shared early
             probe (the first f NDCs of the real traversal — identical code
             path to `e2e_search`)
  estimate   GBDT on probe features → Ŵ_q per request (`predict_budgets`,
             the exact stage-2 path of the one-shot pipeline)
  bucket     requests routed to budget buckets; each request carries its
             live per-lane `SearchState` out of the probe batch
  resume     a bucket batch resumes its lanes with budget min(Ŵ_q, cap) —
             batchmates always have comparable remaining work, so no easy
             lane ever waits on a batch tail
  requeue    lanes with Ŵ_q > cap ran a bounded time slice; their carried
             state is requeued one bucket up (preemption). Because the
             traversal is resume-exact, the final top-k is bit-identical to
             a one-shot `e2e_search` at the same α no matter how the work
             was sliced (tests/test_serve.py pins this).

The scheduler is clock-agnostic: callers pass `now` into submit()/pump() and
service time is measured with the injected `timer` around real engine work.
`launch/serve.py` drives it with a wall clock; a simulation may drive an
open-loop clock off the measured (or modelled) service times.

Routing policies:
  direct    (default) each probed request goes to the smallest bucket whose
            cap covers Ŵ_q — one resume slice unless it rode an
            opportunistic fill.
  escalate  multilevel-feedback: every request starts in the shortest
            bucket and climbs on requeue — hard queries are time-sliced,
            which bounds every batch's wall time at the cost of extra
            slices (useful when the estimator's tail is untrusted).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.e2e import predict_budgets, probe_and_features
from repro_torch.core.engine import SearchEngine
from repro_torch.core.planner import (PLAN_SCAN, PLAN_TRAVERSE, PLANS,
                                      choose_plans, stage0_scan_mask)
from repro_torch.core.plans import ScanStats, scan_search, scan_stats
from repro_torch.core.search import dispatch_counters
from repro_torch.core.state import SearchConfig, pad_lanes, take_lanes
from repro_torch.filters.compile import compile_query
from repro_torch.obs.calibration import CalibrationMonitor
from repro_torch.obs.drift import DriftConfig, DriftMonitor
from repro_torch.obs.trace import as_tracer
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.cache import ResultCache, request_key
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import AdmissionQueue, Request


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    lane_width: int = 16
    buckets: tuple = (256, 1024, 4096, None)
    policy: str = "direct"           # "direct" | "escalate"
    fill: bool = True                # opportunistic fill of spare lanes
    queue_capacity: int = 256
    batch_wait: float = 0.0          # dispatch a partial batch only after
                                     # its head waited this long (0 = eager)
    probe_budget: int = 64
    n_probes: int = 2
    alpha: float = 1.5
    min_budget: int = 32
    max_budget: int = 1 << 30
    ablate_filter: bool = False
    cache_capacity: int = 4096       # 0 disables the result cache
    plan: str = "traverse"           # execution plan: "traverse" (legacy
                                     # E2E pipeline), "scan" / "widen"
                                     # (forced single plan), or "auto"
                                     # (per-lane planner routing — needs a
                                     # fitted core.planner.Planner)


class CostAwareScheduler:
    def __init__(self, engine: SearchEngine, estimator, cfg: SearchConfig,
                 serve_cfg: ServeConfig = ServeConfig(),
                 timer=time.perf_counter, service_model=None, planner=None,
                 tracer=None, calibration: bool = True, drift=True):
        """service_model: optional callable (trip count, lane width) →
        seconds. When set, pump() charges batches by the model instead of
        the wall clock — a calibrated virtual clock that makes scheduling
        simulations deterministic. Real engine work still runs either way;
        only the *charged* service time differs. (Scan batches have no
        lockstep trips; under a service model they charge ⌈σ·N / (lane
        degree)⌉ equivalent trips, the same distance work per lane.)

        planner: a fitted `core.planner.Planner`; required when
        serve_cfg.plan is "auto" or "widen" (those route on its cost
        heads), ignored for "traverse" (the legacy `estimator` head) and
        "scan" (closed-form).

        tracer: optional `obs.Tracer`. Requests get trace ids at submit;
        spans cover admit → probe → estimate → plan-select → resume
        slices (per-launch spans from the persistent launch loop) → complete.
        Spans wrap only host dispatch boundaries that already exist, so
        results are bit for bit the same with tracing on and off.

        calibration: record (features, predicted Ŵ_q, actual NDC, plan)
        per completed non-cache-hit request into `self.calibration` (a
        `obs.CalibrationMonitor`). Costs one feature-matrix device→host
        copy per probe batch, outside every launch loop.

        drift: watch the calibration log with an `obs.DriftMonitor`
        (True → default thresholds, a `DriftConfig` → custom, False →
        off; requires calibration). It runs only when `drift_report()` /
        `status()` / `prometheus()` is called, never inside a pump."""
        if serve_cfg.policy not in ("direct", "escalate"):
            raise ValueError(f"unknown policy {serve_cfg.policy!r}")
        if serve_cfg.plan not in PLANS + ("auto",):
            raise ValueError(f"unknown plan {serve_cfg.plan!r} "
                             f"(one of {PLANS + ('auto',)})")
        if planner is None and serve_cfg.plan in ("auto", "widen"):
            raise ValueError(f"plan {serve_cfg.plan!r} needs a fitted "
                             "core.planner.Planner")
        self.engine = engine
        self.device = engine.device
        self.service_model = service_model
        self.estimator = estimator
        self.planner = planner
        self.cfg = cfg
        self.cfg_widen = dataclasses.replace(cfg, mode="widen")
        self.scfg = serve_cfg
        self.timer = timer
        self.ingress = AdmissionQueue(serve_cfg.queue_capacity)
        self.batcher = MicroBatcher(serve_cfg.lane_width, serve_cfg.buckets,
                                    serve_cfg.fill,
                                    n_words=engine.n_words,
                                    n_values=engine.n_values,
                                    device=self.device)
        self.cache = (ResultCache(serve_cfg.cache_capacity)
                      if serve_cfg.cache_capacity else None)
        self.metrics = ServeMetrics()
        # precision is a per-engine deployment knob: the codec identity is
        # part of every cache key (resolved against THIS scheduler's cfg),
        # and quantized engines rerank finished lanes with exact float32
        # before results leave the scheduler
        self._codec = engine.codec_key(cfg)
        self._rerank = engine.effective_precision(cfg) != "float32"
        # index-sharded engines (core.sharded) report their layout through
        # the serving summary: a request's NDC spreads over n_shards
        # traversals, which capacity planning needs to see. 1 = unsharded.
        self._n_shards = int(getattr(engine, "n_shards", 1))
        self._persistent = getattr(
            get_backend(cfg.backend or engine.backend or "dense"),
            "persistent", False)
        self.tracer = tracer
        self._tr = as_tracer(tracer)
        self.calibration = CalibrationMonitor() if calibration else None
        self.drift_monitor = None
        if calibration and drift:
            self.drift_monitor = DriftMonitor(
                drift if isinstance(drift, DriftConfig) else None)

    def _sync(self) -> None:
        """Wait for the device's queued work (the reference's
        `block_until_ready`), so the timer read after it covers it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _launches0(self) -> int:
        """Persistent launch-loop dispatch counter snapshot (pump sites diff
        two snapshots around their engine work to get loop-observed launch
        counts; single-step backends never touch the counter)."""
        return dispatch_counters()["launches"]

    def _launch_stats(self, steps: int, lane_steps,
                      observed: int) -> tuple[int, float]:
        """Dispatch accounting for one lockstep batch. On a persistent
        backend `observed` (the launch loop's dispatch-counter delta
        around this batch's engine work) is the count: a probe dispatches
        once per snapshot and the compaction ladder relaunches at reduced
        widths. Single-step backends count one launch per trip.
        `early_exit_frac` is the fraction of real lanes that finished
        before the batch's slowest — the lanes the launch loop's
        compaction stops paying for."""
        if self._persistent:
            launches = int(observed)
            if launches == 0 and steps <= 0:
                return 0, 0.0
        elif steps <= 0:
            return 0, 0.0
        else:
            launches = steps
        lane_steps = np.asarray(lane_steps)
        early = (float(np.mean(lane_steps < steps))
                 if lane_steps.size and steps > 0 else 0.0)
        return launches, early

    def _observe_shards(self, out, entry, n_real: int) -> None:
        """Per-shard NDC deltas of one pump's real lanes (sharded engines
        only). `out` / `entry` are the batch's exit and entry states;
        entry=None means the batch started from scratch. Reads the
        per-shard [B, S] counter the merge already holds — no kernel, one
        small device-to-host copy after the pump's own readbacks. Summed
        over pumps these add up to exactly Σ completed-request NDC."""
        sh = getattr(out, "shard", None)
        if sh is None or n_real <= 0:
            return
        cnt = sh.cnt[:n_real].cpu().numpy().astype(np.int64)   # [n, S]
        if entry is not None:
            cnt = cnt - entry.shard.cnt[:n_real].cpu().numpy()
        self.metrics.observe_shard_ndc(cnt.sum(axis=0))

    def _observe_shard_bitmap(self, stats, n_real: int) -> None:
        """Per-shard popcounts of one freshly compiled filter bitmap
        (sharded engines only): the [B, N] validity mask cut at the
        engine's shard offsets. Called once per ScanStats compilation, so
        each admitted filter row is counted once."""
        if self._n_shards <= 1 or n_real <= 0:
            return
        ns = self.engine.shard_size
        offs = self.engine.offsets
        valid = stats.valid[:n_real]
        counts = torch.stack([valid[:, int(o):int(o) + ns].sum()
                              for o in offs[:self._n_shards]])
        self.metrics.observe_shard_bitmap(
            [int(c) for c in counts.cpu().numpy()])

    # ------------------------------------------------------------- ingress ----
    def _key_for(self, req: Request, plan: str) -> str:
        s = self.scfg
        return request_key(
            req, self.cfg.k, self.cfg.queue_size, s.alpha,
            s.probe_budget, s.min_budget, s.max_budget, s.n_probes,
            s.ablate_filter, codec=self._codec, plan=plan)

    def _key(self, req: Request) -> str:
        # memoized on the request: the canonical-DNF serialization inside
        # request_key is a recursive Python walk, and the key is needed
        # twice per served request (submit lookup + completion put)
        if req.cache_key is None:
            req.cache_key = self._key_for(req, self.scfg.plan)
        return req.cache_key

    def submit(self, req: Request, now: float) -> str:
        """Returns "hit" | "queued" | "shed" | "expired"."""
        req.arrival = now if req.arrival is None else req.arrival
        if self.tracer is not None and not req.trace_id:
            req.trace_id = self._tr.new_trace("req")
        if self.cache is not None:
            # keyed on the canonical expression, so hits never pay compile
            hit = self.cache.get(self._key(req))
            if hit is not None:
                req.res_idx, req.res_dist, req.ndc = hit
                req.cache_hit = True
                req.completed = now
                self._tr.emit("complete", req.trace_id, rid=req.rid,
                              cache_hit=True, ndc=int(req.ndc))
                self.metrics.complete(req)
                return "hit"
        if req.program is None and len(self.ingress) < self.ingress.capacity:
            # compile once per request, BEFORE admission: an expression the
            # compiler rejects (label outside the alphabet, DNF blow-up)
            # must raise here, while nothing is queued. The capacity
            # pre-check keeps the overload shed path O(1).
            req.program = compile_query(req.get_expr(), self.engine.n_words,
                                        self.engine.n_values)
        if not self.ingress.offer(req, now):
            status = ("expired" if (req.deadline is not None
                                    and now > req.deadline) else "shed")
            self._tr.emit("admit", req.trace_id, rid=req.rid, status=status)
            return status
        self._tr.emit("admit", req.trace_id, rid=req.rid, status="queued")
        return "queued"

    def has_work(self) -> bool:
        return bool(len(self.ingress) or self.batcher.depth())

    def depth(self) -> int:
        return len(self.ingress) + self.batcher.depth()

    # --------------------------------------------------------------- pump ----
    def _dispatchable(self, now: float):
        """All queues holding work, as (head arrival, target) where target
        is "probe" or a bucket key — filtered by the batching gate: a
        batch dispatches when it can fill its lanes or when its head has
        waited `batch_wait`. Probe batches are never gated: a probe costs
        probe_budget NDC per lane (≪ any bucket cap), and eager probing
        routes work into buckets sooner."""
        heads = []
        if len(self.ingress):
            heads.append((self.ingress.head_arrival(), "probe",
                          self.batcher.lane_width))
        for arrival, i, n in self.batcher.bucket_heads():
            heads.append((arrival, i, n))
        ready = [(a, t) for a, t, n in heads
                 if n >= self.batcher.lane_width
                 or now - a >= self.scfg.batch_wait]
        return ready, heads

    def next_deadline(self) -> float | None:
        """Earliest time a currently-gated batch becomes dispatchable (the
        caller's idle-advance target); None when no work is queued."""
        _, heads = self._dispatchable(float("inf"))
        if not heads:
            return None
        return min(a for a, _, _ in heads) + self.scfg.batch_wait

    def pump(self, now: float) -> tuple[list[Request], float]:
        """Execute one micro-batch: among dispatchable queues the oldest
        head wins, so probe work and bucket work interleave FIFO-fair.
        Returns (completed requests, measured busy seconds); completions
        are stamped at now + busy. (([], 0.0) means every queued batch is
        still gated — advance the clock to `next_deadline()`.)"""
        self.metrics.observe_depth(now, self.depth())
        ready, _ = self._dispatchable(now)
        if not ready:
            return [], 0.0
        # oldest head wins; on arrival ties probe work goes first (it feeds
        # the bucket queues, improving downstream batch fill)
        target = min(ready, key=lambda x: (x[0], x[1] != "probe"))[1]
        if target == "probe":
            return self._pump_probe(now)
        return self._pump_bucket(now, target)

    def run_until_idle(self, now: float) -> float:
        """Drain all queued work; returns the advanced clock."""
        while self.has_work():
            _, busy = self.pump(now)
            if busy > 0:
                now += busy
            else:
                # everything gated on batch_wait — jump to the deadline
                now = max(now, self.next_deadline())
        return now

    # ---------------------------------------------------------- internals ----
    def _final_results(self, queries, state, any_finish: bool = True):
        """Host copies of the result arrays lanes finish with: the
        traversal buffers at float32 precision, the exact-reranked pool on
        a quantized engine.

        The rerank runs on the whole batch, but only when some lane
        actually finishes in this pump (`any_finish`). Lanes that continue
        keep their carried state untouched, so resumes stay in the
        compressed domain and the scheduled result remains the one-shot
        `e2e_search`'s, whose terminal rerank sees the same per-lane pools.
        """
        if self._rerank and any_finish:
            rd, ri = self.engine.rerank_arrays(queries, state)
            return ri.cpu().numpy(), rd.cpu().numpy()
        return state.res_idx.cpu().numpy(), state.res_dist.cpu().numpy()

    def _probe_batch(self, reqs: list[Request], bt: str):
        """The shared early probe of `reqs` through the one-shot
        pipeline's `probe_and_features` (per-lane budget: pad lanes get 0);
        it always runs the session (post) config — the widen plan, like
        run_plan("widen"), widens only the resume."""
        width = self.batcher.width_for(len(reqs))
        queries = self.batcher.pad_queries(reqs, width)
        prog = self.batcher.pad_program(reqs, width)
        lane_on = np.zeros(width, np.int32)
        lane_on[: len(reqs)] = 1
        st, feats = probe_and_features(
            self.engine, self.cfg, queries, prog,
            lane_on * np.int32(self.scfg.probe_budget),
            n_probes=self.scfg.n_probes, tracer=self.tracer, trace_id=bt)
        return width, queries, st, feats

    def _pump_probe(self, now: float) -> tuple[list[Request], float]:
        """Ingress pump. Under the legacy/forced-traversal plans this is
        the shared early probe; under "scan" it executes the terminal scan
        plan directly (no probe — the bitmap makes σ exact for free); under
        "auto" it is the planner's two-stage router."""
        scfg = self.scfg
        reqs = self.ingress.take_group(self.batcher.lane_width)
        if scfg.plan == "scan":
            for r in reqs:
                r.plan, r.plan_pure = "scan", True
            return self._scan_batch(now, reqs, None)
        if scfg.plan == "auto":
            return self._pump_auto(now, reqs)
        t0 = self.timer()
        bt = self._tr.new_trace("probe") if self.tracer is not None else ""
        l0 = self._launches0()
        width, queries, st, feats = self._probe_batch(reqs, bt)

        # Stage 2 — cost estimate (same path as one-shot e2e_search /
        # run_plan): the legacy estimator for traverse, the planner's widen
        # head for the forced widen plan; forests from the device cache.
        head = (self.estimator if scfg.plan == "traverse"
                else self.planner.widen)
        with self._tr.span("estimate", bt, lanes=len(reqs)):
            budgets, _ = predict_budgets(head, feats, scfg.alpha,
                                         scfg.min_budget, scfg.max_budget,
                                         scfg.ablate_filter,
                                         packed=head.packed(self.device))
            self._sync()
            budgets = budgets.cpu().numpy()
        cnt = st.cnt.cpu().numpy()
        self._observe_shards(st, None, len(reqs))
        res_idx, res_dist = self._final_results(
            queries, st,
            any(int(budgets[i]) <= int(cnt[i]) for i in range(len(reqs))))
        hops = st.hops.cpu().numpy()
        steps = int(hops.max())  # lockstep trip count
        busy = (self.timer() - t0 if self.service_model is None
                else self.service_model(steps, width))
        launches, early = self._launch_stats(steps, hops[: len(reqs)],
                                             observed=self._launches0() - l0)
        self.metrics.observe_batch("probe", len(reqs), width, busy, steps,
                                   launches=launches, early_exit_frac=early)
        feats_h = (feats.cpu().numpy() if self.calibration is not None
                   else None)

        done = []
        for i, r in enumerate(reqs):
            r.plan, r.plan_pure = scfg.plan, True
            r.budget = int(budgets[i])
            r.probe_done = now + busy
            r.executed = int(cnt[i])
            r.probe_ndc = int(cnt[i])
            if feats_h is not None:
                r.features = feats_h[i]
            self._tr.emit("probe-done", r.trace_id, rid=r.rid, batch=bt,
                          budget=r.budget, probe_ndc=r.probe_ndc,
                          plan=str(r.plan))
            if r.budget <= r.executed:
                # the estimator says the probe already saw enough — the
                # one-shot pipeline's resume would be a no-op for this lane
                self._finish(r, res_idx[i], res_dist[i], cnt[i], now + busy)
                done.append(r)
            else:
                r.state = (st, i)   # lane reference into the probe batch
                bucket = (0 if self.scfg.policy == "escalate" else None)
                self.batcher.enqueue(r, bucket)
        return done, busy

    def _pump_auto(self, now: float, reqs: list[Request],
                   ) -> tuple[list[Request], float]:
        """Planner routing (plan="auto"): stage 0 compiles the bitmap and
        routes clearly-scannable lanes to scan *without probing*; the rest
        run the shared probe and split on the per-plan cost heads. Every
        sub-path is the code the one-shot `planned_search` runs, which is
        what extends scheduled ≡ one-shot to auto."""
        scfg = self.scfg
        t0 = self.timer()
        bt = self._tr.new_trace("auto") if self.tracer is not None else ""
        width = self.batcher.width_for(len(reqs))
        prog = self.batcher.pad_program(reqs, width)
        with self._tr.span("plan-stage0", bt, lanes=len(reqs)) as sp:
            stats = scan_stats(self.engine, prog)
            self._observe_shard_bitmap(stats, len(reqs))
            s0 = stage0_scan_mask(
                self.planner, stats, prog, scfg.alpha, scfg.min_budget,
                scfg.max_budget, self.device)[: len(reqs)]
            sp.set(scan_routed=int(s0.sum()))
        busy = self.timer() - t0 if self.service_model is None else 0.0
        done = []
        scan_i = np.nonzero(s0)[0]
        if scan_i.size:
            sub = [reqs[i] for i in scan_i]
            for r in sub:
                r.plan, r.plan_pure = "scan", True
            d, b = self._scan_batch(now, sub, stats.rows(scan_i))
            done += d
            busy += b
        rest_i = np.nonzero(~s0)[0]
        if rest_i.size:
            d, b = self._auto_probe(now, [reqs[i] for i in rest_i],
                                    stats.rows(rest_i))
            done += d
            busy += b
        return done, busy

    def _auto_probe(self, now: float, reqs: list[Request],
                    stats) -> tuple[list[Request], float]:
        """Stage 1 of auto routing: shared probe → per-plan heads →
        argmin route. Scan-routed lanes ("late scan" — the static head
        kept them past stage 0) execute immediately, carrying their probe
        counters; traverse/widen lanes enqueue into their plan's buckets."""
        scfg = self.scfg
        t0 = self.timer()
        bt = self._tr.new_trace("probe") if self.tracer is not None else ""
        l0 = self._launches0()
        width, queries, st, feats = self._probe_batch(reqs, bt)
        cnt = st.cnt.cpu().numpy()
        self._observe_shards(st, None, len(reqs))
        counts = np.zeros(width, np.int64)
        counts[: len(reqs)] = stats.counts
        with self._tr.span("plan-select", bt, lanes=len(reqs)):
            ids, w_t, w_w = choose_plans(
                self.planner, feats, cnt, counts, scfg.alpha,
                scfg.min_budget, scfg.max_budget)
        fin = [i for i in range(len(reqs)) if ids[i] != PLAN_SCAN
               and int((w_t if ids[i] == PLAN_TRAVERSE else w_w)[i])
               <= int(cnt[i])]
        res_idx, res_dist = self._final_results(queries, st, bool(fin))
        hops = st.hops.cpu().numpy()
        steps = int(hops.max())
        busy = (self.timer() - t0 if self.service_model is None
                else self.service_model(steps, width))
        launches, early = self._launch_stats(steps, hops[: len(reqs)],
                                             observed=self._launches0() - l0)
        self.metrics.observe_batch("probe", len(reqs), width, busy, steps,
                                   launches=launches, early_exit_frac=early)
        feats_h = (feats.cpu().numpy() if self.calibration is not None
                   else None)
        for i, r in enumerate(reqs):
            r.probe_ndc = int(cnt[i])
            if feats_h is not None:
                r.features = feats_h[i]

        done = []
        late = [i for i in range(len(reqs)) if ids[i] == PLAN_SCAN]
        if late:
            sub = [reqs[i] for i in late]
            for r in sub:
                # probe counters leak into the scan state: the result is
                # NOT bitwise the forced-scan path (cnt differs), so no
                # dual-put under the forced key
                r.plan, r.plan_pure = "scan", False
            d, b = self._scan_batch(now, sub, stats.rows(late),
                                    base=take_lanes(st, np.asarray(late)))
            done += d
            busy += b
        for i, r in enumerate(reqs):
            if ids[i] == PLAN_SCAN:
                continue
            plan = "traverse" if ids[i] == PLAN_TRAVERSE else "widen"
            r.plan, r.plan_pure = plan, True
            r.budget = int((w_t if ids[i] == PLAN_TRAVERSE else w_w)[i])
            r.probe_done = now + busy
            r.executed = int(cnt[i])
            self._tr.emit("probe-done", r.trace_id, rid=r.rid, batch=bt,
                          budget=r.budget, probe_ndc=r.probe_ndc, plan=plan)
            if r.budget <= r.executed:
                self._finish(r, res_idx[i], res_dist[i], cnt[i], now + busy)
                done.append(r)
            else:
                r.state = (st, i)
                bucket = (0 if self.scfg.policy == "escalate" else None)
                self.batcher.enqueue(r, bucket)
        return done, busy

    def _scan_batch(self, now: float, reqs: list[Request], stats,
                    base=None) -> tuple[list[Request], float]:
        """Execute the terminal scan plan for a group of requests. `stats`
        is the lanes' ScanStats rows (None → compile here, the forced-scan
        path); `base` carries probe states for late-scan lanes. The batch
        pads to the lane-width ladder like every other micro-batch — the
        per-lane-deterministic scan distance path makes the padding (and
        any batch composition) invisible in the results."""
        t0 = self.timer()
        bt = self._tr.new_trace("scan") if self.tracer is not None else ""
        width = self.batcher.width_for(len(reqs))
        queries = self.batcher.pad_queries(reqs, width)
        prog = self.batcher.pad_program(reqs, width)
        pad = width - len(reqs)
        if stats is None:
            stats = scan_stats(self.engine, prog)  # pads match nothing
            self._observe_shard_bitmap(stats, len(reqs))
        elif pad:
            stats = ScanStats(
                valid=torch.cat([stats.valid, stats.valid.new_zeros(
                    (pad, stats.valid.shape[1]))]),
                counts=np.pad(stats.counts, (0, pad)),
                clause_frac=np.pad(stats.clause_frac, ((0, pad), (0, 0))),
                n=stats.n)
        if base is not None and pad:
            base = pad_lanes(base, pad)
        with self._tr.span("scan", bt, lanes=len(reqs), width=width,
                           late=base is not None):
            st = scan_search(self.engine, self.cfg, queries, prog,
                             stats=stats, base_state=base)
            self._sync()
        res_idx, res_dist = self._final_results(queries, st, True)
        cnt = st.cnt.cpu().numpy()
        self._observe_shards(st, base, len(reqs))
        # scan has no lockstep trips; charge the service model the
        # distance-equivalent count (σ·N work / the per-trip lane degree)
        steps = int(np.ceil(stats.counts.max(initial=0)
                            / max(self.cfg.degree, 1)))
        busy = (self.timer() - t0 if self.service_model is None
                else self.service_model(steps, width))
        # scan is one dispatch of the distance kernel regardless of
        # backend; no lockstep lanes to early-exit
        self.metrics.observe_batch("scan", len(reqs), width, busy, steps,
                                   launches=1)
        done = []
        for i, r in enumerate(reqs):
            r.budget = int(cnt[i])
            r.executed = int(cnt[i])
            self._finish(r, res_idx[i], res_dist[i], cnt[i], now + busy)
            done.append(r)
        return done, busy

    def _pump_bucket(self, now: float, bucket: tuple[str, int] | None = None,
                     ) -> tuple[list[Request], float]:
        (plan, idx), reqs, cap = self.batcher.form_batch(bucket)
        if not reqs:
            return [], 0.0
        # plan-homogeneous batch (the batcher keys queues by plan): widen
        # lanes resume under the widened-frontier config, traverse lanes
        # under the session config — same resume-exact lockstep either way
        cfg = self.cfg_widen if plan == "widen" else self.cfg
        t0 = self.timer()
        bt = self._tr.new_trace("bucket") if self.tracer is not None else ""
        l0 = self._launches0()
        width = self.batcher.width_for(len(reqs))
        queries = self.batcher.pad_queries(reqs, width)
        prog = self.batcher.pad_program(reqs, width)
        targets = self.batcher.budget_targets(reqs, cap, width)
        state = self.batcher.pad_states(reqs, width)

        # Stage 3 — adaptive termination, bounded by the bucket cap.
        entry_hops = state.hops.cpu().numpy()
        with self._tr.span("resume", bt, bucket=int(idx), plan=plan,
                           lanes=len(reqs), width=width) as sp:
            out = self.engine.search(cfg, queries, prog, targets,
                                     state=state, tracer=self.tracer,
                                     trace_id=bt)
            self._sync()
            step_d = out.hops.cpu().numpy() - entry_hops
            lane_steps = step_d[: len(reqs)]
            steps = int(step_d.max())
            sp.set(steps=steps)
        res_idx, res_dist = self._final_results(
            queries, out,
            cap is None or any(r.budget <= cap for r in reqs))
        cnt = out.cnt.cpu().numpy()
        self._observe_shards(out, state, len(reqs))
        busy = (self.timer() - t0 if self.service_model is None
                else self.service_model(steps, width))
        label = f"bucket{idx}" if plan == "traverse" else f"bucket{idx}:{plan}"
        launches, early = self._launch_stats(steps, lane_steps,
                                             observed=self._launches0() - l0)
        self.metrics.observe_batch(label, len(reqs), width, busy, steps,
                                   launches=launches, early_exit_frac=early)

        done = []
        for i, r in enumerate(reqs):
            r.n_slices += 1
            r.executed = int(targets[i])
            if cap is None or r.budget <= cap:
                r.state = None
                self._finish(r, res_idx[i], res_dist[i], cnt[i], now + busy)
                done.append(r)
            else:
                # preemption: bounded slice done, requeue the carried state
                r.state = (out, i)
                nxt = (idx + 1 if self.scfg.policy == "escalate" else None)
                self.batcher.enqueue(r, nxt)
        return done, busy

    def _finish(self, req: Request, res_idx, res_dist, ndc, at: float):
        req.res_idx = np.asarray(res_idx)
        req.res_dist = np.asarray(res_dist)
        req.ndc = int(ndc)
        req.completed = at
        if self.calibration is not None:
            # cache hits never reach _finish, so every record is a real
            # execution: predicted Ŵ_q vs the NDC the search actually spent
            self.calibration.record(
                rid=req.rid, plan=req.plan or "traverse",
                predicted=req.budget if req.budget is not None else req.ndc,
                actual=req.ndc, probe_ndc=req.probe_ndc,
                n_slices=req.n_slices, alpha=self.scfg.alpha,
                features=req.features)
        self._tr.emit("complete", req.trace_id, rid=req.rid, ndc=req.ndc,
                      plan=str(req.plan or "traverse"),
                      budget=int(req.budget or 0),
                      n_slices=req.n_slices, cache_hit=False)
        if self.cache is not None:
            self.cache.put(self._key(req), req.res_idx, req.res_dist, req.ndc)
            if self.scfg.plan == "auto" and req.plan_pure and req.plan:
                # dual put: this auto completion executed its chosen plan
                # through the exact bitwise path a forced-plan scheduler
                # would have taken (no probe carry leaked into a scan), so
                # the result is also valid under the forced key. Late
                # scans (plan_pure=False) skip this: their NDC includes the
                # probe a forced scan never pays.
                self.cache.put(self._key_for(req, req.plan),
                               req.res_idx, req.res_dist, req.ndc)
        self.metrics.complete(req)

    def summary(self) -> dict:
        out = self.metrics.summary(self.ingress.n_shed,
                                   self.ingress.n_expired, self.cache)
        out["n_shards"] = self._n_shards
        return out

    def calibration_report(self) -> dict | None:
        """Rolling calibration health (None when calibration is off)."""
        return (None if self.calibration is None
                else self.calibration.report())

    def drift_report(self) -> dict | None:
        """Current drift-monitor state against the calibration log (None
        when drift monitoring is off). Freezes the reference window on the
        first call that sees ≥ min_ref records — the analysis runs here,
        at poll/scrape cadence, never inside a pump."""
        if self.drift_monitor is None or self.calibration is None:
            return None
        return self.drift_monitor.observe(self.calibration)

    def status(self) -> dict:
        """The serving health surface: one structured, JSON-serializable
        report unifying queue/admission state, the metrics summary,
        calibration health and the drift-alarm state. `healthy` is the
        single pager bit: False exactly while a drift detector alarms."""
        drift = self.drift_report()
        return dict(
            healthy=drift is None or not drift["alarm"],
            queue=dict(depth=self.depth(),
                       ingress=len(self.ingress),
                       bucketed=self.batcher.depth(),
                       capacity=self.ingress.capacity,
                       shed=int(self.ingress.n_shed),
                       expired=int(self.ingress.n_expired)),
            summary=self.summary(),
            calibration=self.calibration_report(),
            drift=drift,
        )

    def prometheus(self, prefix: str = "repro") -> str:
        """One Prometheus-text-format scrape over the serving summary and
        (when enabled) the calibration and drift reports."""
        from repro_torch.obs.export import prometheus_text

        return prometheus_text(self.summary(), self.calibration_report(),
                               self.drift_report(), prefix=prefix)

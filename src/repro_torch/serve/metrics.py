"""Serving metrics: latency percentiles, NDC histogram, queue depth, cache.

Counterpart of `repro/serve/metrics.py` (host code; same summary dict).
One record per completed request plus periodic queue-depth samples; the
summary feeds the `launch/serve.py` report and the Prometheus scrape.
Times are in whatever unit the driving clock uses (seconds for the
real-clock launcher). The per-shard counters are kept for the sharded
engine; nothing feeds them on one index.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from functools import partial

import numpy as np

# Retention caps: a long-lived serving process must not grow memory without
# bound, so per-request / per-batch observations are sliding windows (the
# aggregate counters n_batches / busy_time stay exact for the full
# lifetime). At serving rates that fill these windows, the percentiles in
# summary() describe the most recent traffic — which is what an operator
# wants from a live system anyway.
MAX_RECORDS = 1 << 17
MAX_SAMPLES = 1 << 16


@dataclasses.dataclass
class ServeMetrics:
    records: deque = dataclasses.field(
        default_factory=partial(deque, maxlen=MAX_RECORDS))
    depth_samples: deque = dataclasses.field(
        default_factory=partial(deque, maxlen=MAX_SAMPLES))
    batches: deque = dataclasses.field(
        default_factory=partial(deque, maxlen=MAX_SAMPLES))
    n_batches: int = 0
    n_completed: int = 0
    busy_time: float = 0.0
    # per-shard attribution (sharded engines only; stays None on S=1):
    # lifetime exact counters, the telemetry ROADMAP's skew-aware budget
    # routing will read
    shard_ndc: np.ndarray | None = None     # [S] i64, Σ == Σ request NDC
    shard_bitmap: np.ndarray | None = None  # [S] i64 filter-valid rows seen

    def observe_shard_ndc(self, deltas) -> None:
        """Accumulate per-shard NDC deltas [S] from one pump (already
        summed over the batch's real lanes by the scheduler)."""
        d = np.asarray(deltas, np.int64)
        if self.shard_ndc is None:
            self.shard_ndc = np.zeros(d.shape[0], np.int64)
        self.shard_ndc += d

    def observe_shard_bitmap(self, counts) -> None:
        """Accumulate per-shard filter-bitmap popcounts [S] from one
        compiled ScanStats observation (summed over real lanes)."""
        c = np.asarray(counts, np.int64)
        if self.shard_bitmap is None:
            self.shard_bitmap = np.zeros(c.shape[0], np.int64)
        self.shard_bitmap += c

    def observe_batch(self, phase: str, size: int, fill: int,
                      busy: float, steps: int = 0, launches: int = 0,
                      early_exit_frac: float = 0.0) -> None:
        """`launches` is how many device dispatches the batch cost (== steps
        for single-step backends, ≈ steps / steps_per_launch for persistent
        ones); `early_exit_frac` is the fraction of real lanes that
        terminated before the batch's slowest lane — the lanes a persistent
        backend's in-launch early exit stops paying for."""
        self.n_batches += 1
        self.busy_time += busy
        self.batches.append(dict(phase=phase, size=size, lanes=fill,
                                 busy=busy, steps=steps, launches=launches,
                                 early_exit=early_exit_frac))

    def observe_depth(self, now: float, depth: int) -> None:
        self.depth_samples.append((now, depth))

    def complete(self, req) -> None:
        self.n_completed += 1
        self.records.append(dict(
            rid=req.rid,
            latency=(req.completed - req.arrival),
            probe_latency=(None if req.probe_done is None
                           else req.probe_done - req.arrival),
            ndc=req.ndc,
            budget=req.budget,
            n_slices=req.n_slices,
            cache_hit=req.cache_hit,
            deadline_missed=(req.deadline is not None
                            and req.completed > req.deadline),
        ))

    # ------------------------------------------------------------ summary ----
    def _percentiles(self, values, qs=(50, 95, 99)) -> dict:
        """Percentiles that are finite for any window: empty → 0.0, and
        non-finite observations (a NaN latency from a mis-stamped clock
        must not poison the whole scrape) are dropped first. Singleton
        windows return that single value at every quantile."""
        v = np.asarray(values, np.float64)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return {f"p{q}": 0.0 for q in qs}
        return {f"p{q}": float(np.percentile(v, q)) for q in qs}

    def summary(self, n_shed: int = 0, n_expired: int = 0,
                cache=None) -> dict:
        lat = np.asarray([r["latency"] for r in self.records], np.float64)
        plat = np.asarray([r["probe_latency"] for r in self.records
                           if r.get("probe_latency") is not None], np.float64)
        ndc = np.asarray([r["ndc"] for r in self.records
                          if r["ndc"] is not None], np.float64)
        hist, edges = (np.histogram(ndc, bins=8) if len(ndc)
                       else (np.zeros(8, int), np.zeros(9)))
        depth = np.asarray([d for _, d in self.depth_samples], np.float64)
        by_phase = {}
        for b in self.batches:
            d = by_phase.setdefault(b["phase"],
                                    dict(n=0, busy=0.0, size=0, lanes=0,
                                         steps=0, launches=0, early_w=0.0))
            lanes = b["size"]  # real lanes; "lanes" in the record is the
            d["n"] += 1        # padded dispatch width
            d["busy"] += b["busy"]
            d["size"] += b["size"]
            d["lanes"] += lanes
            d["steps"] += b.get("steps", 0)
            d["launches"] += b.get("launches", 0)
            # weight each batch's early-exit fraction by its real lane
            # count: an unweighted per-batch mean lets a 1-lane tail batch
            # count as much as a full 64-lane one, overstating (or
            # understating) how many lanes actually exited early
            d["early_w"] += b.get("early_exit", 0.0) * lanes
        launches_total = steps_total = lanes_total = 0
        early_w_total = 0.0
        for d in by_phase.values():
            launches_total += d["launches"]
            steps_total += d["steps"]
            lanes_total += d["lanes"]
            early_w_total += d["early_w"]
            d["mean_fill"] = d.pop("size") / d["n"]
            d["busy"] = round(d["busy"], 4)
            d["early_exit_frac"] = round(
                d.pop("early_w") / max(d.pop("lanes"), 1), 4)
        out = dict(
            n_completed=self.n_completed,
            n_batches=self.n_batches,
            busy_time=float(self.busy_time),
            batches_by_phase=by_phase,
            launches_total=int(launches_total),
            steps_total=int(steps_total),
            early_exit_frac=round(early_w_total / max(lanes_total, 1), 4),
            latency=self._percentiles(lat),
            latency_mean=float(lat.mean()) if len(lat) else 0.0,
            probe_latency=self._percentiles(plat),
            ndc=self._percentiles(ndc),
            ndc_hist=dict(counts=hist.tolist(),
                          edges=[float(e) for e in edges]),
            queue_depth_mean=float(depth.mean()) if len(depth) else 0.0,
            queue_depth_max=int(depth.max()) if len(depth) else 0,
            n_shed=int(n_shed),
            n_expired=int(n_expired),
            n_requeues=int(sum(max(0, r["n_slices"] - 1)
                               for r in self.records)),
            deadline_miss_rate=(float(np.mean([r["deadline_missed"]
                                               for r in self.records]))
                                if self.records else 0.0),
        )
        if cache is not None:
            out["cache"] = dict(hits=cache.hits, misses=cache.misses,
                                hit_rate=cache.hit_rate, entries=len(cache))
        if self.shard_ndc is not None or self.shard_bitmap is not None:
            out["shards"] = self._shard_summary()
        return out

    def _shard_summary(self) -> dict:
        def skew(v):
            # max/mean ≥ 1; 1.0 means perfectly even (also the empty case)
            if v is None or v.sum() <= 0:
                return 1.0
            return float(v.max() / max(v.mean(), 1e-12))

        ndc = self.shard_ndc
        bmp = self.shard_bitmap
        s = len(ndc) if ndc is not None else len(bmp)
        total = int(ndc.sum()) if ndc is not None else 0
        mx = int(ndc.max()) if ndc is not None else 0
        return dict(
            n_shards=int(s),
            ndc_by_shard=[] if ndc is None else [int(v) for v in ndc],
            ndc_skew=skew(ndc),
            bitmap_by_shard=[] if bmp is None else [int(v) for v in bmp],
            bitmap_skew=skew(bmp),
            work_balance=(total / (s * mx)) if mx > 0 else 1.0,
        )

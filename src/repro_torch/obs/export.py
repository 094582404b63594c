"""Prometheus-text-format exporter over serving + calibration telemetry.

Counterpart of `repro/obs/export.py` (host code; the port keeps its own
copy, so the same dicts give the same scrape, metric prefix included).

Renders a `ServeMetrics.summary()` dict (and optionally a
`CalibrationMonitor.report()`) as a Prometheus exposition-format scrape —
`# HELP` / `# TYPE` headers followed by samples, quantile-labeled gauges
for the latency/NDC distributions, phase-labeled counters for batches, and
plan-labeled calibration gauges.

`validate_prometheus(text)` is a strict structural checker used by the
tests and benchmarks: every sample line must parse, every metric must have
a TYPE declaration before its first sample, and no sample may be NaN/Inf
(Prometheus technically allows them; an exporter that emits them is almost
always leaking an unguarded empty-window division — see the ServeMetrics
hardening notes).
"""
from __future__ import annotations

import math
import re

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    rf"^({_NAME})(\{{[^{{}}]*\}})? (-?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|NaN|Inf|"
    rf"-Inf))$")
_LABELS_RE = re.compile(r'^\{(?:[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*")'
                        r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*")*\}$')


class _Writer:
    def __init__(self, prefix: str):
        self.prefix = prefix
        self.lines: list[str] = []
        self._declared: set[str] = set()

    def metric(self, name: str, kind: str, help_text: str):
        full = f"{self.prefix}_{name}"
        if full not in self._declared:
            self.lines.append(f"# HELP {full} {help_text}")
            self.lines.append(f"# TYPE {full} {kind}")
            self._declared.add(full)
        return full

    def sample(self, full: str, value, labels: dict | None = None):
        v = float(value)
        if not math.isfinite(v):
            v = 0.0  # an exporter must not publish NaN windows
        lab = ""
        if labels:
            lab = "{" + ",".join(f'{k}="{_esc(v2)}"'
                                 for k, v2 in labels.items()) + "}"
        # integral values render without the trailing .0 noise
        s = str(int(v)) if float(v).is_integer() and abs(v) < 1e15 else repr(v)
        self.lines.append(f"{full}{lab} {s}")

    def gauge(self, name, value, help_text, labels=None):
        self.sample(self.metric(name, "gauge", help_text), value, labels)

    def counter(self, name, value, help_text, labels=None):
        self.sample(self.metric(name, "counter", help_text), value, labels)

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(summary: dict, calibration: dict | None = None,
                    drift: dict | None = None,
                    prefix: str = "repro") -> str:
    """Serialize a serving summary (+ optional calibration report and
    drift report) as one Prometheus scrape. Pure function of its dict
    inputs — callers decide when a scrape happens, nothing here touches
    the scheduler."""
    w = _Writer(prefix)

    w.counter("requests_completed_total", summary.get("n_completed", 0),
              "requests finished (cache hits included)")
    w.counter("batches_total", summary.get("n_batches", 0),
              "micro-batches executed")
    w.counter("busy_seconds_total", summary.get("busy_time", 0.0),
              "engine busy time (charged clock units)")
    w.counter("requests_shed_total", summary.get("n_shed", 0),
              "requests rejected by admission backpressure")
    w.counter("requests_expired_total", summary.get("n_expired", 0),
              "requests rejected with an already-passed deadline")
    w.counter("requeues_total", summary.get("n_requeues", 0),
              "preemption slices beyond each request's first")
    w.gauge("deadline_miss_rate", summary.get("deadline_miss_rate", 0.0),
            "fraction of completed requests past their deadline")

    for key, help_text in (("latency", "end-to-end request latency"),
                           ("probe_latency", "arrival-to-probe latency"),
                           ("ndc", "node distance computations per request")):
        dist = summary.get(key, {})
        full = w.metric(f"{key}", "gauge",
                        f"{help_text} (rolling-window quantiles)")
        for q_key, q_lab in (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99")):
            if q_key in dist:
                w.sample(full, dist[q_key], {"quantile": q_lab})
    if "latency_mean" in summary:
        w.gauge("latency_mean", summary["latency_mean"],
                "mean end-to-end latency over the window")

    w.gauge("queue_depth_mean", summary.get("queue_depth_mean", 0.0),
            "mean total queue depth at pump times")
    w.gauge("queue_depth_max", summary.get("queue_depth_max", 0),
            "max total queue depth observed")

    # dispatch accounting (the persistent-execution story): launches are
    # loop-observed device dispatches; early_exit_frac is lane-weighted
    w.counter("launches_total", summary.get("launches_total", 0),
              "device dispatches across all batches")
    w.counter("steps_total", summary.get("steps_total", 0),
              "lockstep trips across all batches")
    w.gauge("early_exit_frac", summary.get("early_exit_frac", 0.0),
            "lane-weighted fraction of lanes finishing before their batch")

    for phase, d in sorted(summary.get("batches_by_phase", {}).items()):
        lab = {"phase": phase}
        w.counter("phase_batches_total", d.get("n", 0),
                  "batches per lifecycle phase", lab)
        w.counter("phase_busy_seconds_total", d.get("busy", 0.0),
                  "busy time per lifecycle phase", lab)
        w.counter("phase_launches_total", d.get("launches", 0),
                  "device dispatches per lifecycle phase", lab)
        w.gauge("phase_mean_fill", d.get("mean_fill", 0.0),
                "mean real lanes per batch", lab)
        w.gauge("phase_early_exit_frac", d.get("early_exit_frac", 0.0),
                "lane-weighted early-exit fraction per phase", lab)

    # per-shard work/skew telemetry (sharded engines only) — the inputs
    # ROADMAP's skew-aware budget routing will consume
    shards = summary.get("shards")
    if shards:
        w.gauge("shards", shards.get("n_shards", 1),
                "index-axis shards behind the engine")
        for s, v in enumerate(shards.get("ndc_by_shard", [])):
            w.counter("shard_ndc_total", v,
                      "distance computations attributed per shard",
                      {"shard": str(s)})
        for s, v in enumerate(shards.get("bitmap_by_shard", [])):
            w.counter("shard_bitmap_count_total", v,
                      "filter-bitmap valid rows observed per shard",
                      {"shard": str(s)})
        w.gauge("shard_ndc_skew", shards.get("ndc_skew", 1.0),
                "max/mean per-shard NDC (1.0 = perfectly balanced)")
        w.gauge("shard_bitmap_skew", shards.get("bitmap_skew", 1.0),
                "max/mean per-shard filter-bitmap count")
        w.gauge("shard_work_balance", shards.get("work_balance", 1.0),
                "total NDC / (S * max shard NDC); 1.0 = balanced")

    cache = summary.get("cache")
    if cache:
        w.counter("cache_hits_total", cache.get("hits", 0),
                  "result-cache hits")
        w.counter("cache_misses_total", cache.get("misses", 0),
                  "result-cache misses")
        w.gauge("cache_entries", cache.get("entries", 0),
                "live result-cache entries")

    if calibration is not None:
        w.counter("calibration_records_total",
                  calibration.get("n_recorded_total", 0),
                  "calibration records observed (lifetime)")
        w.gauge("calibration_window_size", calibration.get("n_records", 0),
                "records in the rolling calibration window")
        w.gauge("calibration_log_rmse", calibration.get("log_rmse", 0.0),
                "rolling RMSE of log(predicted) - log(actual)")
        w.gauge("calibration_mean_log_ratio",
                calibration.get("mean_log_ratio", 0.0),
                "mean log(predicted/actual); >0 over-provisions")
        w.gauge("calibration_overprediction_rate",
                calibration.get("overprediction_rate", 0.0),
                "fraction of queries with predicted > actual NDC")
        w.gauge("calibration_underprediction_rate",
                calibration.get("underprediction_rate", 0.0),
                "fraction of queries with predicted < actual NDC")
        ratio = calibration.get("ratio", {})
        full = w.metric("calibration_ratio", "gauge",
                        "predicted/actual NDC ratio quantiles")
        for q_key, q_lab in (("p10", "0.1"), ("p50", "0.5"), ("p90", "0.9")):
            if q_key in ratio:
                w.sample(full, ratio[q_key], {"quantile": q_lab})
        for plan, d in sorted(calibration.get("per_plan", {}).items()):
            lab = {"plan": plan}
            w.counter("plan_queries_total", d.get("n", 0),
                      "completed queries per chosen plan", lab)
            w.gauge("plan_share", d.get("share", 0.0),
                    "routing share per plan over the window", lab)
            w.gauge("plan_win_rate", d.get("win_rate", 0.0),
                    "fraction delivered within predicted budget", lab)
            w.gauge("plan_mean_actual_ndc", d.get("mean_actual_ndc", 0.0),
                    "mean actual NDC per plan", lab)

    if drift is not None:
        w.gauge("drift_ready", 1.0 if drift.get("ready") else 0.0,
                "1 once the drift reference window is frozen")
        w.gauge("drift_alarm", 1.0 if drift.get("alarm") else 0.0,
                "1 while any drift detector is alarming (the "
                "recalibration trigger)")
        for kind, on in sorted(drift.get("alarms", {}).items()):
            w.gauge("drift_alarm_detail", 1.0 if on else 0.0,
                    "per-detector alarm state", {"kind": kind})
        w.gauge("drift_n_ref", drift.get("n_ref", 0),
                "rows in the frozen drift reference window")
        w.gauge("drift_n_cur", drift.get("n_cur", 0),
                "rows in the current drift window")
        w.gauge("drift_psi_max", drift.get("psi_max", 0.0),
                "max per-feature PSI, current vs reference window")
        w.gauge("drift_psi_mean", drift.get("psi_mean", 0.0),
                "mean per-feature PSI")
        w.gauge("drift_log_rmse_ref", drift.get("log_rmse_ref", 0.0),
                "estimator log-RMSE over the reference window")
        w.gauge("drift_log_rmse_cur", drift.get("log_rmse_cur", 0.0),
                "estimator log-RMSE over the current window")
        w.gauge("drift_win_rate_shift_max",
                drift.get("win_rate_shift_max", 0.0),
                "max per-plan |win-rate shift| among judged plans")

    return w.text()


def validate_prometheus(text: str) -> dict:
    """Strict structural validation of an exposition-format scrape.

    Returns {metric name: sample count}; raises ValueError on any
    malformed line, a sample without a prior TYPE declaration, malformed
    labels, or a non-finite sample value."""
    declared: set[str] = set()
    counts: dict[str, int] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or not re.fullmatch(_NAME, parts[2]):
                raise ValueError(f"line {ln}: malformed comment {line!r}")
            if parts[1] == "TYPE":
                if parts[3].split()[0] not in ("counter", "gauge",
                                               "histogram", "summary",
                                               "untyped"):
                    raise ValueError(f"line {ln}: bad TYPE {line!r}")
                declared.add(parts[2])
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        name, labels, value = m.group(1), m.group(2), m.group(3)
        if name not in declared:
            raise ValueError(f"line {ln}: sample {name} before TYPE")
        if labels and not _LABELS_RE.match(labels):
            raise ValueError(f"line {ln}: malformed labels {labels!r}")
        if value in ("NaN", "Inf", "-Inf"):
            raise ValueError(f"line {ln}: non-finite sample {line!r}")
        counts[name] = counts.get(name, 0) + 1
    if not counts:
        raise ValueError("scrape contains no samples")
    return counts

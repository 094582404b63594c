"""Observability: lifecycle tracing, calibration telemetry, export, EXPLAIN.

Counterpart of `repro/obs`. Six pieces, all outside the device's launch
loops:

  trace        `Tracer` — trace IDs + spans at host dispatch boundaries
               (bounded ring, bounded+rotating JSONL sink); `NO_TRACE`
               no-op.
  calibration  `CalibrationMonitor` — the frozen per-query
               (features, Ŵ_q, actual NDC, plan, recall) log the online
               recalibration work trains from.
  drift        `DriftMonitor` — rolling-window PSI / log-RMSE / win-rate
               drift detection over the calibration log.
  export       `prometheus_text` / `validate_prometheus` — exposition-
               format scrape over ServeMetrics + calibration + drift
               reports.
  explain      `QueryReport` / `termination_reasons` — per-query EXPLAIN
               surface for `e2e_search` / `planned_search`.
  shard        `ShardSection` / `attach_shard_sections` — per-shard
               EXPLAIN attribution on index-axis-sharded engines (sums
               exactly to the merged counters), merge topology, work
               balance.
"""
from repro_torch.obs.calibration import (PLAN_NAMES, RECORD_FIELDS,
                                         SCHEMA_VERSION, CalibrationMonitor)
from repro_torch.obs.drift import DriftConfig, DriftMonitor, psi
from repro_torch.obs.explain import (QueryReport, StageReport, build_reports,
                                     feature_dict, format_reports,
                                     termination_reasons)
from repro_torch.obs.export import prometheus_text, validate_prometheus
from repro_torch.obs.shard import (ShardSection, attach_shard_sections,
                                   build_shard_sections, work_balance)
from repro_torch.obs.trace import (NO_TRACE, NullTracer, Span, Tracer,
                                   as_tracer)

__all__ = [
    "CalibrationMonitor", "PLAN_NAMES", "RECORD_FIELDS", "SCHEMA_VERSION",
    "DriftConfig", "DriftMonitor", "psi",
    "QueryReport", "StageReport", "build_reports", "feature_dict",
    "format_reports", "termination_reasons",
    "prometheus_text", "validate_prometheus",
    "ShardSection", "attach_shard_sections", "build_shard_sections",
    "work_balance",
    "NO_TRACE", "NullTracer", "Span", "Tracer", "as_tracer",
]

"""Observability in the PyTorch port (`repro_torch.obs` and the tracing /
EXPLAIN hooks of the search path), on the CPU.

- Every test of `tests/test_obs.py` has a counterpart here, run against
  the port: tracer ring/sink invariants, span attributes (every
  `torch.Tensor` refused, 0-d ones included), EXPLAIN termination
  semantics, the calibration schema and persistence, Prometheus
  validity, ServeMetrics hardening, the tracing-changes-nothing contract
  (every `SearchState` field equal with tracing on and off, zero added
  `dispatch_counters` launches, one "launch" span per launch) and the
  scheduler's launch accounting. The drift detectors and the sink
  rotation of `tests/test_obs_shard.py` are mirrored too.
- Across the packages, on the same seeded inputs: a calibration window
  saved by either package loads in the other; `prometheus_text` gives
  identical text for the same summary, calibration and drift dicts;
  `e2e_search(explain=True)` and `planned_search(explain=True)` give
  reports whose `to_dict()` are equal (the backend name mapped) and the
  same span stream (trace ids, names and attributes; times aside).

Vectors and queries sit on the grid 1/64, so distances are exact in both
packages and `res_dist` is required equal bit for bit.
"""
import functools
import json
import os
import types

import numpy as np
import pytest
import torch

from repro.core import (CostEstimator as JEstimator, SearchConfig as JConfig,
                        SearchEngine as JEngine, e2e_search as j_e2e,
                        fit_planner as j_fit_planner,
                        generate_plan_training_data as j_plan_data,
                        generate_training_data as j_training,
                        planned_search as j_planned)
from repro.data import make_composite_workload as j_composite
from repro.data import make_dataset as j_make_dataset
from repro.data import make_label_workload
from repro.index import build_graph_index
from repro.obs import CalibrationMonitor as JCalibration
from repro.obs import DriftConfig as JDriftConfig
from repro.obs import DriftMonitor as JDriftMonitor
from repro.obs import Tracer as JTracer
from repro.obs import prometheus_text as j_prometheus_text
from repro.serve import ServeMetrics as JServeMetrics
from repro_torch.convert import (engine_from_arrays, estimator_to_torch,
                                 planner_to_torch)
from repro_torch.core import (SearchConfig, dispatch_counters, e2e_search,
                              planned_search)
from repro_torch.core.features import FEATURE_NAMES
from repro_torch.data import make_composite_workload, make_dataset
from repro_torch.filters import FilterSpec
from repro_torch.filters.predicates import PRED_CONTAIN
from repro_torch.obs import (NO_TRACE, PLAN_NAMES, RECORD_FIELDS,
                             SCHEMA_VERSION, CalibrationMonitor, DriftConfig,
                             DriftMonitor, NullTracer, Tracer, as_tracer,
                             build_reports, feature_dict, prometheus_text,
                             psi, termination_reasons, validate_prometheus)
from repro_torch.obs.explain import host_leaves
from repro_torch.obs.trace import _host_scalar
from repro_torch.serve import (CostAwareScheduler, ServeConfig, ServeMetrics,
                               requests_from_workload)

#: the reference's backend name for each of the port's
REF_BACKEND = {"dense": "dense", "persistent": "pallas_persistent"}
PROBE = 48


def on_grid(a):
    return (np.round(np.asarray(a) * 64) / 64).astype(np.float32)


def pspec(spec):
    return FilterSpec(spec.kind, spec.label_masks, spec.range_lo,
                      spec.range_hi)


# ------------------------------------------------------------- tracer ----
def test_tracer_ring_ids_and_filters():
    clock = iter(float(i) for i in range(10_000))
    tr = Tracer(capacity=4, clock=lambda: next(clock))
    assert tr.new_trace("q") == "q-000001"
    assert tr.new_trace("req") == "req-000002"      # one counter, replayable
    for i in range(6):
        tr.emit("launch", "q-000001", steps=i)
    assert tr.n_emitted == 6                        # lifetime count
    assert len(tr) == 4                             # ring evicted the oldest
    assert [s.attrs["steps"] for s in tr.spans()] == [2, 3, 4, 5]
    assert tr.spans(name="nope") == []
    assert len(tr.spans(trace_id="q-000001", name="launch")) == 4
    with tr.span("probe", "q-000001", budget=64) as sp:
        sp.set(steps=7)
    got = tr.spans(name="probe")[0]
    assert got.attrs == dict(budget=64, steps=7)
    assert got.t1 >= got.t0                         # monotonic interval
    tr.clear()
    assert len(tr) == 0 and tr.n_emitted == 7       # clear keeps lifetime


def test_tracer_sink_jsonl(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    tr = Tracer(capacity=2, sink=path)
    for i in range(5):
        tr.emit("launch", f"q-{i}", width=8)
    tr.close()
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 5                          # sink outlives the ring
    assert lines[3] == {**lines[3], "name": "launch", "trace": "q-3",
                        "width": 8}


def test_span_attrs_must_be_host_scalars():
    tr = Tracer()
    assert _host_scalar(np.int32(3)) == 3
    assert _host_scalar(np.float64(2.5)) == 2.5
    assert _host_scalar(np.bool_(True)) is True
    with pytest.raises(TypeError):
        tr.emit("bad", "t", arr=np.zeros(4))        # arrays must not leak
    with pytest.raises(TypeError):
        with tr.span("bad", "t") as sp:
            sp.set(arr=np.zeros(4))                 # ... via sp.set either
    # every torch.Tensor is refused, 0-d included: int() of a 0-d CUDA
    # tensor would synchronize the device inside the traced region
    for bad in (torch.zeros(4), torch.tensor(3), torch.tensor(True)):
        with pytest.raises(TypeError, match="torch.Tensor"):
            tr.emit("bad", "t", v=bad)
        with pytest.raises(TypeError, match="torch.Tensor"):
            with tr.span("bad", "t") as sp:
                sp.set(v=bad)
    assert tr.spans(name="bad") == []               # nothing was recorded


def test_null_tracer_is_inert():
    assert as_tracer(None) is NO_TRACE
    t = Tracer()
    assert as_tracer(t) is t
    assert isinstance(NO_TRACE, NullTracer)
    assert NO_TRACE.new_trace() == ""
    with NO_TRACE.span("x", "t", a=1) as sp:
        sp.set(b=2)                                 # writable, discarded
    NO_TRACE.emit("x", arr=np.zeros(3))             # no validation either
    NO_TRACE.emit("x", arr=torch.zeros(3))
    assert len(NO_TRACE) == 0 and NO_TRACE.spans() == []


def test_trace_sink_rotation_bounds_disk(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    cap = 2000
    tr = Tracer(sink=path, sink_max_bytes=cap)
    for i in range(300):
        tr.emit("launch", f"q-{i}", width=8, step=i)
    tr.flush()
    assert tr.n_rotations > 0
    assert os.path.getsize(path) <= cap
    assert os.path.getsize(path + ".1") <= cap
    for name in (path, path + ".1"):                # kept lines stay valid
        with open(name) as f:
            for line in f:
                json.loads(line)
    tr.close()
    # re-opening an existing file resumes the byte count from its size
    tr2 = Tracer(sink=path, sink_max_bytes=cap)
    assert tr2._sink_bytes == os.path.getsize(path)
    tr2.close()


# ------------------------------------------------------------ explain ----
def _fake_state(cand_dist, cand_exp, res_worst, cnt):
    """Minimal duck-typed final carry for termination_reasons."""
    cand_dist = np.asarray(cand_dist, np.float32)
    k = 3
    res = np.full((cand_dist.shape[0], k), np.inf, np.float32)
    res[:, -1] = res_worst
    return types.SimpleNamespace(
        cand_dist=cand_dist,
        cand_idx=np.where(np.isfinite(cand_dist), 1, -1).astype(np.int32),
        cand_exp=np.asarray(cand_exp, bool),
        res_dist=res,
        cnt=np.asarray(cnt, np.int32),
        hops=np.zeros(cand_dist.shape[0], np.int32),
        res_idx=np.zeros((cand_dist.shape[0], k), np.int32),
    )


def _as_tensors(st):
    return types.SimpleNamespace(**{k: torch.from_numpy(v)
                                    for k, v in vars(st).items()})


def test_termination_reason_priority():
    inf = np.inf
    st = _fake_state(
        # lane 0: every candidate expanded → queue-drained (beats budget:
        #         its cnt is also ≥ budget, drained wins the priority)
        # lane 1: unexpanded candidate + cnt ≥ budget → budget
        # lane 2: unexpanded cand worse than worst result → greedy
        # lane 3: none of the above → active
        cand_dist=[[1.0, 2.0], [1.0, inf], [9.0, inf], [1.0, inf]],
        cand_exp=[[True, True], [False, False], [False, False],
                  [False, False]],
        res_worst=[5.0, 5.0, 5.0, 5.0],
        cnt=[100, 100, 10, 10],
    )
    for s in (st, _as_tensors(st)):        # host arrays or tensor leaves
        cfg = SearchConfig(k=3, greedy_stop=True)
        assert termination_reasons(cfg, s, 50) == [
            "queue-drained", "budget", "greedy", "active"]
        # greedy_stop off: the greedy condition must not fire
        cfg = SearchConfig(k=3, greedy_stop=False)
        assert termination_reasons(cfg, s, 50) == [
            "queue-drained", "budget", "active", "active"]
        # per-lane budgets broadcast
        assert termination_reasons(
            SearchConfig(k=3), s, [100, 101, 5, 100]) == [
            "queue-drained", "active", "budget", "active"]


def test_host_leaves_one_transfer_keeps_bits():
    """The explain readback widens every leaf to float64 for one copy:
    int32 extremes, -1 ids, ±inf, NaN and bools come back unchanged."""
    st = types.SimpleNamespace(
        cand_dist=torch.tensor([[0.1, np.inf, np.nan], [-np.inf, 3e38, 0]],
                               dtype=torch.float32),
        cand_idx=torch.tensor([[-1, 2**31 - 1, -2**31], [0, 5, 7]],
                              dtype=torch.int32),
        cand_exp=torch.tensor([[True, False, True], [False, False, True]]),
        res_dist=torch.tensor([[1.5], [np.inf]], dtype=torch.float32),
        res_idx=torch.tensor([[3], [-1]], dtype=torch.int32),
        cnt=torch.tensor([7, 2**30], dtype=torch.int32),
        hops=np.asarray([1, 2], np.int32))          # host leaf passes
    got = host_leaves(st)
    for name, want in vars(st).items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype and got[name].shape == want.shape
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_feature_dict_naming():
    n = len(FEATURE_NAMES)
    d = feature_dict(np.arange(2 * n + 1, dtype=np.float32))
    assert list(d)[:n] == list(FEATURE_NAMES)
    assert list(d)[n:2 * n] == [f"d_{f}" for f in FEATURE_NAMES]
    assert list(d)[-1] == f"f{2 * n}"               # overflow block
    assert d[FEATURE_NAMES[1]] == 1.0


def test_build_reports_roundtrip():
    st = _fake_state(cand_dist=[[1.0, np.inf]], cand_exp=[[False, False]],
                     res_worst=[5.0], cnt=[80])
    for s in (st, _as_tensors(st)):
        reports = build_reports(
            SearchConfig(k=3), s, 64, backend="dense", plans=["widen"],
            probe_ndc=[32], trace_ids=["t-1"],
            features=np.ones((1, 4), np.float32))
        r = reports[0]
        assert (r.plan, r.termination, r.predicted_budget, r.actual_ndc,
                r.probe_ndc) == ("widen", "budget", 64, 80, 32)
        d = json.loads(r.to_json())
        assert d["trace_id"] == "t-1" and d["backend"] == "dense"
        assert "plan=widen" in r.format() and "terminated=budget" in r.format()


# -------------------------------------------------------- calibration ----
def test_calibration_schema_is_frozen():
    """The recalibration work trains from saved windows — names, dtypes and
    order are a contract, and the reference's."""
    from repro.obs import PLAN_NAMES as J_PLAN_NAMES
    from repro.obs import RECORD_FIELDS as J_FIELDS
    from repro.obs import SCHEMA_VERSION as J_VERSION

    assert SCHEMA_VERSION == 1 == J_VERSION
    assert [(n, d) for n, d, _ in RECORD_FIELDS] == [
        ("rid", "int64"), ("plan", "int32"), ("predicted", "int64"),
        ("actual", "int64"), ("probe_ndc", "int64"), ("n_slices", "int32"),
        ("alpha", "float32"), ("recall", "float32")]
    assert tuple(RECORD_FIELDS) == tuple(J_FIELDS)
    assert PLAN_NAMES == ("traverse", "scan", "widen") == J_PLAN_NAMES


def test_calibration_report_math():
    mon = CalibrationMonitor()
    assert np.isfinite(list(mon.report()["predicted"].values())).all()
    # traverse: predicted 100 vs actual {50, 200} → one win, one loss
    mon.record(predicted=100, actual=50, plan="traverse", rid=0)
    mon.record(predicted=100, actual=200, plan="traverse", rid=1)
    mon.record(predicted=300, actual=100, plan="scan", rid=2, recall=0.9)
    rep = mon.report()
    assert rep["n_records"] == 3 and rep["n_recorded_total"] == 3
    assert rep["overprediction_rate"] == pytest.approx(2 / 3)
    assert rep["underprediction_rate"] == pytest.approx(1 / 3)
    assert rep["per_plan"]["traverse"]["win_rate"] == pytest.approx(0.5)
    assert rep["per_plan"]["scan"]["win_rate"] == 1.0
    assert rep["per_plan"]["scan"]["share"] == pytest.approx(1 / 3)
    assert rep["recall_mean"] == pytest.approx(0.9)
    assert rep["n_with_recall"] == 1
    expected = np.sqrt(np.mean(np.log([100 / 50, 100 / 200, 300 / 100]) ** 2))
    assert rep["log_rmse"] == pytest.approx(expected)
    mon.set_recall({0: 1.0})
    assert mon.report()["n_with_recall"] == 2


def _filled(cls):
    mon = cls()
    for i in range(7):
        mon.record(rid=i, predicted=64 + i, actual=60 + 2 * i,
                   plan=PLAN_NAMES[i % 3], probe_ndc=32, n_slices=1,
                   alpha=1.5, features=np.arange(6, dtype=np.float32) + i)
    return mon


def test_calibration_save_load_roundtrip(tmp_path):
    mon = _filled(CalibrationMonitor)
    path = mon.save(str(tmp_path), tag="win0")
    mon2, manifest = CalibrationMonitor.load(path)
    assert manifest["schema_version"] == SCHEMA_VERSION
    assert manifest["feature_width"] == 6
    a, b = mon.arrays(), mon2.arrays()
    for name, _, _ in RECORD_FIELDS:
        np.testing.assert_array_equal(a[name], b[name])
    np.testing.assert_array_equal(a["features"], b["features"])
    # integrity: a torn/tampered npz must not load silently
    data = os.path.join(path, "arrays.npz")
    with open(data, "ab") as f:
        f.write(b"x")
    with pytest.raises(IOError):
        CalibrationMonitor.load(path)
    CalibrationMonitor.load(path, validate=False)   # escape hatch


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_calibration_file_crosses_packages(tmp_path, saver):
    """The saved window format is the reference's: a window saved by one
    package loads in the other with every column equal."""
    save_cls, load_cls = ((JCalibration, CalibrationMonitor)
                          if saver == "reference"
                          else (CalibrationMonitor, JCalibration))
    mon = _filled(save_cls)
    path = mon.save(str(tmp_path), tag="win")
    got, manifest = load_cls.load(path)
    assert manifest["schema_version"] == SCHEMA_VERSION
    a, b = mon.arrays(), got.arrays()
    for name in [n for n, _, _ in RECORD_FIELDS] + ["features"]:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert got.report() == mon.report()


# --------------------------------------------------------- prometheus ----
def _tiny_summary(cls=ServeMetrics):
    m = cls()
    m.observe_batch("probe", size=8, fill=8, busy=0.1, steps=40, launches=5,
                    early_exit_frac=0.5)
    m.observe_batch("resume", size=4, fill=8, busy=0.2, steps=80, launches=10,
                    early_exit_frac=0.25)
    m.observe_depth(0.0, 3)
    req = types.SimpleNamespace(rid=0, completed=1.0, arrival=0.0,
                                probe_done=0.5, ndc=120, budget=128,
                                n_slices=1, cache_hit=False, deadline=None)
    m.complete(req)
    return m.summary()


def test_prometheus_text_is_valid_and_nan_free():
    mon = CalibrationMonitor()
    mon.record(predicted=100, actual=80, plan="scan")
    text = prometheus_text(_tiny_summary(), mon.report())
    names = validate_prometheus(text)               # raises on any violation
    for expect in ("repro_requests_completed_total", "repro_latency",
                   "repro_launches_total", "repro_early_exit_frac",
                   "repro_phase_batches_total", "repro_calibration_log_rmse",
                   "repro_plan_win_rate", "repro_plan_queries_total"):
        assert expect in names, (expect, sorted(names))
    assert "nan" not in text.lower()
    # a NaN smuggled into the summary renders as 0.0, not as "nan"
    s = _tiny_summary()
    s["latency"]["p99"] = float("nan")
    validate_prometheus(prometheus_text(s))
    # custom prefix propagates
    assert "acme_launches_total" in validate_prometheus(
        prometheus_text(_tiny_summary(), prefix="acme"))


def test_prometheus_validator_rejects_garbage():
    with pytest.raises(ValueError):
        validate_prometheus("")                     # empty scrape
    with pytest.raises(ValueError):
        validate_prometheus("this is not a metric line\n")
    with pytest.raises(ValueError):                 # sample before # TYPE
        validate_prometheus("repro_x 1.0\n")
    with pytest.raises(ValueError):                 # NaN sample
        validate_prometheus(
            "# HELP repro_x x\n# TYPE repro_x gauge\nrepro_x NaN\n")
    with pytest.raises(ValueError):                 # malformed labels
        validate_prometheus(
            "# HELP repro_x x\n# TYPE repro_x gauge\n"
            'repro_x{quantile=0.5} 1.0\n')


def _drift_window(cal, n, loc, actual_mult, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        cal.record(rid=i, plan="traverse", predicted=300,
                   actual=int(300 * actual_mult * np.exp(rng.normal(0, 0.1))),
                   probe_ndc=32, n_slices=1, alpha=1.5,
                   features=rng.normal(loc=loc, size=6).astype(np.float32))


def test_prometheus_text_equals_reference():
    """The same summary, calibration and drift dicts give the same scrape
    from both packages; the dicts themselves are equal too."""
    dicts = {}
    for pkg, (metrics, cal_cls, drift, dcfg) in {
            "ref": (JServeMetrics, JCalibration, JDriftMonitor, JDriftConfig),
            "port": (ServeMetrics, CalibrationMonitor, DriftMonitor,
                     DriftConfig)}.items():
        cal = cal_cls()
        mon = drift(dcfg(min_ref=32, min_cur=16))
        _drift_window(cal, 40, loc=0.0, actual_mult=1.0, seed=4)
        mon.observe(cal)
        _drift_window(cal, 40, loc=2.0, actual_mult=4.0, seed=5)
        dicts[pkg] = (_tiny_summary(metrics), cal.report(), mon.observe(cal))
    assert dicts["ref"] == dicts["port"]
    assert dicts["port"][2]["alarm"]               # the shift alarms
    s, c, d = dicts["port"]
    for args in ((s,), (s, c), (s, c, d)):
        text = prometheus_text(*args)
        assert text == j_prometheus_text(*args)
        validate_prometheus(text)


# ---------------------------------------------------------------- drift ----
def test_psi_hand_computed():
    # 2 bins at the reference median: ref (0.5, 0.5) vs cur (0.9, 0.1)
    expect = 0.4 * np.log(0.9 / 0.5) - 0.4 * np.log(0.1 / 0.5)
    got = psi([0.0] * 50 + [1.0] * 50, [0.0] * 90 + [1.0] * 10, bins=2)
    np.testing.assert_allclose(got, expect, rtol=1e-6)
    rng = np.random.default_rng(0)
    v = rng.normal(size=500)
    assert psi(v, v) == pytest.approx(0.0, abs=1e-9)
    assert psi([], [1.0]) == 0.0
    assert psi(v, []) == 0.0
    assert psi(np.zeros(100), np.ones(100) * 5) == 0.0


def test_drift_quiet_on_stationary_alarms_on_shift():
    dcfg = DriftConfig(min_ref=64, min_cur=32)
    cal = CalibrationMonitor()
    mon = DriftMonitor(dcfg)
    rep = mon.observe(cal)
    assert not rep["ready"] and not rep["alarm"]     # below min_ref
    _drift_window(cal, 100, loc=0.0, actual_mult=1.0, seed=1)
    rep = mon.observe(cal)                           # freezes the reference
    assert rep["ready"] and rep["n_ref"] == 100 and rep["n_cur"] == 0
    assert not rep["alarm"]
    _drift_window(cal, 100, loc=0.0, actual_mult=1.0, seed=2)
    rep = mon.observe(cal)                           # stationary → quiet
    assert rep["n_cur"] == 100 and not rep["alarm"]
    assert rep["psi_max"] < dcfg.psi_threshold
    mon.advance(cal)
    _drift_window(cal, 100, loc=3.0, actual_mult=8.0, seed=3)
    rep = mon.observe(cal)                           # injected shift → alarm
    assert rep["alarm"] and rep["alarms"]["psi"] and rep["alarms"]["log_rmse"]
    assert rep["log_rmse_cur"] == pytest.approx(np.log(8.0), abs=0.15)
    mon.advance(cal)
    rep = mon.observe(cal)
    assert rep["n_cur"] == 0 and not rep["alarm"]
    json.dumps(rep)
    names = validate_prometheus(
        prometheus_text({"n_completed": 1}, None, rep))
    assert {"repro_drift_alarm", "repro_drift_psi_max",
            "repro_drift_alarm_detail"} <= set(names)


def test_drift_psi_matches_hand_recomputation():
    dcfg = DriftConfig(min_ref=32, min_cur=16, psi_bins=4)
    cal = CalibrationMonitor()
    mon = DriftMonitor(dcfg)
    _drift_window(cal, 40, loc=0.0, actual_mult=1.0, seed=4)
    mon.observe(cal)
    _drift_window(cal, 40, loc=1.0, actual_mult=1.0, seed=5)
    rep = mon.report(cal)
    ref = mon._ref["features"]
    cur = cal.arrays()["features"][-40:]
    for j, got in enumerate(rep["psi_by_feature"]):
        assert got == pytest.approx(psi(ref[:, j], cur[:, j], bins=4),
                                    rel=1e-9)


def test_drift_win_rate_shift_detector():
    cfgd = DriftConfig(min_ref=32, min_cur=32, min_plan_n=24,
                       win_rate_shift=0.25)
    cal = CalibrationMonitor()
    mon = DriftMonitor(cfgd)
    rng = np.random.default_rng(0)
    for i in range(50):      # reference: traverse always wins (act ≤ pred)
        cal.record(rid=i, plan="traverse", predicted=300, actual=200,
                   probe_ndc=8, n_slices=1, alpha=1.0,
                   features=rng.normal(size=4).astype(np.float32))
    mon.set_reference(cal)
    for i in range(50):      # shifted: traverse always loses
        cal.record(rid=i, plan="traverse", predicted=300, actual=400,
                   probe_ndc=8, n_slices=1, alpha=1.0,
                   features=rng.normal(size=4).astype(np.float32))
    rep = mon.report(cal)
    assert rep["alarms"]["win_rate"]
    assert rep["plans"]["traverse"]["shift"] == pytest.approx(1.0)
    assert rep["plans"]["traverse"]["judged"]
    assert not rep["plans"]["scan"]["judged"]


def test_drift_window_is_bounded():
    dcfg = DriftConfig(min_ref=16, min_cur=8, window=32)
    cal = CalibrationMonitor()
    mon = DriftMonitor(dcfg)
    _drift_window(cal, 20, loc=0.0, actual_mult=1.0, seed=6)
    mon.observe(cal)
    _drift_window(cal, 200, loc=0.0, actual_mult=1.0, seed=7)
    assert mon.report(cal)["n_cur"] == 32            # capped at `window`


# ----------------------------------------------- metrics hardening (s1) ----
def test_metrics_summary_finite_on_empty_and_singleton():
    m = ServeMetrics()
    s = m.summary()
    flat = [s["latency"]["p50"], s["latency"]["p99"], s["latency_mean"],
            s["probe_latency"]["p95"], s["ndc"]["p50"], s["queue_depth_mean"],
            s["early_exit_frac"], s["deadline_miss_rate"]]
    assert np.isfinite(flat).all() and s["launches_total"] == 0
    req = types.SimpleNamespace(rid=0, completed=2.0, arrival=1.0,
                                probe_done=None, ndc=None, budget=None,
                                n_slices=0, cache_hit=False, deadline=None)
    m.complete(req)
    s = m.summary()                                 # singleton window
    assert s["latency"]["p50"] == s["latency"]["p99"] == 1.0
    assert s["ndc"]["p99"] == 0.0                   # ndc=None drops cleanly


def test_metrics_percentiles_drop_nonfinite():
    m = ServeMetrics()
    for lat in (1.0, float("nan"), 3.0, float("inf")):
        m.complete(types.SimpleNamespace(
            rid=0, completed=lat, arrival=0.0, probe_done=None, ndc=10,
            budget=None, n_slices=0, cache_hit=False, deadline=None))
    s = m.summary()
    assert s["latency"]["p50"] == pytest.approx(2.0)  # only {1, 3} survive
    assert np.isfinite(s["latency"]["p99"])


def test_metrics_early_exit_weighted_by_real_lanes():
    m = ServeMetrics()
    # a full 64-lane batch at 0.5 and a 1-lane tail at 1.0: an unweighted
    # mean says 0.75; the truth over the 65 real lanes is (32+1)/65
    m.observe_batch("resume", size=64, fill=64, busy=1.0, steps=10,
                    launches=2, early_exit_frac=0.5)
    m.observe_batch("resume", size=1, fill=8, busy=1.0, steps=10,
                    launches=1, early_exit_frac=1.0)
    s = m.summary()
    want = (0.5 * 64 + 1.0 * 1) / 65
    assert s["early_exit_frac"] == pytest.approx(want, abs=1e-4)
    assert s["batches_by_phase"]["resume"]["early_exit_frac"] == \
        pytest.approx(want, abs=1e-4)
    assert s["launches_total"] == 3 and s["steps_total"] == 20


# ------------------------------------------------ engine integration ----
@functools.lru_cache(maxsize=1)
def _world():
    """Grid data from both packages' generators (the same seeded numpy
    draws), the reference's graph and estimator, and the port's engines
    on the CPU with the same arrays."""
    kw = dict(n=2000, dim=16, n_clusters=6, alphabet_size=32, seed=0)
    jds, ds = j_make_dataset(**kw), make_dataset(**kw)
    jds.vectors = on_grid(jds.vectors)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(jds.vectors, degree=16, seed=0)
    cfg = JConfig(k=5, queue_size=64, pred_kind=PRED_CONTAIN)
    jengines = {b: JEngine.build(jds, graph, backend=REF_BACKEND[b],
                                 mesh=None) for b in REF_BACKEND}
    wl_tr = make_label_workload(jds, batch=96, kind="contain", seed=7)
    wl_tr.queries = on_grid(wl_tr.queries)
    td = j_training(jengines["dense"], jds, wl_tr, cfg, probe_budget=PROBE,
                    chunk=96)
    jest = JEstimator.fit(td.features, td.w_q, n_trees=40, depth=4)
    engines = {b: engine_from_arrays(
        ds.vectors, ds.labels_packed, ds.value_matrix,
        np.asarray(graph.neighbors), graph.entry_point, backend=b,
        device="cpu") for b in REF_BACKEND}
    return jds, ds, jengines, engines, jest, estimator_to_torch(jest)


@functools.lru_cache(maxsize=1)
def _planner():
    """A reference planner on 48 composite "mixed" queries, and the same
    planner carried to the port."""
    jds, _, jengines, _, _, _ = _world()
    jwl = j_composite(jds, batch=48, seed=11, structure="mixed",
                      selectivities=(0.01, 0.1, 0.3))
    jwl.queries = on_grid(jwl.queries)
    data = j_plan_data(jengines["dense"], jds, jwl,
                       JConfig(k=5, queue_size=64), probe_budget=PROBE,
                       chunk=48)
    jp = j_fit_planner(data, probe_budget=PROBE, n_trees=30, depth=3)
    return jp, planner_to_torch(jp)


def _eval_workload(batch=12, seed=3):
    jds = _world()[0]
    wl = make_label_workload(jds, batch=batch, kind="contain", seed=seed)
    wl.queries = on_grid(wl.queries)
    return wl


@pytest.mark.parametrize("backend", ["dense", "persistent"])
def test_e2e_tracing_changes_nothing_and_explains(backend):
    """The overhead contract: tracing + explain return the same state bit
    for bit and (persistent) add zero dispatches; the launch spans
    account for every launch of the loop 1:1."""
    _, _, _, engines, _, est = _world()
    engine = engines[backend]
    cfg = SearchConfig(k=5, queue_size=64, pred_kind=PRED_CONTAIN)
    wl = _eval_workload()
    spec = pspec(wl.spec)

    d0 = dispatch_counters()
    plain = e2e_search(engine, est, cfg, wl.queries, spec,
                       probe_budget=PROBE, alpha=1.5)
    d1 = dispatch_counters()
    tr = Tracer()
    traced = e2e_search(engine, est, cfg, wl.queries, spec,
                        probe_budget=PROBE, alpha=1.5, tracer=tr,
                        explain=True)
    d2 = dispatch_counters()

    for name, a, b in zip(plain.state._fields, plain.state, traced.state):
        assert torch.equal(a, b), name
    np.testing.assert_array_equal(plain.predicted_budget,
                                  traced.predicted_budget)
    launches_plain = d1["launches"] - d0["launches"]
    launches_traced = d2["launches"] - d1["launches"]
    assert launches_traced == launches_plain         # zero added dispatches
    assert len(tr.spans(name="launch")) == launches_traced
    if backend == "persistent":
        assert launches_traced > 0
        # the spans' steps add up to the loop's own count; a launch may
        # advance 0 steps when its lanes stop at their first check (the
        # reference's loop does the same on this data: the next test)
        spans = tr.spans(name="launch")
        assert sum(sp.attrs["steps"] for sp in spans) == \
            d2["steps"] - d1["steps"]
        assert all(sp.attrs["steps"] >= 0 and sp.attrs["width"] >= 1
                   for sp in spans)
        assert max(sp.attrs["steps"] for sp in spans) >= 1

    names = {s.name for s in tr.spans()}
    assert {"probe", "feature-extract", "estimate", "resume"} <= names
    assert len(tr.spans(name="probe")) == 2          # n_probes=2 snapshots

    reports = traced.reports
    assert plain.reports is None and len(reports) == wl.batch
    cnts = traced.state.cnt.numpy()
    for i, r in enumerate(reports):
        assert r.backend == backend and r.plan == "traverse"
        assert r.termination in ("budget", "queue-drained", "greedy",
                                 "active")
        assert r.predicted_budget == int(traced.predicted_budget[i])
        assert r.actual_ndc == int(cnts[i]) and r.probe_ndc > 0
        assert [s.name for s in r.stages] == ["probe", "estimate", "resume",
                                              "rerank"]
        probe_st, _, resume_st, _ = r.stages
        assert probe_st.ndc + resume_st.ndc == r.actual_ndc
        assert probe_st.launches >= 1 and r.features  # named feature dict
        assert "ndc=" in r.format(features=True)


def _stream(tr):
    """A tracer's spans without their times: (trace id, name, attrs)."""
    return [(s.trace_id, s.name, s.attrs) for s in tr.spans()]


def _mapped(reports, backend):
    out = []
    for r in reports:
        d = r.to_dict()
        assert d["backend"] == REF_BACKEND[backend]
        d["backend"] = backend
        out.append(d)
    return out


@pytest.mark.parametrize("backend", ["dense", "persistent"])
def test_e2e_reports_and_spans_match_reference(backend):
    """Same inputs, same estimator: the reference's and the port's
    `e2e_search(explain=True)` give equal reports (features within 1e-5,
    the packages' float routines; every other field equal) and the same
    span stream; the states agree bit for bit."""
    _, _, jengines, engines, jest, est = _world()
    wl = _eval_workload(seed=5)
    jtr, tr = JTracer(), Tracer()
    kw = dict(probe_budget=PROBE, alpha=1.5, explain=True)
    ref = j_e2e(jengines[backend], jest,
                JConfig(k=5, queue_size=64, pred_kind=PRED_CONTAIN),
                wl.queries, wl.spec, tracer=jtr, **kw)
    got = e2e_search(engines[backend], est,
                     SearchConfig(k=5, queue_size=64, pred_kind=PRED_CONTAIN),
                     wl.queries, pspec(wl.spec), tracer=tr, **kw)
    np.testing.assert_array_equal(got.state.res_idx.numpy(),
                                  np.asarray(ref.state.res_idx))
    np.testing.assert_array_equal(got.state.res_dist.numpy(),
                                  np.asarray(ref.state.res_dist))
    want = _mapped(ref.reports, backend)
    have = [r.to_dict() for r in got.reports]
    for w, h in zip(want, have):
        wf, hf = w.pop("features"), h.pop("features")
        assert list(wf) == list(hf)
        np.testing.assert_allclose(list(hf.values()), list(wf.values()),
                                   rtol=1e-5, atol=1e-5)
    assert have == want
    assert _stream(tr) == _stream(jtr)
    if backend == "persistent":
        assert len(tr.spans(name="launch")) > 0


@pytest.mark.parametrize("backend", ["dense", "persistent"])
def test_planned_reports_and_spans_match_reference(backend):
    """`planned_search(explain=True)` on a reference planner carried
    across: equal plans, equal reports (backend mapped) and the same span
    stream; tracing leaves the port's state unchanged."""
    jds, ds, jengines, engines, _, _ = _world()
    jp, planner = _planner()
    kw = dict(batch=16, seed=22, structure="mixed", selectivities=(0.01, 0.3))
    jwl, wl = j_composite(jds, **kw), make_composite_workload(ds, **kw)
    jwl.queries = on_grid(jwl.queries)
    wl.queries = on_grid(wl.queries)
    jtr, tr = JTracer(), Tracer()
    args = dict(probe_budget=PROBE, explain=True)
    ref = j_planned(jengines[backend], jp, JConfig(k=5, queue_size=64),
                    jwl.queries, jwl.exprs, tracer=jtr, **args)
    c = SearchConfig(k=5, queue_size=64)
    got = planned_search(engines[backend], planner, c, wl.queries, wl.exprs,
                         tracer=tr, **args)
    plain = planned_search(engines[backend], planner, c, wl.queries,
                           wl.exprs, probe_budget=PROBE)
    for name, a, b in zip(got.state._fields, got.state, plain.state):
        assert torch.equal(a, b), name
    assert plain.reports is None
    np.testing.assert_array_equal(got.plan, ref.plan)
    np.testing.assert_array_equal(got.state.res_dist.numpy(),
                                  np.asarray(ref.state.res_dist))
    assert [r.to_dict() for r in got.reports] == _mapped(ref.reports,
                                                         backend)
    assert _stream(tr) == _stream(jtr)
    names = [s.name for s in tr.spans()]
    assert names[0] == "plan-stage0" and names[-1] == "rerank"


def test_scheduler_launch_accounting_and_telemetry():
    """Σ per-batch launches recorded by the scheduler equals the launch
    loop's dispatch count on the persistent backend; scheduled results
    are the same with tracing and calibration on and off; the calibration
    and Prometheus surfaces work."""
    _, _, _, engines, _, est = _world()
    engine = engines["persistent"]
    cfg = SearchConfig(k=5, queue_size=64, pred_kind=PRED_CONTAIN)
    jds = _world()[0]
    wl = make_label_workload(jds, batch=24, kind="contain", seed=11)
    wl.queries = on_grid(wl.queries)
    from repro_torch.data.synthetic import QueryWorkload

    pwl = QueryWorkload(wl.queries, pspec(wl.spec), wl.sigma_global,
                        wl.hardness)
    scfg = ServeConfig(lane_width=8, probe_budget=PROBE)

    def run(tracer, calibration):
        sch = CostAwareScheduler(engine, est, cfg, scfg, tracer=tracer,
                                 calibration=calibration)
        reqs = requests_from_workload(pwl, arrivals=np.zeros(pwl.batch))
        d0 = dispatch_counters()["launches"]
        for r in reqs:
            sch.submit(r, now=0.0)
        sch.run_until_idle(now=0.0)
        return sch, reqs, dispatch_counters()["launches"] - d0

    tr = Tracer()
    s1, r1, delta = run(tr, True)
    s2, r2, delta2 = run(None, False)
    for a, b in zip(r1, r2):
        assert np.array_equal(a.res_idx, b.res_idx)
        assert np.array_equal(a.res_dist, b.res_dist)
        assert a.ndc == b.ndc
    assert delta == delta2 > 0                       # tracing adds nothing

    summ = s1.summary()
    assert summ["launches_total"] == delta           # 1:1 accounting
    assert summ["launches_total"] == sum(
        p["launches"] for p in summ["batches_by_phase"].values())
    assert len(tr.spans(name="launch")) == delta

    n_miss = sum(1 for r in r1 if not r.cache_hit)
    rep = s1.calibration_report()
    assert rep["n_records"] == n_miss                # cache hits not recorded
    assert set(rep["per_plan"]) <= set(PLAN_NAMES)
    assert s2.calibration_report() is None           # opt-out honored

    names = validate_prometheus(s1.prometheus())
    assert "repro_calibration_records_total" in names
    assert all(r.trace_id.startswith("req-") for r in r1)
    assert len(tr.spans(name="admit")) == pwl.batch
    assert len(tr.spans(name="complete")) == pwl.batch
    done = tr.spans(name="probe-done")
    assert 0 < len(done) <= pwl.batch                # cache hits skip probe
    assert all("rid" in s.attrs and "budget" in s.attrs for s in done)

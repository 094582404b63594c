"""Shard-aware observability in the PyTorch port (`repro_torch.obs.shard`
and the scheduler's per-shard telemetry), on the CPU, against the JAX
reference.

Counterparts of `tests/test_obs_shard.py` (its PSI, drift and sink-rotation
tests are ported in `tests/test_torch_obs.py`): the merge plan and the
balance index; the per-shard EXPLAIN sum invariant (every per-shard counter
sums exactly to its merged counterpart) at S ∈ {1, 2, 4} and on every plan,
with each report — shard sections included — equal to the reference's;
sections read straight off a search; tracing on ≡ off with no added
dispatch on sharded engines; the scheduler's per-shard NDC and bitmap
counters (equal to the reference scheduler's summary) and health surface.

The world is `tests/_shard_world.py`'s grid data; the estimators are the
reference's trivial constant-label forests carried across. Tolerance:
none, except probe features (rtol 1e-5 + atol 1e-5, as in
tests/test_torch_e2e.py).
"""
import dataclasses
import functools
import itertools
import json

import numpy as np
import pytest

import jax

from repro.core import CostEstimator as JEstimator
from repro.core import e2e_search as j_e2e
from repro.core.features import FEATURE_NAMES
from repro.core.planner import Planner as JPlanner
from repro.core.planner import planned_search as j_planned
from repro.distributed.merge import merge_plan as j_merge_plan
from repro.obs.shard import build_shard_sections as j_sections
from repro.obs.shard import shard_budgets as j_shard_budgets
from repro.obs.shard import work_balance as j_work_balance
from repro.serve import CostAwareScheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import requests_from_workload as j_requests
import _shard_world as W
from repro_torch.convert import estimator_to_torch, planner_to_torch
from repro_torch.core import SearchConfig, dispatch_counters, e2e_search
from repro_torch.core.planner import planned_search, scan_stats
from repro_torch.distributed.merge import merge_plan
from repro_torch.obs import DriftConfig, Tracer, validate_prometheus
from repro_torch.obs.shard import (build_shard_sections, shard_budgets,
                                   work_balance)
from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                               requests_from_workload)

F = 2 * len(FEATURE_NAMES)
CFG = SearchConfig(k=5, queue_size=32, pred_kind=0)


@pytest.fixture(autouse=True)
def _drop_jax_executables():
    """Free the reference's compiled programs after each test (see
    tests/test_torch_shard.py)."""
    yield
    jax.clear_caches()


@functools.lru_cache(maxsize=1)
def _heads():
    """The reference's constant-label heads (≈300 NDC), and the port's
    copies: these tests pin accounting, not prediction quality."""
    rng = np.random.default_rng(0)

    def fit(w):
        return JEstimator.fit(rng.normal(size=(64, w)).astype(np.float32),
                              np.full(64, 300.0), n_trees=5, depth=2)

    jest = fit(F)
    jplanner = JPlanner(traverse=fit(F), widen=fit(F), static=fit(8))
    return jest, estimator_to_torch(jest), jplanner, planner_to_torch(jplanner)


def _engines(s: int, backend: str = "dense"):
    """(reference, port) engines with S shards; S=1 is the plain engine."""
    if s == 1:
        from repro.core import SearchEngine as JEngine

        jds, g = W.dataset(), W.plain_graph()
        return (JEngine.build(jds, g, backend=W.REF_BACKEND[backend],
                              mesh=None), W.port_plain(backend=backend))
    return W.ref_sharded(s, backend=backend), W.port_sharded(s, backend=backend)


def _assert_reports_equal(reports, jreports):
    """Every field of every report, shard sections included; the backend's
    name mapped, the features within tolerance."""
    for r, jr in zip(reports, jreports, strict=True):
        d, jd = r.to_dict(), jr.to_dict()
        jd["backend"] = d["backend"]
        f, jf = d.pop("features"), jd.pop("features")
        assert d == jd
        assert list(f) == list(jf)
        np.testing.assert_allclose(list(f.values()), list(jf.values()),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- merge plan ----
def test_merge_plan_closed_form():
    assert merge_plan(1) == (0, 0)
    assert merge_plan(2) == (1, 1)
    assert merge_plan(4) == (3, 2)
    assert merge_plan(5) == (4, 3)
    assert merge_plan(8) == (7, 3)
    assert all(merge_plan(s) == j_merge_plan(s) for s in range(0, 33))


def test_shard_budgets_and_balance():
    np.testing.assert_array_equal(shard_budgets(np.array([300, 301]), 2),
                                  [150, 151])
    bal = work_balance(np.array([[100, 100], [200, 0], [0, 0]]))
    np.testing.assert_allclose(bal, [1.0, 0.5, 1.0])
    rng = np.random.default_rng(1)
    for s in (1, 2, 3, 4):
        b = rng.integers(0, 5000, 17)
        np.testing.assert_array_equal(shard_budgets(b, s),
                                      j_shard_budgets(b, s))
        ndc = rng.integers(0, 900, (17, s))
        ndc[0] = 0
        np.testing.assert_array_equal(work_balance(ndc), j_work_balance(ndc))


# ------------------------------------------------- sum invariant ----------
@pytest.mark.parametrize("s", [1, 2, 4])
def test_shard_sections_sum_invariant(s):
    """Per-shard sections sum exactly to the merged counters (they read the
    stacked tensors the merge summed), and every report equals the
    reference's."""
    jest, est, _, _ = _heads()
    jeng, eng = _engines(s)
    wl = W.workload(6, 3)
    r = e2e_search(eng, est, CFG, wl.queries, W.pspec(wl.spec),
                   probe_budget=32, alpha=1.5, explain=True)
    jr = j_e2e(jeng, jest, W.jcfg(), wl.queries, wl.spec, probe_budget=32,
               alpha=1.5, explain=True)
    _assert_reports_equal(r.reports, jr.reports)
    st = r.state
    merged_clause = st.n_clause_valid.numpy()
    for i, rep in enumerate(r.reports):
        if s == 1:
            assert rep.shards == [] and rep.work_balance == 1.0
            assert (rep.merge_pairwise, rep.merge_depth) == (0, 0)
            continue
        assert len(rep.shards) == s
        assert (rep.merge_pairwise, rep.merge_depth) == merge_plan(s)
        assert sum(sec.ndc for sec in rep.shards) == rep.actual_ndc
        assert sum(sec.hops for sec in rep.shards) == int(st.hops[i])
        assert (sum(sec.n_inspected for sec in rep.shards)
                == int(st.n_inspected[i]))
        clause = np.sum([sec.n_clause_valid for sec in rep.shards], axis=0)
        np.testing.assert_array_equal(clause, merged_clause[i])
        sb = int(shard_budgets(rep.predicted_budget, s)[()])
        for j, sec in enumerate(rep.shards):
            assert sec.shard == j and sec.budget == sb
            assert sec.termination in ("queue-drained", "budget", "greedy",
                                       "active")
        assert 1.0 / s <= rep.work_balance <= 1.0
        d = json.loads(rep.to_json())
        assert len(d["shards"]) == s
        assert f"shards={s}" in rep.format()


@pytest.mark.parametrize("plan", ["scan", "traverse", "widen"])
def test_shard_sections_all_plans(plan):
    """The invariant holds on every plan's report, scan lanes override the
    per-shard termination too, and the reports equal the reference's."""
    _, _, jplanner, planner = _heads()
    jeng, eng = _engines(2)
    wl = W.workload(4, 5)
    res = planned_search(eng, planner, CFG, wl.queries, W.pspec(wl.spec),
                         probe_budget=32, alpha=1.5, force_plan=plan,
                         explain=True)
    jres = j_planned(jeng, jplanner, W.jcfg(), wl.queries, wl.spec,
                     probe_budget=32, alpha=1.5, force_plan=plan,
                     explain=True)
    _assert_reports_equal(res.reports, jres.reports)
    st = res.state
    for i, rep in enumerate(res.reports):
        assert rep.plan == plan and len(rep.shards) == 2
        assert sum(sec.ndc for sec in rep.shards) == int(st.cnt[i])
        assert sum(sec.hops for sec in rep.shards) == int(st.hops[i])
        if plan == "scan":
            assert rep.termination == "scan-exhaustive"
            assert all(sec.termination == "scan-exhaustive"
                       for sec in rep.shards)


def test_direct_sections_match_engine_search():
    jeng, eng = _engines(4)
    wl = W.workload(4, 7)
    st = eng.search(CFG, wl.queries, W.pspec(wl.spec), 200)
    secs = build_shard_sections(CFG, st, 200)
    jsecs = j_sections(W.jcfg(), jeng.search(W.jcfg(), wl.queries, wl.spec,
                                             200), 200)
    cnt = st.shard.cnt.numpy()
    for i in range(4):
        assert [sec.ndc for sec in secs[i]] == [int(v) for v in cnt[i]]
        assert sum(sec.ndc for sec in secs[i]) == int(st.cnt[i])
        assert ([dataclasses.asdict(x) for x in secs[i]]
                == [dataclasses.asdict(x) for x in jsecs[i]])


# --------------------------------------------- sharded tracing contract ----
@pytest.mark.parametrize("backend", ["dense", "persistent"])
def test_sharded_tracing_bit_identity_zero_dispatch(backend):
    """Tracing changes no result bit and adds no launch on sharded engines;
    shard spans carry the shard index and the merge topology as plain
    host values."""
    _, est, _, _ = _heads()
    _, eng = _engines(2, backend)
    wl = W.workload(6, 9)
    spec = W.pspec(wl.spec)
    d0 = dispatch_counters()
    plain = e2e_search(eng, est, CFG, wl.queries, spec, probe_budget=32,
                       alpha=1.5)
    d1 = dispatch_counters()
    tr = Tracer()
    traced = e2e_search(eng, est, CFG, wl.queries, spec, probe_budget=32,
                        alpha=1.5, tracer=tr, explain=True)
    d2 = dispatch_counters()
    for part in ("merged", "shard"):
        a, b = getattr(plain.state, part), getattr(traced.state, part)
        for f, x, y in zip(a._fields, a, b):
            assert x.equal(y), (part, f)
    assert (d2["launches"] - d1["launches"]
            == d1["launches"] - d0["launches"])
    if backend == "persistent":
        assert d1["launches"] > d0["launches"]

    searches = tr.spans(name="shard-search")
    assert searches and all(sp.attrs["n_shards"] == 2 for sp in searches)
    assert {sp.attrs["shard"] for sp in searches} == {0, 1}
    merges = tr.spans(name="shard-merge")
    assert merges
    for sp in merges:
        assert (sp.attrs["pairwise"], sp.attrs["depth"]) == merge_plan(2)
        assert sp.attrs["path"] == "loop"
        assert all(isinstance(v, (int, float, str, bool))
                   for v in sp.attrs.values())


# --------------------------------------------- scheduler shard telemetry ----
def _clock():
    c = itertools.count()
    return lambda: float(next(c))


def _serve_both(s, scfg, wl, planner=False):
    """The same requests through the port's and the reference's schedulers
    (injected clocks) → (port scheduler, its requests, reference
    scheduler)."""
    jest, est, jplanner, pplanner = _heads()
    jeng, eng = _engines(s)
    sched = CostAwareScheduler(eng, est, CFG, scfg, timer=_clock(),
                               planner=pplanner if planner else None)
    jsched = JScheduler(jeng, jest, W.jcfg(),
                        JServeConfig(**dataclasses.asdict(scfg)),
                        timer=_clock(), planner=jplanner if planner else None)
    reqs = requests_from_workload(dataclasses.replace(wl, spec=W.pspec(
        wl.spec)), arrivals=np.zeros(wl.batch))
    jreqs = j_requests(wl, arrivals=np.zeros(wl.batch))
    for sch, rs in ((sched, reqs), (jsched, jreqs)):
        for r in rs:
            sch.submit(r, 0.0)
        sch.run_until_idle(0.0)
    return sched, reqs, jsched


def test_scheduler_shard_ndc_sums_to_request_ndc():
    scfg = ServeConfig(lane_width=4, buckets=(128, None), probe_budget=32,
                       alpha=1.5, cache_capacity=0, queue_capacity=64)
    sched, reqs, jsched = _serve_both(2, scfg, W.workload(10, 11))
    sh = sched.summary()["shards"]
    assert sh["n_shards"] == 2 and len(sh["ndc_by_shard"]) == 2
    assert sum(sh["ndc_by_shard"]) == sum(r.ndc for r in reqs)
    assert sh["ndc_skew"] >= 1.0 and 0.0 < sh["work_balance"] <= 1.0
    assert sched.summary() == jsched.summary()
    names = validate_prometheus(sched.prometheus())
    assert names["repro_shard_ndc_total"] == 2
    assert "repro_shard_work_balance" in names


def test_scheduler_shard_bitmap_counts():
    """Forced-scan serving counts each admitted filter's bitmap once, cut
    at the engine's shard offsets — an offline popcount of the same
    workload's validity mask, and the reference scheduler's counts."""
    scfg = ServeConfig(lane_width=4, buckets=(128, None), plan="scan",
                       cache_capacity=0, queue_capacity=64)
    wl = W.workload(8, 13)
    sched, _, jsched = _serve_both(2, scfg, wl)
    eng = sched.engine
    valid = scan_stats(eng, eng.compile(W.pspec(wl.spec))).valid.numpy()
    ns = eng.shard_size
    expect = [int(valid[:, int(o):int(o) + ns].sum()) for o in eng.offsets]
    sh = sched.summary()["shards"]
    assert sh["bitmap_by_shard"] == expect
    assert sched.summary() == jsched.summary()
    names = validate_prometheus(sched.prometheus())
    assert names["repro_shard_bitmap_count_total"] == 2


def test_scheduler_status_surface():
    _, est, _, _ = _heads()
    _, eng2 = _engines(2)
    _, eng1 = _engines(1)
    sched = CostAwareScheduler(
        eng2, est, CFG,
        ServeConfig(lane_width=4, probe_budget=32, cache_capacity=0,
                    queue_capacity=64),
        drift=DriftConfig(min_ref=4, min_cur=2))
    wl = W.workload(6, 15)
    reqs = requests_from_workload(dataclasses.replace(
        wl, spec=W.pspec(wl.spec)), arrivals=np.zeros(wl.batch))
    for r in reqs:
        sched.submit(r, 0.0)
    sched.run_until_idle(0.0)
    st = sched.status()
    json.dumps(st)
    assert st["healthy"] is True
    assert st["queue"]["depth"] == 0 and st["queue"]["capacity"] == 64
    assert st["summary"]["shards"]["n_shards"] == 2
    assert st["summary"]["n_shards"] == 2
    assert st["drift"]["ready"]
    assert st["calibration"]["n_records"] == 6
    s2 = CostAwareScheduler(eng1, est, CFG, ServeConfig(lane_width=4),
                            drift=False)
    st2 = s2.status()
    assert st2["drift"] is None and st2["healthy"] is True
    assert "shards" not in st2["summary"]


def test_unsharded_engine_has_no_shard_metrics():
    scfg = ServeConfig(lane_width=4, probe_budget=32, cache_capacity=0,
                       queue_capacity=64)
    sched, _, jsched = _serve_both(1, scfg, W.workload(4, 17))
    assert "shards" not in sched.summary()
    assert sched.summary()["n_shards"] == 1
    assert sched.summary() == jsched.summary()
    validate_prometheus(sched.prometheus())

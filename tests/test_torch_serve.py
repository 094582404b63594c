"""Cost-aware serving in the PyTorch port (`repro_torch.serve` and the
serve launcher), on the CPU.

- Every test of `tests/test_serve.py` has a counterpart here, run against
  the port: batcher invariants, bucket routing, scheduled ≡ one-shot
  `e2e_search` bit for bit (direct and escalate, padding, mixed kinds,
  mixed boolean structures; on the dense and the persistent backend),
  cache correctness and keys, the plan-collision matrix under "auto",
  admission control.
- Across the packages: the reference's and the port's schedulers get the
  same requests, the same `now` and the same injected timer; each request
  must come out with the same `res_idx`, `res_dist` (bit for bit: grid
  data), `ndc`, `budget`, `n_slices` and `plan`, the two `summary()`
  dicts must be equal field by field, and the span streams the same
  (trace ids, names, attributes; times aside). Cases: "traverse" on the
  persistent backend (direct and escalate), "auto" with a reference
  planner carried by `convert.planner_to_torch`, and an int8 engine on
  the exact data of `tests/_quant_grid.py`.
- `launch/serve.py::main` with `--device cpu` at the reference's default
  corpus, with `--explain 2 --status --prometheus`: its scrape passes
  `validate_prometheus`.
"""
import contextlib
import dataclasses
import functools
import io
import itertools
import json

import numpy as np
import pytest
import torch

from repro.core import (CostEstimator as JEstimator, SearchConfig as JConfig,
                        SearchEngine as JEngine,
                        fit_planner as j_fit_planner,
                        generate_plan_training_data as j_plan_data,
                        generate_training_data as j_training)
from repro.data import make_composite_workload as j_composite
from repro.data import make_dataset as j_make_dataset
from repro.data import make_label_workload as j_label
from repro.index import build_graph_index
from repro.obs import Tracer as JTracer
from repro.serve import CostAwareScheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import requests_from_workload as j_requests
from _quant_grid import grid_index, grid_queries
from repro_torch.convert import (engine_from_arrays, estimator_to_torch,
                                 planner_to_torch)
from repro_torch.core import SearchConfig, e2e_search
from repro_torch.data import (make_composite_workload, make_dataset,
                              make_label_workload, make_range_workload)
from repro_torch.filters import And, Contain, Not, Or, Range
from repro_torch.filters.predicates import PRED_CONTAIN, PRED_EQUAL, PRED_RANGE
from repro_torch.obs import DriftConfig, Tracer, validate_prometheus
from repro_torch.serve import (AdmissionQueue, CostAwareScheduler,
                               MicroBatcher, Request, ServeConfig,
                               requests_from_workload)
from repro_torch.serve.cache import request_key

REF_BACKEND = {"dense": "dense", "persistent": "pallas_persistent"}
PROBE = 48


def on_grid(a):
    return (np.round(np.asarray(a) * 64) / 64).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _world():
    """Grid data from both packages' generators (the same seeded numpy
    draws), the reference's graph and estimator, and the port's engines
    on the CPU over the same arrays."""
    kw = dict(n=2500, dim=24, n_clusters=6, alphabet_size=32, seed=0)
    jds, ds = j_make_dataset(**kw), make_dataset(**kw)
    jds.vectors = on_grid(jds.vectors)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(jds.vectors, degree=16, seed=0)
    jengines = {b: JEngine.build(jds, graph, backend=REF_BACKEND[b],
                                 mesh=None) for b in REF_BACKEND}
    engines = {b: engine_from_arrays(
        ds.vectors, ds.labels_packed, ds.value_matrix,
        np.asarray(graph.neighbors), graph.entry_point, backend=b,
        device="cpu") for b in REF_BACKEND}
    wl_tr = j_label(jds, batch=192, kind="contain", seed=7)
    wl_tr.queries = on_grid(wl_tr.queries)
    td = j_training(jengines["dense"], jds, wl_tr,
                    JConfig(k=5, queue_size=64, pred_kind=PRED_CONTAIN),
                    probe_budget=PROBE, chunk=96)
    jest = JEstimator.fit(td.features, td.w_q, n_trees=60, depth=4)
    return dict(jds=jds, ds=ds, graph=graph, jengines=jengines,
                engines=engines, jest=jest, est=estimator_to_torch(jest))


@functools.lru_cache(maxsize=1)
def _planners():
    """A reference planner fitted on 48 composite "mixed" queries, and the
    same planner carried to the port."""
    w = _world()
    jwl = j_composite(w["jds"], batch=48, seed=11, structure="mixed",
                      selectivities=(0.01, 0.1, 0.3))
    jwl.queries = on_grid(jwl.queries)
    data = j_plan_data(w["jengines"]["dense"], w["jds"], jwl,
                       JConfig(k=5, queue_size=64), probe_budget=PROBE,
                       chunk=48)
    jp = j_fit_planner(data, probe_budget=PROBE, n_trees=60, depth=4)
    return jp, planner_to_torch(jp)


CFG = SearchConfig(k=5, queue_size=64, pred_kind=PRED_CONTAIN)


def _label(batch, seed, kind="contain"):
    """A label (or range) workload from the port's generator, on grid."""
    ds = _world()["ds"]
    wl = (make_range_workload(ds, batch=batch, seed=seed) if kind == "range"
          else make_label_workload(ds, batch=batch, kind=kind, seed=seed))
    wl.queries = on_grid(wl.queries)
    return wl


def _req(rid, kind=PRED_CONTAIN, budget=None, arrival=0.0, dim=4, words=1):
    r = Request(rid=rid, query=np.full(dim, rid, np.float32), kind=kind,
                arrival=arrival)
    if kind == PRED_RANGE:
        r.range_lo, r.range_hi = 0.0, 1.0
    else:
        r.label_mask = np.asarray([rid + 1] * words, np.uint32)
    r.budget = budget
    return r


def _run(sched, reqs, now=0.0):
    for r in reqs:
        assert sched.submit(r, now) == "queued"
    sched.run_until_idle(now)


# -------------------------------------------------------------- batcher ----
def test_batcher_padding_invariants():
    b = MicroBatcher(lane_width=8, buckets=(100, None), n_words=1, n_values=1,
                     device="cpu")
    reqs = [_req(i, budget=50, arrival=i) for i in range(3)]
    q = b.pad_queries(reqs)
    assert isinstance(q, torch.Tensor) and q.device.type == "cpu"
    assert q.shape == (8, 4)
    assert (q[3:] == 0).all()                       # pad lanes zeroed
    prog = b.pad_program(reqs)
    assert prog.masks.shape == (8, 1, 1)            # 3 single-clause + pads
    assert isinstance(prog.masks, torch.Tensor)     # on the engine's device
    assert (prog.masks[3:] == 0).all()
    # pad lanes are match-nothing: no active term → valid ≡ False
    assert not prog.term_active[3:].any()
    assert prog.term_active[:3].all()
    budgets = b.pad_budgets(reqs, cap=None)
    assert budgets.shape == (8,) and budgets.dtype == torch.int32
    assert (budgets[:3] == 50).all() and (budgets[3:] == 0).all()


def test_batcher_mixes_filter_structures():
    """Compiled programs erase the same-kind restriction: one FIFO batch
    carries label, range, and composite filters together."""
    b = MicroBatcher(lane_width=4, buckets=(100, None), fill=True,
                     n_words=1, n_values=1, device="cpu")
    b.enqueue(_req(0, kind=PRED_CONTAIN, budget=50, arrival=0.0))
    b.enqueue(_req(1, kind=PRED_RANGE, budget=50, arrival=1.0))
    r2 = Request(rid=2, query=np.zeros(4, np.float32), arrival=2.0,
                 expr=And(Contain([1]), Range(0.1, 0.9)))
    r2.budget = 50
    b.enqueue(r2)
    _, reqs, _ = b.form_batch()
    assert [r.rid for r in reqs] == [0, 1, 2]        # strict FIFO, one batch
    prog = b.pad_program(reqs, width=4)
    # slot shape covers the widest program (the 2-clause conjunction),
    # rounded to a power of two
    assert prog.n_slots == 2 and prog.batch == 4
    assert prog.active.sum(dim=1).tolist() == [1, 1, 2, 0]


def test_bucket_routing_deterministic():
    b = MicroBatcher(lane_width=4, buckets=(100, 400, None))
    assert b.bucket_of(1) == 0
    assert b.bucket_of(100) == 0                     # cap is inclusive
    assert b.bucket_of(101) == 1
    assert b.bucket_of(400) == 1
    assert b.bucket_of(401) == 2
    assert b.bucket_of(10**9) == 2

    def fill(bb):
        for i, w in enumerate([50, 500, 90, 120, 10**6]):
            bb.enqueue(_req(i, budget=w, arrival=i))
        out = []
        while bb.depth():
            idx, reqs, cap = bb.form_batch()
            out.append((idx, [r.rid for r in reqs], cap))
        return out
    b2 = MicroBatcher(lane_width=4, buckets=(100, 400, None))
    assert fill(b) == fill(b2)


def test_opportunistic_fill_rides_spare_lanes():
    b = MicroBatcher(lane_width=4, buckets=(100, None), fill=True,
                     device="cpu")
    for i in range(3):
        b.enqueue(_req(i, budget=50 + i, arrival=float(i)))
    for i in (3, 4):
        b.enqueue(_req(i, budget=5000, arrival=3.0 + i))
    (plan, idx), reqs, cap = b.form_batch()
    assert plan == "traverse" and idx == 0 and cap == 100
    # 3 residents → natural width 4 → exactly one free pad lane for a rider
    assert [r.rid for r in reqs] == [0, 1, 2, 3]
    # the rider runs a bounded slice: its lane budget is clamped to the cap
    assert b.pad_budgets(reqs, cap, width=4).tolist() == [50, 51, 52, 100]
    assert b.budget_targets(reqs, cap, width=4).tolist() == [50, 51, 52, 100]


def test_fill_never_widens_past_natural_width():
    """Riders must not push a batch to a wider (costlier) lane shape."""
    b = MicroBatcher(lane_width=16, buckets=(100, None), fill=True)
    for i in range(3):                              # natural width 4
        b.enqueue(_req(i, budget=50, arrival=float(i)))
    for i in range(10, 22):                         # plenty of riders
        b.enqueue(_req(i, budget=5000, arrival=float(i)))
    _, reqs, _ = b.form_batch()
    assert len(reqs) == 4 == b.width_for(3)         # 1 rider, not 13


def test_batcher_rejects_unordered_buckets():
    with pytest.raises(ValueError, match="ascending"):
        MicroBatcher(buckets=(400, 100, None))


def test_form_batch_on_empty_named_bucket():
    b = MicroBatcher(lane_width=4, buckets=(100, None), fill=True)
    b.enqueue(_req(0, budget=5000, arrival=0.0))     # lives in bucket 1
    key, reqs, cap = b.form_batch(bucket=("traverse", 0))  # bucket 0 empty
    assert (key, reqs, cap) == (("traverse", 0), [], 100)
    assert b.depth() == 1                            # nothing was lost


# ------------------------------------------------- scheduled == one-shot ----
def _assert_oneshot(reqs, one):
    reqs = sorted(reqs, key=lambda r: r.rid)
    np.testing.assert_array_equal(np.stack([r.res_idx for r in reqs]),
                                  one.state.res_idx.numpy())
    np.testing.assert_array_equal(np.stack([r.res_dist for r in reqs]),
                                  one.state.res_dist.numpy())
    np.testing.assert_array_equal(np.asarray([r.ndc for r in reqs]),
                                  one.state.cnt.numpy())
    np.testing.assert_array_equal(np.asarray([r.budget for r in reqs]),
                                  one.predicted_budget)


@pytest.mark.parametrize("backend", ["dense", "persistent"])
@pytest.mark.parametrize("policy", ["direct", "escalate"])
def test_scheduled_equals_oneshot(policy, backend):
    """The acceptance bar: scheduling (micro-batching, bucket routing,
    resume-requeue slicing, lane padding) is bit-invisible in the results."""
    w = _world()
    engine, est = w["engines"][backend], w["est"]
    wl = _label(24, 42)
    one = e2e_search(engine, est, CFG, wl.queries, wl.spec,
                     probe_budget=PROBE, alpha=1.5)
    scfg = ServeConfig(lane_width=8, buckets=(128, 512, None), policy=policy,
                       probe_budget=PROBE, alpha=1.5, cache_capacity=0)
    sched = CostAwareScheduler(engine, est, CFG, scfg)
    reqs = requests_from_workload(wl)
    _run(sched, reqs)
    _assert_oneshot(reqs, one)
    if policy == "escalate":
        # the preemption path must actually have been exercised
        assert any(r.n_slices >= 2 for r in reqs)


def test_scheduled_equals_oneshot_with_padding():
    """5 requests through 8-wide lanes: pad lanes must be inert."""
    w = _world()
    engine, est = w["engines"]["persistent"], w["est"]
    wl = _label(5, 13)
    one = e2e_search(engine, est, CFG, wl.queries, wl.spec,
                     probe_budget=PROBE, alpha=1.5)
    sched = CostAwareScheduler(engine, est, CFG, ServeConfig(
        lane_width=8, buckets=(128, 512, None), probe_budget=PROBE,
        alpha=1.5, cache_capacity=0))
    reqs = requests_from_workload(wl)
    _run(sched, reqs)
    _assert_oneshot(reqs, one)


def test_scheduled_mixed_kinds_equal_per_kind_oneshot():
    """Interleaved contain/range requests: each kind matches its one-shot."""
    w = _world()
    engine, est = w["engines"]["persistent"], w["est"]
    wl_c, wl_r = _label(8, 5), _label(8, 6, kind="range")
    cfg_r = dataclasses.replace(CFG, pred_kind=PRED_RANGE)
    one_c = e2e_search(engine, est, CFG, wl_c.queries, wl_c.spec,
                       probe_budget=PROBE, alpha=1.5)
    one_r = e2e_search(engine, est, cfg_r, wl_r.queries, wl_r.spec,
                       probe_budget=PROBE, alpha=1.5)
    sched = CostAwareScheduler(engine, est, CFG, ServeConfig(
        lane_width=8, buckets=(128, 512, None), probe_budget=PROBE,
        alpha=1.5, cache_capacity=0))
    rc = requests_from_workload(wl_c, start_rid=0)
    rr = requests_from_workload(wl_r, start_rid=100)
    _run(sched, [r for pair in zip(rc, rr) for r in pair])
    np.testing.assert_array_equal(np.stack([r.res_idx for r in rc]),
                                  one_c.state.res_idx.numpy())
    np.testing.assert_array_equal(np.stack([r.res_idx for r in rr]),
                                  one_r.state.res_idx.numpy())


def test_scheduled_mixed_structures_equal_oneshot():
    """Mixed-boolean-structure batch (And/Or/Not composites + bare leaves
    interleaved): shared lanes, results bit for bit one-shot's."""
    w = _world()
    engine, est = w["engines"]["persistent"], w["est"]
    wl = make_composite_workload(w["ds"], batch=20, structure="mixed",
                                 seed=77)
    wl.queries = on_grid(wl.queries)
    one = e2e_search(engine, est, CFG, wl.queries, wl.exprs,
                     probe_budget=PROBE, alpha=1.5)
    sched = CostAwareScheduler(engine, est, CFG, ServeConfig(
        lane_width=8, buckets=(128, 512, None), probe_budget=PROBE,
        alpha=1.5, cache_capacity=0))
    reqs = requests_from_workload(wl)
    _run(sched, reqs)
    # probe batches mixed at least two different program structures
    assert len({r.program.n_slots for r in reqs}) > 1
    _assert_oneshot(reqs, one)


# ---------------------------------------------------------------- cache ----
def test_cache_hit_returns_identical_result():
    w = _world()
    engine, est = w["engines"]["persistent"], w["est"]
    wl = _label(4, 3)
    sched = CostAwareScheduler(engine, est, CFG, ServeConfig(
        lane_width=4, buckets=(128, None), probe_budget=PROBE, alpha=1.5))
    reqs = requests_from_workload(wl)
    _run(sched, reqs)
    again = requests_from_workload(wl)
    for r in again:
        assert sched.submit(r, 1.0) == "hit"
    for a, b in zip(reqs, again):
        assert b.cache_hit and b.completed == 1.0
        np.testing.assert_array_equal(a.res_idx, b.res_idx)
        np.testing.assert_array_equal(a.res_dist, b.res_dist)
        assert isinstance(b.res_idx, np.ndarray)     # host copies
        assert a.ndc == b.ndc
    assert sched.cache.hit_rate == 0.5  # 4 misses then 4 hits


def test_cache_keys_distinguish_filter_spec_collisions():
    q = np.ones(8, np.float32)
    base = dict(k=5, queue_size=64, alpha=1.5, probe_budget=48)
    contain = Request(0, q, PRED_CONTAIN, label_mask=np.asarray([7], np.uint32))
    equal = Request(1, q, PRED_EQUAL, label_mask=np.asarray([7], np.uint32))
    # same query, same mask *bytes*, different predicate kind
    assert request_key(contain, **base) != request_key(equal, **base)
    other = Request(2, q, PRED_CONTAIN, label_mask=np.asarray([9], np.uint32))
    assert request_key(contain, **base) != request_key(other, **base)
    # a range whose float bytes shadow the mask bytes still differs
    lo, hi = np.frombuffer(np.asarray([7, 7], np.uint32).tobytes(),
                           np.float32)[:2]
    rng_req = Request(3, q, PRED_RANGE, range_lo=float(lo), range_hi=float(hi))
    assert request_key(contain, **base) != request_key(rng_req, **base)
    # search parameters are part of the key — every answer-changing one
    assert (request_key(contain, 5, 64, 1.5, 48)
            != request_key(contain, 5, 64, 2.0, 48))
    assert (request_key(contain, **base)
            != request_key(contain, **base, min_budget=64))
    assert (request_key(contain, **base)
            != request_key(contain, **base, n_probes=1))
    assert (request_key(contain, **base)
            != request_key(contain, **base, ablate_filter=True))
    assert (request_key(contain, **base)
            != request_key(contain, **base, codec="int8:aabbccddeeff"))
    assert (request_key(contain, **base, codec="int8:aabbccddeeff")
            != request_key(contain, **base, codec="pq:aabbccddeeff"))
    assert (request_key(contain, **base, codec="pq:aabbccddeeff")
            != request_key(contain, **base, codec="pq:001122334455"))
    assert (request_key(contain, **base, codec="float32")
            == request_key(contain, **base))          # explicit default collides
    twin = Request(4, q.copy(), PRED_CONTAIN,
                   label_mask=np.asarray([7], np.uint32))
    assert request_key(contain, **base) == request_key(twin, **base)
    # the reference's key for the same request is the same digest
    from repro.serve import Request as JRequest
    from repro.serve.cache import request_key as j_request_key

    jcontain = JRequest(0, q, PRED_CONTAIN,
                        label_mask=np.asarray([7], np.uint32))
    assert request_key(contain, **base, plan="scan") == j_request_key(
        jcontain, **base, plan="scan")


def test_cache_keys_canonicalize_composite_filters():
    """And(a,b) vs Or(a,b) must differ; And(a,b) vs And(b,a) must collide
    (same canonical program → same traversal → same answer)."""
    q = np.ones(8, np.float32)
    base = dict(k=5, queue_size=64, alpha=1.5, probe_budget=48)
    a, b = Contain([3]), Range(0.25, 0.75)

    def key(expr):
        return request_key(Request(0, q, expr=expr), **base)

    assert key(And(a, b)) == key(And(b, a))          # commutativity collides
    assert key(Or(a, b)) == key(Or(b, a))
    assert key(And(a, b)) != key(Or(a, b))           # structure distinguishes
    assert key(And(a, b)) != key(And(a, Not(b)))     # negation distinguishes
    assert key(a) != key(And(a, b))
    assert key(Not(Not(a))) == key(a)                # double negation
    # a bare leaf and its legacy-field spelling collide (the shim contract)
    legacy = Request(1, q, PRED_CONTAIN, label_mask=np.asarray([8], np.uint32))
    assert request_key(legacy, **base) == key(Contain([3]))


def test_cache_plan_collision_matrix():
    """plan enters the cache key exactly when it can change the answer; an
    auto completion is dual-put under the chosen forced key iff it
    executed the exact bitwise forced path (plan_pure)."""
    w = _world()
    engine, est = w["engines"]["persistent"], w["est"]
    _, planner = _planners()
    base = dict(k=5, queue_size=64, alpha=1.5, probe_budget=48)
    probe = Request(0, np.ones(24, np.float32),
                    expr=And(Contain([3]), Range(0.25, 0.75)))
    keys = {p: request_key(probe, **base, plan=p)
            for p in ("traverse", "scan", "widen", "auto")}
    assert keys["traverse"] == request_key(probe, **base)  # legacy stable
    assert len(set(keys.values())) == 4                    # pairwise distinct

    scfg = ServeConfig(lane_width=8, buckets=(256, None), probe_budget=PROBE,
                       plan="auto")
    sched = CostAwareScheduler(engine, est, CFG, scfg, planner=planner)
    wl = make_composite_workload(w["ds"], batch=8, seed=21,
                                 structure="mixed", selectivities=(0.01, 0.3))
    wl.queries = on_grid(wl.queries)
    reqs = requests_from_workload(wl)
    _run(sched, reqs)
    plans = {"scan", "traverse", "widen"}
    assert all(r.plan in plans for r in reqs)
    for r in reqs:
        hit = {p: sched.cache.get(sched._key_for(r, p)) is not None
               for p in plans | {"auto"}}
        assert hit["auto"]                       # always stored under auto
        assert hit[r.plan] == r.plan_pure        # dual-put iff bitwise-pure
        assert not any(hit[p] for p in plans - {r.plan})  # others never

    pure = [r for r in reqs if r.plan_pure]
    assert pure                                  # routing produced pure lanes
    victim = pure[0]
    pos = reqs.index(victim)
    forced_same = CostAwareScheduler(
        engine, est, CFG, dataclasses.replace(scfg, plan=victim.plan),
        planner=planner)
    forced_same.cache = sched.cache
    assert forced_same.submit(requests_from_workload(wl)[pos], 1.0) == "hit"
    other = next(p for p in plans if p != victim.plan)
    forced_other = CostAwareScheduler(
        engine, est, CFG, dataclasses.replace(scfg, plan=other),
        planner=planner)
    forced_other.cache = sched.cache
    assert (forced_other.submit(requests_from_workload(wl)[pos], 1.0)
            == "queued")                         # forced-Y never sees X's entry

    # late-scan completions (probe counters leaked into NDC) must NOT be
    # dual-put: a forced-scan run never pays the probe
    late = Request(99, np.full(24, 0.5, np.float32),
                   expr=Contain([5]), arrival=2.0)
    late.plan, late.plan_pure = "scan", False
    sched._finish(late, np.full(CFG.k, -1, np.int32),
                  np.full(CFG.k, np.inf, np.float32), 17, 2.0)
    assert sched.cache.get(sched._key(late)) is not None
    assert sched.cache.get(sched._key_for(late, "scan")) is None


def test_uncompilable_filter_rejected_at_submit():
    """A filter the compiler rejects must raise at submit() with nothing
    queued — compiling after admission would poison the pump loop."""
    w = _world()
    engine, est = w["engines"]["persistent"], w["est"]
    sched = CostAwareScheduler(engine, est, CFG, ServeConfig(
        lane_width=4, buckets=(128, None), cache_capacity=0))
    pairs = [Or(Contain([2 * i]), Contain([2 * i + 1])) for i in range(6)]
    bomb = Request(0, np.zeros(24, np.float32), expr=And(*pairs))  # 2^6 DNF
    with pytest.raises(ValueError, match="clauses"):
        sched.submit(bomb, 0.0)
    assert sched.depth() == 0                        # nothing poisoned
    ok = requests_from_workload(_label(3, 1))
    _run(sched, ok)                                  # pump still healthy
    assert all(r.res_idx is not None for r in ok)


# ------------------------------------------------------------- admission ----
def test_admission_backpressure_and_deadlines():
    q = AdmissionQueue(capacity=2)
    a, b, c = (_req(i, arrival=float(i)) for i in range(3))
    assert q.offer(a, 0.0) and q.offer(b, 0.0)
    assert not q.offer(c, 0.0)                       # full → shed
    assert q.n_shed == 1
    d = _req(9, arrival=0.0)
    d.deadline = 1.0
    assert not q.offer(d, 2.0)                       # expired on arrival
    assert q.n_expired == 1
    assert len(q) == 2


def test_scheduler_reports_shed_and_metrics_json():
    w = _world()
    engine, est = w["engines"]["persistent"], w["est"]
    sched = CostAwareScheduler(engine, est, CFG, ServeConfig(
        lane_width=4, buckets=(128, None), probe_budget=PROBE, alpha=1.5,
        queue_capacity=4, cache_capacity=0))
    reqs = requests_from_workload(_label(6, 9))
    outcomes = [sched.submit(r, 0.0) for r in reqs]
    assert outcomes.count("queued") == 4 and outcomes.count("shed") == 2
    sched.run_until_idle(0.0)
    s = sched.summary()
    assert s["n_completed"] == 4 and s["n_shed"] == 2
    assert s["latency"]["p50"] <= s["latency"]["p99"]
    json.dumps(s)  # plain-JSON serializable


def test_scheduler_status_surface():
    """The health surface on one index (tests/test_obs_shard.py's, less
    the shard block): serializable, drift ready, no shard metrics."""
    w = _world()
    engine, est = w["engines"]["persistent"], w["est"]
    sched = CostAwareScheduler(
        engine, est, CFG,
        ServeConfig(lane_width=4, probe_budget=32, cache_capacity=0,
                    queue_capacity=64),
        drift=DriftConfig(min_ref=4, min_cur=2))
    wl = _label(6, 15)
    _run(sched, requests_from_workload(wl, arrivals=np.zeros(wl.batch)))
    st = sched.status()
    json.dumps(st)
    assert st["healthy"] is True
    assert st["queue"]["depth"] == 0 and st["queue"]["capacity"] == 64
    assert st["drift"]["ready"] and st["calibration"]["n_records"] == 6
    assert "shards" not in st["summary"] and st["summary"]["n_shards"] == 1
    validate_prometheus(sched.prometheus())
    s2 = CostAwareScheduler(engine, est, CFG, ServeConfig(lane_width=4),
                            drift=False)
    st2 = s2.status()
    assert st2["drift"] is None and st2["healthy"] is True


# ------------------------------------- the reference's scheduler, same run ----
def _timer():
    """An injected clock: every read advances by one unit, so both
    schedulers measure the same busy time as long as they read it at the
    same points."""
    c = itertools.count()
    return lambda: float(next(c))


def _both(jengine, engine, jest, est, scfg, jreqs, reqs, jplanner=None,
          planner=None):
    """Serve the same requests through both schedulers; return both."""
    jcfg = JConfig(k=5, queue_size=64, pred_kind=PRED_CONTAIN)
    jtr, tr = JTracer(clock=_timer()), Tracer(clock=_timer())
    jsched = JScheduler(jengine, jest, jcfg, JServeConfig(
        **dataclasses.asdict(scfg)), timer=_timer(), planner=jplanner,
        tracer=jtr)
    sched = CostAwareScheduler(engine, est, CFG, scfg, timer=_timer(),
                               planner=planner, tracer=tr)
    for sch, rs in ((jsched, jreqs), (sched, reqs)):
        for r in rs:
            assert sch.submit(r, 0.0) == "queued"
        sch.run_until_idle(0.0)
    return jsched, jtr, sched, tr


def _assert_same_service(jsched, jtr, jreqs, sched, tr, reqs):
    assert [r.rid for r in reqs] == [r.rid for r in jreqs]
    for j, p in zip(jreqs, reqs):
        np.testing.assert_array_equal(p.res_idx, np.asarray(j.res_idx))
        np.testing.assert_array_equal(p.res_dist, np.asarray(j.res_dist))
        assert (p.ndc, p.budget, p.n_slices, p.plan) == (
            j.ndc, j.budget, j.n_slices, j.plan), p.rid
    assert sched.summary() == jsched.summary()
    assert ([(s.trace_id, s.name, s.attrs) for s in tr.spans()]
            == [(s.trace_id, s.name, s.attrs) for s in jtr.spans()])


@pytest.mark.parametrize("policy", ["direct", "escalate"])
def test_scheduler_matches_reference_traverse(policy):
    """"traverse" on the persistent backend against the reference's
    "pallas_persistent": the same service request by request, the same
    summary, the same span stream."""
    w = _world()
    jwl = j_label(w["jds"], batch=20, kind="contain", seed=42)
    jwl.queries = on_grid(jwl.queries)
    wl = _label(20, 42)
    np.testing.assert_array_equal(wl.queries, jwl.queries)
    scfg = ServeConfig(lane_width=8, buckets=(128, 512, None), policy=policy,
                       probe_budget=PROBE, alpha=1.5)
    jreqs, reqs = j_requests(jwl), requests_from_workload(wl)
    jsched, jtr, sched, tr = _both(
        w["jengines"]["persistent"], w["engines"]["persistent"], w["jest"],
        w["est"], scfg, jreqs, reqs)
    _assert_same_service(jsched, jtr, jreqs, sched, tr, reqs)
    assert sched.summary()["launches_total"] > 0
    if policy == "escalate":
        assert any(r.n_slices >= 2 for r in reqs)


def test_scheduler_matches_reference_auto():
    """plan="auto" with a reference planner carried across: the same
    routes (scan / traverse / widen), results, summary and spans."""
    w = _world()
    jp, planner = _planners()
    kw = dict(batch=16, seed=21, structure="mixed", selectivities=(0.01, 0.3))
    jwl = j_composite(w["jds"], **kw)
    wl = make_composite_workload(w["ds"], **kw)
    jwl.queries = on_grid(jwl.queries)
    wl.queries = on_grid(wl.queries)
    scfg = ServeConfig(lane_width=8, buckets=(256, None), probe_budget=PROBE,
                       alpha=1.5, plan="auto")
    jreqs, reqs = j_requests(jwl), requests_from_workload(wl)
    jsched, jtr, sched, tr = _both(
        w["jengines"]["persistent"], w["engines"]["persistent"], w["jest"],
        w["est"], scfg, jreqs, reqs, jplanner=jp, planner=planner)
    _assert_same_service(jsched, jtr, jreqs, sched, tr, reqs)
    assert len({r.plan for r in reqs}) >= 2       # the router chose


def test_scheduler_matches_reference_int8():
    """An int8 engine on exact data (tests/_quant_grid.py): scheduled
    results after the rerank equal the one-shot `e2e_search`'s and the
    reference scheduler's, summary and spans included."""
    w = _world()
    jds = w["jds"]
    jeng = JEngine.build(jds, w["graph"], backend="pallas_persistent",
                         mesh=None)
    jeng.precision = "int8"
    jeng.quant = grid_index("int8", jds.vectors)
    eng = engine_from_arrays(jds.vectors, jds.labels_packed,
                             jds.value_matrix, np.asarray(w["graph"].neighbors),
                             w["graph"].entry_point, backend="persistent",
                             device="cpu", precision="int8", quant=jeng.quant)
    assert eng.codec_key() == jeng.codec_key()
    jcfg = JConfig(k=5, queue_size=64)
    wlt = j_label(jds, batch=24, kind="contain", seed=10)
    wlt.queries = grid_queries(wlt.queries, "int8")
    td = j_training(jeng, jds, wlt, jcfg, probe_budget=PROBE, chunk=24)
    jest = JEstimator.fit(td.features, td.w_q, n_trees=40, depth=3)
    est = estimator_to_torch(jest)

    jwl = j_label(jds, batch=12, kind="contain", seed=5)
    jwl.queries = grid_queries(jwl.queries, "int8")
    wl = _label(12, 5)
    wl.queries = jwl.queries.copy()
    one = e2e_search(eng, est, CFG, wl.queries, wl.spec, probe_budget=PROBE,
                     alpha=1.5)
    scfg = ServeConfig(lane_width=8, buckets=(128, 512, None),
                       probe_budget=PROBE, alpha=1.5, cache_capacity=0)
    jreqs, reqs = j_requests(jwl), requests_from_workload(wl)
    jsched, jtr, sched, tr = _both(jeng, eng, jest, est, scfg, jreqs, reqs)
    _assert_oneshot(reqs, one)
    _assert_same_service(jsched, jtr, jreqs, sched, tr, reqs)


# -------------------------------------------------------------- launcher ----
def test_serve_launcher_on_cpu(monkeypatch):
    """`python -m repro_torch.launch.serve` at the reference's default
    corpus, traced, with the health report and the scrape."""
    from repro_torch.launch import serve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sched = serve.main(["--device", "cpu", "--explain", "2", "--status",
                            "--prometheus"])
    text = out.getvalue()
    assert "== lifecycle timelines (first 2 requests)" in text
    assert text.count("request ") >= 2 and " admit " in text
    scrape = text.split("== prometheus scrape\n", 1)[1]
    names = validate_prometheus(scrape)
    assert "repro_requests_completed_total" in names
    health = json.loads(text.split("== serving health\n", 1)[1].split(
        "== prometheus scrape")[0])
    assert health["summary"]["n_completed"] == 64 == sched.metrics.n_completed
    assert health["queue"]["depth"] == 0
    # without a card and without --device cpu the launcher raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "4"])

"""The planning path of the PyTorch port, held to the JAX reference on CPU.

- `gather_frontier` (post, pre, widen) equals the reference's.
- Traversal in post, pre and widen mode on the "dense", "fused" and
  "persistent" backends equals the reference's "dense", "pallas" and
  "pallas_persistent" in every `SearchState` field, with the persistent
  launch loop's dispatch counter deltas.
- `scan_search` equals the reference's (every field) and the port's own
  `filtered_knn_exact` bit for bit; a lane's scan is independent of its
  batchmates and of the padded width.
- `planned_search` on a reference `Planner` carried across by
  `planner_to_torch` gives the reference's plan per lane, budgets and
  state; `planned_search(force_plan=p)` equals `run_plan(p)` in every
  field; `generate_plan_training_data` gives the reference's labels.

Both packages draw the same dataset and composite workloads from the same
seeds (numpy); vectors and queries sit on the grid 1/64, so every squared
distance is exact in float32 in any summation order and float fields are
required equal too. The probe features feed three GBDT heads through
`log1p` of integer counters, where the packages' float routines can differ
by one ulp (ROADMAP Queue 3); with integer counts on this data they give
the same plans and budgets, which the tests require.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (PLANS as J_PLANS, SearchConfig as JConfig,
                        SearchEngine as JEngine, fit_planner as j_fit_planner,
                        generate_plan_training_data as j_generate,
                        planned_search as j_planned, scan_search as j_scan)
from repro.core.search import dispatch_counters as j_dispatch_counters
from repro.core.step import gather_frontier as j_gather_frontier
from repro.data import make_composite_workload as j_composite
from repro.data import make_dataset as j_make_dataset
from repro.index import build_graph_index
from repro_torch.convert import (engine_from_arrays, planner_to_torch,
                                 state_to_numpy)
from repro_torch.core import (PLANS, SearchConfig, SearchEngine,
                              concat_lanes, dispatch_counters,
                              generate_plan_training_data, pad_lanes,
                              planned_search, probe_and_features, run_plan,
                              scan_search, scan_stats, take_lanes)
from repro_torch.core.step import gather_frontier
from repro_torch.data import make_composite_workload, make_dataset
from repro_torch.filters import And, Contain, Range
from repro_torch.index.bruteforce import filtered_knn_exact
from repro_torch.kernels.distance import SCAN_ALIGN, sqdist_rows_plain

K, M, DEG, PROBE = 5, 64, 16, 48


def on_grid(a):
    return (np.round(a * 64) / 64).astype(np.float32)


def assert_fields_equal(port_state, ref_state, where):
    for name, g, w in zip(port_state._fields, state_to_numpy(port_state),
                          ref_state):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (where, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")


def assert_states_equal(a, b, where):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{where}: {name}"


@functools.lru_cache(maxsize=1)
def _world():
    kw = dict(n=3000, dim=32, n_clusters=6, alphabet_size=32, seed=0)
    jds, ds = j_make_dataset(**kw), make_dataset(**kw)
    jds.vectors = on_grid(jds.vectors)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(jds.vectors, degree=DEG, seed=0)
    jeng = JEngine.build(jds, graph, mesh=None)
    eng = engine_from_arrays(ds.vectors, ds.labels_packed, ds.value_matrix,
                             np.asarray(graph.neighbors), graph.entry_point,
                             device="cpu")
    return jds, ds, jeng, eng


def _workloads(structure, batch, seed, selectivities):
    """The same composite workload from each package, queries on grid."""
    jds, ds, _, _ = _world()
    jwl = j_composite(jds, batch=batch, seed=seed, structure=structure,
                      selectivities=selectivities)
    wl = make_composite_workload(ds, batch=batch, seed=seed,
                                 structure=structure,
                                 selectivities=selectivities)
    jwl.queries = on_grid(jwl.queries)
    wl.queries = on_grid(wl.queries)
    return jwl, wl


@functools.lru_cache(maxsize=1)
def _training():
    """The reference's plan training data and planner on a mixed workload,
    and the port's labels for the same queries."""
    jds, ds, jeng, eng = _world()
    jwl, wl = _workloads("mixed", 64, 11, (0.01, 0.1, 0.3))
    jdata = j_generate(jeng, jds, jwl, JConfig(k=K, queue_size=M),
                       probe_budget=PROBE, chunk=64)
    jplanner = j_fit_planner(jdata, probe_budget=PROBE, n_trees=40, depth=4)
    data = generate_plan_training_data(
        eng, ds, wl, SearchConfig(k=K, queue_size=M), probe_budget=PROBE,
        chunk=64)
    return jdata, jplanner, data


@functools.lru_cache(maxsize=1)
def _skewed_planner():
    """A reference planner whose heads are fitted to skewed labels — widen
    at half its cost, the static head at an eighth of traverse's, a scan
    floor of 8 — so that routing takes every branch: stage-0 scans, late
    scans (a probed carry into the scan) and widen resumes."""
    from repro.core import CostEstimator as JEstimator
    from repro.core.planner import Planner as JPlanner

    jdata, _, _ = _training()
    kw = dict(n_trees=40, depth=4)
    return JPlanner(
        traverse=JEstimator.fit(jdata.features, jdata.w_traverse, **kw),
        widen=JEstimator.fit(jdata.features,
                             np.maximum(jdata.w_widen // 2, 1), **kw),
        static=JEstimator.fit(jdata.static_feats,
                              np.maximum(jdata.w_traverse // 8, 1), **kw),
        scan_floor=8)


@pytest.fixture(scope="module")
def world():
    return _world()


# ------------------------------------------------------------ frontier ----
@pytest.mark.parametrize("mode", ["post", "pre", "widen"])
def test_gather_frontier_matches_reference(world, mode):
    """1-hop ∪ strided 2-hop with in-row dedup (first occurrence kept),
    including -1 graph padding."""
    nbrs = np.asarray(world[3].neighbors).copy()
    nbrs[::7, -1] = -1
    nbrs[::5, 3] = nbrs[::5, 2]                  # repeated ids in a row
    u = np.random.default_rng(3).integers(0, nbrs.shape[0], 24)
    for stride in (8, 3):
        cfg = SearchConfig(degree=DEG, mode=mode, two_hop_stride=stride)
        jcfg = JConfig(degree=DEG, mode=mode, two_hop_stride=stride)
        got = gather_frontier(cfg, torch.from_numpy(nbrs),
                              torch.from_numpy(u.astype(np.int32)))
        want = j_gather_frontier(jcfg, jnp.asarray(nbrs),
                                 jnp.asarray(u.astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------- traversal modes ----
@pytest.mark.parametrize("mode", ["post", "pre", "widen"])
@pytest.mark.parametrize("backend,ref_backend", [
    ("dense", "dense"), ("fused", "pallas"),
    ("persistent", "pallas_persistent")])
def test_modes_match_reference(world, mode, backend, ref_backend):
    """Every field after a search with heterogeneous budgets, then a
    resume to a larger budget; the persistent launch loop's dispatch
    counter deltas equal the reference's."""
    _, _, jeng, eng = world
    jwl, wl = _workloads("and", 12, 9, (0.05, 0.2))
    budgets = np.random.default_rng(1).integers(100, 700, 12).astype(np.int32)
    kw = dict(k=K, queue_size=M, mode=mode, steps_per_launch=3)
    jcfg, cfg = (JConfig(backend=ref_backend, **kw),
                 SearchConfig(backend=backend, **kw))
    j0, p0 = j_dispatch_counters(), dispatch_counters()
    ref = jeng.search(jcfg, jwl.queries, jwl.filters, budgets)
    got = eng.search(cfg, wl.queries, wl.filters, budgets)
    assert_fields_equal(got, ref, f"{mode}/{backend}")
    ref = jeng.search(jcfg, jwl.queries, jwl.filters, 2 * budgets, state=ref)
    got = eng.search(cfg, wl.queries, wl.filters, 2 * budgets, state=got)
    assert_fields_equal(got, ref, f"{mode}/{backend} resumed")
    jd = {k: v - j0[k] for k, v in j_dispatch_counters().items()}
    pd = {k: v - p0[k] for k, v in dispatch_counters().items()}
    assert pd == jd, (pd, jd)
    cnt, insp = got.cnt.numpy(), got.n_inspected.numpy()
    if mode == "pre":
        assert (cnt <= insp).all() and (cnt < insp).any()
    else:
        np.testing.assert_array_equal(cnt, insp)


# ------------------------------------------------------------ scan plan ----
@pytest.mark.parametrize("structure", ["and", "mixed"])
def test_scan_matches_reference_and_oracle(world, structure):
    """Every field equal to the reference's scan; ids and distances equal
    to the port's own oracle bit for bit; cnt == σ·N, no hops, terminal."""
    jds, ds, jeng, eng = world
    jwl, wl = _workloads(structure, 24, 3, (0.01, 0.1, 0.4))
    cfg = SearchConfig(k=K, queue_size=M)
    ref = j_scan(jeng, JConfig(k=K, queue_size=M), jwl.queries, jwl.filters)
    got = scan_search(eng, cfg, wl.queries, wl.filters)
    assert_fields_equal(got, ref, structure)
    gi, gd = filtered_knn_exact(wl.queries, ds.vectors, wl.filters,
                                ds.labels_packed, ds.value_matrix, K,
                                device="cpu")
    np.testing.assert_array_equal(got.res_idx.numpy(), gi)
    np.testing.assert_array_equal(got.res_dist.numpy().view(np.uint32),
                                  gd.view(np.uint32))
    stats = scan_stats(eng, eng.compile(wl.filters))
    np.testing.assert_array_equal(got.cnt.numpy(), stats.counts)
    assert not got.hops.any() and not got.active.any()


def test_scan_match_nothing_and_match_all(world):
    jds, ds, jeng, eng = world
    from repro.filters import And as JAnd, Contain as JContain, \
        Range as JRange

    exprs = [Range(1e9, 1e9 + 1), Range(-1e9, 1e9),
             And(Contain([1]), Range(1e9, 1e9 + 1))]
    jexprs = [JRange(1e9, 1e9 + 1), JRange(-1e9, 1e9),
              JAnd(JContain([1]), JRange(1e9, 1e9 + 1))]
    q = on_grid(ds.vectors[:3] + 0.1)
    got = scan_search(eng, SearchConfig(k=K, queue_size=M), q, exprs)
    ref = j_scan(jeng, JConfig(k=K, queue_size=M), q, jexprs)
    assert_fields_equal(got, ref, "degenerate")
    assert got.cnt.tolist() == [0, ds.n, 0]
    assert (got.res_idx[0] == -1).all() and torch.isinf(got.res_dist[0]).all()


def test_scan_late_carry_matches_reference(world):
    """A probed carry scanned as the planner's late scan (`base_state`):
    counters accumulate on the probe's, buffers are replaced."""
    from repro.core import probe_and_features as j_probe

    _, _, jeng, eng = world
    jwl, wl = _workloads("and", 8, 4, (0.05, 0.2))
    jst, _ = j_probe(jeng, JConfig(k=K, queue_size=M), jwl.queries,
                     jwl.filters, PROBE, 2)
    st, _ = probe_and_features(eng, SearchConfig(k=K, queue_size=M),
                               wl.queries, wl.filters, PROBE, 2)
    ref = j_scan(jeng, JConfig(k=K, queue_size=M), jwl.queries, jwl.filters,
                 base_state=jst)
    got = scan_search(eng, SearchConfig(k=K, queue_size=M), wl.queries,
                      wl.filters, base_state=st)
    assert_fields_equal(got, ref, "late scan")


def test_scan_lane_and_width_invariance(world):
    """A lane's scan is independent of its batchmates (and so of the
    padded width their counts set), and the per-lane plain distance of a
    (query, row) pair is the same at V and at V + 64·j padded rows — on
    unrounded float data."""
    _, ds, _, eng = world
    _, wl = _workloads("and", 12, 5, (0.02, 0.3))
    cfg = SearchConfig(k=K, queue_size=M)
    full = scan_search(eng, cfg, wl.queries, wl.filters)
    sub_idx = [1, 4, 9]
    sub = scan_search(eng, cfg, wl.queries[sub_idx],
                      [wl.exprs[i] for i in sub_idx])
    for name in ("res_idx", "res_dist", "cand_dist", "cand_idx", "cnt"):
        assert torch.equal(getattr(full, name)[sub_idx], getattr(sub, name))
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.standard_normal((ds.n, 32)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, ds.n, (5, 2 * SCAN_ALIGN))
                           .astype(np.int32))
    mask = torch.from_numpy(rng.random((5, 2 * SCAN_ALIGN)) < 0.8)
    d = sqdist_rows_plain(q, base, ids, mask)
    for j in (1, 3):
        pad = j * SCAN_ALIGN
        wide = sqdist_rows_plain(
            q, base, torch.nn.functional.pad(ids, (0, pad)),
            torch.nn.functional.pad(mask, (0, pad)))
        assert torch.equal(wide[:, :2 * SCAN_ALIGN], d)
        assert torch.isinf(wide[:, 2 * SCAN_ALIGN:]).all()
    one = sqdist_rows_plain(q[3:4], base, ids[3:4], mask[3:4])
    assert torch.equal(one[0], d[3])


# ------------------------------------------------------------- planner ----
def test_plan_training_data_matches_reference(world):
    """Per query: probe features (1e-5: `log1p` and ratios in other float
    routines), the static features, both exhaustion labels and their
    convergence flags, σ, and the oracle (distances equal, ids equal away
    from distance ties, where the reference's `argpartition` order is
    arbitrary and the port's is by id)."""
    jdata, _, data = _training()
    for name in ("static_feats", "w_traverse", "w_widen", "converged_t",
                 "converged_w", "sigma", "gt_dist"):
        np.testing.assert_array_equal(getattr(data, name),
                                      np.asarray(getattr(jdata, name)),
                                      err_msg=name)
    np.testing.assert_allclose(data.features, np.asarray(jdata.features),
                               rtol=1e-5, atol=1e-5)
    gd = data.gt_dist
    with np.errstate(invalid="ignore"):  # inf - inf pads
        tie = np.zeros_like(gd, bool)
        tie[:, 1:] |= np.diff(gd, axis=1) == 0
        tie[:, :-1] |= np.diff(gd, axis=1) == 0
    np.testing.assert_array_equal(data.gt_idx[~tie],
                                  np.asarray(jdata.gt_idx)[~tie])
    assert data.converged_t.any() and data.converged_w.any()


def test_planner_to_torch_carries_the_heads():
    _, jplanner, _ = _training()
    planner = planner_to_torch(jplanner)
    for head in ("traverse", "widen", "static"):
        jm, pm = getattr(jplanner, head).model, getattr(planner, head).model
        for f in ("feat", "thresh", "leaf"):
            np.testing.assert_array_equal(getattr(pm, f), getattr(jm, f))
        assert pm.base == jm.base and pm.depth == jm.depth
    assert planner.scan_floor == jplanner.scan_floor == 2 * PROBE


@pytest.mark.parametrize("structure,backend,ref_backend,heads", [
    ("and", "fused", "pallas", "trained"),
    ("mixed", "fused", "pallas", "trained"),
    ("mixed", "dense", "dense", "trained"),
    ("mixed", "persistent", "pallas_persistent", "trained"),
    ("mixed", "fused", "pallas", "skewed"),
    ("mixed", "persistent", "pallas_persistent", "skewed")])
def test_planned_search_matches_reference(world, structure, backend,
                                          ref_backend, heads):
    """The same plan per lane (stage-0 routing included), predicted
    budgets and every state field as the reference on a carried planner:
    the trained one (scan and traverse lanes) and the skewed one (stage-0
    and late scans, widen lanes)."""
    _, _, jeng, eng = world
    jplanner = _training()[1] if heads == "trained" else _skewed_planner()
    planner = planner_to_torch(jplanner)
    jwl, wl = _workloads(structure, 16, 13, (0.01, 0.2))
    ref = j_planned(jeng, jplanner, JConfig(k=K, queue_size=M,
                                            backend=ref_backend),
                    jwl.queries, jwl.filters, probe_budget=PROBE, alpha=1.2)
    got = planned_search(eng, planner, SearchConfig(k=K, queue_size=M,
                                                    backend=backend),
                         wl.queries, wl.filters, probe_budget=PROBE,
                         alpha=1.2)
    np.testing.assert_array_equal(got.plan, ref.plan)
    np.testing.assert_array_equal(got.pre_probe, ref.pre_probe)
    np.testing.assert_array_equal(got.predicted_budget, ref.predicted_budget)
    np.testing.assert_array_equal(got.sigma, ref.sigma)
    assert_fields_equal(got.state, ref.state, structure)
    assert got.plan_names() == [J_PLANS[p] for p in ref.plan]
    if structure == "mixed":
        assert len(set(got.plan.tolist())) >= 2
    if heads == "skewed":
        assert (got.plan == PLANS.index("widen")).any()
        assert ((got.plan == PLANS.index("scan")) & ~got.pre_probe).any()


@pytest.mark.parametrize("plan", PLANS)
def test_forced_plan_equals_run_plan(world, plan):
    """planned_search(force_plan=p) ≡ run_plan(p), every field — the
    router can choose, never perturb."""
    _, _, _, eng = world
    _, jplanner, _ = _training()
    planner = planner_to_torch(jplanner)
    _, wl = _workloads("mixed", 16, 13, (0.01, 0.2))
    cfg = SearchConfig(k=K, queue_size=M, backend="fused")
    forced = planned_search(eng, planner, cfg, wl.queries, wl.filters,
                            probe_budget=PROBE, alpha=1.2, force_plan=plan)
    direct = run_plan(eng, planner, plan, cfg, wl.queries, wl.filters,
                      probe_budget=PROBE, alpha=1.2)
    assert (forced.plan == PLANS.index(plan)).all()
    assert_states_equal(forced.state, direct, plan)


def test_concat_and_pad_lanes(world):
    _, _, _, eng = world
    _, wl = _workloads("and", 6, 2, (0.1,))
    st = eng.search(SearchConfig(k=K, queue_size=M), wl.queries, wl.filters,
                    200)
    parts = [take_lanes(st, [0, 1]), take_lanes(st, [2]),
             take_lanes(st, [3, 4, 5])]
    assert_states_equal(concat_lanes(parts), st, "concat")
    padded = pad_lanes(st, 2)
    assert padded.cnt.shape == (8,)
    assert_states_equal(take_lanes(padded, range(6)), st, "pad")
    assert not padded.cnt[6:].any() and not padded.active[6:].any()


def test_planned_search_needs_no_search_engine_rebuild(world):
    """An engine built by `SearchEngine.build` from the port's dataset and
    the reference's graph plans like the converted one."""
    from repro_torch.index.graph import GraphIndex

    jds, ds, _, eng = world
    graph = GraphIndex(neighbors=eng.neighbors.clone(),
                       entry_point=eng.entry_point, dim=ds.dim)
    built = SearchEngine.build(ds, graph, device="cpu")
    _, wl = _workloads("and", 8, 6, (0.02, 0.2))
    cfg = SearchConfig(k=K, queue_size=M)
    assert_states_equal(scan_search(built, cfg, wl.queries, wl.filters),
                        scan_search(eng, cfg, wl.queries, wl.filters),
                        "built engine")

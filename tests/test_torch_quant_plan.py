"""Quantized planning in the PyTorch port, held to the JAX reference on CPU.

- Pre and widen traversal under int8 and PQ on the "dense", "fused" and
  "persistent" backends equal the reference's "dense", "pallas" and
  "pallas_persistent" in every `SearchState` field, with the persistent
  launch loop's dispatch counter deltas (the R'=160 frontier: K3 / K4's
  shape).
- The compressed `scan_search` (the distances of K6q rows' plain version)
  equals the reference's, every field, and the port's own
  `compressed_filtered_topk` (ids and distance bits); the late scan with a
  probed carry too. On unrounded data a lane's compressed scan, its
  `q_err_sum` included, does not depend on its batchmates or on the padded
  width.
- `generate_plan_training_data` on a quantized engine (the compressed
  convergence target) gives the reference's labels; `planned_search` on a
  carried planner (a trained and a skewed one) gives its plans, budgets and
  every state field after the rerank; `planned_search(force_plan=p)` ≡
  `run_plan(p)`; a scan whose pool holds the whole valid set recovers the
  exact top-k after the rerank.
- K6q rows' plain version equals `quant_dist` (the traversal's plain
  distance) on gathered rows; the kernel's own tests are in
  `tests/test_torch_quant_rows.py`.

Data on `tests/_quant_grid.py`'s grid: every ADC distance, norm, error and
sum of them is exact in float32 whatever the order, so float fields are
required equal, not close. The probe features go through `log1p` and the
GBDT heads; on this data they give the same plans and budgets (features to
1e-5, as in `tests/test_torch_planner.py`).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _quant_grid import grid_index, grid_queries, on_grid
from repro.core import (SearchConfig as JConfig, SearchEngine as JEngine,
                        fit_planner as j_fit_planner,
                        generate_plan_training_data as j_generate,
                        planned_search as j_planned, scan_search as j_scan)
from repro.core.search import dispatch_counters as j_dispatch_counters
from repro.data import make_composite_workload as j_composite
from repro.data import make_dataset as j_make_dataset
from repro.index import build_graph_index
from repro_torch.convert import (engine_from_arrays, planner_to_torch,
                                 state_to_numpy)
from repro_torch.core import (PLANS, SearchConfig, SearchEngine,
                              dispatch_counters, generate_plan_training_data,
                              planned_search, probe_and_features, run_plan,
                              scan_search, scan_stats)
from repro_torch.data import make_composite_workload, make_dataset
from repro_torch.index.bruteforce import filtered_knn_exact, valid_mask
from repro_torch.kernels.quant_rows import (sqdist_rows_quant,
                                            sqdist_rows_quant_plain)
from repro_torch.quant import codecs as P

K, M, DEG, PROBE = 5, 64, 16, 48
CODECS = ("int8", "pq")


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
    """Grid dataset and graph; per codec the reference engine with a grid
    quant index and the port's engine carrying the same index."""
    kw = dict(n=3000, dim=32, n_clusters=6, alphabet_size=32, seed=0)
    jds, ds = j_make_dataset(**kw), make_dataset(**kw)
    jds.vectors = on_grid(jds.vectors)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(jds.vectors, degree=DEG, seed=0)
    engines = {}
    for precision in CODECS:
        jeng = JEngine.build(jds, graph, mesh=None)
        jeng.precision = precision
        jeng.quant = grid_index(precision, jds.vectors)
        eng = engine_from_arrays(ds.vectors, ds.labels_packed,
                                 ds.value_matrix, np.asarray(graph.neighbors),
                                 graph.entry_point, device="cpu",
                                 precision=precision, quant=jeng.quant)
        engines[precision] = (jeng, eng)
    return jds, ds, graph, engines


def _workloads(precision, structure, batch, seed, selectivities):
    """The same composite workload from each package, queries on the
    codec's grid."""
    jds, ds, _, _ = _world()
    jwl = j_composite(jds, batch=batch, seed=seed, structure=structure,
                      selectivities=selectivities)
    wl = make_composite_workload(ds, batch=batch, seed=seed,
                                 structure=structure,
                                 selectivities=selectivities)
    jwl.queries = grid_queries(jwl.queries, precision)
    wl.queries = grid_queries(wl.queries, precision)
    return jwl, wl


@functools.lru_cache(maxsize=2)
def _training(precision):
    """Plan training data of both packages on a "mixed" workload (the
    compressed convergence target), and the reference's planner."""
    jds, ds, _, engines = _world()
    jeng, eng = engines[precision]
    jwl, wl = _workloads(precision, "mixed", 64, 11, (0.01, 0.1, 0.3))
    jdata = j_generate(jeng, jds, jwl, JConfig(k=K, queue_size=M),
                       probe_budget=PROBE, chunk=64)
    data = generate_plan_training_data(eng, ds, wl,
                                       SearchConfig(k=K, queue_size=M),
                                       probe_budget=PROBE, chunk=64)
    jplanner = j_fit_planner(jdata, probe_budget=PROBE, n_trees=40, depth=4)
    return jdata, data, jplanner


@functools.lru_cache(maxsize=2)
def _skewed_planner(precision):
    """A reference planner fitted to skewed labels (widen at half its
    cost, the static head at an eighth of traverse's, a scan floor of 8),
    so that routing takes every branch: stage-0 and late scans and widen
    resumes."""
    from repro.core import CostEstimator as JEstimator
    from repro.core.planner import Planner as JPlanner

    jdata = _training(precision)[0]
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


# ------------------------------------------------- pre / widen, codec ----
@pytest.mark.parametrize("precision", CODECS)
@pytest.mark.parametrize("mode", ["pre", "widen"])
@pytest.mark.parametrize("backend,ref_backend", [
    ("dense", "dense"), ("fused", "pallas"),
    ("persistent", "pallas_persistent")])
def test_widened_modes_under_a_codec_match_reference(world, precision, mode,
                                                     backend, ref_backend):
    """Every field after a search with heterogeneous budgets and after a
    resume to twice them; the persistent loop's dispatch deltas equal the
    reference's; pre counts only valid rows, q_err_sum every new one."""
    _, _, _, engines = world
    jeng, eng = engines[precision]
    jwl, wl = _workloads(precision, "and", 12, 9, (0.05, 0.2))
    budgets = np.random.default_rng(1).integers(100, 700, 12).astype(np.int32)
    kw = dict(k=K, queue_size=M, mode=mode, steps_per_launch=3)
    jcfg = JConfig(backend=ref_backend, **kw)
    cfg = SearchConfig(backend=backend, **kw)
    j0, p0 = j_dispatch_counters(), dispatch_counters()
    ref = jeng.search(jcfg, jwl.queries, jwl.filters, budgets)
    got = eng.search(cfg, wl.queries, wl.filters, budgets)
    assert_fields_equal(got, ref, f"{precision}/{mode}/{backend}")
    ref = jeng.search(jcfg, jwl.queries, jwl.filters, 2 * budgets, state=ref)
    got = eng.search(cfg, wl.queries, wl.filters, 2 * budgets, state=got)
    assert_fields_equal(got, ref, f"{precision}/{mode}/{backend} resumed")
    jd = {k: v - j0[k] for k, v in j_dispatch_counters().items()}
    pd = {k: v - p0[k] for k, v in dispatch_counters().items()}
    assert pd == jd, (pd, jd)
    cnt, insp = got.cnt.numpy(), got.n_inspected.numpy()
    if mode == "pre":
        assert (cnt <= insp).all() and (cnt < insp).any()
    else:
        np.testing.assert_array_equal(cnt, insp)
    assert (got.q_err_sum.numpy() > 0).all()


# ------------------------------------------------- the compressed scan ----
@pytest.mark.parametrize("precision", CODECS)
@pytest.mark.parametrize("structure", ["and", "mixed"])
def test_quant_scan_matches_reference_and_oracle(world, precision, structure):
    """Every field equal to the reference's compressed scan; ids and
    distance bits equal to the port's `compressed_filtered_topk`; cnt ==
    σ·N; q_err_sum > 0 where a row passed; terminal."""
    _, ds, _, engines = world
    jeng, eng = engines[precision]
    jwl, wl = _workloads(precision, structure, 24, 3, (0.01, 0.1, 0.4))
    ref = j_scan(jeng, JConfig(k=K, queue_size=M), jwl.queries, jwl.filters)
    got = scan_search(eng, SearchConfig(k=K, queue_size=M), wl.queries,
                      wl.filters)
    assert_fields_equal(got, ref, f"{precision}/{structure}")
    ok = valid_mask(wl.exprs, ds.labels_packed, ds.value_matrix)
    od, oi = P.compressed_filtered_topk(precision, eng.quant, wl.queries, ok,
                                        K, chunk=7, n_block=1000)
    np.testing.assert_array_equal(got.res_idx.numpy(), oi)
    np.testing.assert_array_equal(got.res_dist.numpy().view(np.uint32),
                                  od.view(np.uint32))
    stats = scan_stats(eng, eng.compile(wl.filters))
    np.testing.assert_array_equal(got.cnt.numpy(), stats.counts)
    assert (got.q_err_sum.numpy()[stats.counts > 0] > 0).all()
    assert not got.hops.any() and not got.active.any()


@pytest.mark.parametrize("precision", CODECS)
def test_quant_scan_late_carry_matches_reference(world, precision):
    """The planner's late scan: a probed carry scanned with `base_state`
    accumulates counters, q_err_sum included, on the probe's."""
    from repro.core import probe_and_features as j_probe

    _, _, _, engines = world
    jeng, eng = engines[precision]
    jwl, wl = _workloads(precision, "and", 8, 4, (0.05, 0.2))
    jst, _ = j_probe(jeng, JConfig(k=K, queue_size=M), jwl.queries,
                     jwl.filters, PROBE, 2)
    st_, _ = probe_and_features(eng, SearchConfig(k=K, queue_size=M),
                                wl.queries, wl.filters, PROBE, 2)
    ref = j_scan(jeng, JConfig(k=K, queue_size=M), jwl.queries, jwl.filters,
                 base_state=jst)
    got = scan_search(eng, SearchConfig(k=K, queue_size=M), wl.queries,
                      wl.filters, base_state=st_)
    assert_fields_equal(got, ref, f"late scan {precision}")
    assert (got.q_err_sum > st_.q_err_sum).any()


@pytest.mark.parametrize("precision", CODECS)
def test_quant_scan_lane_and_width_invariance(world, precision):
    """On unrounded data (a codec trained on unrounded vectors): a lane's
    compressed scan, q_err_sum included, equals its scan in another batch
    (so at another padded width), and the plain K6q rows gives each pair
    the same bits at V and at V + 64·j padded rows and alone."""
    _, ds, _, engines = world
    _, eng = engines[precision]
    rng = np.random.default_rng(2)
    raw = torch.from_numpy((ds.vectors + rng.normal(
        scale=1e-3, size=ds.vectors.shape)).astype(np.float32))
    quant = P.build_quant_index(precision, raw, device="cpu", pq_subspaces=8,
                                pq_centroids=32, pq_iters=4)
    qeng = dataclasses.replace(eng, base_vectors=raw, quant=quant)
    _, wl = _workloads(precision, "and", 12, 5, (0.02, 0.3))
    q = (wl.queries + rng.normal(scale=1e-3, size=wl.queries.shape)).astype(
        np.float32)
    cfg = SearchConfig(k=K, queue_size=M)
    full = scan_search(qeng, cfg, q, wl.filters)
    sub_idx = [1, 4, 9]
    sub = scan_search(qeng, cfg, q[sub_idx], [wl.exprs[i] for i in sub_idx])
    assert full.cnt[sub_idx].tolist() != [full.cnt.max().item()] * 3
    for name in ("res_idx", "res_dist", "cand_dist", "cand_idx", "cnt",
                 "q_err_sum"):
        assert torch.equal(getattr(full, name)[sub_idx],
                           getattr(sub, name)), name
    prep = P.prepare_query(precision, quant, torch.from_numpy(q[:5]))
    ids = torch.from_numpy(rng.integers(0, ds.n, (5, 128)).astype(np.int32))
    mask = torch.from_numpy(rng.random((5, 128)) < 0.8)
    d = sqdist_rows_quant_plain(prep, quant.codes, quant.norms, ids, mask)
    for j in (1, 3):
        pad = 64 * j
        wide = sqdist_rows_quant_plain(
            prep, quant.codes, quant.norms,
            torch.nn.functional.pad(ids, (0, pad)),
            torch.nn.functional.pad(mask, (0, pad)))
        assert torch.equal(wide[:, :128], d)
        assert torch.isinf(wide[:, 128:]).all()
    lane = type(prep)(*(t[3:4] for t in prep))
    one = sqdist_rows_quant_plain(lane, quant.codes, quant.norms, ids[3:4],
                                  mask[3:4])
    assert torch.equal(one[0], d[3])


@pytest.mark.parametrize("precision", CODECS)
def test_quant_scan_pool_covers_exact(precision):
    """Mirror of `tests/test_planner.py::test_quant_scan_pool_covers_exact`:
    on an engine whose codec is trained by `SearchEngine.build`, a
    compressed scan whose queue holds the whole valid set recovers the
    exact filtered top-k after the rerank."""
    from repro_torch.index.builder import build_graph_index as p_graph

    ds = make_dataset(n=2000, dim=24, n_clusters=6, alphabet_size=32, seed=0)
    graph = p_graph(ds.vectors, degree=16, seed=0, device="cpu")
    engine = SearchEngine.build(ds, graph, device="cpu", precision=precision,
                                quant_cfg=dict(pq_subspaces=8,
                                               pq_centroids=32, pq_iters=8))
    cfg = SearchConfig(k=5, queue_size=64, degree=16)
    wl = make_composite_workload(ds, batch=16, seed=7, structure="and",
                                 selectivities=(0.005, 0.01))
    stats = scan_stats(engine, engine.compile(wl.filters))
    assert (stats.counts <= cfg.queue_size).all()   # pool ⊇ valid set
    st_ = scan_search(engine, cfg, wl.queries, wl.filters)
    assert (st_.q_err_sum.numpy()[stats.counts > 0] > 0).all()
    st_ = engine.rerank(cfg, wl.queries, st_)
    gi, _ = filtered_knn_exact(wl.queries, ds.vectors, wl.exprs,
                               ds.labels_packed, ds.value_matrix, cfg.k,
                               device="cpu")
    np.testing.assert_array_equal(st_.res_idx.numpy(), gi)


# ------------------------------------------------------------ planner ----
@pytest.mark.parametrize("precision", CODECS)
def test_quant_plan_training_data_matches_reference(world, precision):
    """The compressed convergence target: both labels and their flags, the
    static features, σ and the exact oracle's distances equal; probe
    features to 1e-5; some lanes converge under both plans."""
    jdata, data, _ = _training(precision)
    for name in ("static_feats", "w_traverse", "w_widen", "converged_t",
                 "converged_w", "sigma", "gt_dist"):
        np.testing.assert_array_equal(getattr(data, name),
                                      np.asarray(getattr(jdata, name)),
                                      err_msg=name)
    np.testing.assert_allclose(data.features, np.asarray(jdata.features),
                               rtol=1e-5, atol=1e-5)
    assert data.converged_t.any() and data.converged_w.any()


@pytest.mark.parametrize("precision", CODECS)
@pytest.mark.parametrize("backend,ref_backend,heads", [
    ("fused", "pallas", "trained"),
    ("persistent", "pallas_persistent", "skewed"),
    ("dense", "dense", "skewed")])
def test_quant_planned_search_matches_reference(world, precision, backend,
                                                ref_backend, heads):
    """The same plan per lane, predicted budgets and every state field
    after the terminal rerank as the reference on a carried planner; the
    skewed heads take late scans and widen lanes."""
    _, _, _, engines = world
    jeng, eng = engines[precision]
    jplanner = (_training(precision)[2] if heads == "trained"
                else _skewed_planner(precision))
    planner = planner_to_torch(jplanner)
    jwl, wl = _workloads(precision, "mixed", 16, 13, (0.01, 0.2))
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
    assert_fields_equal(got.state, ref.state, f"{precision}/{backend}")
    assert len(set(got.plan.tolist())) >= 2
    if heads == "skewed":
        assert (got.plan == PLANS.index("widen")).any()
        assert ((got.plan == PLANS.index("scan")) & ~got.pre_probe).any()


@pytest.mark.parametrize("precision", CODECS)
@pytest.mark.parametrize("plan", PLANS)
def test_quant_forced_plan_equals_run_plan(world, precision, plan):
    """planned_search(force_plan=p) ≡ run_plan(p), every field, on a
    quantized engine (both end in the exact rerank)."""
    _, _, _, engines = world
    _, eng = engines[precision]
    planner = planner_to_torch(_training(precision)[2])
    _, wl = _workloads(precision, "mixed", 16, 13, (0.01, 0.2))
    cfg = SearchConfig(k=K, queue_size=M, backend="fused")
    forced = planned_search(eng, planner, cfg, wl.queries, wl.filters,
                            probe_budget=PROBE, alpha=1.2, force_plan=plan)
    direct = run_plan(eng, planner, plan, cfg, wl.queries, wl.filters,
                      probe_budget=PROBE, alpha=1.2)
    assert (forced.plan == PLANS.index(plan)).all()
    assert_states_equal(forced.state, direct, f"{precision}/{plan}")


# ------------------------------------------------------------ K6q rows ----
@pytest.mark.parametrize("precision", CODECS)
def test_k6q_rows_plain_equals_quant_dist_on_grid(world, precision):
    """On grid data the plain K6q rows equals `quant_dist` (the traversal's
    plain distance) on the gathered rows, every pair, through the
    `kernels.ops` dispatch on CPU tensors."""
    from repro_torch.kernels.ops import masked_scan_dist_quant

    _, ds, _, engines = world
    _, eng = engines[precision]
    rng = np.random.default_rng(5)
    q = torch.from_numpy(grid_queries(ds.vectors[rng.integers(0, ds.n, 6)]
                                      + 0.05, precision))
    prep = P.prepare_query(precision, eng.quant, q)
    ids = torch.from_numpy(rng.integers(0, ds.n, (6, 192)).astype(np.int32))
    mask = torch.from_numpy(rng.random((6, 192)) < 0.7)
    got = masked_scan_dist_quant(prep, eng.quant, ids, mask)
    want = P.quant_dist(precision, P.QuantGather(
        prep=prep, codes=eng.quant.codes[ids.long()],
        norms=eng.quant.norms[ids.long()]))
    assert torch.equal(got[mask], want[mask])
    assert torch.isinf(got[~mask]).all()
    assert torch.equal(sqdist_rows_quant(prep, eng.quant.codes,
                                         eng.quant.norms, ids, mask), got)

"""The paper's §5 baselines and the test oracles of the PyTorch port, held
to the JAX reference on CPU.

- `core.baselines`: `naive_search` (a static beam, unlimited budget),
  `fixed_budget_search`, `laet_search` (the filter feature group ablated)
  and `oracle_search` (stop at the ground-truth W_q) give the reference's
  budgets, top-k ids, NDC and every `SearchState` field, on an estimator
  the reference trained and the port carries.
- `core.ref_search.ref_search_single` (the sequential Algorithm 1) equals
  the reference's copy and the port's lockstep dense post-mode search, lane
  by lane.
- `core.estimator.spearman` and `CostEstimator.eval_metrics` equal the
  reference's, ties included, with `tests/test_property.py`'s invariances.
- `index.bruteforce.knn_exact` equals the reference's: distances equal,
  ids equal away from distance ties (the reference's `argpartition` order
  is arbitrary there; the port's is by id).

Vectors and queries sit on the grid 1/64, so every squared distance is
exact in float32 whatever the order: float fields are required equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import (CostEstimator as JEstimator, SearchConfig as JConfig,
                        SearchEngine as JEngine, ablate_filter_features,
                        baselines as jb, generate_training_data)
from repro.core import spearman as j_spearman
from repro.core.ref_search import ref_search_single as j_ref_search
from repro.data import make_dataset, make_label_workload, make_range_workload
from repro.index import build_graph_index
from repro.index import knn_exact as j_knn_exact
from repro_torch.convert import (engine_from_arrays, gbdt_from_arrays,
                                 state_to_numpy)
from repro_torch.core import CostEstimator, SearchConfig, baselines, spearman
from repro_torch.core.ref_search import ref_search_single
from repro_torch.filters import FilterSpec
from repro_torch.filters.predicates import PRED_CONTAIN, PRED_RANGE
from repro_torch.index import knn_exact

K, M, PROBE = 5, 32, 32


def on_grid(a):
    return (np.round(a * 64) / 64).astype(np.float32)


def pspec(spec):
    return FilterSpec(spec.kind, spec.label_masks, spec.range_lo,
                      spec.range_hi)


def carried(jest):
    m = jest.model
    return CostEstimator(gbdt_from_arrays(m.feat, m.thresh, m.leaf, m.base,
                                          m.depth, m.importances))


def assert_fields_equal(port_state, ref_state, where):
    for name, g, w in zip(port_state._fields, state_to_numpy(port_state),
                          ref_state):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (where, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")


@pytest.fixture(scope="module")
def world():
    """A grid dataset and graph, both engines, the reference's training
    data on 96 contain queries and two estimators fitted on it (all
    features; filter group ablated), carried into the port."""
    ds = make_dataset(n=2000, dim=16, n_clusters=6, alphabet_size=32, seed=1)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(ds.vectors, degree=8, seed=0)
    jeng = JEngine.build(ds, graph, mesh=None)
    eng = engine_from_arrays(ds.vectors, ds.labels_packed, ds.value_matrix,
                             graph.neighbors, graph.entry_point, device="cpu")
    wl = make_label_workload(ds, batch=96, kind="contain", seed=10)
    wl.queries = on_grid(wl.queries)
    td = generate_training_data(jeng, ds, wl, JConfig(k=K, queue_size=M),
                                probe_budget=PROBE, chunk=96)
    kw = dict(n_trees=40, depth=4, min_child=5)
    jest = JEstimator.fit(td.features, td.w_q, **kw)
    jest_nf = JEstimator.fit(
        np.asarray(ablate_filter_features(jnp.asarray(td.features))),
        td.w_q, **kw)
    return dict(ds=ds, graph=graph, jeng=jeng, eng=eng, wl=wl, td=td,
                jest=jest, jest_nf=jest_nf)


def _eval(ds, kind, batch=16):
    if kind == "range":
        wl = make_range_workload(ds, batch=batch, seed=21)
    else:
        wl = make_label_workload(ds, batch=batch, kind="contain", seed=20)
    wl.queries = on_grid(wl.queries)
    return wl


# ----------------------------------------------------------- baselines ----
@pytest.mark.parametrize("ef", [16, 64])
@pytest.mark.parametrize("backend,ref_backend", [
    ("dense", "dense"), ("persistent", "pallas_persistent")])
def test_naive_search_matches_reference(world, ef, backend, ref_backend):
    """A static beam of width ef searched to exhaustion: every field."""
    wl = _eval(world["ds"], "contain")
    ref = jb.naive_search(world["jeng"], JConfig(k=K, queue_size=M,
                                                 backend=ref_backend),
                          wl.queries, wl.spec, ef)
    got = baselines.naive_search(world["eng"], SearchConfig(
        k=K, queue_size=M, backend=backend), wl.queries, pspec(wl.spec), ef)
    assert_fields_equal(got, ref, f"naive ef={ef} {backend}")
    assert got.cand_dist.shape[1] == ef and not got.active.any()


@pytest.mark.parametrize("kind", ["contain", "range"])
@pytest.mark.parametrize("budget", [50, 300])
def test_fixed_budget_search_matches_reference(world, kind, budget):
    wl = _eval(world["ds"], kind)
    ref = jb.fixed_budget_search(world["jeng"], JConfig(k=K, queue_size=M),
                                 wl.queries, wl.spec, budget)
    got = baselines.fixed_budget_search(
        world["eng"], SearchConfig(k=K, queue_size=M), wl.queries,
        pspec(wl.spec), budget)
    assert_fields_equal(got, ref, f"fixed {kind} {budget}")


@pytest.mark.parametrize("kind", ["contain", "range"])
def test_laet_search_matches_reference(world, kind):
    """The filter-ablated estimator: the same budgets (the features it saw
    to 1e-5, the filter group zeroed) and every state field."""
    wl = _eval(world["ds"], kind)
    ref = jb.laet_search(world["jeng"], world["jest_nf"],
                         JConfig(k=K, queue_size=M), wl.queries, wl.spec,
                         probe_budget=PROBE, alpha=1.5)
    got = baselines.laet_search(world["eng"], carried(world["jest_nf"]),
                                SearchConfig(k=K, queue_size=M), wl.queries,
                                pspec(wl.spec), probe_budget=PROBE, alpha=1.5)
    np.testing.assert_array_equal(got.predicted_budget,
                                  np.asarray(ref.predicted_budget))
    np.testing.assert_allclose(got.probe_features,
                               np.asarray(ref.probe_features), rtol=1e-5,
                               atol=1e-5)
    assert_fields_equal(got.state, ref.state, f"laet {kind}")


@pytest.mark.parametrize("alpha", [1.0, 1.5])
def test_oracle_search_matches_reference(world, alpha):
    """Budgets max(int(α·W_q), 1) from the training labels: every field;
    at α=1 every converged lane holds its exact top-k."""
    wl, td = world["wl"], world["td"]
    q, spec = wl.queries[:24], wl.spec.slice(slice(0, 24))
    w_q = np.asarray(td.w_q)[:24]
    ref = jb.oracle_search(world["jeng"], JConfig(k=K, queue_size=M), q,
                           spec, w_q, alpha=alpha)
    got = baselines.oracle_search(world["eng"], SearchConfig(k=K,
                                                             queue_size=M),
                                  q, pspec(spec), w_q, alpha=alpha)
    assert_fields_equal(got, ref, f"oracle α={alpha}")
    if alpha == 1.0:
        conv = np.asarray(td.converged)[:24]
        np.testing.assert_array_equal(got.res_dist.numpy()[conv],
                                      np.asarray(td.gt_dist)[:24][conv])


# ------------------------------------------------------ the sequential ----
def _ref_args(ds, spec, i, kind):
    if kind == "range":
        return (spec.range_lo[i], spec.range_hi[i]), ds.values, PRED_RANGE
    return spec.label_masks[i], ds.labels_packed, PRED_CONTAIN


@pytest.mark.parametrize("kind", ["contain", "range"])
def test_ref_search_single_matches_reference_and_lockstep(world, kind):
    """Per query: the port's sequential Algorithm 1 == the reference's copy
    (every output) == the lockstep dense post-mode search of that lane
    (top-k, NDC and the counters), with convergence against the oracle."""
    ds, eng, graph, td = world["ds"], world["eng"], world["graph"], \
        world["td"]
    wl = _eval(ds, kind, batch=6)
    nbrs = np.asarray(graph.neighbors)
    budget = 400
    st_ = eng.search(SearchConfig(k=K, queue_size=M, backend="dense"),
                     wl.queries, pspec(wl.spec), budget)
    lock = dict(zip(st_._fields, state_to_numpy(st_)))
    gt = np.asarray(td.gt_dist)[:1]
    for i in range(wl.batch):
        q_attr, attrs, pred = _ref_args(ds, wl.spec, i, kind)
        args = (wl.queries[i], q_attr, ds.vectors, attrs, nbrs,
                int(graph.entry_point), K, M, budget, pred)
        got = ref_search_single(*args)
        want = j_ref_search(*args)
        assert got.keys() == want.keys()
        for name in got:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{i}: {name}")
        np.testing.assert_array_equal(got["res_idx"], lock["res_idx"][i])
        np.testing.assert_array_equal(got["res_dist"], lock["res_dist"][i])
        for name in ("cnt", "n_inspected", "n_valid_visited", "n_pop_valid",
                     "hops", "res_full_cnt"):
            assert got[name] == lock[name][i], (i, name)
        with_gt = ref_search_single(*args, gt_dist=gt[0])
        assert with_gt["conv_cnt"] == j_ref_search(*args,
                                                   gt_dist=gt[0])["conv_cnt"]


# ----------------------------------------------------- estimator metrics ----
def test_spearman_matches_reference():
    """Average ranks for ties: runs of equal values in either argument,
    all-equal input, and unrelated draws."""
    rng = np.random.default_rng(3)
    cases = [(rng.normal(size=50), rng.normal(size=50)),
             (rng.integers(0, 5, 60).astype(float), rng.normal(size=60)),
             (rng.integers(0, 3, 40), rng.integers(0, 4, 40)),
             (np.ones(10), rng.normal(size=10))]
    for a, b in cases:
        assert spearman(a, b) == j_spearman(a, b)


def test_spearman_invariances():
    """`tests/test_property.py::test_spearman_invariances`, on the port."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=100)
    assert spearman(a, a) == pytest.approx(1.0)
    assert spearman(a, -a) == pytest.approx(-1.0)
    assert abs(spearman(a, rng.normal(size=100))) < 0.35
    assert spearman(a, np.exp(a)) == pytest.approx(1.0)


def test_eval_metrics_matches_reference(world):
    """Table 3's log-RMSE, R² and Spearman ρ of a carried estimator on its
    training features: equal to the reference's."""
    td = world["td"]
    feats, w_q = np.asarray(td.features), np.asarray(td.w_q)
    want = world["jest"].eval_metrics(feats, w_q)
    got = carried(world["jest"]).eval_metrics(feats, w_q)
    assert got == want
    assert got["spearman"] > 0.5


# ---------------------------------------------------------- knn_exact ----
def test_knn_exact_matches_reference(world):
    """Unfiltered exact top-k over K6's row-id variant in the oracles'
    layout (blocks off SCAN_ALIGN): distances equal, ids equal away from
    distance ties, ties by ascending id."""
    ds = world["ds"]
    rng = np.random.default_rng(4)
    q = on_grid(ds.vectors[rng.integers(0, ds.n, 20)]
                + rng.normal(scale=0.1, size=(20, ds.dim)))
    wi, wd = j_knn_exact(q, ds.vectors, 10)
    gi, gd = knn_exact(q, ds.vectors, 10, device="cpu", q_chunk=7,
                       n_block=700)
    np.testing.assert_array_equal(gd, np.asarray(wd))
    with np.errstate(invalid="ignore"):
        tie = np.zeros_like(gd, bool)
        tie[:, 1:] |= np.diff(gd, axis=1) == 0
        tie[:, :-1] |= np.diff(gd, axis=1) == 0
    np.testing.assert_array_equal(gi[~tie], np.asarray(wi)[~tie])
    assert (~tie).mean() > 0.5
    for i, j in zip(*np.nonzero(tie[:, :-1] & tie[:, 1:])):
        if gd[i, j] == gd[i, j + 1]:
            assert gi[i, j] < gi[i, j + 1]
    full = np.sort(((q[:, None, :] - ds.vectors[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(gd, full[:, :10].astype(np.float32))

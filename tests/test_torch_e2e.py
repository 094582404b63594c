"""E2E parity of the PyTorch port against the JAX reference, on CPU.

One estimator is trained by the reference and carried across; the port's
`e2e_search` must then give identical budgets, top-k ids and NDC, with
probe features within 1e-5 (the packages evaluate `log1p`, sums and
ratios with different float routines). Data sits on the grid 1/64 so
distances are exact in both packages (see test_torch_search.py).
"""
import numpy as np
import pytest

from repro.core import (CostEstimator as JEstimator, SearchConfig as JConfig,
                        SearchEngine as JEngine, e2e_search as j_e2e,
                        generate_training_data)
from repro.core.gbdt import train_gbdt as j_train_gbdt
from repro.data import make_dataset, make_label_workload, make_range_workload
from repro.index import build_graph_index
from repro.index.bruteforce import valid_mask
from repro_torch.convert import engine_from_arrays, gbdt_from_arrays
from repro_torch.core import (CostEstimator, SearchConfig, e2e_search,
                              feature_names, train_gbdt)
from repro_torch.core import generate_training_data as p_generate_training_data
from repro_torch.data.synthetic import QueryWorkload
from repro_torch.filters import FilterSpec


def on_grid(a):
    return (np.round(a * 64) / 64).astype(np.float32)


def pspec(spec):
    return FilterSpec(spec.kind, spec.label_masks, spec.range_lo,
                      spec.range_hi)


@pytest.fixture(scope="module")
def world():
    ds = make_dataset(n=2000, dim=16, n_clusters=6, alphabet_size=32, seed=1)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(ds.vectors, degree=8, seed=0)
    jeng = JEngine.build(ds, graph, mesh=None)
    eng = engine_from_arrays(ds.vectors, ds.labels_packed, ds.value_matrix,
                             graph.neighbors, graph.entry_point, device="cpu")
    wl = make_label_workload(ds, batch=96, kind="contain", seed=10)
    wl.queries = on_grid(wl.queries)
    td = generate_training_data(jeng, ds, wl, JConfig(k=5, queue_size=32),
                                probe_budget=32, chunk=96)
    jest = JEstimator.fit(td.features, td.w_q, n_trees=40, depth=4,
                          min_child=5)
    m = jest.model
    est = CostEstimator(gbdt_from_arrays(m.feat, m.thresh, m.leaf, m.base,
                                         m.depth, m.importances))
    return ds, jeng, eng, jest, est, td


def _eval(ds, kind):
    if kind == "range":
        wl = make_range_workload(ds, batch=16, seed=21)
    else:
        wl = make_label_workload(ds, batch=16, kind="contain", seed=20)
    wl.queries = on_grid(wl.queries)
    return wl


def _compare(ref, got):
    np.testing.assert_allclose(got.probe_features, np.asarray(ref.probe_features),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.predicted_budget,
                                  np.asarray(ref.predicted_budget))
    np.testing.assert_array_equal(got.state.res_idx.numpy(),
                                  np.asarray(ref.state.res_idx))
    np.testing.assert_array_equal(got.state.cnt.numpy(),
                                  np.asarray(ref.state.cnt))
    np.testing.assert_allclose(got.state.res_dist.numpy(),
                               np.asarray(ref.state.res_dist), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["contain", "range"])
@pytest.mark.parametrize("backend,ref_backend", [("dense", "dense"),
                                                 ("fused", "pallas")])
@pytest.mark.parametrize("alpha", [1.0, 2.0])
def test_e2e_matches_reference(world, kind, backend, ref_backend, alpha):
    ds, jeng, eng, jest, est, _ = world
    wl = _eval(ds, kind)
    ref = j_e2e(jeng, jest, JConfig(k=5, queue_size=32, backend=ref_backend),
                wl.queries, wl.spec, probe_budget=32, alpha=alpha)
    got = e2e_search(eng, est, SearchConfig(k=5, queue_size=32,
                                            backend=backend),
                     wl.queries, pspec(wl.spec), probe_budget=32, alpha=alpha)
    assert got.probe_features.shape == (16, len(feature_names(2)))
    _compare(ref, got)


@pytest.mark.parametrize("backend,ref_backend", [("dense", "dense"),
                                                 ("fused", "pallas")])
def test_e2e_repredict_matches_reference(world, backend, ref_backend):
    ds, jeng, eng, jest, est, _ = world
    wl = _eval(ds, "contain")
    ref = j_e2e(jeng, jest, JConfig(k=5, queue_size=32, backend=ref_backend),
                wl.queries, wl.spec, probe_budget=32, repredict_every=24)
    got = e2e_search(eng, est, SearchConfig(k=5, queue_size=32,
                                            backend=backend),
                     wl.queries, pspec(wl.spec), probe_budget=32,
                     repredict_every=24)
    _compare(ref, got)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_training_data_matches_reference(world, backend):
    """The W_q labels the estimator trains on: probe features, the
    convergence NDC (the `gt_dist` branch of the step) and the exhaustion
    fallback must equal the reference's lane for lane."""
    ds, _, eng, *_, ref = world
    wl = make_label_workload(ds, batch=96, kind="contain", seed=10)
    wl.queries = on_grid(wl.queries)
    pwl = QueryWorkload(wl.queries, pspec(wl.spec), wl.sigma_global,
                        wl.hardness)
    got = p_generate_training_data(
        eng, ds, pwl, SearchConfig(k=5, queue_size=32, backend=backend),
        probe_budget=32, chunk=48)
    assert 0 < ref.converged.sum() < len(ref.converged)
    np.testing.assert_array_equal(got.converged, ref.converged)
    np.testing.assert_array_equal(got.w_q, ref.w_q)
    np.testing.assert_allclose(got.features, ref.features, rtol=1e-5,
                               atol=1e-5)
    _assert_same_exact_topk(got, ref, wl, ds)


def _assert_same_exact_topk(got, ref, wl, ds):
    """Equal ground-truth distances, and equal ids except among equal
    distances: the reference picks tied items through `np.argpartition`,
    whose order on ties is arbitrary, so there each id is checked to be a
    valid item at its stated distance (exact on the grid)."""
    np.testing.assert_array_equal(got.gt_dist, ref.gt_dist)
    np.testing.assert_array_equal(got.gt_idx < 0, ref.gt_idx < 0)
    d = ref.gt_dist
    tied = ((d[:, :, None] == d[:, None, :]).sum(-1) > 1) | (d == d[:, -1:])
    np.testing.assert_array_equal(got.gt_idx[~tied], ref.gt_idx[~tied])
    ok = valid_mask(wl.spec, ds.labels_packed, ds.value_matrix)
    lane, pos = np.nonzero(got.gt_idx >= 0)
    ids = got.gt_idx[lane, pos]
    assert ok[lane, ids].all()
    diff = wl.queries[lane].astype(np.float64) - ds.vectors[ids]
    np.testing.assert_array_equal((diff * diff).sum(-1).astype(np.float32),
                                  got.gt_dist[lane, pos])


def test_train_gbdt_gives_identical_model(world):
    *_, td = world
    y = np.log(np.maximum(td.w_q, 1.0))
    ref = j_train_gbdt(td.features, y, n_trees=30, depth=4, min_child=5,
                       subsample=0.8, seed=3)
    got = train_gbdt(td.features, y, n_trees=30, depth=4, min_child=5,
                     subsample=0.8, seed=3)
    for name in ("feat", "thresh", "leaf", "importances"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    assert got.base == ref.base and got.depth == ref.depth


def test_predict_cost_matches_reference(world):
    *_, jest, est, td = world
    np.testing.assert_array_equal(est.predict_cost(td.features),
                                  jest.predict_cost(td.features))

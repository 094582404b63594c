"""Data, ground truth and graph construction of the PyTorch port, on CPU.

The generators must give arrays bit-equal to the reference's for the same
seed; the exact filtered kNN must return the reference's ids; the port's
device graph builder must give a valid graph whose greedy-search recall
is within 0.02 of the reference builder's graph on the same data.
"""
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.index import build_graph_index as j_build
from repro.index.bruteforce import filtered_knn_exact as j_knn
from repro_torch.core import BIG_BUDGET, SearchConfig, SearchEngine
from repro_torch.data import synthetic as psyn
from repro_torch.filters import PRED_CONTAIN, FilterSpec
from repro_torch.index import (GraphIndex, build_graph_index,
                               filtered_knn_exact, recall_at_k)

DS_FIELDS = ("vectors", "labels_packed", "values", "cluster_ids",
             "values_aux")


@pytest.mark.parametrize("kw", [
    dict(n=1500, dim=24, n_clusters=6, alphabet_size=40, seed=5),
    dict(jsyn.DATASET_PRESETS["tripclick-s"], n=1200, n_value_attrs=3),
])
def test_dataset_and_workloads_bit_equal(kw):
    jd, pd = jsyn.make_dataset(**kw), psyn.make_dataset(**kw)
    for f in DS_FIELDS:
        np.testing.assert_array_equal(getattr(pd, f), getattr(jd, f), f)
    assert pd.label_sets == jd.label_sets
    for kind in ("contain", "equal"):
        jw = jsyn.make_label_workload(jd, batch=40, kind=kind, seed=9)
        pw = psyn.make_label_workload(pd, batch=40, kind=kind, seed=9)
        for f in ("queries", "sigma_global", "hardness"):
            np.testing.assert_array_equal(getattr(pw, f), getattr(jw, f))
        np.testing.assert_array_equal(pw.spec.label_masks,
                                      jw.spec.label_masks)
        assert pw.spec.kind == jw.spec.kind
    jw = jsyn.make_range_workload(jd, batch=40, seed=8)
    pw = psyn.make_range_workload(pd, batch=40, seed=8)
    for f in ("queries", "sigma_global", "hardness"):
        np.testing.assert_array_equal(getattr(pw, f), getattr(jw, f))
    np.testing.assert_array_equal(pw.spec.range_lo, jw.spec.range_lo)
    np.testing.assert_array_equal(pw.spec.range_hi, jw.spec.range_hi)


@pytest.fixture(scope="module")
def data():
    kw = dict(n=2000, dim=16, n_clusters=8, alphabet_size=32, seed=2)
    return jsyn.make_dataset(**kw), psyn.make_dataset(**kw)


@pytest.mark.parametrize("kind", ["contain", "range"])
def test_filtered_knn_exact_matches_reference(data, kind):
    jd, pd = data
    if kind == "range":
        jw = jsyn.make_range_workload(jd, batch=24, seed=3)
        pw = psyn.make_range_workload(pd, batch=24, seed=3)
    else:
        jw = jsyn.make_label_workload(jd, batch=24, seed=3)
        pw = psyn.make_label_workload(pd, batch=24, seed=3)
    ji, jdist = j_knn(jw.queries, jd.vectors, jw.spec, jd.labels_packed,
                      jd.value_matrix, 10)
    pi, pdist = filtered_knn_exact(pw.queries, pd.vectors, pw.spec,
                                   pd.labels_packed, pd.value_matrix, 10,
                                   device="cpu", q_chunk=7, n_block=300)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pdist, jdist, rtol=1e-5, atol=1e-5)


def _greedy_recall(pd, graph: GraphIndex, queries, gt):
    eng = SearchEngine.build(pd, graph, device="cpu")
    spec = FilterSpec(PRED_CONTAIN, np.zeros((len(queries), pd.n_words),
                                             np.uint32))      # matches all
    st = eng.search(SearchConfig(k=10, queue_size=48), queries, spec,
                    BIG_BUDGET)
    return float(recall_at_k(st.res_idx.numpy(), gt).mean())


def test_graph_builder_recall_close_to_reference(data):
    jd, pd = data
    jg = j_build(jd.vectors, degree=16, seed=0)
    pg = build_graph_index(pd.vectors, degree=16, seed=0, device="cpu")
    pg.validate()
    assert pg.neighbors.dtype == torch.int32
    assert pg.degree == 16 and int(pg.out_degrees().min()) > 0
    wl = psyn.make_label_workload(pd, batch=64, seed=7)
    spec = FilterSpec(PRED_CONTAIN, np.zeros((64, pd.n_words), np.uint32))
    gt, _ = filtered_knn_exact(wl.queries, pd.vectors, spec,
                               pd.labels_packed, pd.value_matrix, 10,
                               device="cpu")
    ref_graph = GraphIndex(torch.from_numpy(jg.neighbors), jg.entry_point,
                           jg.dim)
    r_ref = _greedy_recall(pd, ref_graph, wl.queries, gt)
    r_port = _greedy_recall(pd, pg, wl.queries, gt)
    assert r_port >= r_ref - 0.02, (r_port, r_ref)


def test_graph_validate_rejects_bad_graphs():
    nb = torch.tensor([[1, 2], [0, 2], [0, 1]], dtype=torch.int32)
    GraphIndex(nb, 0, 4).validate()
    with pytest.raises(TypeError, match="int32"):
        GraphIndex(nb.long(), 0, 4).validate()
    with pytest.raises(ValueError, match="out of range"):
        GraphIndex(torch.tensor([[1, 3], [0, 2], [0, 1]], dtype=torch.int32),
                   0, 4).validate()
    with pytest.raises(ValueError, match="self loop"):
        GraphIndex(torch.tensor([[1, 2], [1, 2], [0, 1]], dtype=torch.int32),
                   0, 4).validate()
    with pytest.raises(ValueError, match="entry_point"):
        GraphIndex(nb, 3, 4).validate()
